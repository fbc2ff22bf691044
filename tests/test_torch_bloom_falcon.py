"""BLOOM and Falcon (every block shape) against the JAX package.

``BloomConfig.tiny()`` and ``FalconConfig.tiny()`` in the reference's
three Falcon block shapes — falcon-7b's parallel single-LN block with one
shared K/V head and rope, the new decoder architecture (``ln_attn`` /
``ln_mlp``, grouped K/V) and falcon-rw (sequential, ALiBi at 2/sqrt(d)
the BLOOM slopes, biases) — with the JAX model's weights carried over by
``load_jax_state_dict``, on the CPU in fp32, where every kernel wrapper
runs its plain version (ALiBi: K2/K5's plain versions). Tolerances: the
same algorithm on both sides, only the summation order of XLA's and
ATen's products differs (a few ulp an op through two layers): logits
within 1e-4, the loss rtol 1e-5, a gradient element rtol 1e-4 and atol
1e-6 near zero, parameters after one AdamW step atol 1e-5 (as in
``test_torch_train.py``). Greedy streams must be token-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.models import bloom as jbloom
from paddle_tpu.models import decoding as jdec
from paddle_tpu.models import falcon as jfalcon
from paddle_tpu.nn import functional as JF
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import bloom as tbloom
from paddle_tpu_torch.models import decoding as tdec
from paddle_tpu_torch.models import falcon as tfalcon
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.train import init_state, make_train_step
from tests.test_torch_common import to_np
from tests._torch_threads import one_torch_thread  # noqa: F401

VOCAB = 128
# family -> (JAX model, JAX config, port model, port config, config kw)
FAMILIES = {
    "bloom": (jbloom.BloomForCausalLM, jbloom.BloomConfig,
              tbloom.BloomForCausalLM, tbloom.BloomConfig, {}),
    "falcon_parallel_mqa": (jfalcon.FalconForCausalLM, jfalcon.FalconConfig,
                            tfalcon.FalconForCausalLM, tfalcon.FalconConfig,
                            {}),
    "falcon_new_arch_gqa": (jfalcon.FalconForCausalLM, jfalcon.FalconConfig,
                            tfalcon.FalconForCausalLM, tfalcon.FalconConfig,
                            dict(new_decoder_architecture=True,
                                 num_kv_heads=2)),
    "falcon_rw_alibi": (jfalcon.FalconForCausalLM, jfalcon.FalconConfig,
                        tfalcon.FalconForCausalLM, tfalcon.FalconConfig,
                        dict(alibi=True, bias=True, multi_query=False,
                             parallel_attn=False)),
}


def _pair(family, seed=0, **kw):
    jcls, jcfg, tcls, tcfg, fam_kw = FAMILIES[family]
    pt.seed(seed)
    jm = jcls(jcfg.tiny(**fam_kw, **kw))
    tm = tcls(tcfg.tiny(**fam_kw, **kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


# the generation tests' weights: std 0.3 instead of 0.02, so that the tiny
# models' greedy streams do not settle on one token at once
GEN_INIT = dict(initializer_range=0.3)


def _ids(seed, b=3, s=14):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s))


def _loss_fn(m, ids, labels):
    return m.loss(ids, labels)


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_reference(family):
    jm, tm = _pair(family)
    ids = _ids(1)
    want = jm(jnp.asarray(ids))
    got = tm(torch.as_tensor(ids))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-4, atol=1e-4)


def test_falcon_configs_leave_out_what_the_reference_leaves_out():
    """Biases and LayerNorms a config turns off are no parameters: the
    port's names are the reference's, whichever block shape."""
    for family in FAMILIES:
        jm, tm = _pair(family)
        assert set(dict(tm.named_parameters())) == set(jm.state_dict())


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_generate_is_token_identical(family):
    jm, tm = _pair(family, **GEN_INIT)
    ids = _ids(2, s=9)
    want = jdec.generic_generate(jm, jnp.asarray(ids), max_new_tokens=10)
    got = tdec.generic_generate(tm, ids, max_new_tokens=10)
    assert got.shape == (3, 19)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_generate_eos_min_new_tokens_and_penalty(family):
    """EOS (a token the penalised greedy streams emit after their first
    two steps and not in them, so that min_new_tokens 2 masks no argmax),
    min_new_tokens 2 and repetition penalty 1.3: the same buffer, EOS
    repeated after a row's first and the loop stopped (zeros after) once
    every row has emitted it."""
    jm, tm = _pair(family, **GEN_INIT)
    ids = _ids(3, s=7)
    kw = dict(max_new_tokens=12, repetition_penalty=1.3)
    first = np.asarray(jdec.generic_generate(jm, jnp.asarray(ids), **kw))
    eos = next(int(t) for t in first[:, 9:].reshape(-1)
               if t not in first[:, 7:9])
    kw.update(eos_token_id=eos, min_new_tokens=2)
    want = np.asarray(jdec.generic_generate(jm, jnp.asarray(ids), **kw))
    got = tdec.generic_generate(tm, ids, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 9:] == eos).any()
    assert not (got[:, 7:9] == eos).any()          # min_new_tokens


@pytest.mark.parametrize("family", FAMILIES)
def test_sampled_generate_matches_on_filtered_logits(family, monkeypatch):
    """Under temperature 0.7, top_k 20 and top_p 0.8 the draws cannot match
    (torch generators, not JAX keys), so both sides draw the argmax of
    the distribution they would sample from: the streams are then equal
    exactly when the filtered logits agree at every step, penalty
    included."""
    jm, tm = _pair(family, **GEN_INIT)
    ids = _ids(4, s=8)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits, axis))
    monkeypatch.setattr(tdec, "_gumbel_max",
                        lambda logits, gen: torch.argmax(logits, -1))
    kw = dict(max_new_tokens=8, temperature=0.7, top_k=20, top_p=0.8,
              repetition_penalty=1.2)
    want = jdec.generic_generate(jm, jnp.asarray(ids), **kw)
    got = tdec.generic_generate(tm, ids, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, None, 0.9), (1.3, 5, None), (0.5, 40, 0.6)])
def test_filter_logits_matches_reference_sample(temperature, top_k, top_p,
                                                monkeypatch):
    """The logits the reference's ``_sample`` hands to
    ``jax.random.categorical`` against ``filter_logits``."""
    seen = []

    def capture(key, logits, axis=-1):
        seen.append(np.asarray(logits))
        return jnp.argmax(logits, axis)
    monkeypatch.setattr(jax.random, "categorical", capture)
    logits = 3 * np.random.RandomState(5).randn(4, VOCAB).astype(np.float32)
    jdec._sample(jnp.asarray(logits), jax.random.PRNGKey(0), temperature,
                 top_k, top_p)
    got = tdec.filter_logits(torch.as_tensor(logits), temperature, top_k,
                             top_p)
    np.testing.assert_allclose(got.numpy(), seen[0], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    tok = tdec._sample(torch.as_tensor(logits), gen, temperature, top_k,
                       top_p)
    assert (got.gather(-1, tok[:, None]) > -1e29).all()   # never a cut one


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_loss_and_grads_match_reference(family):
    """One make_train_step step (AdamW, the headline's settings) on both
    sides: its loss and every gradient against jax.value_and_grad of the
    reference's loss, and every parameter after the update."""
    jm, tm = _pair(family)
    ids = _ids(6, b=2, s=16)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    # the reference's gradients under one jax.jit (eager JAX compiles
    # every op apart)
    jloss, jgrads = jax.jit(value_and_grad(_loss_fn))(
        jm, jnp.asarray(ids), jnp.asarray(labels))

    def adamw(mod):
        return mod.AdamW(learning_rate=3e-4, weight_decay=0.1,
                         grad_clip=mod.ClipGradByGlobalNorm(1.0))
    jo = adamw(jopt)
    jstate, jstep_loss = j_make_train_step(_loss_fn, jo, donate=False)(
        j_init_state(jm, jo), jnp.asarray(ids), jnp.asarray(labels))
    to = adamw(topt)
    state, loss = make_train_step(_loss_fn, to)(
        init_state(tm, to), torch.as_tensor(ids), torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jstep_loss), rtol=1e-5)
    want = jgrads.state_dict()
    params = dict(tm.named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        np.testing.assert_allclose(to_np(p.grad), np.asarray(want[name],
                                                             np.float32),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    after = jstate.model.state_dict()
    for name, p in params.items():
        np.testing.assert_allclose(to_np(p), np.asarray(after[name],
                                                        np.float32),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("family", ["bloom", "falcon_rw_alibi"])
def test_remat_gives_the_same_grads(family):
    """remat recomputes each block in the backward (torch checkpoint):
    the same arithmetic on the CPU, so the same gradients."""
    _, tm = _pair(family)
    _, tr = _pair(family, remat=True)
    ids = torch.as_tensor(_ids(7, b=2, s=12))
    labels = torch.cat([ids[:, 1:], torch.full((2, 1), -100)], dim=1)
    for m in (tm, tr):
        m.loss(ids, labels).backward()
    for (name, a), b in zip(tm.named_parameters(), tr.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7,
                                   msg=name)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("affine", [(True, True), (True, False),
                                    (False, False)],
                         ids=["weight_bias", "weight", "none"])
def test_layer_norm_matches_reference(dtype, affine):
    """LayerNorm with its weight/bias each present or None, fp32
    statistics and one cast back in both packages (bf16: equal up to one
    bf16 step, the casts of the inputs being identical)."""
    from paddle_tpu.nn.layers import LayerNorm as JLayerNorm
    rs = np.random.RandomState(8)
    x = (2 + 3 * rs.randn(3, 5, 48)).astype(np.float32)
    w, b = 1 + 0.1 * rs.randn(48), 0.1 * rs.randn(48)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    pt.seed(0)
    jl = JLayerNorm(48, epsilon=1e-5, weight_attr=affine[0],
                    bias_attr=affine[1], dtype=jdt)
    tl = LayerNorm(48, epsilon=1e-5, weight_attr=affine[0],
                   bias_attr=affine[1], dtype=tdt, device="cpu")
    assert (tl.weight is None) == (jl.weight is None)
    assert (tl.bias is None) == (jl.bias is None)
    if affine[0]:
        jl.weight = jnp.asarray(w, jdt)
        tl.weight.data = torch.as_tensor(w).to(tdt)
    if affine[1]:
        jl.bias = jnp.asarray(b, jdt)
        tl.bias.data = torch.as_tensor(b).to(tdt)
    want = jl(jnp.asarray(x, jdt))
    got = tl(torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype is np.float32 else 1e-2
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        to_np(TF.layer_norm(torch.as_tensor(x), 48)),
        to_np(JF.layer_norm(jnp.asarray(x), 48)), rtol=1e-5, atol=1e-5)


def test_layer_norm_defaults_to_the_card():
    """Like every entry point of the port, a LayerNorm built without a
    device puts its parameters on the card, and raises without one."""
    if torch.cuda.is_available():
        assert LayerNorm(8).weight.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LayerNorm(8)
    assert LayerNorm(8, device="cpu").bias.device.type == "cpu"


@pytest.mark.parametrize("approximate", [True, False],
                         ids=["tanh", "exact"])
def test_gelu_matches_reference(approximate):
    x = 3 * np.random.RandomState(9).randn(257).astype(np.float32)
    np.testing.assert_allclose(
        to_np(TF.gelu(torch.as_tensor(x), approximate=approximate)),
        to_np(JF.gelu(jnp.asarray(x), approximate=approximate)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [4, 6, 16, 32, 71])
def test_alibi_slopes_match_reference(n):
    np.testing.assert_allclose(tbloom.alibi_slopes(n, "cpu").numpy(),
                               np.asarray(jbloom.alibi_slopes(n)), rtol=1e-7)
