"""Gemma, GPT-J and CodeGen against the JAX package.

``GemmaConfig.tiny()`` (head dim 16), ``GemmaConfig.tiny(head_dim=256)``
(the head dim of every published Gemma, at a narrow hidden size: the
attention path the card runs on K2/K5 at 256), ``GPTJConfig.tiny()`` and
``CodeGenConfig.tiny()``, with the JAX model's weights carried over by
``load_jax_state_dict``, on the CPU in fp32, where every kernel wrapper
runs its plain version. Tolerances: the same algorithm on both sides, only
the summation order of XLA's and ATen's products differs (a few ulp an op
through two layers): logits within 1e-4, the loss rtol 1e-5, a gradient
element rtol 1e-4 and atol 1e-6 near zero, parameters after one AdamW step
atol 1e-5 (as in ``test_torch_bloom_falcon.py``). Greedy streams must be
token-identical. In bf16, Gemma's embedding scale is rounded to bf16
before the multiply, as the reference casts it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.models import decoding as jdec
from paddle_tpu.models import gemma as jgemma
from paddle_tpu.models import gptj as jgptj
from paddle_tpu.ops import attention as JA
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import decoding as tdec
from paddle_tpu_torch.models import gemma as tgemma
from paddle_tpu_torch.models import gptj as tgptj
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.ops import attention as TA
from tests.test_torch_common import to_np

VOCAB = 128
# family -> (JAX model, JAX config, port model, port config, config kw)
FAMILIES = {
    "gemma": (jgemma.GemmaForCausalLM, jgemma.GemmaConfig,
              tgemma.GemmaForCausalLM, tgemma.GemmaConfig, {}),
    "gemma_hd256": (jgemma.GemmaForCausalLM, jgemma.GemmaConfig,
                    tgemma.GemmaForCausalLM, tgemma.GemmaConfig,
                    dict(head_dim=256)),
    "gptj": (jgptj.GPTJForCausalLM, jgptj.GPTJConfig,
             tgptj.GPTJForCausalLM, tgptj.GPTJConfig, {}),
    "codegen": (jgptj.CodeGenForCausalLM, jgptj.CodeGenConfig,
                tgptj.CodeGenForCausalLM, tgptj.CodeGenConfig, {}),
}


def _pair(family, seed=0, jdtype=None, tdtype=None, **kw):
    jcls, jcfg, tcls, tcfg, fam_kw = FAMILIES[family]
    pt.seed(seed)
    jkw, tkw = {**fam_kw, **kw}, {**fam_kw, **kw}
    if jdtype is not None:
        jkw["dtype"], tkw["dtype"] = jdtype, tdtype
    jm = jcls(jcfg.tiny(**jkw))
    tm = tcls(tcfg.tiny(**tkw), device="cpu")
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


@pytest.mark.parametrize("family", FAMILIES)
def test_parameters_are_the_reference_s(family):
    """The port's parameter names and shapes are the reference's: one tied
    embedding for Gemma (no lm_head), the untied biased head for GPT-J and
    CodeGen, zero-centred Gemma norm weights (0 at init, not 1)."""
    jm, tm = _pair(family)
    want = jm.state_dict()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert tuple(p.shape) == tuple(np.shape(want[name])), name
    if family.startswith("gemma"):
        assert "lm_head" not in got
        fresh = tgemma.GemmaForCausalLM(tgemma.GemmaConfig.tiny(),
                                        device="cpu")
        assert not fresh.norm.weight.any()
    else:
        assert {"lm_head", "lm_head_bias", "h.0.fc_in_bias"} <= set(got)


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_generate_is_token_identical(family):
    jm, tm = _pair(family, **GEN_INIT)
    ids = _ids(2, s=9)
    want = jdec.generic_generate(jm, jnp.asarray(ids), max_new_tokens=10)
    got = tdec.generic_generate(tm, ids, max_new_tokens=10)
    assert got.shape == (3, 19)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
    from paddle_tpu_torch.train import init_state, make_train_step
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


@pytest.mark.parametrize("family", ["gemma_hd256", "gptj"])
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


def test_gemma_bf16_embedding_scale_rounds_like_reference():
    """bf16 at hidden 48: sqrt(48) = 6.9282 rounds to 6.9375 in bf16, and
    the reference multiplies by that rounded scale. The port's first layer
    receives exactly embed * bf16(sqrt(48)), which differs from a multiply
    by the fp32 scale for some entries; the logits agree with the
    reference's bf16 logits to bf16 rounding (2% of their RMS)."""
    jm, tm = _pair("gemma", jdtype=jnp.bfloat16, tdtype=torch.bfloat16,
                   hidden_size=48, initializer_range=0.5)
    ids = _ids(8)
    scale = torch.tensor(48 ** 0.5, dtype=torch.bfloat16)
    assert float(scale) == float(jnp.asarray(48 ** 0.5, jnp.bfloat16))
    assert float(scale) != 48 ** 0.5
    seen = []
    tm.layers[0].register_forward_pre_hook(lambda mod, a: seen.append(a[0]))
    got = tm(torch.as_tensor(ids))
    emb = tm.embed_tokens.detach()[torch.as_tensor(ids)]
    want_x = jnp.take(jm.embed_tokens, jnp.asarray(ids), axis=0) * \
        jnp.asarray(48 ** 0.5, jnp.bfloat16)
    assert seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(seen[0]), to_np(want_x))
    assert not torch.equal(seen[0], (emb.float() * 48 ** 0.5).bfloat16())
    # the rest of the forward in bf16 on both sides (XLA and ATen round
    # their products' sums at other points): within 2% of the logits' RMS
    want = to_np(jm(jnp.asarray(ids))).astype(np.float32)
    err = to_np(got).astype(np.float32) - want
    assert np.sqrt(np.mean(err ** 2)) <= 0.02 * np.sqrt(np.mean(want ** 2))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gemma_rms_norm_matches_reference(dtype):
    """y = norm(x) * (1 + w) in fp32 and one cast: equal up to fp32
    rounding (bf16: one bf16 step)."""
    rs = np.random.RandomState(9)
    x = (2 + 3 * rs.randn(3, 5, 48)).astype(np.float32)
    w = 0.3 * rs.randn(48).astype(np.float32)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jn = jgemma.GemmaRMSNorm(48, 1e-6, jdt)
    jn.weight = jnp.asarray(w, jdt)
    from paddle_tpu_torch.models.llama import _Init
    cfg = tgemma.GemmaConfig.tiny(dtype=tdt)
    tn = tgemma.GemmaRMSNorm(48, 1e-6, _Init(cfg, torch.device("cpu"), 0))
    tn.weight.data = torch.as_tensor(w).to(tdt)
    got = tn(torch.as_tensor(x).to(tdt))
    want = jn(jnp.asarray(x, jdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype is np.float32 else 1e-2
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("rot,d", [(4, 4), (64, 256)],
                         ids=["all_lanes", "first_64_of_256"])
def test_apply_rope_interleaved_matches_reference(dtype, rot, d):
    """GPT-J's interleaved rope on the first ``rot`` lanes against the
    reference's ``apply_rope_interleaved`` (fp32 tables; bf16 x promotes,
    one cast back: equal up to one bf16 step), and the even/odd pairs are
    the ones rotated: position 0 is the identity, lane 2i+1 at position 1
    is x[2i+1] cos + x[2i] sin."""
    rs = np.random.RandomState(10)
    x = rs.randn(2, 7, 3, d).astype(np.float32)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jcos, jsin = JA.rope_cos_sin(7, rot)
    tcos, tsin = TA.rope_cos_sin(7, rot, device="cpu")
    want = JA.apply_rope_interleaved(jnp.asarray(x, jdt)[..., :rot], jcos,
                                     jsin)
    got = TA.apply_rope_interleaved(torch.as_tensor(x).to(tdt)[..., :rot],
                                    tcos, tsin)
    assert got.dtype == tdt and got.shape == (2, 7, 3, rot)
    tol = 1e-6 if dtype is np.float32 else 1e-2
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
    if dtype is np.float32:
        np.testing.assert_allclose(to_np(got)[:, 0], x[:, 0, :, :rot],
                                   rtol=1e-6, atol=1e-6)
        c, s = float(tcos[1, 0]), float(tsin[1, 0])
        np.testing.assert_allclose(to_np(got)[:, 1, :, 1],
                                   x[:, 1, :, 1] * c + x[:, 1, :, 0] * s,
                                   rtol=1e-6, atol=1e-6)


def test_gptj_config_defaults_are_gpt_j_6b():
    """``GPTJConfig()`` is EleutherAI/gpt-j-6b's config (16 heads of 256,
    n_inner 4 x 4096) and ``GemmaConfig()`` google/gemma-7b's (16 heads of
    256 over hidden 3072), as the reference's defaults."""
    cfg, ref = tgptj.GPTJConfig(), jgptj.GPTJConfig()
    for f in ("vocab_size", "n_embd", "n_layer", "n_head", "rotary_dim",
              "n_inner", "layer_norm_epsilon"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.n_embd // cfg.n_head == 256 and cfg.n_inner == 16384
    assert tgptj.CodeGenConfig.tiny().n_inner == 128
    g, gref = tgemma.GemmaConfig(), jgemma.GemmaConfig()
    for f in ("vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "rms_norm_eps",
              "rope_theta", "remat"):
        assert getattr(g, f) == getattr(gref, f), f
