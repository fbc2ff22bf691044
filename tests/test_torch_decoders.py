"""GPT, GPT-NeoX, OPT, Phi and GLM against the JAX package, and their HF
loaders against ``transformers``.

Each family at ``tiny()`` (plus OPT's 350m shape with post-norm blocks,
NeoX's sequential block and GLM without q/k/v biases), with the JAX
model's weights carried over by ``load_jax_state_dict``, on the CPU in
fp32, where every kernel wrapper runs its plain version. Tolerances: the
same algorithm on both sides, only the summation order of XLA's and
ATen's products differs: logits within 1e-4, the loss rtol 1e-5, a
gradient element rtol 1e-4 and atol 1e-6 near zero, parameters after one
AdamW step atol 1e-5 (as in ``test_torch_gemma_gptj.py``); greedy
``generic_generate`` streams token-identical. GPT's dropout > 0 is
checked for its keep rate and scaling, not for its bits (torch cannot
draw ``jax.random``'s). The HF cases mirror ``tests/test_convert.py``'s:
every parameter bit-equal to the reference loader's (the loaders only
transpose, slice and reshape) and the logits within that test's
tolerance of HF's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.models import convert as jconv
from paddle_tpu.models import decoding as jdec
from paddle_tpu.models import glm as jglm
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import gpt_neox as jneox
from paddle_tpu.models import opt as jopt_m
from paddle_tpu.models import phi as jphi
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import convert as tconv
from paddle_tpu_torch.models import decoding as tdec
from paddle_tpu_torch.models import glm as tglm
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import gpt_neox as tneox
from paddle_tpu_torch.models import opt as topt_m
from paddle_tpu_torch.models import phi as tphi
from paddle_tpu_torch.models.convert import load_jax_state_dict
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_common import to_np

VOCAB = 128
# case -> (JAX model, JAX config, port model, port config, config kw)
FAMILIES = {
    "gpt": (jgpt.GPTForCausalLM, jgpt.GPTConfig, tgpt.GPTForCausalLM,
            tgpt.GPTConfig, {}),
    "gpt_neox": (jneox.GPTNeoXForCausalLM, jneox.GPTNeoXConfig,
                 tneox.GPTNeoXForCausalLM, tneox.GPTNeoXConfig, {}),
    "gpt_neox_sequential": (jneox.GPTNeoXForCausalLM, jneox.GPTNeoXConfig,
                            tneox.GPTNeoXForCausalLM, tneox.GPTNeoXConfig,
                            dict(use_parallel_residual=False)),
    "opt": (jopt_m.OPTForCausalLM, jopt_m.OPTConfig, topt_m.OPTForCausalLM,
            topt_m.OPTConfig, {}),
    "opt_350m_shape": (jopt_m.OPTForCausalLM, jopt_m.OPTConfig,
                       topt_m.OPTForCausalLM, topt_m.OPTConfig,
                       dict(word_embed_proj_dim=16,
                            do_layer_norm_before=False)),
    "phi": (jphi.PhiForCausalLM, jphi.PhiConfig, tphi.PhiForCausalLM,
            tphi.PhiConfig, {}),
    "glm": (jglm.GlmForCausalLM, jglm.GlmConfig, tglm.GlmForCausalLM,
            tglm.GlmConfig, {}),
    "glm_no_bias": (jglm.GlmForCausalLM, jglm.GlmConfig, tglm.GlmForCausalLM,
                    tglm.GlmConfig, dict(attention_bias=False)),
}
MAIN = ("gpt", "gpt_neox", "opt", "phi", "glm")


def _pair(family, seed=0, **kw):
    jcls, jcfg, tcls, tcfg, fam_kw = FAMILIES[family]
    pt.seed(seed)
    kw = {**fam_kw, **kw}
    jm = jcls(jcfg.tiny(**kw))
    tm = tcls(tcfg.tiny(**kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


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
    """The port's parameter names and shapes are the reference's: tied
    heads for GPT and OPT (no head parameter), OPT's 350m projections and
    no final LayerNorm under post-norm, no ``qkv_bias`` for GLM without
    attention biases."""
    jm, tm = _pair(family)
    want = jm.state_dict()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert tuple(p.shape) == tuple(np.shape(want[name])), name
    if family == "opt_350m_shape":
        assert {"project_in", "project_out"} <= set(got)
        assert "final_layer_norm.weight" not in got
    if family == "glm_no_bias":
        assert not any(n.endswith("qkv_bias") for n in got)


@pytest.mark.parametrize("family", MAIN)
def test_greedy_generate_is_token_identical(family):
    """generic_generate re-forwards the fixed buffer each step on both
    sides (weights at std 0.3, so the tiny models do not settle on one
    token at once)."""
    jm, tm = _pair(family, initializer_range=0.3)
    ids = _ids(2, s=9)
    want = jdec.generic_generate(jm, jnp.asarray(ids), max_new_tokens=8)
    got = tdec.generic_generate(tm, ids, max_new_tokens=8)
    assert got.shape == (3, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_loss_and_grads_match_reference(family):
    """One make_train_step step (AdamW with weight decay and global-norm
    clipping) on both sides: its loss and every gradient against
    jax.value_and_grad of the reference's loss, and every parameter
    after the update."""
    jm, tm = _pair(family)
    ids = _ids(6, b=2, s=16)
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
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
        np.testing.assert_allclose(to_np(p.grad),
                                   np.asarray(want[name], np.float32),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    after = jstate.model.state_dict()
    for name, p in params.items():
        np.testing.assert_allclose(to_np(p), np.asarray(after[name],
                                                        np.float32),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("family", ["gpt", "gpt_neox", "phi", "glm"])
def test_remat_gives_the_same_grads(family):
    """remat recomputes each block in the backward (torch checkpoint): the
    same arithmetic on the CPU, so the same gradients."""
    _, tm = _pair(family)
    _, tr = _pair(family, remat=True)
    ids = torch.as_tensor(_ids(7, b=2, s=12))
    labels = torch.cat([ids[:, 1:], torch.full((2, 1), -100)], dim=1)
    for m in (tm, tr):
        m.loss(ids, labels).backward()
    for (name, a), b in zip(tm.named_parameters(), tr.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7,
                                   msg=name)


def test_gpt_dropout_keep_rate_scaling_and_remat():
    """GPT with dropout 0.25 while training: a masked residual branch keeps
    ~75% of its elements, scaled by 1 / 0.75 (checked through
    ``nn.Dropout`` on a large tensor: keep share within 1% of 0.75, every
    kept value exactly x / 0.75); the same generator seed gives the same
    loss and gradients with and without remat (each block's masks are
    drawn before the block, so its recompute applies them); eval mode and
    dropout 0 give the reference's loss."""
    from paddle_tpu_torch.nn.layers import Dropout
    x = torch.randn(400, 500, generator=torch.Generator().manual_seed(0))
    drop = Dropout(0.25)
    y = drop(x, generator=torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    drop.eval()
    assert drop(x) is x
    jm, tm = _pair("gpt", dropout=0.25)
    _, tr = _pair("gpt", dropout=0.25, remat=True)
    ids = torch.as_tensor(_ids(8, b=2, s=12))
    labels = torch.cat([ids[:, 1:], torch.full((2, 1), -100)], dim=1)
    losses = []
    for m in (tm, tr):
        loss = m.loss(ids, labels, generator=torch.Generator().manual_seed(3))
        loss.backward()
        losses.append(float(loss.detach()))
    assert losses[0] == losses[1]
    for (name, a), b in zip(tm.named_parameters(), tr.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7,
                                   msg=name)
    tm.eval()
    jm.eval()
    with torch.no_grad():
        got = float(tm.loss(ids, labels))
    want = float(jm.loss(jnp.asarray(ids.numpy()), jnp.asarray(
        labels.numpy())))
    assert got != losses[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_glm_rms_norm_is_k1_s_function(dtype):
    """GLM's norm (fp32 statistics, the weight in fp32, one cast) through
    ``ops.fused_rms_norm`` against the reference's ``GlmRMSNorm`` at
    GLM-4's epsilon 1.5625e-7: equal up to fp32 rounding (bf16: one bf16
    step)."""
    rs = np.random.RandomState(9)
    x = (2 + 3 * rs.randn(3, 5, 48)).astype(np.float32)
    w = (1 + 0.3 * rs.randn(48)).astype(np.float32)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jn = jglm.GlmRMSNorm(48, 1.5625e-07, jdt)
    jn.weight = jnp.asarray(w, jdt)
    from paddle_tpu_torch.models.llama import _Init
    tn = tglm.GlmRMSNorm(48, 1.5625e-07, _Init(tglm.GlmConfig(dtype=tdt),
                                               torch.device("cpu"), 0))
    tn.weight.data = torch.as_tensor(w).to(tdt)
    got = tn(torch.as_tensor(x).to(tdt))
    want = jn(jnp.asarray(x, jdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype is np.float32 else 1e-2
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ HF loaders
transformers = pytest.importorskip("transformers")


def _hf_case(name):
    """(HF model, JAX model + loader, port model + loader, ids, tol), the
    configs of ``tests/test_convert.py``'s cases."""
    T = transformers
    f32 = dict(dtype=jnp.float32, remat=False)
    t32 = dict(dtype=torch.float32, remat=False)
    tol = dict(rtol=2e-4, atol=2e-4)
    vocab = 96
    if name == "gpt2":
        hf = T.GPT2LMHeadModel(T.GPT2Config(
            vocab_size=96, n_embd=32, n_layer=2, n_head=4, n_positions=64,
            n_inner=None, attn_implementation="eager", resid_pdrop=0.0,
            embd_pdrop=0.0, attn_pdrop=0.0))
        kw = dict(vocab_size=96, hidden_size=32, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=64, dropout=0.0,
                  layer_norm_eps=hf.config.layer_norm_epsilon)
        j = (jgpt.GPTForCausalLM(jgpt.GPTConfig(**kw, **f32)),
             jconv.load_gpt2_state_dict)
        t = (tgpt.GPTForCausalLM(tgpt.GPTConfig(**kw, **t32), device="cpu"),
             tconv.load_gpt2_state_dict)
        tol = dict(rtol=3e-4, atol=3e-4)
    elif name.startswith("opt"):
        kw = dict(vocab_size=96, hidden_size=32, ffn_dim=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=64)
        if name == "opt_350m_shape":
            kw.update(vocab_size=64, word_embed_proj_dim=16,
                      do_layer_norm_before=False)
            vocab = 64
        hf = T.OPTForCausalLM(T.OPTConfig(**kw, use_cache=False,
                                          attn_implementation="eager"))
        j = (jopt_m.OPTForCausalLM(jopt_m.OPTConfig(**kw, **f32)),
             jconv.load_opt_state_dict)
        t = (topt_m.OPTForCausalLM(topt_m.OPTConfig(**kw, **t32),
                                   device="cpu"), tconv.load_opt_state_dict)
    elif name.startswith("gpt_neox"):
        kw = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  rotary_pct=0.25, max_position_embeddings=64,
                  use_parallel_residual=name == "gpt_neox_parallel")
        hf = T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
            **kw, use_cache=False, attn_implementation="eager"))
        j = (jneox.GPTNeoXForCausalLM(jneox.GPTNeoXConfig(**kw, **f32)),
             jconv.load_gpt_neox_state_dict)
        t = (tneox.GPTNeoXForCausalLM(tneox.GPTNeoXConfig(**kw, **t32),
                                      device="cpu"),
             tconv.load_gpt_neox_state_dict)
    elif name == "glm":
        hf = T.GlmForCausalLM(T.GlmConfig(
            vocab_size=96, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, partial_rotary_factor=0.5,
            rms_norm_eps=1e-6, max_position_embeddings=64, use_cache=False,
            pad_token_id=0, eos_token_id=1, bos_token_id=2, head_dim=8,
            attn_implementation="eager"))
        j = (jglm.GlmForCausalLM(jglm.GlmConfig.tiny(vocab_size=96)),
             jconv.load_glm_state_dict)
        t = (tglm.GlmForCausalLM(tglm.GlmConfig.tiny(vocab_size=96),
                                 device="cpu"), tconv.load_glm_state_dict)
        tol = dict(rtol=3e-4, atol=3e-4)
    elif name == "phi":
        hf = T.PhiForCausalLM(T.PhiConfig(
            vocab_size=96, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, partial_rotary_factor=0.5,
            max_position_embeddings=64, use_cache=False,
            attn_implementation="eager"))
        j = (jphi.PhiForCausalLM(jphi.PhiConfig.tiny(vocab_size=96)),
             jconv.load_phi_state_dict)
        t = (tphi.PhiForCausalLM(tphi.PhiConfig.tiny(vocab_size=96),
                                 device="cpu"), tconv.load_phi_state_dict)
    else:
        raise KeyError(name)
    ids = np.random.RandomState(0).randint(0, vocab, (2, 12))
    return hf.eval(), j, t, ids, tol


HF_CASES = ["gpt2", "opt", "opt_350m_shape", "gpt_neox_parallel",
            "gpt_neox_sequential", "glm", "phi"]


@pytest.mark.parametrize("name", HF_CASES)
def test_hf_loader_fills_the_reference_parameters_and_matches_hf(name):
    """Bit-equal parameters to the reference loader's; logits within
    ``test_convert.py``'s tolerance of HF's (fp32)."""
    torch.manual_seed(0)
    pt.seed(0)
    hf, (jm, jload), (tm, tload), ids, tol = _hf_case(name)
    sd = hf.state_dict()
    jm = jload(jm.eval(), sd)
    assert tload(tm, sd) is tm
    jp = jm.state_dict()
    tp = dict(tm.named_parameters())
    assert set(jp) == set(tp)
    for k, arr in jp.items():
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(arr), err_msg=k)
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
        got = tm(torch.as_tensor(ids)).float().numpy()
    np.testing.assert_allclose(got, ref, **tol)


def test_hf_loaders_take_numpy_and_retype():
    """numpy input loads like tensors; ``dtype=bf16`` turns every weight
    into the fp32 load's bf16 rounding (Phi)."""
    torch.manual_seed(0)
    hf, _, (tm, tload), _, _ = _hf_case("phi")
    sd = hf.state_dict()
    tload(tm, {k: v.numpy() for k, v in sd.items()})
    _, _, (tb, _), _, _ = _hf_case("phi")
    tload(tb, sd, dtype=torch.bfloat16)
    assert tb.cfg.dtype == torch.bfloat16
    for (k, p32), (k2, pb) in zip(tm.named_parameters(),
                                  tb.named_parameters()):
        assert k == k2 and pb.dtype == torch.bfloat16, k
        assert torch.equal(pb, p32.to(torch.bfloat16)), k
