"""Selective remat and scanned layers in the port against the JAX package.

Ports ``tests/test_remat_policy.py`` and ``test_highlevel.py``'s
scan-vs-loop case. The port cuts each decoder layer into checkpointed
segments whose boundaries are the names a ``remat_policy`` saves
(``models/llama.py`` ``_segments``): the tensors kept across the
checkpoints, counted with ``torch.autograd.graph.saved_tensors_hooks``,
grow None < hidden < no_ffn < dots, the [1, 8, 96] gate/up activation is
kept exactly when the policy names ``ffn_gu``, a saved product is not
recomputed in the backward (counted ``aten.mm`` calls), and loss and
gradients are bit-identical across policies (Llama, Mistral, Qwen2) and
equal the reference's within fp32 tolerance. ``scan_layers=True`` holds
the reference's stacked parameters (``load_jax_state_dict`` carries a
scanned JAX model across), matches the loop and the reference, and every
walker of ``model.model.layers`` refuses it by name.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.models import mistral as jmistral
from paddle_tpu.models import qwen as jqwen
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models import (MistralConfig, MistralForCausalLM,
                                     Qwen2Config, Qwen2ForCausalLM)
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from tests.test_torch_common import to_np

# hidden 32, intermediate 48: the fused gate/up activation's last dim 96
# is unique in the net, so its presence among the saved tensors
# identifies the policy
_B, _S, _H, _I = 1, 8, 32, 48
POLICIES = [None, "full", "hidden", "no_ffn", "dots"]
FAMILIES = {
    "llama": (JLlamaConfig.tiny, JLlama, LlamaConfig.tiny, LlamaForCausalLM),
    "mistral": (jmistral.MistralConfig.tiny, jmistral.MistralForCausalLM,
                MistralConfig.tiny, MistralForCausalLM),
    "qwen2": (jqwen.Qwen2Config.tiny, jqwen.Qwen2ForCausalLM,
              Qwen2Config.tiny, Qwen2ForCausalLM),
}
SMALL = dict(remat=True, num_hidden_layers=2, hidden_size=_H,
             intermediate_size=_I, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=64)


def _pair(family, **kw):
    jcfg, jcls, tcfg, tcls = FAMILIES[family]
    pt.seed(0)
    jm = jcls(jcfg(**kw))
    tm = tcls(tcfg(**kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


def _batch(s=_S):
    ids = np.arange(s, dtype=np.int64)[None] % 64
    labels = np.concatenate([ids[:, 1:], np.full((1, 1), -100)], axis=1)
    return torch.as_tensor(ids), torch.as_tensor(labels)


@pytest.fixture(scope="module")
def model():
    return _pair("llama", **SMALL)[1]


def _saved_shapes(model, ids, labels):
    """Shapes of the tensors autograd keeps for the backward outside the
    checkpoints' own recompute: each checkpoint's inputs (what its policy
    saved) and the tensors of the ops outside any checkpoint."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(ids, labels)
    return shapes


def test_policy_monotonically_grows_saved_residuals(model):
    ids, labels = _batch()
    counts = {}
    for pol in [None, "hidden", "no_ffn", "dots"]:
        model.cfg.remat_policy = pol
        counts[pol] = len(_saved_shapes(model, ids, labels))
    model.cfg.remat_policy = None
    assert counts[None] < counts["hidden"] < counts["no_ffn"] < \
        counts["dots"], counts


def test_ffn_gu_saved_exactly_when_policy_names_it(model):
    ids, labels = _batch()
    gu_shape = (_B, _S, 2 * _I)
    model.cfg.remat_policy = "dots"          # names "ffn_gu"
    assert gu_shape in _saved_shapes(model, ids, labels)
    model.cfg.remat_policy = "no_ffn"        # does not
    assert gu_shape not in _saved_shapes(model, ids, labels)
    model.cfg.remat_policy = None


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_saved_products_are_not_recomputed(model):
    """The backward's matrix products: a policy that saves ``qkv`` skips
    the qkv product's recompute, one that saves ``ffn_gu`` the gate/up
    product's too (one product a layer each)."""
    ids, labels = _batch()
    mms = {}
    for pol in [None, "hidden", "no_ffn", "dots"]:
        model.cfg.remat_policy = pol
        loss = model.loss(ids, labels)
        with _CountMM() as c:
            loss.backward()
        mms[pol] = c.mm
        model.zero_grad(set_to_none=True)
    model.cfg.remat_policy = None
    layers = model.cfg.num_hidden_layers
    assert mms["hidden"] == mms[None]
    assert mms["no_ffn"] == mms[None] - layers
    assert mms["dots"] == mms[None] - 2 * layers


@pytest.mark.parametrize("family", ["llama", "mistral", "qwen2"])
def test_loss_and_grads_identical_across_policies(family):
    """Remat trades memory for recompute only: loss and every gradient
    bit-identical under every policy (and without remat), and equal to
    the reference model's within fp32 tolerance."""
    jm, tm = _pair(family, **SMALL)
    ids, labels = _batch(20)
    ref = None
    for remat, pol in [(False, None)] + [(True, p) for p in POLICIES]:
        tm.cfg.remat, tm.cfg.remat_policy = remat, pol
        tm.zero_grad(set_to_none=True)
        loss = tm.loss(ids, labels)
        loss.backward()
        got = (float(loss.detach()),
               {n: p.grad.clone() for n, p in tm.named_parameters()})
        if ref is None:
            ref = got
            continue
        assert got[0] == ref[0], f"loss drifted under {pol!r}"
        for n, g in got[1].items():
            assert torch.equal(g, ref[1][n]), f"grad {n} under {pol!r}"
    jm.cfg.remat_policy = "dots"
    jloss, jgrads = value_and_grad(lambda m, i, l: m.loss(i, l))(
        jm, jnp.asarray(ids.numpy()), jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(ref[0], float(jloss), rtol=1e-6)
    want = dict(jgrads.named_parameters())
    for n, g in ref[1].items():
        np.testing.assert_allclose(to_np(g), np.asarray(want[n]), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_unknown_policy_raises(model):
    ids, _ = _batch()
    model.cfg.remat_policy = "everything"
    with pytest.raises(ValueError, match="remat_policy"):
        model(ids)
    model.cfg.remat_policy = None
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaConfig(remat_policy="everything")


def test_llama_scan_layers_matches_loop():
    """A scanned JAX model carried across by load_jax_state_dict: the
    reference's stacked names and [L, ...] shapes, the outputs of the loop
    and of the reference, and the stacked gradient (leading dim L) the
    loop's per-layer gradients, under a selective policy too."""
    pt.seed(0)
    jloop = JLlama(JLlamaConfig.tiny())
    pt.seed(0)
    jscan = JLlama(JLlamaConfig.tiny(scan_layers=True))
    loop = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_state_dict(loop, jloop.state_dict())
    scan = LlamaForCausalLM(LlamaConfig.tiny(scan_layers=True), device="cpu")
    load_jax_state_dict(scan, jscan.state_dict())
    L = scan.cfg.num_hidden_layers
    assert len(scan.model.layers) == 0
    assert scan.model.layers_stacked.self_attn.qkv_proj.shape[0] == L
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (2, 16))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    out = to_np(scan(torch.as_tensor(ids)))
    np.testing.assert_array_equal(out, to_np(loop(torch.as_tensor(ids))))
    np.testing.assert_allclose(out, np.asarray(jscan(jnp.asarray(ids))),
                               rtol=2e-5, atol=2e-5)
    loop.loss(torch.as_tensor(ids), torch.as_tensor(labels)).backward()
    for remat, pol in ((False, None), (True, "no_ffn")):
        scan.cfg.remat, scan.cfg.remat_policy = remat, pol
        scan.zero_grad(set_to_none=True)
        loss = scan.loss(torch.as_tensor(ids), torch.as_tensor(labels))
        assert np.isfinite(float(loss.detach()))
        loss.backward()
        stacked = scan.model.layers_stacked.self_attn.qkv_proj.grad
        assert stacked.shape[0] == L
        for i, lyr in enumerate(loop.model.layers):
            assert torch.equal(stacked[i], lyr.self_attn.qkv_proj.grad)


def _walkers():
    """Each port entry point that walks ``model.model.layers``."""
    from paddle_tpu_torch import peft
    from paddle_tpu_torch import quantization as TQW
    from paddle_tpu_torch.core.random import generator
    from paddle_tpu_torch.models import convert, decoding, paged
    from paddle_tpu_torch.models.speculative import speculative_generate
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.serving import quant as TQ
    ids = torch.zeros(1, 4, dtype=torch.long)
    return {
        "llama_prefill_paged": lambda m: paged.llama_prefill_paged(
            m, ids, np.array([4]), paged.PagedKVCache.init(
                2, 4, 4, 2, 16, 1, 4, torch.float32, device="cpu")),
        "generate": lambda m: decoding.generate(m, ids, 2),
        "speculative_generate": lambda m: speculative_generate(m, m, ids, 2),
        "LLMEngine": lambda m: LLMEngine(m, num_slots=1, block_size=4,
                                         max_prompt_len=4, max_seq_len=8,
                                         device="cpu"),
        "quantize_for_serving": lambda m: TQ.quantize_for_serving(
            m, "weight_only_int8"),
        "smooth_for_serving": lambda m: TQ.smooth_for_serving(m),
        "quantize_llama_weights": lambda m: TQW.quantize_llama_weights(
            m, "gptq_int4", calib_ids=ids),
        "lora_init": lambda m: peft.lora_init(m, generator(0, "cpu")),
        "load_llama_state_dict": lambda m: convert.load_llama_state_dict(
            m, {}),
    }


@pytest.mark.parametrize("walker", sorted(_walkers()))
def test_layer_walkers_refuse_a_scanned_model(walker):
    """An empty ``layers`` would make every loop over it do nothing: each
    walker raises by name instead, the model left as it was."""
    scan = LlamaForCausalLM(LlamaConfig.tiny(scan_layers=True), device="cpu")
    before = {n: p.clone() for n, p in scan.named_parameters()}
    with pytest.raises(NotImplementedError, match="scan_layers"):
        _walkers()[walker](scan)
    assert all(torch.equal(p, before[n])
               for n, p in scan.named_parameters())
