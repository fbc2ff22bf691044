"""Adapter-only LoRA training, ``paddle_tpu_torch.peft.make_lora_train_step``,
against the reference's (``tests/test_peft.py``
``test_make_lora_train_step_with_adamw``): the same tiny fp32 Llama, the
same adapters (numpy, through both packages' ``lora_load_state_dict``;
B nonzero so every gradient is live) and the same batch, 3 AdamW steps.

Tolerances: losses rtol 1e-5 (fp32, same algorithm; only the summation
order differs); adapters after the steps rtol 1e-4 / atol 1e-6 (AdamW at
lr 1e-2 moves an entry ~1e-2 a step, its rounding far below that). The
base model's parameters are held BIT-identical, with no ``.grad``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import peft as jpeft
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import peft
from paddle_tpu_torch.optimizer import AdamW
from tests.test_torch_common import tiny_pair, to_np

KW = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
          num_key_value_heads=2, vocab_size=64)


def _adapter_state(targets, model, r=4, seed=3):
    rs = np.random.RandomState(seed)
    params = dict(model.named_parameters())
    sd = {"_scale": np.float32(16 / r)}
    for t in targets:
        k, n = params[t].shape
        sd[t + ".lora_A"] = (rs.randn(k, r) / np.sqrt(k)).astype(np.float32)
        sd[t + ".lora_B"] = (0.05 * rs.randn(r, n)).astype(np.float32)
    return sd


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 64, (4, 8)), rs.randint(0, 64, (4, 8))


def _port_setup(remat=False, seed=0):
    import paddle_tpu as pt
    from paddle_tpu.models.llama import LlamaConfig as JConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    pt.seed(seed)
    jm = JLlama(JConfig.tiny(**KW))
    tm = LlamaForCausalLM(LlamaConfig.tiny(remat=remat, **KW), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    targets = peft.lora_targets(tm, ("qkv_proj", "o_proj"))
    sd = _adapter_state(targets, tm)
    template = peft.lora_init(tm, torch.Generator().manual_seed(0), r=4,
                              target_modules=("qkv_proj", "o_proj"))
    return jm, tm, sd, peft.lora_load_state_dict(template, sd)


def test_lora_train_step_matches_reference():
    jm, tm, sd, lora = _port_setup()
    jtemplate = jpeft.lora_init(jm, __import__("jax").random.PRNGKey(0), r=4,
                                target_modules=("qkv_proj", "o_proj"))
    jlora = jpeft.lora_load_state_dict(jtemplate, sd)
    ids, labels = _batch()
    jstep, jad, jst = jpeft.make_lora_train_step(
        jm, jlora, JAdamW(learning_rate=1e-2), lambda m, x, y: m.loss(x, y))
    step, ad, st = peft.make_lora_train_step(
        tm, lora, AdamW(learning_rate=1e-2), lambda m, x, y: m.loss(x, y),
        device="cpu")
    base = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jl, tl = [], []
    for _ in range(3):
        jad, jst, jloss = jstep(jad, jst, jnp.asarray(ids),
                                jnp.asarray(labels))
        ad, st, loss = step(ad, st, torch.as_tensor(ids),
                            torch.as_tensor(labels))
        jl.append(float(jloss))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for name in ad:
        if name == "_scale":
            continue
        for r in ("a", "b"):
            np.testing.assert_allclose(to_np(ad[name][r]),
                                       np.asarray(jad[name][r]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name}.{r}")
    # the base stays bit-identical and gradient-free
    for n, p in tm.named_parameters():
        assert torch.equal(p, base[n]), n
        assert p.grad is None, n
    # only A/B entered the optimizer; _scale rides along untouched
    assert set(st["moment1"]) == {f"{t}.{r}" for t in ad if t != "_scale"
                                  for r in ("a", "b")}
    assert float(ad["_scale"]) == float(lora["_scale"]) == 4.0
    assert int(st["step"]) == 3


def test_lora_train_step_copies_and_round_trips():
    _, tm, sd, lora = _port_setup()
    orig = {k: {r: v.clone() for r, v in ab.items()} for k, ab in lora.items()
            if k != "_scale"}
    ids, labels = _batch()
    step, ad, st = peft.make_lora_train_step(
        tm, lora, AdamW(learning_rate=1e-2), lambda m, x, y: m.loss(x, y),
        device="cpu")
    for _ in range(2):
        ad, st, _ = step(ad, st, torch.as_tensor(ids), torch.as_tensor(labels))
    for k, ab in orig.items():            # the caller's tree is untouched
        for r, v in ab.items():
            assert torch.equal(lora[k][r], v)
    rt = peft.lora_load_state_dict(ad, peft.lora_state_dict(ad))
    assert float(rt["_scale"]) == 4.0
    with torch.no_grad():
        merged = peft.lora_merge(tm, ad)(torch.as_tensor(ids))
        base = tm(torch.as_tensor(ids))
    assert not torch.equal(merged, base)


def test_lora_train_step_with_remat_matches_without():
    """Under remat the layers re-run inside the backward: they must read
    the merged weights there too, so both runs train the same adapters."""
    out = []
    for remat in (False, True):
        _, tm, _, lora = _port_setup(remat=remat)
        ids, labels = _batch()
        step, ad, st = peft.make_lora_train_step(
            tm, lora, AdamW(learning_rate=1e-2),
            lambda m, x, y: m.loss(x, y), device="cpu")
        for _ in range(2):
            ad, st, _ = step(ad, st, torch.as_tensor(ids),
                             torch.as_tensor(labels))
        out.append(ad)
    for k in out[0]:
        if k != "_scale":
            for r in ("a", "b"):
                np.testing.assert_allclose(to_np(out[1][k][r]),
                                           to_np(out[0][k][r]), rtol=1e-5,
                                           atol=1e-7)


def test_lora_train_step_refuses_a_base_on_another_device():
    _, tm, _, lora = _port_setup()
    with pytest.raises(ValueError, match="lives on"):
        peft.make_lora_train_step(tm, lora, AdamW(1e-2),
                                  lambda m, x, y: m.loss(x, y),
                                  device="meta")
