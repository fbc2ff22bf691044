"""HF checkpoint loaders of the port (``models/convert.py``): for each
family the port has, an HF model built from a config in the test is
loaded into the JAX model by the reference loader and into the port by
the port's loader. Every port parameter must equal the JAX one bit for
bit (fp32: the loaders only transpose, slice and reshape), and the port's
logits must match HF's within ``tests/test_convert.py``'s tolerance of
that family. ``load_safetensors`` is held on a file the ``safetensors``
package wrote and on a hand-written bf16 file, with ``safetensors`` and
``ml_dtypes`` blocked from import."""
import json
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import bloom as jbloom
from paddle_tpu.models import convert as jconv
from paddle_tpu.models import falcon as jfalcon
from paddle_tpu.models import gemma as jgemma
from paddle_tpu.models import gptj as jgptj
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import mistral as jmistral
from paddle_tpu.models import mixtral as jmixtral
from paddle_tpu.models import qwen as jqwen
from paddle_tpu.models import qwen2_moe as jqmoe
from paddle_tpu_torch.models import bloom as tbloom
from paddle_tpu_torch.models import convert as tconv
from paddle_tpu_torch.models import falcon as tfalcon
from paddle_tpu_torch.models import gemma as tgemma
from paddle_tpu_torch.models import gptj as tgptj
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import mistral as tmistral
from paddle_tpu_torch.models import mixtral as tmixtral
from paddle_tpu_torch.models import qwen as tqwen
from paddle_tpu_torch.models import qwen2_moe as tqmoe

transformers = pytest.importorskip("transformers")

_LLAMA = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64)
_FALCON = {
    "7b": dict(multi_query=True, parallel_attn=True, bias=False,
               new_decoder_architecture=False, alibi=False),
    "new": dict(new_decoder_architecture=True, num_kv_heads=2,
                multi_query=True, parallel_attn=True, bias=False,
                alibi=False),
    "rw": dict(multi_query=False, parallel_attn=False, bias=True,
               new_decoder_architecture=False, alibi=True),
}


def _case(name):
    """(HF model, JAX model + loader, port model + loader, ids, tol) of one
    parity case, the configs those of ``tests/test_convert.py``."""
    T = transformers
    f32 = dict(dtype=jnp.float32, remat=False)
    t32 = dict(dtype=torch.float32, remat=False)
    ids = np.random.RandomState(0).randint(0, 96, (2, 12))
    tol = dict(rtol=2e-4, atol=2e-4)
    if name.startswith("llama"):
        nkv = int(name[-1])
        hf = T.LlamaForCausalLM(T.LlamaConfig(
            **_LLAMA, num_key_value_heads=nkv, attn_implementation="eager"))
        kw = dict(_LLAMA, num_key_value_heads=nkv,
                  rms_norm_eps=hf.config.rms_norm_eps)
        j = (jllama.LlamaForCausalLM(jllama.LlamaConfig(**kw, **f32)),
             jconv.load_llama_state_dict)
        t = (tllama.LlamaForCausalLM(tllama.LlamaConfig(**kw, **t32),
                                     device="cpu"),
             tconv.load_llama_state_dict)
    elif name == "qwen2":
        hf = T.Qwen2ForCausalLM(T.Qwen2Config(
            **_LLAMA, num_key_value_heads=2, rope_theta=1e6,
            tie_word_embeddings=False, attn_implementation="eager"))
        kw = dict(_LLAMA, num_key_value_heads=2, rope_theta=1e6,
                  attention_bias=True, rms_norm_eps=hf.config.rms_norm_eps)
        j = (jqwen.Qwen2ForCausalLM(jqwen.Qwen2Config(**kw, **f32)),
             jconv.load_llama_state_dict)
        t = (tqwen.Qwen2ForCausalLM(tqwen.Qwen2Config(**kw, **t32),
                                    device="cpu"),
             tconv.load_llama_state_dict)
        ids = np.random.RandomState(1).randint(0, 96, (1, 10))
    elif name == "mistral":
        hf = T.MistralForCausalLM(T.MistralConfig(
            **_LLAMA, num_key_value_heads=2, sliding_window=None,
            attn_implementation="eager"))
        kw = dict(_LLAMA, num_key_value_heads=2, sliding_window=None,
                  rms_norm_eps=hf.config.rms_norm_eps)
        j = (jmistral.MistralForCausalLM(jmistral.MistralConfig(**kw, **f32)),
             jconv.load_llama_state_dict)
        t = (tmistral.MistralForCausalLM(
            tmistral.MistralConfig(**kw, **t32), device="cpu"),
             tconv.load_llama_state_dict)
        ids = np.random.RandomState(2).randint(0, 96, (1, 14))
    elif name.startswith("bloom"):
        h, nh, vocab = (36, 6, 64) if name == "bloom6" else (32, 4, 96)
        hf = T.BloomForCausalLM(T.BloomConfig(
            vocab_size=vocab, hidden_size=h, n_layer=2, n_head=nh,
            use_cache=False))
        kw = dict(vocab_size=vocab, hidden_size=h, n_layer=2, n_head=nh)
        j = (jbloom.BloomForCausalLM(jbloom.BloomConfig(**kw, **f32)),
             jconv.load_bloom_state_dict)
        t = (tbloom.BloomForCausalLM(tbloom.BloomConfig(**kw, **t32),
                                     device="cpu"),
             tconv.load_bloom_state_dict)
        ids = np.random.RandomState(1).randint(0, vocab, (1, 9))
    elif name.startswith("falcon"):
        extra = _FALCON[name.split("_")[1]]
        base = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4)
        hf = T.FalconForCausalLM(T.FalconConfig(
            **base, **extra, use_cache=False, attn_implementation="eager"))
        j = (jfalcon.FalconForCausalLM(
            jfalcon.FalconConfig(**base, **extra, **f32)),
             jconv.load_falcon_state_dict)
        t = (tfalcon.FalconForCausalLM(
            tfalcon.FalconConfig(**base, **extra, **t32), device="cpu"),
             tconv.load_falcon_state_dict)
        tol = dict(rtol=2e-4, atol=3e-4)
    elif name == "gptj" or name == "codegen":
        hcls, hcfg = ((T.GPTJForCausalLM, T.GPTJConfig) if name == "gptj"
                      else (T.CodeGenForCausalLM, T.CodeGenConfig))
        hf = hcls(hcfg(vocab_size=96, n_embd=32, n_layer=2, n_head=4,
                       rotary_dim=4, n_positions=64, use_cache=False,
                       attn_implementation="eager"))
        kw = dict(vocab_size=96, n_embd=32, n_layer=2, n_head=4,
                  rotary_dim=4)
        if name == "gptj":
            j = (jgptj.GPTJForCausalLM(jgptj.GPTJConfig(**kw, **f32)),
                 jconv.load_gptj_state_dict)
            t = (tgptj.GPTJForCausalLM(tgptj.GPTJConfig(**kw, **t32),
                                       device="cpu"),
                 tconv.load_gptj_state_dict)
        else:
            j = (jgptj.CodeGenForCausalLM(jgptj.CodeGenConfig.tiny(
                vocab_size=96)), jconv.load_codegen_state_dict)
            t = (tgptj.CodeGenForCausalLM(tgptj.CodeGenConfig.tiny(
                vocab_size=96), device="cpu"), tconv.load_codegen_state_dict)
    elif name == "qwen2_moe":
        hf = T.Qwen2MoeForCausalLM(T.Qwen2MoeConfig(
            **_LLAMA, num_key_value_heads=2, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=16,
            shared_expert_intermediate_size=48, norm_topk_prob=False,
            decoder_sparse_step=1, mlp_only_layers=[1], use_cache=False,
            attn_implementation="eager"))
        j = (jqmoe.Qwen2MoeForCausalLM(jqmoe.Qwen2MoeConfig.tiny(
            vocab_size=96, mlp_only_layers=(1,))),
             jconv.load_qwen2_moe_state_dict)
        t = (tqmoe.Qwen2MoeForCausalLM(tqmoe.Qwen2MoeConfig.tiny(
            vocab_size=96, mlp_only_layers=(1,)), device="cpu"),
             tconv.load_qwen2_moe_state_dict)
        tol = dict(rtol=3e-4, atol=3e-4)
    elif name == "gemma":
        hf = T.GemmaForCausalLM(T.GemmaConfig(
            **_LLAMA, num_key_value_heads=2, head_dim=16, use_cache=False,
            attn_implementation="eager"))
        j = (jgemma.GemmaForCausalLM(jgemma.GemmaConfig.tiny(vocab_size=96)),
             jconv.load_gemma_state_dict)
        t = (tgemma.GemmaForCausalLM(tgemma.GemmaConfig.tiny(vocab_size=96),
                                     device="cpu"),
             tconv.load_gemma_state_dict)
        tol = dict(rtol=3e-4, atol=3e-4)
    elif name == "mixtral":
        hf = T.MixtralForCausalLM(T.MixtralConfig(
            **_LLAMA, num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2, use_cache=False,
            attn_implementation="eager"))
        j = (jmixtral.MixtralForCausalLM(jmixtral.MixtralConfig.tiny(
            vocab_size=96)), jconv.load_mixtral_state_dict)
        t = (tmixtral.MixtralForCausalLM(tmixtral.MixtralConfig.tiny(
            vocab_size=96), device="cpu"), tconv.load_mixtral_state_dict)
        tol = dict(rtol=5e-4, atol=5e-4)
    else:
        raise KeyError(name)
    return hf.eval(), j, t, ids, tol


CASES = ["llama_nkv4", "llama_nkv2", "qwen2", "mistral", "bloom4", "bloom6",
         "gptj", "falcon_7b", "falcon_new", "falcon_rw", "qwen2_moe", "gemma",
         "mixtral", "codegen"]


@pytest.mark.parametrize("name", CASES)
def test_loader_fills_the_reference_parameters_and_matches_hf(name):
    """Bit-equal parameters to the reference loader's; logits within
    ``test_convert.py``'s tolerance of HF's (fp32)."""
    torch.manual_seed(0)
    pt.seed(0)
    hf, (jm, jload), (tm, tload), ids, tol = _case(name)
    sd = hf.state_dict()
    jm = jload(jm.eval(), sd)
    assert tload(tm, sd) is tm
    jp = jm.state_dict()
    tp = dict(tm.named_parameters())
    assert set(jp) == set(tp)
    for k, arr in jp.items():
        got = tp[k].detach()
        want = np.asarray(arr)
        assert got.dtype == (torch.float32 if want.dtype == np.float32
                             else got.dtype), k
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
        got = tm(torch.as_tensor(ids)).float().numpy()
    np.testing.assert_allclose(got, ref, **tol)


def test_loader_takes_numpy_keeps_the_router_in_fp32_and_retypes():
    """numpy input loads like tensors; ``dtype=bf16`` turns every weight
    into the fp32 load's bf16 rounding, except the routers' ``gate_w``."""
    torch.manual_seed(0)
    hf, _, (tm, tload), _, _ = _case("mixtral")
    sd = hf.state_dict()
    tload(tm, {k: v.numpy() for k, v in sd.items()})
    _, _, (tb, _), _, _ = _case("mixtral")
    tload(tb, sd, dtype=torch.bfloat16)
    assert tb.cfg.dtype == torch.bfloat16
    for (k, p32), (k2, pb) in zip(tm.named_parameters(),
                                  tb.named_parameters()):
        assert k == k2
        if k.endswith("gate_w"):
            assert pb.dtype == torch.float32
            assert torch.equal(pb, p32), k
        else:
            assert pb.dtype == torch.bfloat16, k
            assert torch.equal(pb, p32.to(torch.bfloat16)), k


def test_loader_refuses_missing_and_misshaped_tensors():
    torch.manual_seed(0)
    hf, _, (tm, tload), _, _ = _case("llama_nkv2")
    sd = dict(hf.state_dict())
    bad = dict(sd)
    bad["model.layers.1.self_attn.k_proj.weight"] = torch.zeros(8, 32)
    with pytest.raises(ValueError, match="qkv_proj"):
        tload(tm, bad)
    gone = {k: v for k, v in sd.items() if "layers.1.mlp.down" not in k}
    with pytest.raises(KeyError):
        tload(tm, gone)


# ------------------------------------------------------------ safetensors
def _block_st_packages(monkeypatch):
    for mod in ("safetensors", "safetensors.numpy", "safetensors.torch",
                "ml_dtypes"):
        monkeypatch.setitem(sys.modules, mod, None)


def test_load_safetensors_reads_the_package_file(tmp_path):
    """A file the ``safetensors`` package wrote (f32, f16, bf16, int, an
    empty and a scalar tensor) reads back bit for bit with the package
    and ``ml_dtypes`` blocked."""
    from safetensors.torch import save_file
    rs = np.random.RandomState(0)
    tensors = {
        "w32": torch.from_numpy(rs.randn(3, 5).astype(np.float32)),
        "w16": torch.from_numpy(rs.randn(7).astype(np.float16)),
        "wbf": torch.from_numpy(rs.randn(4, 3).astype(np.float32)).to(
            torch.bfloat16),
        "i64": torch.arange(5, dtype=torch.int64),
        "i8": torch.tensor([-3, 4, 127], dtype=torch.int8),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }
    path = tmp_path / "m.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    with pytest.MonkeyPatch.context() as mp:
        _block_st_packages(mp)
        out = tconv.load_safetensors(str(path))
    assert set(out) == set(tensors)
    for k, v in tensors.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        assert torch.equal(out[k], v), k


def test_load_safetensors_reads_hand_written_bf16(tmp_path):
    """A hand-written file (header, then raw little-endian buffers, the
    bf16 one at an odd offset) with both packages blocked."""
    rs = np.random.RandomState(1)
    bf = torch.from_numpy(rs.randn(6, 2).astype(np.float32)).to(
        torch.bfloat16)
    f32 = rs.randn(2, 2).astype(np.float32)
    raw_bf = bf.view(torch.int16).numpy().tobytes()
    raw_f32 = f32.tobytes()
    header = {"__metadata__": {"k": "v"},
              "pad": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]},
              "bf": {"dtype": "BF16", "shape": [6, 2],
                     "data_offsets": [1, 1 + len(raw_bf)]},
              "f": {"dtype": "F32", "shape": [2, 2],
                    "data_offsets": [1 + len(raw_bf),
                                     1 + len(raw_bf) + len(raw_f32)]}}
    hb = json.dumps(header).encode()
    path = tmp_path / "h.safetensors"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        f.write(b"\x07" + raw_bf + raw_f32)
    with pytest.MonkeyPatch.context() as mp:
        _block_st_packages(mp)
        out = tconv.load_safetensors(str(path))
        assert sys.modules["ml_dtypes"] is None
    assert out["bf"].dtype == torch.bfloat16
    assert torch.equal(out["bf"], bf)
    np.testing.assert_array_equal(out["f"].numpy(), f32)
    assert int(out["pad"][0]) == 7
    # the reference's parser reads the same file (it needs ml_dtypes for
    # the bf16 tensor)
    ref = jconv.load_safetensors(str(path))
    np.testing.assert_array_equal(
        out["bf"].float().numpy(), np.asarray(ref["bf"], np.float32))
