"""The port's auto registry (``models/auto.py``) against the reference's
(``paddle_tpu/models/auto.py``, spec ``tests/test_auto.py``): a two-shard
local Llama directory loads and matches HF and the reference loader, each
of the twenty-three ported types (fifteen decoders, eight encoders)
builds from an HF-style config dict and runs a forward, each encoder
loads from a local HF directory and matches HF, an unported reference
type raises by its ROADMAP item, an unknown type and a directory without
shards raise as the reference does."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import auto as jauto
from paddle_tpu_torch.models import auto as tauto
from paddle_tpu_torch.models import convert as tconv

transformers = pytest.importorskip("transformers")


def test_two_shard_llama_directory_loads(tmp_path):
    """``save_pretrained`` into two safetensors shards; the port's model
    equals the reference's load of the same directory parameter for
    parameter (fp32, bit for bit) and HF's logits within
    ``test_auto.py``'s tolerance (2e-4)."""
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM as HFModel
    torch.manual_seed(0)
    hf = HFModel(HFConfig(vocab_size=96, hidden_size=32,
                          intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=64,
                          attn_implementation="eager")).eval()
    hf.save_pretrained(tmp_path, safe_serialization=True,
                       max_shard_size="60KB")
    shards = sorted(p.name for p in tmp_path.glob("*.safetensors"))
    assert len(shards) == 2, shards
    ours = tauto.auto_from_pretrained(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    assert isinstance(ours, tauto.AUTO_REGISTRY["llama"].model_cls)
    assert ours.device.type == "cpu" and ours.cfg.dtype == torch.float32
    pt.seed(0)
    ref = jauto.auto_from_pretrained(str(tmp_path), dtype=jnp.float32)
    jp = ref.state_dict()
    tp = dict(ours.named_parameters())
    assert set(jp) == set(tp)
    for k, arr in jp.items():
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(arr), err_msg=k)
    ids = np.random.RandomState(0).randint(0, 96, (2, 10))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
        got = ours(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # bf16: every weight the fp32 load's bf16 rounding
    bf = tauto.auto_from_pretrained(str(tmp_path), dtype=torch.bfloat16,
                                    device="cpu")
    for k, p in bf.named_parameters():
        assert p.dtype == torch.bfloat16, k
        assert torch.equal(p, tp[k].to(torch.bfloat16)), k


_BASE = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=4, max_position_embeddings=32)
_TYPES = {
    "llama": dict(intermediate_size=64, num_key_value_heads=2),
    "mistral": dict(intermediate_size=64, num_key_value_heads=2,
                    sliding_window=8),
    "qwen2": dict(intermediate_size=64, num_key_value_heads=2),
    "qwen2_moe": dict(intermediate_size=64, num_key_value_heads=2,
                      num_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=16,
                      shared_expert_intermediate_size=32,
                      mlp_only_layers=[]),
    "mixtral": dict(intermediate_size=64, num_key_value_heads=2,
                    num_local_experts=4, num_experts_per_tok=2),
    "gemma": dict(intermediate_size=64, num_key_value_heads=2, head_dim=16),
    "bloom": dict(n_layer=1, n_head=4),
    "falcon": dict(multi_query=True),
    "gptj": dict(n_embd=32, n_layer=1, n_head=4, rotary_dim=4, n_inner=None),
    "codegen": dict(n_embd=32, n_layer=1, n_head=4, rotary_dim=4,
                    n_inner=None),
    # HF GPT-2's names, remapped onto the GPT config's fields
    "gpt2": dict(n_embd=32, n_layer=1, n_head=4, n_inner=64, n_positions=32),
    "gpt_neox": dict(intermediate_size=64, rotary_pct=0.25,
                     use_parallel_residual=False),
    "opt": dict(ffn_dim=64, word_embed_proj_dim=16,
                do_layer_norm_before=False),
    "phi": dict(intermediate_size=64, num_key_value_heads=2,
                partial_rotary_factor=0.5),
    "glm": dict(intermediate_size=64, num_key_value_heads=2,
                partial_rotary_factor=0.5, attention_bias=False),
    "bert": dict(intermediate_size=64),
    "roberta": dict(intermediate_size=64),
    "ernie": dict(intermediate_size=64),
    "electra": dict(intermediate_size=64, embedding_size=16),
    "layoutlm": dict(intermediate_size=64),
    "distilbert": dict(dim=32, n_layers=1, n_heads=4, hidden_dim=64),
    "albert": dict(intermediate_size=64, embedding_size=16),
    "ernie_m": dict(intermediate_size=64),
}
ENCODERS = ("bert", "roberta", "ernie", "electra", "layoutlm", "distilbert",
            "albert", "ernie_m")


def _first_output(m, mt, ids):
    """The model's first output tensor (LayoutLM's boxes all zero)."""
    with torch.no_grad():
        out = (m(ids, torch.zeros(*ids.shape, 4, dtype=torch.int64))
               if mt == "layoutlm" else m(ids))
    return out[0] if isinstance(out, tuple) else out


def test_the_registry_splits_the_references():
    assert len(tauto.AUTO_REGISTRY) == 23
    assert len(tauto.NOT_PORTED) == 14
    assert set(tauto.AUTO_REGISTRY) | set(tauto.NOT_PORTED) == \
        set(jauto._registry())
    assert not set(tauto.AUTO_REGISTRY) & set(tauto.NOT_PORTED)


@pytest.mark.parametrize("mt", sorted(_TYPES))
def test_auto_from_config_builds_each_ported_type(mt):
    """The HF dict's fields land in the port's config (the dtype string
    included), the model builds on the CPU and its forward is finite."""
    cfgd = {**_BASE, **_TYPES[mt], "model_type": mt, "dtype": "float32",
            "remat": False}
    if mt in ("bloom", "gptj", "codegen", "gpt2"):
        for k in ("num_hidden_layers", "num_attention_heads"):
            cfgd.pop(k)
    if mt == "gpt2":
        cfgd.pop("hidden_size")
        cfgd.pop("max_position_embeddings")
    if mt == "distilbert":
        for k in ("hidden_size", "num_hidden_layers", "num_attention_heads"):
            cfgd.pop(k)
    m = tauto.auto_from_config(cfgd, device="cpu")
    assert isinstance(m, tauto.AUTO_REGISTRY[mt].model_cls)
    assert m.cfg.dtype == torch.float32
    # the same fields as the reference's auto_config, except the ones the
    # port's registry sets for an HF type without a key (Qwen2-MoE's q/k/v
    # biases, which the reference leaves at LlamaConfig's False)
    implied = dict(tauto.AUTO_REGISTRY[mt].implied)
    jm_cfg = jauto.auto_config(mt, {**cfgd, "dtype": jnp.float32, **implied})
    for k, v in vars(m.cfg).items():
        if k != "dtype" and hasattr(jm_cfg, k):
            assert getattr(jm_cfg, k) == v, (mt, k)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 64, (1, 8)))
    out = _first_output(m, mt, ids)
    want = {"electra": (1, 8), "ernie_m": (1, 8, 32)}.get(mt, (1, 8, 64))
    assert out.shape == want
    assert torch.isfinite(out.float()).all(), mt


_HF_ENCODERS = {  # model_type -> (HF model class, config class, config kw)
    "bert": ("BertForPreTraining", "BertConfig", {}),
    "roberta": ("RobertaForMaskedLM", "RobertaConfig",
                dict(type_vocab_size=1, pad_token_id=1)),
    "ernie": ("ErnieForMaskedLM", "ErnieConfig",
              dict(use_task_id=True, task_type_vocab_size=3)),
    "electra": ("ElectraForPreTraining", "ElectraConfig",
                dict(embedding_size=16)),
    "layoutlm": ("LayoutLMForMaskedLM", "LayoutLMConfig",
                 dict(max_2d_position_embeddings=64)),
    "distilbert": ("DistilBertForMaskedLM", "DistilBertConfig",
                   dict(dim=32, n_layers=2, n_heads=4, hidden_dim=64)),
    "albert": ("AlbertForMaskedLM", "AlbertConfig", dict(embedding_size=16)),
    "ernie_m": ("ErnieMModel", "ErnieMConfig", {}),
}


@pytest.mark.parametrize("mt", ENCODERS)
def test_auto_from_pretrained_loads_each_encoder(mt, tmp_path):
    """A local HF directory of each encoder (``save_pretrained``) loads
    into the class the reference's registry names, every parameter
    written from the checkpoint, and its first output matches HF's
    (fp32, within ``test_convert.py``'s 2e-4)."""
    cls, cfg_cls, kw = _HF_ENCODERS[mt]
    base = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=40, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    if mt == "distilbert":
        base = dict(vocab_size=64, max_position_embeddings=40, dropout=0.0,
                    attention_dropout=0.0)
    torch.manual_seed(0)
    hf = getattr(transformers, cls)(getattr(transformers, cfg_cls)(
        **base, **kw)).eval()
    hf.save_pretrained(tmp_path, safe_serialization=True)
    ours = tauto.auto_from_pretrained(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    assert type(ours) is tauto.AUTO_REGISTRY[mt].model_cls
    ids = np.random.RandomState(1).randint(2, 64, (2, 9))
    hf_kw = ({"bbox": torch.zeros(2, 9, 4, dtype=torch.int64)}
             if mt == "layoutlm" else {})
    with torch.no_grad():
        ref = hf(torch.tensor(ids), **hf_kw)
    ref = (ref.last_hidden_state if mt == "ernie_m" else
           ref.prediction_logits if mt == "bert" else ref.logits)
    got = _first_output(ours, mt, torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("mt", ["nezha", "t5", "bart", "mpnet"])
def test_unported_reference_type_names_its_item(mt, tmp_path):
    with pytest.raises(NotImplementedError, match=r"item 8\(d\)"):
        tauto.auto_from_config({"model_type": mt})
    (tmp_path / "config.json").write_text(json.dumps({"model_type": mt}))
    with pytest.raises(NotImplementedError, match=r"item 8\(d\)"):
        tauto.auto_from_pretrained(str(tmp_path), device="cpu")


def test_unknown_type_and_missing_shards_raise(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "made_up_arch"}))
    with pytest.raises(ValueError, match="auto registry"):
        tauto.auto_from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="auto registry"):
        jauto.auto_from_pretrained(str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps(
        {**_BASE, **_TYPES["llama"], "model_type": "llama"}))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        tauto.auto_from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tauto.auto_config("llama", {"dtype": "float99"})


def test_qwen2_moe_implies_qkv_biases_and_the_loader_refuses_to_drop_them():
    cfgd = {**_BASE, **_TYPES["qwen2_moe"], "model_type": "qwen2_moe"}
    assert tauto.auto_config("qwen2_moe", cfgd).attention_bias is True
    assert tauto.auto_config(
        "qwen2_moe", {**cfgd, "attention_bias": False}).attention_bias is False
    from transformers import Qwen2Config as HFConfig
    from transformers import Qwen2ForCausalLM as HFModel
    torch.manual_seed(0)
    hf = HFModel(HFConfig(**_BASE, **_TYPES["qwen2"]))
    plain = tauto.auto_from_config(
        {**_BASE, **_TYPES["llama"], "model_type": "llama"}, device="cpu")
    with pytest.raises(ValueError, match="attention_bias=False"):
        tconv.load_llama_state_dict(plain, hf.state_dict())


def test_a_switched_off_window_is_dropped():
    """Qwen2's configs publish ``sliding_window`` with
    ``use_sliding_window: false``; Mistral's window stays."""
    qwen = {**_BASE, **_TYPES["qwen2"], "sliding_window": 32768,
            "use_sliding_window": False}
    assert tauto.auto_config("qwen2", qwen).sliding_window is None
    mistral = {**_BASE, **_TYPES["mistral"]}
    assert tauto.auto_config("mistral", mistral).sliding_window == 8


def test_safetensors_tensors_load_through_the_loader(tmp_path):
    """The memory-mapped tensors of ``load_safetensors`` are valid loader
    input (the path ``auto_from_pretrained`` takes)."""
    from safetensors.torch import save_file
    from transformers import GemmaConfig as HFConfig
    from transformers import GemmaForCausalLM as HFModel
    torch.manual_seed(0)
    hf = HFModel(HFConfig(**_BASE, **_TYPES["gemma"])).eval()
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()
          if k != "lm_head.weight"}
    save_file(sd, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(
        {**hf.config.to_dict(), "dtype": "float32"}))
    m = tauto.auto_from_pretrained(str(tmp_path), device="cpu")
    ref = tconv.load_gemma_state_dict(
        tauto.auto_from_config({**_BASE, **_TYPES["gemma"],
                                "model_type": "gemma", "dtype": "float32"},
                               device="cpu", seed=3), hf.state_dict())
    for (k, p), (_, q) in zip(m.named_parameters(), ref.named_parameters()):
        assert torch.equal(p, q), k
