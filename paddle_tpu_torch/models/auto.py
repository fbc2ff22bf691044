"""Auto registry — counterpart of ``paddle_tpu/models/auto.py``: one entry
point that maps an HF config's ``model_type`` onto the port's (config,
model, loader) triple.

With a LOCAL checkpoint directory (no hub downloads)::

    model = auto_from_pretrained("/path/to/ckpt", dtype=torch.bfloat16)
    # reads config.json and every *.safetensors shard through
    # models.convert.load_safetensors, builds the model on the card
    # (device="cpu" for the CPU) and fills it in place

or from in-memory pieces::

    model = auto_from_config(cfg_dict, device="cpu")    # random init
    model = AUTO_REGISTRY["llama"].load(model, state_dict)

The registry holds the fifteen decoder types the port has (every decoder
of the reference's registry) and eight encoders (BERT, RoBERTa, ERNIE,
ELECTRA, LayoutLM, DistilBERT, ALBERT, ERNIE-M), each with the model
class the reference's registry names. A type that the reference's
registry holds but the port does not yet (its other encoders and the
encoder-decoders) raises ``NotImplementedError`` naming its ROADMAP.md
item; a type in neither raises ``ValueError``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields

import torch

from paddle_tpu_torch.models import albert, bert, bloom, convert as C
from paddle_tpu_torch.models import distilbert, electra, ernie, ernie_m
from paddle_tpu_torch.models import falcon, gemma, glm, gpt, gpt_neox, gptj
from paddle_tpu_torch.models import layoutlm, llama, mixtral, opt, phi, qwen
from paddle_tpu_torch.models import qwen2_moe, roberta


@dataclass(frozen=True)
class _Entry:
    config_cls: object
    model_cls: object
    load: object                        # load_*_state_dict(model, sd, dtype)
    # config fields an HF config of this type implies without a key
    implied: tuple = ()
    # HF config key -> the port's config field (identity where omitted)
    remap: tuple = ()


AUTO_REGISTRY = {
    "llama": _Entry(llama.LlamaConfig, llama.LlamaForCausalLM,
                    C.load_llama_state_dict),
    "mistral": _Entry(llama.LlamaConfig, llama.LlamaForCausalLM,
                      C.load_llama_state_dict),
    "qwen2": _Entry(qwen.Qwen2Config, qwen.Qwen2ForCausalLM,
                    C.load_llama_state_dict),
    # HF's Qwen2-MoE always biases q/k/v (its config has no key for it)
    "qwen2_moe": _Entry(qwen2_moe.Qwen2MoeConfig,
                        qwen2_moe.Qwen2MoeForCausalLM,
                        C.load_qwen2_moe_state_dict,
                        implied=(("attention_bias", True),)),
    "mixtral": _Entry(mixtral.MixtralConfig, mixtral.MixtralForCausalLM,
                      C.load_mixtral_state_dict),
    "gemma": _Entry(gemma.GemmaConfig, gemma.GemmaForCausalLM,
                    C.load_gemma_state_dict),
    "bloom": _Entry(bloom.BloomConfig, bloom.BloomForCausalLM,
                    C.load_bloom_state_dict),
    "falcon": _Entry(falcon.FalconConfig, falcon.FalconForCausalLM,
                     C.load_falcon_state_dict),
    "gptj": _Entry(gptj.GPTJConfig, gptj.GPTJForCausalLM,
                   C.load_gptj_state_dict),
    "codegen": _Entry(gptj.CodeGenConfig, gptj.CodeGenForCausalLM,
                      C.load_codegen_state_dict),
    "gpt2": _Entry(gpt.GPTConfig, gpt.GPTForCausalLM, C.load_gpt2_state_dict,
                   remap=(("n_embd", "hidden_size"),
                          ("n_layer", "num_hidden_layers"),
                          ("n_head", "num_attention_heads"),
                          ("n_inner", "intermediate_size"),
                          ("n_positions", "max_position_embeddings"))),
    "gpt_neox": _Entry(gpt_neox.GPTNeoXConfig, gpt_neox.GPTNeoXForCausalLM,
                       C.load_gpt_neox_state_dict),
    "opt": _Entry(opt.OPTConfig, opt.OPTForCausalLM, C.load_opt_state_dict),
    "phi": _Entry(phi.PhiConfig, phi.PhiForCausalLM, C.load_phi_state_dict),
    "glm": _Entry(glm.GlmConfig, glm.GlmForCausalLM, C.load_glm_state_dict),
    "bert": _Entry(bert.BertConfig, bert.BertForPretraining,
                   C.load_bert_state_dict),
    "roberta": _Entry(roberta.RobertaConfig, roberta.RobertaForMaskedLM,
                      C.load_roberta_state_dict),
    "ernie": _Entry(ernie.ErnieConfig, ernie.ErnieForMaskedLM,
                    C.load_ernie_state_dict),
    "electra": _Entry(electra.ElectraConfig, electra.ElectraForPreTraining,
                      C.load_electra_state_dict),
    "layoutlm": _Entry(layoutlm.LayoutLMConfig, layoutlm.LayoutLMForMaskedLM,
                       C.load_layoutlm_state_dict),
    "distilbert": _Entry(distilbert.DistilBertConfig,
                         distilbert.DistilBertForMaskedLM,
                         C.load_distilbert_state_dict),
    "albert": _Entry(albert.AlbertConfig, albert.AlbertForMaskedLM,
                     C.load_albert_state_dict),
    "ernie_m": _Entry(ernie_m.ErnieMConfig, ernie_m.ErnieMModel,
                      C.load_ernie_m_state_dict),
}

# the reference registry's other types: its other encoders and the
# encoder-decoders
NOT_PORTED = (
    "bart", "big_bird", "blenderbot", "blenderbot-small", "deberta-v2",
    "fnet", "mbart", "megatron-bert", "mpnet", "nezha", "pegasus",
    "roformer", "t5", "xlnet")


def _entry(model_type: str) -> _Entry:
    if model_type in AUTO_REGISTRY:
        return AUTO_REGISTRY[model_type]
    if model_type in NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP.md queue "
            f"1, item 8(d): the encoders and encoder-decoders); the port's "
            f"auto registry has "
            f"{sorted(AUTO_REGISTRY)}")
    raise ValueError(
        f"model_type {model_type!r} is not in the auto registry; supported: "
        f"{sorted(AUTO_REGISTRY)}")


def _torch_dtype(value):
    """An HF config's dtype ("bfloat16", "float32", ...) or a torch dtype."""
    if isinstance(value, torch.dtype):
        return value
    dt = getattr(torch, str(value).removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {value!r} in the config")
    return dt


def auto_config(model_type: str, hf_cfg: dict, dtype=None):
    """The port's config dataclass from an HF config dict: shared field
    names copy over, HF keys the config lacks are ignored, ``None`` means
    the field's default, a field that the HF type implies without a key
    (Qwen2-MoE's q/k/v biases) is set, the keys ``remap`` names land in
    the port's field of another name (GPT-2's ``n_embd`` -> ``hidden_size``
    ...), and a ``sliding_window`` that the
    config switches off (``use_sliding_window: false``, as Qwen2's configs
    do) is dropped.
    ``dtype`` (default: the dict's ``dtype``, else the config's default)
    is the parameters' type."""
    entry = _entry(model_type)
    names = {f.name for f in fields(entry.config_cls)}
    kw = {**dict(entry.implied),
          **{k: v for k, v in hf_cfg.items()
             if k in names and v is not None}}
    for theirs, ours in entry.remap:
        if hf_cfg.get(theirs) is not None:
            kw[ours] = hf_cfg[theirs]
    if hf_cfg.get("use_sliding_window") is False:
        # Qwen2's configs carry a window size that they switch off
        kw.pop("sliding_window", None)
    if isinstance(kw.get("mlp_only_layers"), list):
        kw["mlp_only_layers"] = tuple(kw["mlp_only_layers"])
    if dtype is not None:
        kw["dtype"] = dtype
    if "dtype" in kw:
        kw["dtype"] = _torch_dtype(kw["dtype"])
    return entry.config_cls(**kw)


def auto_from_config(hf_cfg: dict, dtype=None, device=None, seed: int = 0):
    """A random-init model from an HF config dict (``model_type`` key) on
    ``device`` (None: the card)."""
    mt = hf_cfg["model_type"]
    return _entry(mt).model_cls(auto_config(mt, hf_cfg, dtype),
                                device=device, seed=seed)


def auto_from_pretrained(path: str, dtype=None, device=None):
    """Load a LOCAL HF checkpoint directory — ``config.json`` and every
    ``*.safetensors`` shard — into the port's model on ``device`` (None:
    the card), in ``dtype`` (default: the config's). The shards are
    memory-mapped; each tensor is moved to the device and written into
    its parameter there, so the host never holds a second copy."""
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    entry = _entry(hf_cfg["model_type"])
    shards = [fn for fn in sorted(os.listdir(path))
              if fn.endswith(".safetensors")]
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    model = auto_from_config(hf_cfg, dtype=dtype, device=device)
    sd = {}
    for fn in shards:
        sd.update(C.load_safetensors(os.path.join(path, fn)))
    return entry.load(model, sd)
