"""Parameter-efficient fine-tuning, the serving half — counterpart of
``paddle_tpu/peft.py`` (ref: ``paddlenlp.peft`` LoRAConfig/LoRAModel).

LoRA lives as a SEPARATE small tree keyed by the dotted parameter name
(the reference's names: the port's ``named_parameters()`` are the JAX
package's paths), ``{name: {"a": [in, r], "b": [r, out]}, "_scale":
alpha / r}``. :func:`lora_merge` builds the model with ``W + scale * A @
B`` on the target weights, sharing every other parameter with the base;
the serving engine instead adds the rank-r correction per row
(``serving/adapters.py``, ``models/paged.py`` ``_lora_delta``).

    lora = lora_init(model, generator(0), target_modules=("qkv_proj",
                                                          "o_proj"))
    merged = lora_merge(model, lora)              # deployment merge

Adapter-only training (the reference's ``make_lora_train_step``) is
ROADMAP.md queue 1 item 6.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

# the reference's default LLaMA target set, extended with this zoo's
# fused projection names
DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj",
                   "out_proj", "query_proj", "key_proj", "value_proj")


def _is_target(pstr: str, leaf, targets) -> bool:
    if not (hasattr(leaf, "ndim") and leaf.ndim == 2):
        return False
    last = pstr.split(".")[-2] if pstr.endswith(".weight") else \
        pstr.split(".")[-1]
    return any(t == last for t in targets)


def lora_targets(model, target_modules=DEFAULT_TARGETS):
    """Dotted names of the 2-D weights LoRA will adapt (a scan_layers=True
    model, whose stacked projections are 3-D, raises by name)."""
    from paddle_tpu_torch.models.llama import refuse_scanned
    refuse_scanned(model, "LoRA (peft)")
    return [name for name, p in model.named_parameters()
            if _is_target(name, p, tuple(target_modules))]


@torch.no_grad()
def lora_init(model, gen, r: int = 8, alpha: int = 16,
              target_modules=DEFAULT_TARGETS, dtype=torch.float32):
    """Build the adapter tree ``{name: {"a": [in, r], "b": [r, out]}}`` on
    each weight's device, ``a`` ~ N(0, 1/in) drawn from the
    ``torch.Generator`` ``gen`` (on that device), ``b`` zero (the
    reference convention), so the adapted model initially computes
    EXACTLY the base model."""
    from paddle_tpu_torch.models.llama import refuse_scanned
    refuse_scanned(model, "LoRA (peft)")
    lora = {}
    for name, w in model.named_parameters():
        if not _is_target(name, w, tuple(target_modules)):
            continue
        fan_in = w.shape[0]
        a = torch.empty((fan_in, r), dtype=dtype, device=w.device)
        a.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
        lora[name] = {"a": a, "b": torch.zeros((r, w.shape[1]), dtype=dtype,
                                               device=w.device)}
    if not lora:
        raise ValueError(f"no 2-D weights matched {target_modules!r}")
    lora["_scale"] = torch.tensor(alpha / r, dtype=torch.float32)
    return lora


@torch.no_grad()
def lora_merge(model, lora):
    """A copy of ``model`` with ``W + scale * A @ B`` (in float32, cast to
    W's type) on every adapted weight; every other parameter and buffer
    is the base's own tensor, shared, as the reference's functional
    rebuild passes untouched leaves through."""
    scale = float(lora["_scale"])
    params = dict(model.named_parameters())
    memo = {id(p): p for name, p in params.items() if name not in lora}
    memo.update({id(b): b for b in model.buffers()})
    merged = copy.deepcopy(model, memo)
    mp = dict(merged.named_parameters())
    for name, ab in lora.items():
        if name == "_scale":
            continue
        w = mp[name]
        delta = (ab["a"].float() @ ab["b"].float()).to(w.device) * scale
        w.copy_((params[name].float() + delta).to(w.dtype))
    return merged


def lora_num_parameters(lora) -> int:
    return sum(int(v.numel()) for k, ab in lora.items()
               for v in ((ab,) if k == "_scale" else ab.values()))


def _np(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def lora_state_dict(lora) -> dict:
    """Flat numpy state for checkpointing the adapters alone (the
    reference's ``lora_model.save_pretrained`` payload), under the
    reference's keys: ``<name>.lora_A``, ``<name>.lora_B``, ``_scale``."""
    out = {}
    for path, ab in lora.items():
        if path == "_scale":
            out["_scale"] = _np(ab)
        else:
            out[path + ".lora_A"] = _np(ab["a"])
            out[path + ".lora_B"] = _np(ab["b"])
    return out


def lora_load_state_dict(lora, state: dict):
    """Inverse of :func:`lora_state_dict` onto an existing adapter tree
    (each entry takes the template's dtype and device; numpy arrays or
    tensors).

    Strict: the state's key set must match the adapter tree exactly. A
    tenant upload with a typo'd path, a stale target set, or extra
    tensors is rejected with a ``ValueError`` naming the offending keys
    (``AdapterStore`` relies on this to bounce malformed uploads)."""
    expected = {"_scale"} | {p + sfx for p in lora if p != "_scale"
                             for sfx in (".lora_A", ".lora_B")}
    missing = sorted(expected - set(state))
    unexpected = sorted(set(state) - expected)
    if missing or unexpected:
        parts = []
        if missing:
            parts.append("missing keys: " + ", ".join(missing))
        if unexpected:
            parts.append("unexpected keys: " + ", ".join(unexpected))
        raise ValueError("lora_load_state_dict: state does not match the "
                         "adapter tree — " + "; ".join(parts))

    def like(x, ref):
        return torch.as_tensor(_np(x)).to(dtype=ref.dtype, device=ref.device)

    new = {}
    for path, ab in lora.items():
        if path == "_scale":
            new["_scale"] = torch.as_tensor(_np(state["_scale"]),
                                            dtype=torch.float32)
        else:
            new[path] = {"a": like(state[path + ".lora_A"], ab["a"]),
                         "b": like(state[path + ".lora_B"], ab["b"])}
    return new
