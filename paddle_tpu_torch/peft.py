"""Parameter-efficient fine-tuning — counterpart of ``paddle_tpu/peft.py``
(ref: ``paddlenlp.peft`` LoRAConfig/LoRAModel).

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

Adapter-only training, :func:`make_lora_train_step`: the merged
forward is the reference's — each target weight is ``W + scale * A @ B``
inside the autograd graph — so it runs the same K1/K2/K5/K7 kernels as the
full train step; only A and B receive gradients and enter the optimizer.
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def _parameters_as(model, values: dict):
    """``model`` with each named parameter replaced by ``values[name]``
    (a plain tensor) for the block, in the module's own parameter slots
    (so the order of ``named_parameters()`` is kept); restored on exit."""
    saved = []
    try:
        for name, val in values.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = val
        yield model
    finally:
        for owner, leaf, orig in reversed(saved):
            owner._parameters[leaf] = orig


def make_lora_train_step(base_model, lora, optimizer, loss_fn, device=None):
    """Adapter-only training (the reference's LoRAModel + Trainer
    pairing). ``loss_fn(merged_model, *batch) -> scalar``. Returns
    ``(step, lora, opt_state)`` with ``step(lora, opt_state, *batch) ->
    (lora, opt_state, loss)``.

    The returned ``lora`` is a COPY of the caller's adapters on
    ``device`` (the card when None; the base model must live there), its
    A/B leaves tensors that require grad; the step updates them in place
    and returns the full tree, ``_scale`` included, so ``lora_merge`` and
    ``lora_state_dict`` work on it. Only the A/B leaves (named ``<weight
    name>.a`` / ``.b``) enter the optimizer: ``_scale`` never sees weight
    decay. The step runs the base model with every target weight replaced
    by ``W + scale * A @ B`` (float32, cast to W's type) and every other
    parameter by its detached self, so the base's parameters keep their
    bits, get no ``.grad`` and cost no weight gradient; the loss and the
    backward (``torch.autograd.grad``, which a remat recompute joins)
    both run with the weights replaced."""
    from paddle_tpu_torch.core.device import resolve_device
    dev = resolve_device(device)
    base_dev = next(base_model.parameters()).device
    if base_dev.type != dev.type or dev.index not in (None, base_dev.index):
        raise ValueError(f"make_lora_train_step: the base model lives on "
                         f"{base_dev}, the step runs on {dev}")
    scale = float(lora["_scale"])
    lora = {k: (torch.tensor(scale, dtype=torch.float32) if k == "_scale"
                else {r: v.detach().to(dev).clone().requires_grad_(True)
                      for r, v in ab.items()})
            for k, ab in lora.items()}

    def adapters_of(tree):
        return {f"{k}.{r}": v for k, ab in tree.items() if k != "_scale"
                for r, v in ab.items()}

    opt_state = optimizer.init(adapters_of(lora))

    def step(lora_tree, opt_state, *batch):
        adapters = adapters_of(lora_tree)
        for v in adapters.values():
            v.requires_grad_(True)
        params = dict(base_model.named_parameters())
        values = {n: p.detach() for n, p in params.items()}
        for name, ab in lora_tree.items():
            if name == "_scale":
                continue
            w = params[name].detach()
            delta = (ab["a"] @ ab["b"]).float() * scale
            values[name] = (w.float() + delta).to(w.dtype)
        with _parameters_as(base_model, values):
            loss = loss_fn(base_model, *batch)
            grads = torch.autograd.grad(loss, list(adapters.values()))
        _, opt_state = optimizer.step(adapters, dict(zip(adapters, grads)),
                                      opt_state)
        return lora_tree, opt_state, loss.detach()

    return step, lora, opt_state
