"""AMP debugging utilities — counterpart of ``paddle_tpu/amp/debugging.py``
(ref ``python/paddle/amp/debugging.py``: check_numerics, operator stats,
accuracy comparison).

The reference counts the ops of the lowered StableHLO program. PyTorch
runs eagerly, so :func:`collect_operator_stats` counts the aten ops a
call dispatches, under a ``TorchDispatchMode``, keyed by (op name, result
dtype). The port's CUDA kernels are ctypes launches inside
``autograd.Function``s: the dispatcher never sees them, so they are
counted only through the aten ops their wrappers run (their plain
versions, on the CPU), or not at all.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["check_numerics", "collect_operator_stats", "compare_accuracy",
           "count_nonfinite"]

_SHORT = {torch.float32: "f32", torch.float16: "f16",
          torch.bfloat16: "bf16", torch.float64: "f64", torch.int32: "i32",
          torch.int8: "i8", torch.int64: "i64", torch.bool: "i1"}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def count_nonfinite(tree):
    """(n_nan, n_inf) across every float tensor of ``tree``, counted on
    each tensor's device in its own dtype; one host read at the end."""
    counts = [torch.stack([torch.isnan(t).sum(), torch.isinf(t).sum()])
              .cpu() for t in _leaves(tree) if t.is_floating_point()]
    if not counts:
        return 0, 0
    n = torch.stack(counts).sum(0)
    return int(n[0]), int(n[1])


def check_numerics(tree, name="tensor", raise_on_error=True):
    """Raise ``FloatingPointError`` (or warn) if any float tensor holds a
    NaN or an inf (ref ``paddle.amp.debugging.check_numerics``)."""
    n_nan, n_inf = count_nonfinite(tree)
    if n_nan or n_inf:
        msg = f"check_numerics({name}): {n_nan} NaN, {n_inf} Inf values"
        if raise_on_error:
            raise FloatingPointError(msg)
        import warnings
        warnings.warn(msg)
        return False
    return True


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.stats: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        dt = (_SHORT.get(first.dtype, str(first.dtype))
              if isinstance(first, torch.Tensor) else "?")
        self.stats[(func.overloadpacket.__name__, dt)] += 1
        return out


def collect_operator_stats(fn, *args, print_fn=print, **kwargs):
    """Count the aten ops ``fn(*args, **kwargs)`` dispatches per (op name,
    result dtype) (ref ``paddle.amp.debugging.collect_operator_stats``):
    which products stayed float32. Kernel launches of ``ops.cuda`` are
    not aten ops (see the module docstring)."""
    with _OpCounter() as mode:
        fn(*args, **kwargs)
    stats = mode.stats
    if print_fn:
        width = max((len(k[0]) for k in stats), default=4)
        for (op, dt), n in sorted(stats.items(), key=lambda kv: -kv[1]):
            print_fn(f"{op:<{width}}  {dt:>5}  x{n}")
    return dict(stats)


def compare_accuracy(run_fp32, run_low, *args, atol=1e-2, rtol=1e-2,
                     print_fn=print):
    """Run the same computation in two precisions and report each output
    leaf's max abs / rel error (ref ``compare_accuracy``)."""
    flat_hi = list(_leaves(run_fp32(*args)))
    flat_lo = list(_leaves(run_low(*args)))
    if len(flat_hi) != len(flat_lo):
        raise ValueError(
            f"fp32/low-precision outputs have different structures "
            f"({len(flat_hi)} vs {len(flat_lo)} leaves); cannot compare")
    report = []
    ok = True
    for i, (a, b) in enumerate(zip(flat_hi, flat_lo)):
        a = a.detach().float().cpu()
        b = b.detach().float().cpu()
        d = (a - b).abs()
        abs_err = float(d.max()) if a.numel() else 0.0
        rel_err = (float((d / (a.abs() + 1e-9)).max()) if a.numel()
                   else 0.0)
        good = abs_err <= atol or rel_err <= rtol
        ok &= good
        report.append({"leaf": i, "abs_err": abs_err, "rel_err": rel_err,
                       "ok": good})
        if print_fn:
            print_fn(f"leaf {i}: abs {abs_err:.3e} rel {rel_err:.3e} "
                     f"{'OK' if good else 'MISMATCH'}")
    return ok, report
