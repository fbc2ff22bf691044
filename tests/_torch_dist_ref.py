"""The JAX side of the port's multi-process tests (``test_torch_dist_*``):
reference modules with numpy-drawn weights and the tolerance measure.

``numpy_module`` builds a JAX package module from its shapes alone
(``jax.eval_shape`` of its constructor, so none of the per-shape XLA
compiles of its initializers) and draws every parameter with numpy from a
seed: normal(0, 0.02), norm weights 1 + normal(0, 0.1). The tests hand the
same arrays to the port, so the weights' law does not matter, only that
both sides hold the same ones.
"""
import jax
import jax.numpy as jnp
import numpy as np

from paddle_tpu.core import random as jrandom
from paddle_tpu.core.module import _path_to_str


def numpy_module(make, seed):
    saved = jrandom._global
    try:
        skeleton = jax.eval_shape(make)
    finally:
        jrandom._global = saved      # eval_shape traced the global key
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        x = rs.randn(*leaf.shape)
        x = 1 + 0.1 * x if "norm" in _path_to_str(path) else 0.02 * x
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, skeleton)


def rel(got, want):
    """Max abs error over the reference's RMS."""
    want = np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / rms)
