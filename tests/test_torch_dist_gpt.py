"""The port's GPT under tensor parallelism, 4 gloo ranks, against the JAX
package's single-device run: the reference's ``bench.py``
``bench_gpt3_tp`` path (``make_train_step`` with AdamW(2e-4,
weight_decay=0.1) over ``HybridMesh(tp=n)``) on ``GPTConfig.tiny`` with 4
heads.

Meshes: tp=2 (ranks 0-1) and dp2 x tp2 (all four). ``shard_module``
applies the reference's specs: ``qkv`` / ``qkv_bias`` / ``fc1`` /
``fc1_bias`` column-sharded (the fused [q|k|v] interleaved so a rank
holds whole heads), ``proj`` / ``fc2`` row-sharded, ``wte`` sharded over
the vocabulary; the embedding lookup is the vocab-parallel lookup and the
tied head gives vocab-sharded logits, so the loss is the vocab-parallel
cross entropy, and the lookup's and the head's gradients sum in the
rank's ``wte`` shard. Each data rank takes its rows of the 8 x 16 global
batch.

Tolerances as ``test_torch_dist_llama.py`` (fp32 both sides, a tp split
reorders the sums): loss rtol 2e-4, logits and every gradient within 1e-4
of their RMS, three AdamW steps' losses rtol 3e-4, the global
``state_dict()`` bit for bit under the reference's names.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.optimizer as jopt
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from tests import _torch_dist_child as child
from tests._torch_dist_ref import numpy_module, rel

MESHES = sorted(child.GPT_MESHES)


def _batch():
    ids = np.random.RandomState(1).randint(0, 128, (8, 16))
    return ids, np.concatenate([ids[:, 1:], np.full((8, 1), -100)], axis=1)


def _model():
    return numpy_module(lambda: JGPT(JGPTConfig.tiny(**child.GPT_TINY)), 0)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    ids, labels = _batch()
    inputs = {"ids": ids, "labels": labels,
              **{f"w:{k}": np.asarray(v, np.float32)
                 for k, v in _model().state_dict().items()}}
    return child.World("gpt", inputs, 4, tmp_path_factory.mktemp("dist_gpt"))


@pytest.fixture(scope="module")
def ref(started):
    """The JAX package's single-device run, computed while the world
    runs."""
    jm = _model()
    ids, labels = (jnp.asarray(a) for a in _batch())

    @jax.jit
    def single(m, i, lab):
        loss, grads = jax.value_and_grad(lambda mm: mm.loss(i, lab))(m)
        return loss, grads, m(i)

    loss, grads, logits = single(jm, ids, labels)
    opt = jopt.AdamW(learning_rate=2e-4, weight_decay=0.1)
    step = j_make_train_step(lambda m, i, lab: m.loss(i, lab), opt,
                             donate=False)
    state, losses = j_init_state(jm, opt), []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    return {"loss": float(loss), "logits": np.asarray(logits, np.float32),
            "grads": {k: np.asarray(v, np.float32)
                      for k, v in grads.state_dict().items()},
            "train": losses,
            "weights": {k: np.asarray(v, np.float32)
                        for k, v in jm.state_dict().items()}}


@pytest.fixture(scope="module")
def world(started, ref):
    return started.result()[0]


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_matches_single_device(world, ref, mesh):
    np.testing.assert_allclose(float(world[f"{mesh}:loss"]), ref["loss"],
                               rtol=2e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_logits_match_single_device(world, ref, mesh):
    """The vocab-sharded tied head's logits gathered over tp (and the
    rows over dp) equal the single-device logits."""
    got = world[f"{mesh}:logits"]
    assert got.shape == ref["logits"].shape
    assert rel(got, ref["logits"]) <= 1e-4


@pytest.mark.parametrize("mesh", MESHES)
def test_every_grad_matches_single_device(world, ref, mesh):
    """Every global gradient, ``wte``'s among them (the lookup's rows and
    the tied head's columns summed in each rank's vocab shard)."""
    want = ref["grads"]
    got = {k[len(f"{mesh}:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{mesh}:grad:")}
    assert set(got) == set(want)
    for name, g in got.items():
        assert rel(g, want[name]) <= 1e-4, name


@pytest.mark.parametrize("mesh", MESHES)
def test_state_dict_is_global(world, ref, mesh):
    """A sharded GPT's state_dict() gives the reference's names and global
    [in, out] arrays (the qkv interleave undone), while a rank holds half
    of ``wte``'s rows."""
    want = ref["weights"]
    got = {k[len(f"{mesh}:sd:"):]: v for k, v in world.items()
           if k.startswith(f"{mesh}:sd:")}
    assert set(got) == set(want)
    for name, v in got.items():
        np.testing.assert_array_equal(v, want[name], err_msg=name)
    assert world[f"{mesh}:local_wte"].tolist() == [64, 32]


@pytest.mark.parametrize("mesh", MESHES)
def test_bench_gpt3_tp_training_matches_single_device(world, ref, mesh):
    """Three steps of make_train_step(AdamW(2e-4, weight_decay=0.1),
    mesh=) against the reference's single-device trajectory."""
    np.testing.assert_allclose(world[f"{mesh}:train_losses"],
                               ref["train"], rtol=3e-4)


def test_tp_refuses_a_degree_that_does_not_divide_the_heads(world):
    assert "tp=4 must divide num_attention_heads=2" in str(
        world["tp4_refusal"])
