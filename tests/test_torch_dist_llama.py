"""The port's hybrid mesh on the tiny Llama, 4 gloo ranks, against the JAX
package's single-device run.

Counterpart of ``tests/test_parallel.py`` (tp / fsdp loss, logits and
grads, ``test_hybrid_training_matches_single_device``, the partition
rule). The reference's sharded runs fail on this tree under jax 0.9.0
(ROADMAP.md queue 3), so the port is held to what they are held to: the
single-device model. Meshes: tp=2, fsdp=2, dp=2 (on ranks 0-1), dp×tp and
fsdp×tp = 2×2 (all four); the reference's hybrid case, dp2×fsdp2×tp2,
needs 8 ranks: ``test_torch_dist_hybrid.py``. Each rank takes its rows of
the global batch (8 x 16) over the data axes. On every mesh with a data
axis the same checks run once more on a prompt-masked batch whose rows
keep different numbers of labels on each data rank (``_sft_labels``):
the loss is the masked mean over the whole global batch, as the
reference's one program computes it, and Trainer.fit accumulating two
microbatches a step follows the reference Trainer's trajectory.

Tolerances (fp32 on both sides, only the summation order differs, and a
tp or fsdp split reorders the sums further): loss rtol 2e-4, as
``test_parallel.py:43``; logits and every gradient within 1e-4 of their
RMS (max abs error); three AdamW steps' losses rtol 3e-4, as
``test_parallel.py:126``; the global ``state_dict()`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.core.module import _path_to_str
from paddle_tpu.distributed import partition_specs as j_partition_specs
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.train import Trainer as JTrainer
from paddle_tpu.train import TrainerArgs as JTrainerArgs
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from tests import _torch_dist_child as child
from tests._torch_dist_ref import numpy_module, rel

MESHES = sorted(child.LLAMA_MESHES)
DATA_MESHES = [m for m in MESHES if m != "tp2"]
# positions masked at the head of each row (a prompt): the data ranks'
# rows keep 14 and 54 labels over dp2, row 2 keeps none
PROMPT = [12, 9, 16, 10, 0, 2, 1, 3]


def _batch():
    ids = np.random.RandomState(0).randint(0, 256, (8, 16))
    return ids, np.concatenate([ids[:, 1:], np.full((8, 1), -100)], axis=1)


def _sft_labels(labels):
    keep = np.arange(labels.shape[1])[None, :] >= np.asarray(PROMPT)[:, None]
    return np.where(keep, labels, -100)


def _model():
    return numpy_module(lambda: JLlama(JLlamaConfig.tiny()), 0)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    ids, labels = _batch()
    inputs = {"ids": ids, "labels": labels, "sft_labels": _sft_labels(labels),
              **{f"w:{k}": np.asarray(v, np.float32)
                 for k, v in _model().state_dict().items()}}
    return child.World("llama", inputs, 4,
                       tmp_path_factory.mktemp("dist_llama"))


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
    opt = jopt.AdamW(learning_rate=1e-3)
    step = j_make_train_step(lambda m, i, lab: m.loss(i, lab), opt,
                             donate=False)
    state, losses = j_init_state(jm, opt), []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    return {"loss": float(loss), "logits": np.asarray(logits, np.float32),
            "grads": {k: np.asarray(v, np.float32)
                      for k, v in grads.state_dict().items()},
            "train": losses, "model": jm,
            "weights": {k: np.asarray(v, np.float32)
                        for k, v in jm.state_dict().items()},
            "sft": uneven_masks_ref(jm, single, step)}


def uneven_masks_ref(jm, single, step):
    """The reference's single-device loss, grads and 3 AdamW steps on the
    prompt-masked batch, and its Trainer accumulating the two halves of
    that batch a step (``single`` and ``step`` as in ``ref``)."""
    ids, labels = _batch()
    ids, labels = jnp.asarray(ids), jnp.asarray(_sft_labels(labels))
    loss, grads, _ = single(jm, ids, labels)
    state, losses = j_init_state(jm, jopt.AdamW(learning_rate=1e-3)), []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    # the Trainer donates its model's buffers: give it a copy
    tr = JTrainer(jax.tree_util.tree_map(jnp.copy, jm),
                  jopt.AdamW(learning_rate=1e-3),
                  lambda m, i, lab: m.loss(i, lab),
                  JTrainerArgs(max_steps=3, log_every=1, grad_accum_steps=2))
    tr.fit(iter([(ids[:4], labels[:4]), (ids[4:], labels[4:])] * 3))
    return {"loss": float(loss), "train": losses,
            "trainer": [h["loss"] for h in tr.history],
            "grads": {k: np.asarray(v, np.float32)
                      for k, v in grads.state_dict().items()}}


@pytest.fixture(scope="module")
def world(started, ref):
    return started.result()[0]


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_matches_single_device(world, ref, mesh):
    np.testing.assert_allclose(float(world[f"{mesh}:loss"]), ref["loss"],
                               rtol=2e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_logits_match_single_device(world, ref, mesh):
    """Logit-level parity catches what the loss's reduction could cancel
    (the reference's test_tp_logits / test_fsdp_logits)."""
    got = world[f"{mesh}:logits"]
    assert got.shape == ref["logits"].shape
    assert rel(got, ref["logits"]) <= 1e-4


@pytest.mark.parametrize("mesh", MESHES)
def test_every_grad_matches_single_device(world, ref, mesh):
    want = ref["grads"]
    got = {k[len(f"{mesh}:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{mesh}:grad:")}
    assert set(got) == set(want)
    for name, g in got.items():
        assert rel(g, want[name]) <= 1e-4, name


@pytest.mark.parametrize("mesh", MESHES)
def test_state_dict_is_global(world, ref, mesh):
    """A sharded model's state_dict() gives the reference's names, global
    [in, out] arrays and column order (the tp interleave undone)."""
    want = ref["weights"]
    got = {k[len(f"{mesh}:sd:"):]: v for k, v in world.items()
           if k.startswith(f"{mesh}:sd:")}
    assert set(got) == set(want)
    for name, v in got.items():
        np.testing.assert_array_equal(v, want[name], err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_hybrid_training_matches_single_device(world, ref, mesh):
    """Three AdamW steps of make_train_step(..., mesh=) against the
    reference's single-device trajectory."""
    np.testing.assert_allclose(world[f"{mesh}:train_losses"],
                               ref["train"], rtol=3e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_fit_over_a_mesh_matches_single_device(world, ref, mesh):
    """Trainer(mesh=).fit: each rank's rows of the global batches, the
    gradients averaged over the data axes, the NaN guard's device-side
    update; its three losses on the reference's trajectory."""
    np.testing.assert_allclose(world[f"{mesh}:trainer_losses"],
                               ref["train"], rtol=3e-4)


@pytest.mark.parametrize("mesh", MESHES)
def test_guarded_update_under_a_mesh(world, mesh):
    """Optimizer.step(ok=...) on sharded parameters: a skipped step keeps
    every global parameter bit for bit, a kept one moves them."""
    assert world[f"{mesh}:guard"].tolist() == [1, 1]


@pytest.mark.parametrize("mesh", DATA_MESHES)
def test_uneven_label_masks_loss_and_grads_match_single_device(world, ref,
                                                               mesh):
    """Each data rank's rows keep a different number of labels: the mesh
    step's loss (rtol 2e-4) and every gradient (1e-4 of its RMS) are the
    masked mean over the global batch's labels and its gradient, not the
    ranks' mean of their own masked means."""
    want = ref["sft"]
    np.testing.assert_allclose(float(world[f"{mesh}:sft:loss"]),
                               want["loss"], rtol=2e-4)
    got = {k[len(f"{mesh}:sft:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{mesh}:sft:grad:")}
    assert set(got) == set(want["grads"])
    for name, g in got.items():
        assert rel(g, want["grads"][name]) <= 1e-4, name


@pytest.mark.parametrize("mesh", DATA_MESHES)
@pytest.mark.parametrize("how", ["train", "trainer"])
def test_uneven_label_masks_training_matches_single_device(world, ref, mesh,
                                                           how):
    """Three AdamW steps on the prompt-masked batch (rtol 3e-4): of
    make_train_step(mesh=) against the reference's make_train_step, and of
    Trainer(mesh=).fit with two microbatches a step against the reference
    Trainer's accumulation."""
    np.testing.assert_allclose(world[f"{mesh}:sft:{how}_losses"],
                               ref["sft"][how], rtol=3e-4)


def test_tp_refuses_a_degree_that_does_not_divide_kv_heads(world):
    assert "tp=4 must divide num_key_value_heads=2" in str(
        world["tp4_refusal"])


def test_partition_specs_match_the_reference(ref):
    """The stage-3 rule and the layers' tp specs give every parameter the
    reference's PartitionSpec (fsdp on the largest divisible dim, tp kept),
    and the optimizer's slots mirror them."""
    jm = ref["model"]
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    for stage, min_size in ((3, 1), (3, 2 ** 16), (1, 1)):
        jspecs = j_partition_specs(jm, stage=stage, min_size=min_size,
                                   fsdp_size=2)
        flat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]
        want = {_path_to_str(p): tuple(s) for p, s in flat}
        got = D.partition_specs(tm, stage=stage, min_size=min_size,
                                fsdp_size=2)
        assert set(got) == set(want)
        for name, spec in got.items():
            w = want[name] + (None,) * (len(spec) - len(want[name]))
            assert spec == w, (stage, name, spec, want[name])
    specs = D.partition_specs(tm, stage=3, min_size=1, fsdp_size=2)
    assert any("tp" in s for s in specs.values())
    st = topt.AdamW().init(tm)
    slots = D.opt_state_specs(st, specs)
    assert slots["step"] == () and slots["moment1"] == specs
