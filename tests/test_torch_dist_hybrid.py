"""The reference's 8-device hybrids on an 8-rank gloo world, against the
JAX package's single-device runs.

``test_parallel.py::test_hybrid_training_matches_single_device`` (the tiny
Llama over dp2 × fsdp2 × tp2: loss, logits, every gradient, the global
``state_dict()``, three AdamW steps of ``make_train_step(mesh=)`` and of
``Trainer(mesh=).fit``, and these again on a batch whose data ranks keep
different numbers of labels) and ``test_pipeline_1f1b.py::
test_1f1b_composes_with_tp[dp=2]`` (the pipelined Llama over pp2 × tp2 ×
dp2 under 1f1b and zb1, and its AdamW loop). One world of 8 processes for
the file; the references and tolerances are those of
``test_torch_dist_llama.py`` and ``test_torch_dist_pipeline.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.optimizer as jopt
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from tests import _torch_dist_child as child
from tests._torch_dist_ref import rel
from tests.test_torch_dist_llama import _batch as _llama_batch
from tests.test_torch_dist_llama import _model as _llama_model
from tests.test_torch_dist_llama import _sft_labels, uneven_masks_ref
from tests.test_torch_dist_pipeline import _batch as _pp_batch
from tests.test_torch_dist_pipeline import _llama as _pp_model

MESH, PP_MESH = "dp2_fsdp2_tp2", "pp2_tp2_dp2"


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    ids, labels = _llama_batch()
    pids, plabels = _pp_batch(0, 8)
    inputs = {"ids": ids, "labels": labels, "sft_labels": _sft_labels(labels),
              "pp:ids": pids,
              "pp:labels": plabels,
              **{f"w:{k}": np.asarray(v, np.float32)
                 for k, v in _llama_model().state_dict().items()},
              **{f"pp:w:{k}": np.asarray(v, np.float32)
                 for k, v in _pp_model().state_dict().items()}}
    return child.World("hybrid", inputs, 8,
                       tmp_path_factory.mktemp("dist_hybrid"))


def _single(jm, ids, labels):
    """Loss, logits, named grads and three AdamW steps' losses of the
    single-device reference, and its jitted value-and-grad and step."""
    @jax.jit
    def vg(m, i, lab):
        loss, grads = jax.value_and_grad(lambda mm: mm.loss(i, lab))(m)
        return loss, grads, m(i)

    loss, grads, logits = vg(jm, ids, labels)
    opt = jopt.AdamW(learning_rate=1e-3)
    step = j_make_train_step(lambda m, i, lab: m.loss(i, lab), opt,
                             donate=False)
    state, losses = j_init_state(jm, opt), []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    return (float(loss), np.asarray(logits, np.float32),
            {k: np.asarray(v, np.float32)
             for k, v in grads.state_dict().items()}, losses, vg, step)


@pytest.fixture(scope="module")
def ref(started):
    jm = _llama_model()
    loss, logits, grads, train, vg, step = _single(
        jm, *(jnp.asarray(a) for a in _llama_batch()))
    sft = uneven_masks_ref(jm, vg, step)
    weights = {k: np.asarray(v, np.float32)
               for k, v in jm.state_dict().items()}
    ploss, _, pgrads, ptrain, _, _ = _single(
        _pp_model(), *(jnp.asarray(a) for a in _pp_batch(0, 8)))
    names = {k.split(".", 3)[3] for k in pgrads
             if k.startswith("model.layers.")}
    stacked = {f"layers.{k}": np.stack([pgrads[f"model.layers.{i}.{k}"]
                                        for i in range(4)]) for k in names}
    stacked.update(embed_tokens=pgrads["model.embed_tokens"],
                   norm_weight=pgrads["model.norm.weight"],
                   lm_head=pgrads["lm_head"])
    return dict(loss=loss, logits=logits, grads=grads, train=train, sft=sft,
                weights=weights, pp_loss=ploss, pp_grads=stacked,
                pp_train=ptrain)


@pytest.fixture(scope="module")
def world(started, ref):
    return started.result()[0]


def test_hybrid_loss_logits_and_every_grad_match_single_device(world, ref):
    np.testing.assert_allclose(float(world[f"{MESH}:loss"]), ref["loss"],
                               rtol=2e-4)
    assert rel(world[f"{MESH}:logits"], ref["logits"]) <= 1e-4
    got = {k[len(f"{MESH}:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{MESH}:grad:")}
    assert set(got) == set(ref["grads"])
    for name, g in got.items():
        assert rel(g, ref["grads"][name]) <= 1e-4, name


def test_hybrid_state_dict_is_global(world, ref):
    got = {k[len(f"{MESH}:sd:"):]: v for k, v in world.items()
           if k.startswith(f"{MESH}:sd:")}
    assert set(got) == set(ref["weights"])
    for name, v in got.items():
        np.testing.assert_array_equal(v, ref["weights"][name], err_msg=name)


@pytest.mark.parametrize("how", ["train_losses", "trainer_losses"])
def test_hybrid_training_matches_single_device(world, ref, how):
    """dp2 x fsdp2 x tp2: three AdamW steps of make_train_step(mesh=) and of
    Trainer(mesh=).fit against the single-device trajectory (rtol 3e-4, as
    test_parallel.py:126); the guarded update keeps or moves every global
    parameter as told."""
    np.testing.assert_allclose(world[f"{MESH}:{how}"], ref["train"],
                               rtol=3e-4)
    assert world[f"{MESH}:guard"].tolist() == [1, 1]


def test_hybrid_uneven_label_masks_match_single_device(world, ref):
    """dp2 x fsdp2 x tp2 on the prompt-masked batch (each data rank's rows
    keep a different number of labels): the loss (rtol 2e-4) and every
    gradient (1e-4 of its RMS) of the global batch's masked mean."""
    want = ref["sft"]
    np.testing.assert_allclose(float(world[f"{MESH}:sft:loss"]),
                               want["loss"], rtol=2e-4)
    got = {k[len(f"{MESH}:sft:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{MESH}:sft:grad:")}
    assert set(got) == set(want["grads"])
    for name, g in got.items():
        assert rel(g, want["grads"][name]) <= 1e-4, name


@pytest.mark.parametrize("how", ["train", "trainer"])
def test_hybrid_uneven_label_masks_training_matches_single_device(world, ref,
                                                                  how):
    """Three AdamW steps on the prompt-masked batch (rtol 3e-4): of
    make_train_step(mesh=), and of Trainer(mesh=).fit with two microbatches
    a step against the reference Trainer's accumulation."""
    np.testing.assert_allclose(world[f"{MESH}:sft:{how}_losses"],
                               ref["sft"][how], rtol=3e-4)


@pytest.mark.parametrize("sched", ["1f1b", "zb1"])
def test_1f1b_composes_with_tp_and_dp(world, ref, sched):
    """pp2 x tp2 x dp2: the pipelined Llama's loss and every gradient (tp
    gathered and un-interleaved) equal the single-device model's."""
    case = f"llama_{PP_MESH}_{sched}"
    np.testing.assert_allclose(float(world[f"{case}:loss"]), ref["pp_loss"],
                               rtol=2e-4)
    got = {k[len(f"{case}:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{case}:grad:")}
    assert set(got) == set(ref["pp_grads"])
    for k, v in got.items():
        assert rel(v, ref["pp_grads"][k]) <= 1e-4, k


def test_zb1_bit_identical_to_1f1b_over_tp_and_dp(world):
    a, b = f"llama_{PP_MESH}_1f1b", f"llama_{PP_MESH}_zb1"
    assert float(world[f"{a}:loss"]) == float(world[f"{b}:loss"])
    for k in world:
        if k.startswith(f"{a}:grad:"):
            np.testing.assert_array_equal(world[k], world[b + k[len(a):]],
                                          err_msg=k)


def test_pp_tp_dp_optimizer_loop_matches_adamw(world, ref):
    np.testing.assert_allclose(world[f"llama_{PP_MESH}:train_losses"],
                               ref["pp_train"], rtol=3e-4)
