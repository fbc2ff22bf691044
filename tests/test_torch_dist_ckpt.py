"""Sharded checkpoints of the port under the hybrid mesh, 4 gloo ranks.

Counterpart of the reference's checkpoint contract
(``paddle_tpu/train/checkpoint.py``: global arrays written, restored into
the target's sharding) and of the coordinated multi-process checkpoint of
``tests/_multihost_child.py``. The ranks run ``_torch_dist_child.
ckpt_cases``: two 2-rank meshes side by side (fsdp2 on ranks 0-1, tp2 with
its fused qkv / gate-up interleave on ranks 2-3), then dp2 x fsdp2 on all
four. Every parameter of the tiny Llama is sharded (``min_size=1``).

* A resumed ``Trainer``: 3 steps straight against 2 steps, a checkpoint
  at step 2 and a FRESH Trainer (a model of other weights, a new
  optimizer, in the same world) resumed for the third. Loss, every global
  parameter and every AdamW slot bit for bit. (Before sharded restores
  existed the restore wrote into ``state_dict()``'s gathered copies and
  left the live parameters as they were, and every rank wrote the same
  file: this test failed.)
* Round trips of both formats (the global ``.npz`` and ``use_orbax=True``,
  one file a rank plus an index), sync and async: every live local
  tensor, the step and the generator equal; the next step's loss equal.
* Cross-mesh restores: fsdp2 -> tp2 and fsdp2 -> one process.
* The JAX package's files: its f32 and bf16 (``<V2``) files into sharded
  port models bit for bit; the port's global file of a sharded model read
  by the reference's ``load`` into its own model at f32 (the reference
  cannot restore bf16 into a bf16 target: ROADMAP.md queue 3).
* One rank's shard corrupted: both ranks fall back to the same step.
* The reference's coordinated checkpoint: rank 0 saves, a barrier, every
  rank restores rank 0's values.
* ElasticRunner under fsdp2 and tp2: a kill in a save's rename (on the
  writing rank only) or an exception at a step; one restart, the final
  parameters equal an uninterrupted run's.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.train import checkpoint as jck
from tests import _torch_dist_child as child
from tests._torch_dist_ref import numpy_module

RESUMES = sorted(child.CKPT_RESUME)
MESHES = sorted(child.CKPT_MESHES)
FORMATS = ["global", "sharded"]
MODES = ["sync", "async"]
PAIRS = ["fsdp2", "tp2"]


def _batch():
    ids = np.random.RandomState(0).randint(0, 256, (4, 16))
    return ids, np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1)


def _model(seed, dtype=jnp.float32):
    return numpy_module(lambda: JLlama(JLlamaConfig.tiny(dtype=dtype)), seed)


def _weights(m):
    return {k: np.asarray(v) for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ckpt")
    paths = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        m = _model(3, dt)
        jck.save(m, str(d / f"jax_{name}.npz"))
        paths[name] = (d / f"jax_{name}.npz", _weights(m))
    return d, paths


@pytest.fixture(scope="module")
def world(files):
    d, paths = files
    ids, labels = _batch()
    inputs = {"ids": ids, "labels": labels, "ckpt:dir": np.asarray(str(d)),
              **{f"ckpt:jax_{k}": np.asarray(str(p))
                 for k, (p, _) in paths.items()}}
    for prefix, seed in (("w:", 0), ("w2:", 1)):
        inputs.update({f"{prefix}{k}": np.asarray(v, np.float32)
                       for k, v in _weights(_model(seed)).items()})
    return child.World("ckpt", inputs, 4, d).result()


def _ranks(name):
    return child.CKPT_MESHES[name][0]


@pytest.mark.parametrize("name", RESUMES)
def test_resumed_trainer_is_bit_identical_to_uninterrupted(world, name):
    """Loss of every step, every global parameter and every AdamW slot of
    the resumed run equal the uninterrupted run's bit for bit; the fresh
    Trainer resumed at step 2."""
    mesh_name = child.CKPT_RESUME[name][0]
    w = world[_ranks(mesh_name)[0]]
    key = f"resume:{name}"
    assert int(w[f"{key}:step"]) == 2
    np.testing.assert_array_equal(w[f"{key}:resumed_losses"],
                                  w[f"{key}:full_losses"])
    full = {k[len(f"{key}:full:"):] for k in w if k.startswith(f"{key}:full:")}
    res = {k[len(f"{key}:resumed:"):] for k in w
           if k.startswith(f"{key}:resumed:")}
    assert full == res and any(k.startswith("s:moment2:") for k in full)
    for k in full:
        np.testing.assert_array_equal(w[f"{key}:resumed:{k}"],
                                      w[f"{key}:full:{k}"], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", MESHES)
def test_round_trip_restores_every_local_tensor(world, name, fmt, mode):
    """Every rank's live parameters, slots, step and generator come back
    exactly; the next step's loss from the restored state is the same
    bits as from the saved one."""
    key = f"rt:{name}:{fmt}:{mode}"
    for r in _ranks(name):
        assert int(world[r][f"{key}:eq"]) == 1, r
        a, b = world[r][f"{key}:next"]
        assert a == b, r


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dst", ["tp2", "one"])
def test_cross_mesh_restore(world, dst, fmt):
    """An fsdp2 checkpoint restored into tp2 (the interleave applied to the
    fused projections) and into one process: the global parameters and
    slots are the saved ones, the step too."""
    w = world[0]
    assert int(w[f"x:{dst}:{fmt}:eq"]) == 1
    assert int(w[f"x:{dst}:{fmt}:step"]) == 1


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", PAIRS)
def test_jax_file_loads_into_sharded_port_model(world, files, name, dt):
    """The JAX package's ``save`` of a model (bf16 as ``<V2`` raw bits)
    restores into a sharded port model: its global state_dict equals the
    reference's weights bit for bit."""
    want = files[1][dt][1]
    w = world[_ranks(name)[0]]
    got = {k[len(f"jx:{name}:{dt}:"):]: v for k, v in w.items()
           if k.startswith(f"jx:{name}:{dt}:")}
    assert set(got) == set(want)
    for k, v in want.items():
        ref = v.view(np.int16) if dt == "bf16" else v
        np.testing.assert_array_equal(got[k], ref, err_msg=k)


@pytest.mark.parametrize("name", PAIRS)
def test_port_global_file_loads_in_the_reference(world, files, name):
    """A sharded port model's global file (the mesh's first rank wrote it,
    the other wrote nothing) restores into the reference's model through
    the reference's ``load``, CRCs verified: the weights it was sharded
    from, bit for bit."""
    d = files[0]
    first, other = _ranks(name)
    assert int(world[first][f"jx:{name}:written"]) > 0
    assert int(world[other][f"jx:{name}:written"]) == 0
    template = _model(5)
    got = jck.load(str(d / f"port_{name}.npz"), target=template)
    want = _weights(_model(0))
    for k, v in _weights(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_corrupt_shard_makes_every_rank_fall_back(world):
    """Rank 1's file of step 2 is damaged, rank 0's verifies: both ranks
    restore step 1 (the state saved there), and warn."""
    for r in (0, 1):
        assert int(world[r]["corrupt:step"]) == 1, r
        assert int(world[r]["corrupt:eq"]) == 1, r
        assert int(world[r]["corrupt:warned"]) == 1, r


def test_coordinated_rank0_checkpoint(world):
    """Rank 0 saves, a barrier through the port's collective API, every
    rank restores rank 0's values."""
    for r in range(4):
        np.testing.assert_array_equal(world[r]["coord:w"], np.full(4, 2.0))
        assert int(world[r]["coord:step"]) == 3


@pytest.mark.parametrize("case", sorted(child.CKPT_ELASTIC))
@pytest.mark.parametrize("name", PAIRS)
def test_elastic_restart_under_a_mesh(world, name, case):
    """One restart on every rank, every step run, the final parameters the
    uninterrupted run's bit for bit."""
    steps = child.CKPT_ELASTIC[case][2]
    for r in _ranks(name):
        key = f"el:{name}:{case}"
        assert int(world[r][f"{key}:restarts"]) == 1, r
        assert int(world[r][f"{key}:step"]) == steps, r
        assert int(world[r][f"{key}:eq"]) == 1, r
