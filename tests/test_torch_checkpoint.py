"""The port's checkpoints (``paddle_tpu_torch.train.checkpoint``): the
reference's durability spec (``tests/test_checkpoint_durability.py``) on
the port's files, exact ``TrainState`` round trips (bf16 and the
generator included), and the file format shared with the JAX package
both ways: a reference checkpoint of the tiny fp32 Llama loads into the
port with equal logits (fp32, same algorithm: F32_TOL), the reference's
bf16 ``<V2`` leaves read back bit for bit, and a port file reads in the
reference's ``load``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.train import checkpoint as jck
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.convert import load_jax_checkpoint
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import FLIGHT, METRICS
from paddle_tpu_torch.train import Trainer, TrainerArgs, make_train_step
from paddle_tpu_torch.train.checkpoint import (CheckpointCorruptError,
                                               CheckpointManager, load, save)
from paddle_tpu_torch.train.elastic import ElasticRunner
from paddle_tpu_torch.train.step import init_state
from paddle_tpu_torch.utils.faults import FAULTS, InjectedCrash
from tests.test_torch_common import F32_TOL, tiny_pair, to_np

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _port_hygiene():
    def clean():
        FAULTS.clear()
        METRICS.reset()
        FLIGHT.clear()
    clean()
    yield
    clean()


def _state(v: float):
    return {"w": np.full((4,), v, np.float32), "step": int(v)}


# ----------------------------------------------------------- atomic save

@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.rename"])
def test_kill_during_save_preserves_previous_file(tmp_path, site):
    path = tmp_path / "ck.npz"
    save(_state(1.0), path)
    FAULTS.install(site, on={0}, exc=InjectedCrash)
    with pytest.raises(InjectedCrash):
        save(_state(2.0), path)
    FAULTS.clear()
    got = load(path, target=_state(0.0))
    np.testing.assert_array_equal(got["w"], _state(1.0)["w"])
    assert got["step"] == 1
    save(_state(2.0), path)
    assert load(path, target=_state(0.0))["step"] == 2


def test_save_is_atomic_even_first_time(tmp_path):
    path = tmp_path / "ck.npz"
    FAULTS.install("ckpt.rename", on={0}, exc=InjectedCrash)
    with pytest.raises(InjectedCrash):
        save(_state(1.0), path)
    assert not path.exists()
    with pytest.raises(FileNotFoundError):
        load(path)


def test_truncated_file_raises_corrupt(tmp_path):
    path = tmp_path / "ck.npz"
    save(_state(3.0), path)
    raw = path.read_bytes()
    path.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(CheckpointCorruptError):
        load(path)


def test_crc_mismatch_raises_corrupt(tmp_path):
    path = tmp_path / "ck.npz"
    save(_state(4.0), path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    for lm in meta["leaves"]:
        if lm.get("kind") == "array":
            lm["crc"] ^= 0xDEADBEEF
    np.savez(str(path), __meta__=json.dumps(meta), **arrays)
    with pytest.raises(CheckpointCorruptError, match="CRC mismatch"):
        load(path)
    got = load(path, target=_state(0.0), verify=False)
    np.testing.assert_array_equal(got["w"], _state(4.0)["w"])
    assert METRICS.snapshot()["counters"]["ckpt_crc_failures_total"] == 1


# ----------------------------------------------------- manager + pointer

def test_latest_pointer_survives_kill_during_save(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=3)
    mgr.save(1, _state(1.0))
    FAULTS.install("ckpt.rename", on={0}, exc=InjectedCrash)
    with pytest.raises(InjectedCrash):
        mgr.save(2, _state(2.0))
    FAULTS.clear()
    assert mgr.latest_step() == 1
    got = mgr.restore(_state(0.0))
    assert got["step"] == 1 and mgr.last_restored_step == 1


def test_restore_falls_back_past_corrupt_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _state(float(s)))
    p3 = mgr._step_path(3)
    p3.write_bytes(p3.read_bytes()[:40])
    with pytest.warns(UserWarning, match="fell back"):
        got = mgr.restore(_state(0.0))
    assert got["step"] == 2 and mgr.last_restored_step == 2
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(_state(0.0), step=3)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(_state(0.0), fallback=False)


def test_restore_raises_when_nothing_loadable(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=5)
    for s in (1, 2):
        mgr.save(s, _state(float(s)))
    for s in (1, 2):
        mgr._step_path(s).write_bytes(b"not a checkpoint")
    with pytest.raises(CheckpointCorruptError, match="no loadable"):
        mgr.restore(_state(0.0))


def test_retention_never_deletes_latest_target(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert mgr.restore(_state(0.0))["step"] == 4


def test_damaged_pointer_falls_back_to_glob(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=3)
    mgr.save(5, _state(5.0))
    (tmp_path / "latest").write_text("garbage")
    assert mgr.latest_step() == 5
    (tmp_path / "latest").write_text("999")
    assert mgr.latest_step() == 5


def test_orbax_refused_by_name(tmp_path):
    """``use_orbax=True`` (the sharded format) is no longer refused: on one
    rank it constructs, writes a directory a step (the rank's file and
    the index), keeps ``max_to_keep`` of them and round-trips a
    TrainState exactly, falling back past a corrupt newest step."""
    _, tm = tiny_pair(seed=3)
    opt = topt.AdamW(1e-2)
    state = init_state(tm, opt)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (2, 8)))
    step = make_train_step(lambda m, i: m.loss(i, i), opt)
    mgr = CheckpointManager(tmp_path, max_to_keep=2, use_orbax=True)
    for s in (1, 2, 3):
        state, _ = step(state, ids)
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpt_00000003").iterdir()) \
        == ["index.json", "rank_00000.npz"]
    want = {k: v.clone() for k, v in tm.state_dict().items()}
    slots = {k: v.clone() for k, v in state.opt_state["moment1"].items()}
    _, fresh = tiny_pair(seed=4)
    got = mgr.restore(init_state(fresh, opt))
    assert got.step == 3 and mgr.last_restored_step == 3
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in got.opt_state["moment1"].items():
        assert torch.equal(v, slots[k]), k
    f = tmp_path / "ckpt_00000003" / "rank_00000.npz"
    f.write_bytes(f.read_bytes()[:64])
    with pytest.warns(UserWarning, match="fell back"):
        assert mgr.restore(init_state(fresh, opt)).step == 2


# ---------------------------------------------------- async (background) save

def test_async_save_is_durable_after_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, _state(1.0))
    mgr.wait()
    assert mgr.latest_step() == 1
    assert mgr.restore(_state(0.0))["step"] == 1


def test_async_writer_death_preserves_previous_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, _state(1.0))
    mgr.wait()
    FAULTS.install("ckpt.rename", on={0}, exc=InjectedCrash)
    mgr.save(2, _state(2.0))
    with pytest.raises(InjectedCrash):
        mgr.wait()
    FAULTS.clear()
    assert mgr.latest_step() == 1
    assert mgr.restore(_state(0.0))["step"] == 1
    mgr.save(2, _state(2.0))
    mgr.wait()
    assert mgr.latest_step() == 2


def test_async_writer_failure_surfaces_at_next_save(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    FAULTS.install("ckpt.write", on={0}, exc=InjectedCrash)
    mgr.save(1, _state(1.0))
    with pytest.raises(InjectedCrash):
        mgr.save(2, _state(2.0))
    FAULTS.clear()
    mgr.wait()


def test_async_save_snapshots_before_mutation(tmp_path):
    """The host copy happens on the caller's thread: scribbling over the
    live tensors (numpy and torch) after ``save`` returns must not reach
    the file."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    live = {"w": np.full((4,), 7.0, np.float32), "t": torch.full((3,), 7.0)}
    FAULTS.install("ckpt.write", on={0}, stall_s=0.2)
    mgr.save(1, live)
    live["w"][:] = -1.0
    live["t"].fill_(-1.0)
    mgr.wait()
    got = mgr.restore({"w": np.zeros(4, np.float32), "t": torch.zeros(3)})
    np.testing.assert_array_equal(got["w"], np.full((4,), 7.0, np.float32))
    assert torch.equal(got["t"], torch.full((3,), 7.0))


def test_async_save_at_most_one_in_flight(tmp_path):
    import threading
    mgr = CheckpointManager(tmp_path, async_save=True)
    FAULTS.install("ckpt.write", on={0}, stall_s=0.3)
    mgr.save(1, _state(1.0))
    first_writer = mgr._writer
    mgr.save(2, _state(2.0))
    assert not first_writer.is_alive()
    mgr.wait()
    assert mgr.latest_step() == 2
    assert not any(t.name == "pt-ckpt-writer" and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------------ TrainState round trip

def _lm_batch(cfg, b=2, s=16, seed=0):
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
    return torch.as_tensor(ids), torch.as_tensor(labels)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_train_state_round_trips_exactly(tmp_path, dtype):
    """Save after 2 AdamW steps (multi_precision: bf16 params with fp32
    masters), continue 2 steps; a FRESH model of another seed restored
    from the file continues to the same bits, and ``step``, the LR
    schedule's position and the generator's state come back."""
    cfg = LlamaConfig.tiny(dtype=dtype)
    sched = topt.CosineAnnealingDecay(1e-3, T_max=10)
    o = topt.AdamW(learning_rate=sched, multi_precision=True)
    ids, labels = _lm_batch(cfg)
    step = make_train_step(lambda m, i, l: m.loss(i, l), o)

    def fresh(seed):
        return init_state(LlamaForCausalLM(cfg, device="cpu", seed=seed), o)

    st = fresh(0)
    for _ in range(2):
        st, _ = step(st, ids, labels)
    torch.rand(5, generator=st.rng)          # move the generator
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, st)
    draw = torch.rand(3, generator=st.rng)
    for _ in range(2):
        st, loss_a = step(st, ids, labels)
    st_r = mgr.restore(fresh(1))
    assert int(st_r.step) == 2
    assert o.get_lr(st_r.opt_state) == float(sched.value_at(2))
    assert torch.equal(torch.rand(3, generator=st_r.rng), draw)
    for _ in range(2):
        st_r, loss_b = step(st_r, ids, labels)
    assert float(loss_a) == float(loss_b)
    for (n, a), b in zip(st.model.state_dict().items(),
                         st_r.model.state_dict().values()):
        assert a.dtype == dtype and torch.equal(a, b), n
    for k in ("moment1", "moment2", "master"):
        for n, a in st.opt_state[k].items():
            b = st_r.opt_state[k][n]
            assert (a is None and b is None) or torch.equal(a, b), (k, n)


def test_bf16_leaves_written_as_reference_v2(tmp_path):
    """A bf16 tensor lands as ``<V2`` with ``"dtype": "bfloat16"`` and the
    CRC of its raw bits, as the reference writes it, and reads back bit
    for bit (NaN, inf and the smallest subnormal included)."""
    w = torch.tensor([1.5, -0.0, float("inf"), float("nan"), 9.2e-41,
                      3.0e38], dtype=torch.bfloat16)
    save({"w": w}, tmp_path / "b")
    with np.load(tmp_path / "b.npz") as z:
        meta = json.loads(str(z["__meta__"]))
        raw = z["a0"]
    assert raw.dtype == np.dtype("V2")
    assert meta["leaves"][0]["dtype"] == "bfloat16"
    bits = w.view(torch.int16).numpy()
    assert np.array_equal(raw.view(np.int16), bits)
    back = load(tmp_path / "b", target={"w": torch.zeros(6,
                                                         dtype=torch.bfloat16)})
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    # the reference reads the same file (into a float32 target)
    ref = jck.load(tmp_path / "b")
    np.testing.assert_array_equal(np.asarray(ref["w"]).view(np.int16), bits)


def test_reference_bf16_checkpoint_reads_into_the_port(tmp_path):
    """The reference's own bf16 file restores into a bf16 target of the
    port bit for bit (the reference cannot restore it into a bf16 target
    of its own: numpy has no cast from V2)."""
    rs = np.random.RandomState(0)
    w = jnp.asarray(rs.standard_normal((3, 5)).astype(np.float32),
                    jnp.bfloat16)
    jck.save({"w": w, "step": 7}, tmp_path / "r")
    got = load(tmp_path / "r", target={"w": torch.zeros(
        (3, 5), dtype=torch.bfloat16), "step": 0})
    assert got["step"] == 7
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy(),
        np.asarray(w).view(np.int16))


def test_reference_model_checkpoint_loads_with_equal_logits(tmp_path):
    """A tiny fp32 Llama saved by the JAX package (as a model and inside a
    TrainState) loads into a port model of another seed under the same
    names; the logits agree with the reference's."""
    from paddle_tpu.optimizer import AdamW as JAdamW
    from paddle_tpu.train.step import init_state as j_init_state
    jm, _ = tiny_pair(seed=0)
    jck.save(jm, tmp_path / "m")
    jck.save(j_init_state(jm, JAdamW(1e-3)), tmp_path / "st")
    ids = np.random.RandomState(1).randint(0, 256, (2, 16))
    want = to_np(jm(jnp.asarray(ids)))
    for name in ("m", "st"):
        tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=5)
        load_jax_checkpoint(tm, tmp_path / f"{name}.npz")
        with torch.no_grad():
            got = to_np(tm(torch.as_tensor(ids)))
        np.testing.assert_allclose(got, want, **F32_TOL, err_msg=name)


def test_port_file_reads_in_the_reference(tmp_path):
    """The other way: a port model's fp32 file is the reference's format
    (paths, CRCs), so the reference's ``load`` reads it, CRCs verified."""
    _, tm = tiny_pair(seed=2)
    save(tm, tmp_path / "p")
    ref = jck.load(tmp_path / "p")
    for n, t in tm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(ref[n]), t.numpy())


def test_trainer_resume_continues_bit_identically(tmp_path):
    """Trainer + CheckpointManager: a 6-step fit equals a 4-step fit with
    checkpoints resumed into a fresh trainer for the last 2 steps."""
    from paddle_tpu_torch.nn.layers import Linear
    X = np.random.RandomState(0).standard_normal((6, 4, 3)).astype(np.float32)
    Y = X @ np.array([[1.0], [-2.0], [0.5]], np.float32)
    data = [(X[i], Y[i]) for i in range(6)]

    def make(steps, d):
        net = torch.nn.Sequential(Linear(3, 8, device="cpu"),
                                  torch.nn.Tanh(),
                                  Linear(8, 1, device="cpu"))
        return Trainer(net, topt.AdamW(1e-2),
                       lambda m, x, y: ((m(x) - y) ** 2).mean(),
                       TrainerArgs(max_steps=steps, log_every=0,
                                   ckpt_every=2, ckpt_dir=str(d),
                                   resume_reskip=True), device="cpu")

    full = make(6, tmp_path / "a").fit(iter(data))
    make(4, tmp_path / "b").fit(iter(data))
    resumed = make(6, tmp_path / "b").resume()
    assert int(resumed.state.step) == 4
    out = resumed.fit(iter(data))
    for a, b in zip(full.model.parameters(), out.model.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------ elastic end-to-end

def _regression(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, X.sum(1, keepdims=True).astype(np.float32)


def _make_mlp_trainer(tmp_path, steps, d):
    from paddle_tpu_torch.nn.layers import Linear
    torch.manual_seed(0)
    net = torch.nn.Sequential(Linear(d, 8, device="cpu"), torch.nn.Tanh(),
                              Linear(8, 1, device="cpu"))
    return Trainer(net, topt.SGD(learning_rate=0.05),
                   lambda m, x, y: ((m(x) - y) ** 2).mean(),
                   TrainerArgs(max_steps=steps, log_every=0, ckpt_every=2,
                               ckpt_dir=str(tmp_path), nan_guard=False),
                   device="cpu")


def _stream(X, Y, b):
    def data_fn():
        def gen():
            i = 0
            while True:
                sl = slice((i * b) % len(X), (i * b) % len(X) + b)
                yield X[sl], Y[sl]
                i += 1
        return gen()
    return data_fn


@pytest.mark.parametrize("site,hit,steps", [("ckpt.rename", 1, 8),
                                            ("train.step", 4, 6)],
                         ids=["kill_during_save", "step_exception"])
def test_elastic_recovers_and_matches_clean_run(tmp_path, site, hit, steps):
    """A kill mid-save (the step-4 save's rename) or an exception at the
    5th step: one restart from the previous durable step, all steps run,
    and the final parameters equal an uninterrupted run's bit for bit
    (the restart restores every leaf exactly and fast-forwards the fresh
    stream)."""
    X, Y = _regression(64, 3, 0)
    FAULTS.install(site, on={hit}, exc=InjectedCrash)
    runner = ElasticRunner(lambda: _make_mlp_trainer(tmp_path / "a", steps,
                                                     3),
                           max_restarts=2, backoff_s=0.0)
    state = runner.run(_stream(X, Y, 4))
    FAULTS.clear()
    assert int(state.step) == steps and runner.restarts == 1
    assert any("InjectedCrash" in f for f in runner.failures)
    assert CheckpointManager(tmp_path / "a").latest_step() == steps
    clean = ElasticRunner(lambda: _make_mlp_trainer(tmp_path / "b", steps,
                                                    3),
                          max_restarts=0, backoff_s=0.0).run(_stream(X, Y, 4))
    for a, b in zip(state.model.parameters(), clean.model.parameters()):
        assert torch.equal(a, b)
    assert METRICS.snapshot()["counters"]["elastic_restarts_total"] == 1


# ------------------------------------------- a failed restore writes nothing

def _filled(widths, v):
    layers = [torch.nn.Linear(a, b) for a, b in zip(widths, widths[1:])]
    net = torch.nn.Sequential(*layers)
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(v)
    return net


def _all_equal(net, v):
    return all(bool((p == v).all()) for p in net.parameters())


@pytest.mark.parametrize("target_widths,err", [
    ((4, 3, 2), ValueError),       # the second layer's shape differs
    ((4, 3, 5, 2), KeyError),      # the third layer is not in the file
])
def test_failed_restore_leaves_target_unchanged(tmp_path, target_widths, err):
    """Every leaf is checked before the first copy: the first layer, which
    would fit, still reads 1.0 after the restore raised."""
    save(_filled((4, 3, 5), 7.0), tmp_path / "c")
    target = _filled(target_widths, 1.0)
    with pytest.raises(err):
        load(tmp_path / "c", target=target)
    assert _all_equal(target, 1.0)


def test_manager_restore_failing_every_candidate_leaves_target(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=5)
    for s in (1, 2):
        mgr.save(s, _filled((4, 3, 5), 7.0))
    target = _filled((4, 3, 2), 1.0)
    with pytest.raises(CheckpointCorruptError, match="no loadable"):
        mgr.restore(target)
    assert _all_equal(target, 1.0)
    ok = _filled((4, 3, 5), 1.0)
    mgr.restore(ok)
    assert _all_equal(ok, 7.0)
