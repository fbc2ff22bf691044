"""The port's Trainer (``paddle_tpu_torch.train.trainer``) against the
reference's spec (``tests/test_train_infra.py``, ``tests/test_host_overlap.py``)
and against ``paddle_tpu.train.Trainer`` on the same weights and numpy
batches.

Tolerances: the tiny fp32 Llama's losses over 4 AdamW steps within rtol
1e-5 of the reference's (same algorithm; the summation order of XLA's and
ATen's reductions and the reference's fp32 bias corrections against the
port's float64 ones differ by a few ulp); parameters after the steps
within rtol 1e-4 / atol 1e-6 (a parameter moves ~1e-3 a step, its
rounding far below that). Within the port, the pipelined, double-buffered
and guarded loops are held BIT-identical to the synchronous one: they run
the same device operations in the same order.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.train.trainer import Trainer as JTrainer
from paddle_tpu.train.trainer import TrainerArgs as JTrainerArgs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.observability import FLIGHT, METRICS, TRACER
from paddle_tpu_torch.observability.flops import record_throughput
from paddle_tpu_torch.train import Trainer, TrainerArgs, run_elastic
from paddle_tpu_torch.train.checkpoint import CheckpointManager
from paddle_tpu_torch.utils.faults import FAULTS
from paddle_tpu_torch.utils.watchdog import (StallWatchdog, WatchdogTrip,
                                             check_finite)
from tests.test_torch_common import tiny_pair, to_np


@pytest.fixture(autouse=True)
def _port_hygiene():
    def clean():
        FAULTS.clear()
        METRICS.reset()
        FLIGHT.clear()
        TRACER.disable()
        TRACER.clear()
    clean()
    yield
    clean()


def _lm_batches(n, b=2, s=16, vocab=256, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (b, s))
        labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
        out.append((ids, labels))
    return out


# ------------------------------------------------ parity with the reference

def test_trainer_loss_trace_matches_reference():
    jm, tm = tiny_pair()
    data = _lm_batches(4)
    jtr = JTrainer(jm, jopt.AdamW(1e-3), lambda m, i, l: m.loss(i, l),
                   JTrainerArgs(max_steps=4, log_every=1))
    js = jtr.fit(iter(data))
    tr = Trainer(tm, topt.AdamW(1e-3), lambda m, i, l: m.loss(i, l),
                 TrainerArgs(max_steps=4, log_every=1), device="cpu")
    st = tr.fit(iter(data))
    assert int(st.step) == int(js.step) == 4
    assert [h["step"] for h in tr.history] == [1, 2, 3, 4]
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in jtr.history], rtol=1e-5)
    # the reference keeps its lr as a float32 array, the port a float
    np.testing.assert_allclose([h["lr"] for h in tr.history],
                               [h["lr"] for h in jtr.history], rtol=1e-7)
    np.testing.assert_allclose(to_np(st.model.lm_head),
                               to_np(js.model.lm_head), rtol=1e-4, atol=1e-6)


def test_grad_accum_matches_large_batch_and_reference():
    """accum=2 over half batches: the same update as one full batch (equal
    token counts per microbatch), and as the reference's accumulation."""
    (ids, labels), = _lm_batches(1, b=4)
    halves = [(ids[:2], labels[:2]), (ids[2:], labels[2:])]
    jm, tm = tiny_pair()
    _, tm_full = tiny_pair()
    js = JTrainer(jm, jopt.SGD(0.1), lambda m, i, l: m.loss(i, l),
                  JTrainerArgs(max_steps=1, log_every=0,
                               grad_accum_steps=2)).fit(iter(halves))
    sa = Trainer(tm, topt.SGD(0.1), lambda m, i, l: m.loss(i, l),
                 TrainerArgs(max_steps=1, log_every=0, grad_accum_steps=2),
                 device="cpu").fit(iter(halves))
    sb = Trainer(tm_full, topt.SGD(0.1), lambda m, i, l: m.loss(i, l),
                 TrainerArgs(max_steps=1, log_every=0),
                 device="cpu").fit(iter([(ids, labels)]))
    np.testing.assert_allclose(to_np(sa.model.lm_head),
                               to_np(sb.model.lm_head), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_np(sa.model.lm_head),
                               to_np(js.model.lm_head), rtol=1e-4, atol=1e-6)


def _poisoned_loss(m, ids, labels, poison):
    return m.loss(ids, labels) * poison


def test_nan_guard_skip_matches_reference_and_keeps_state():
    """[good, NaN, good] with AdamW under a warmup schedule: the skipped
    update leaves parameters, both moments and ``step`` bit-identical,
    and does not advance the schedule — the run equals [good, good] bit
    for bit, and the reference's guarded run within tolerance."""
    good = _lm_batches(2)
    poison = [(*good[0], np.float32(1.0)), (*good[0], np.float32("nan")),
              (*good[1], np.float32(1.0))]
    jm, tm = tiny_pair()
    _, tm_clean = tiny_pair()

    def jopt_():
        return jopt.AdamW(jopt.lr.LinearWarmup(1e-3, 4, 0.0, 1e-3))

    def topt_():
        return topt.AdamW(topt.LinearWarmup(1e-3, 4, 0.0, 1e-3))

    js = JTrainer(jm, jopt_(), lambda m, i, l, p: m.loss(i, l) * p,
                  JTrainerArgs(max_steps=3, log_every=0)).fit(iter(poison))
    tr = Trainer(tm, topt_(), _poisoned_loss,
                 TrainerArgs(max_steps=1, log_every=0), device="cpu")
    tr.fit(iter(poison[:1]))
    after1 = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    slots1 = {k: {n: t.clone() for n, t in tr.state.opt_state[k].items()}
              for k in ("moment1", "moment2")}
    tr.args.max_steps = 2            # one more iteration: the poisoned one
    it = iter(poison[1:2])
    tr._fit_sync(it)
    assert int(tr.state.step) == 1 and tr.stats["nan_skips"] == 1
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(v, after1[k]), k
    for k in slots1:
        for n, t in tr.state.opt_state[k].items():
            assert torch.equal(t, slots1[k][n]), (k, n)
    tr.args.max_steps = 2
    st = tr.fit(iter(poison[2:]))
    clean = Trainer(tm_clean, topt_(), _poisoned_loss,
                    TrainerArgs(max_steps=2, log_every=0), device="cpu")
    sc = clean.fit(iter([poison[0], poison[2]]))
    assert int(st.step) == int(js.step) == 2
    for a, b in zip(st.model.parameters(), sc.model.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(to_np(st.model.lm_head),
                               to_np(js.model.lm_head), rtol=1e-4, atol=1e-6)


def test_nan_guard_first_step_keeps_weights():
    tr = Trainer(Linear(4, 4, device="cpu"), topt.SGD(0.1),
                 lambda mod, x: mod(x).sum() / (x * 0.0).sum(),
                 TrainerArgs(max_steps=1, log_every=0, max_bad_steps=5),
                 device="cpu")
    w0 = tr.state.model.weight.detach().clone()
    tr.fit(iter([(np.ones((2, 4), np.float32),)]))
    assert torch.equal(tr.state.model.weight, w0)
    assert int(tr.state.step) == 0


# ------------------------------------------------------- NaN chaos, watchdog

def _linear_trainer(max_steps, **kw):
    return Trainer(Linear(4, 1, device="cpu"), topt.SGD(0.1),
                   lambda mod, x, y: ((mod(x) - y) ** 2).mean(),
                   TrainerArgs(max_steps=max_steps, log_every=0, **kw),
                   device="cpu")


def _linear_data(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(2, 4).astype(np.float32),
             rs.randn(2, 1).astype(np.float32)) for _ in range(n)]


@pytest.mark.chaos
def test_injected_nan_losses_counted_and_skipped():
    tr = _linear_trainer(8, max_bad_steps=10)
    FAULTS.install("train.loss", on={2, 3, 4}, action=lambda c: float("nan"))
    state = tr.fit(iter(_linear_data(8, 0)))
    assert int(state.step) == 8
    assert tr.stats == {"nan_skips": 3, "bad_streak_max": 3}
    assert tr._bad_steps == 0
    snap = METRICS.snapshot()["counters"]
    assert snap["train_nan_skips_total"] == 3
    assert snap['faults_injected_total{site="train.loss"}'] == 3
    assert snap["train_steps_total"] == 8


@pytest.mark.chaos
def test_nan_storm_trips_watchdog():
    tr = _linear_trainer(50, max_bad_steps=3)
    FAULTS.install("train.loss", every=1, action=lambda c: float("nan"))
    with pytest.raises(WatchdogTrip, match="non-finite"):
        tr.fit(iter(_linear_data(50, 1)))
    assert tr.stats["nan_skips"] == 3
    assert any(e["kind"] == "train.giveup" for e in FLIGHT.events())


@pytest.mark.chaos
def test_nan_backoff_sleeps_exponentially():
    tr = _linear_trainer(4, max_bad_steps=10, nan_backoff_s=0.05)
    FAULTS.install("train.loss", on={1, 2}, action=lambda c: float("nan"))
    t0 = time.monotonic()
    tr.fit(iter(_linear_data(4, 2)))
    assert time.monotonic() - t0 >= 0.14
    assert METRICS.snapshot()["counters"]["train_nan_backoff_total"] == 2


def test_watchdog_trips_and_check_finite():
    w = StallWatchdog(timeout_s=0.2).start()
    time.sleep(0.5)
    with pytest.raises(WatchdogTrip):
        w.poke()
    w.stop()
    assert w.tripped
    assert check_finite({"a": torch.ones(3), "b": [torch.zeros(2)]})
    assert not check_finite({"a": torch.ones(3),
                             "b": [torch.tensor([float("nan")])]})
    assert check_finite(Linear(2, 2, device="cpu"))


def test_elastic_gives_up(tmp_path):
    def make():
        return Trainer(Linear(2, 1, device="cpu"), topt.SGD(0.1),
                       lambda m, x, y: ((m(x) - y) ** 2).mean(),
                       TrainerArgs(max_steps=5, ckpt_dir=str(tmp_path)),
                       device="cpu")

    def data_fn():
        def gen():
            raise RuntimeError("always broken")
            yield  # pragma: no cover
        return gen()

    with pytest.raises(RuntimeError, match="gave up"):
        run_elastic(make, data_fn, max_restarts=1, backoff_s=0.0)
    assert METRICS.snapshot()["counters"]["elastic_giveups_total"] == 1


# ------------------------------------------------------------------- MFU

def test_mfu_gauges_and_no_mfu_without_a_peak():
    X = _linear_data(4, 3)
    tr = _linear_trainer(4, flops_per_token=100.0, peak_flops=1e6)
    tr.args.log_every = 2
    tr.fit(iter(X))
    assert len(tr.history) == 2
    rec = tr.history[-1]
    assert rec["mfu"] == pytest.approx(rec["tokens_per_sec"] * 100.0 / 1e6)
    g = METRICS.snapshot()["gauges"]
    assert g["train_mfu"] == rec["mfu"] and g["train_tokens_per_sec"] > 0
    # the CPU has no peak row: no MFU, as the reference off-TPU
    tr0 = _linear_trainer(4, flops_per_token=100.0)
    tr0.args.log_every = 2
    assert tr0.peak_flops == 0.0
    tr0.fit(iter(X))
    assert all("mfu" not in h for h in tr0.history)
    # overlap-aware variant: hidden host time leaves the denominator
    assert record_throughput(10.0, 2.0, 100.0, hidden_host_s=0.5,
                             window_s=1.0) == pytest.approx(0.2)
    assert METRICS.snapshot()["gauges"]["train_mfu_overlap"] == \
        pytest.approx(0.4)


# ------------------------------------------- pipelined fit == synchronous

def _fixed_batches(n=12, b=4, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, b, d)).astype(np.float32)
    W = np.array([[1.0], [-2.0], [0.5]], np.float32)
    return [(X[i], X[i] @ W) for i in range(n)]


def _make_trainer(max_steps, depth, log_every=1, **kw):
    net = torch.nn.Sequential(Linear(3, 8, device="cpu", seed=1),
                              torch.nn.Tanh(),
                              Linear(8, 1, device="cpu", seed=2))
    return Trainer(net, topt.SGD(learning_rate=0.05),
                   lambda m, x, y: ((m(x) - y) ** 2).mean(),
                   TrainerArgs(max_steps=max_steps, log_every=log_every,
                               pipeline_depth=depth, **kw), device="cpu")


def _same_params(a, b):
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("depth,log_every", [(1, 1), (3, 1), (3, 3)])
def test_pipelined_fit_bit_identical_to_sync(depth, log_every):
    data = _fixed_batches()
    tr_sync = _make_trainer(12, 0, log_every=log_every)
    s_sync = tr_sync.fit(iter(data))
    tr_pipe = _make_trainer(12, depth, log_every=log_every)
    s_pipe = tr_pipe.fit(iter(data))
    assert int(s_pipe.step) == int(s_sync.step) == 12
    assert len(tr_pipe.history) == len(tr_sync.history) == 12 // log_every
    for ha, hb in zip(tr_sync.history, tr_pipe.history):
        assert (ha["step"], ha["loss"], ha["lr"]) == \
            (hb["step"], hb["loss"], hb["lr"])
    _same_params(s_sync, s_pipe)


def test_pipelined_fit_with_prefetch_bit_identical():
    from paddle_tpu_torch.io import prefetch_to_device
    data = _fixed_batches()
    s_sync = _make_trainer(12, 0).fit(iter(data))
    with prefetch_to_device(iter(data), depth=2, device="cpu") as p:
        s_pipe = _make_trainer(12, 2).fit(p)
    _same_params(s_sync, s_pipe)


@pytest.mark.chaos
def test_pipelined_nan_attribution_matches_sync(tmp_path):
    def run(depth, d):
        FAULTS.clear()
        FAULTS.install("train.loss", on={2, 3}, action=lambda c: float("nan"))
        tr = _make_trainer(8, depth, max_bad_steps=10, ckpt_every=4,
                           ckpt_dir=str(d))
        state = tr.fit(iter(_fixed_batches(8)))
        FAULTS.clear()
        return tr, state

    tr_a, st_a = run(0, tmp_path / "a")
    tr_b, st_b = run(3, tmp_path / "b")
    assert int(st_a.step) == int(st_b.step) == 8
    assert tr_a.stats == tr_b.stats == {"nan_skips": 2, "bad_streak_max": 2}
    assert (CheckpointManager(tmp_path / "a").all_steps()
            == CheckpointManager(tmp_path / "b").all_steps() == [4, 8])
    _same_params(st_a, st_b)


@pytest.mark.chaos
def test_pipelined_real_nan_is_skipped_like_sync():
    """A real non-finite loss inside a full window: the device counter
    holds, the host mirror catches up at the drain, and the pipelined run
    ends bit-identical to the synchronous one."""
    data = _fixed_batches(10)
    data[3] = (data[3][0], np.full_like(data[3][1], np.nan))

    def run(depth):
        tr = _make_trainer(10, depth, log_every=5, max_bad_steps=10)
        return tr, tr.fit(iter(data))

    (ta, sa), (tb, sb) = run(0), run(3)
    assert int(sa.step) == int(sb.step) == 9
    assert ta.stats == tb.stats == {"nan_skips": 1, "bad_streak_max": 1}
    assert [h["loss"] for h in ta.history] == [h["loss"] for h in tb.history]
    _same_params(sa, sb)


def test_pipelined_fit_emits_drain_spans():
    TRACER.enable()
    _make_trainer(4, 2).fit(iter(_fixed_batches(4)))
    names = [e["name"] for e in TRACER.export()["traceEvents"]]
    assert names.count("train.step") == 4
    assert names.count("train.drain") == 4


@pytest.mark.parametrize("depth", [0, 2])
def test_device_double_buffer_bit_identical(depth):
    data = _fixed_batches()
    tr_ref = _make_trainer(12, depth)
    s_ref = tr_ref.fit(iter(data))
    tr_db = _make_trainer(12, depth, device_double_buffer=True)
    s_db = tr_db.fit(iter(data))
    assert int(s_db.step) == int(s_ref.step) == 12
    for ha, hb in zip(tr_ref.history, tr_db.history):
        assert (ha["step"], ha["loss"]) == (hb["step"], hb["loss"])
    _same_params(s_ref, s_db)


def test_device_double_buffer_consumes_no_extra_batches():
    state = _make_trainer(8, 0, device_double_buffer=True).fit(
        iter(_fixed_batches(n=8)))
    assert int(state.step) == 8


def test_device_double_buffer_with_grad_accum_bit_identical():
    data = _fixed_batches(n=12)
    s_ref = _make_trainer(6, 0, grad_accum_steps=2).fit(iter(data))
    s_db = _make_trainer(6, 2, grad_accum_steps=2,
                         device_double_buffer=True).fit(iter(data))
    _same_params(s_ref, s_db)


def test_pipelined_async_ckpt_end_to_end(tmp_path):
    tr = _make_trainer(8, 2, ckpt_every=4, ckpt_dir=str(tmp_path),
                       async_ckpt=True)
    state = tr.fit(iter(_fixed_batches(8)))
    assert int(state.step) == 8
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 8
    assert int(mgr.restore(tr.state).step) == 8
    assert tr.host_wait_s >= 0.0 and tr.fit_s > 0.0


# -------------------------------------------------------------- profiler

def test_profiler_step_timer_and_scheduler(tmp_path):
    """``utils.profiler``: the Profiler writes torch's trace and the host
    spans under its directory (redirected by export_chrome_tracing),
    StepTimer feeds the shared gauges, make_scheduler walks the
    reference's states, the XLA readers refuse."""
    import json

    from paddle_tpu.utils import profiler as jprof
    from paddle_tpu_torch.utils import profiler as P
    out = tmp_path / "trace"
    with P.Profiler(targets=[P.ProfilerTarget.CPU],
                    on_trace_ready=P.export_chrome_tracing(str(out))) as prof:
        with P.record_event("work"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.log_dir == str(out)
    assert json.load(open(prof.host_trace_path))["traceEvents"]
    assert (out / "trace.json").exists()
    assert any("work" in e.key for e in prof.prof.key_averages())
    timer = P.StepTimer(flops_per_token=10.0, peak_flops=1e3)
    timer.start()
    rec = timer.stop(tokens=100)
    assert rec["mfu"] == pytest.approx(rec["tokens_per_sec"] * 10.0 / 1e3)
    assert METRICS.snapshot()["histograms"]["steptimer_step_seconds"][
        "count"] == 1
    kw = dict(closed=1, ready=1, record=2, repeat=2, skip_first=1)
    sched, jsched = P.make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [sched(i) for i in range(12)] == [jsched(i) for i in range(12)]
    stats = P.device_memory_stats()
    assert all(set(r) >= {"backend", "bytes_in_use", "peak_bytes_in_use",
                          "bytes_limit"} for r in stats.values())
    for fn in (P.dump_cost_analysis, P.compiled_memory_analysis):
        with pytest.raises(NotImplementedError, match="XLA"):
            fn(lambda x: x, 1)


# ------------------------------------------------- set_lr during a fit

def _lr_hook_run(trainer_cls, args, opt, model, xs):
    """SGD(0.1) on ``model`` (weight 1.0, loss sum(model(x)) with x = 2:
    every weight gradient 2) for 4 steps, a hook setting the lr to 0.0
    after step 2: the weight ends at 1 - 2 * 0.1 * 2 = 0.6."""
    holder = {}

    def hook(rec):
        if rec["step"] == 2:
            tr = holder["tr"]
            tr.state.opt_state = opt.set_lr(0.0, tr.state.opt_state)

    tr = holder["tr"] = trainer_cls(model, opt, lambda m, x: m(x).sum(),
                                    args, hooks=[hook])
    return tr.fit(iter(xs))


def test_set_lr_in_a_hook_applies_in_the_reference():
    from paddle_tpu.nn.layers import Linear as JLinear
    m = JLinear(4, 1)
    m.weight = jnp.ones((4, 1), jnp.float32)
    xs = [(np.full((1, 4), 2.0, np.float32),)] * 4
    st = _lr_hook_run(JTrainer, JTrainerArgs(max_steps=4, log_every=1),
                      jopt.SGD(0.1), m, xs)
    np.testing.assert_allclose(np.asarray(st.model.weight), 0.6, rtol=1e-6)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("nan_guard", [True, False])
def test_set_lr_in_a_hook_applies_mid_fit(depth, nan_guard):
    """The NaN guard's step reads a float lr from the state, so a hook's
    ``set_lr`` applies from the next step, as in the reference (the
    guarded step once read a table built when the fit began: 0.2)."""
    m = Linear(4, 1, device="cpu")
    with torch.no_grad():
        m.weight.fill_(1.0)
    xs = [(np.full((1, 4), 2.0, np.float32),)] * 4
    args = TrainerArgs(max_steps=4, log_every=1, pipeline_depth=depth,
                       nan_guard=nan_guard)
    st = _lr_hook_run(lambda *a, **k: Trainer(*a, device="cpu", **k), args,
                      topt.SGD(0.1), m, xs)
    torch.testing.assert_close(st.model.weight.detach(),
                               torch.full((4, 1), 0.6), rtol=1e-6, atol=1e-6)
