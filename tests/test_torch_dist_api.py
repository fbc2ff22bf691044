"""The port's distributed API, collectives, tensor-parallel layers and
facades on a 4-rank gloo world, against the JAX package.

Counterparts of ``tests/test_distributed_api.py``, ``test_parallel.py``'s
collective and layer cases, ``test_fleet_knobs.py``,
``test_train_infra.py::test_fleet_facade`` and ``test_multihost.py``'s
collectives, object gathers and per-rank data sharding. The world starts
once (``_torch_dist_child.run_world``: ``distributed.spawn``, a FileStore
in the test's temporary directory); its ranks run every case and the tests
below read their results. The reference runs its collectives inside
``shard_map`` over 8 virtual devices; the port's are processes, 4 here.
Tolerances: values moved by a collective are exact; the tp layers' fp32
products differ from the reference's dense ones only in summation order
(rtol 1e-5, atol 1e-6).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.distributed as JD
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.layers import Linear
from tests import _torch_dist_child as child
from tests._torch_dist_ref import numpy_module

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def inputs():
    """What the ranks read: the reference layers' weights (numpy-drawn),
    their inputs, and the port's own tiny Llama for the fleet facade (its
    unsharded model is held to the reference's in test_torch_llama.py, its
    sharded runs in test_torch_dist_llama.py)."""
    col = numpy_module(lambda: JD.ColumnParallelLinear(16, 32), 1)
    row = numpy_module(lambda: JD.RowParallelLinear(32, 16), 2)
    emb = numpy_module(lambda: JD.VocabParallelEmbedding(64, 8), 3)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    return {"col_w": np.asarray(col.weight), "col_b": np.asarray(col.bias),
            "row_w": np.asarray(row.weight), "row_b": np.asarray(row.bias),
            "x": np.random.RandomState(0).randn(4, 16).astype(np.float32),
            "emb_w": np.asarray(emb.weight),
            "emb_ids": np.random.RandomState(0).randint(0, 64, (2, 10)),
            "ce_logits": np.random.RandomState(0).randn(4, 32).astype(
                np.float32),
            "ce_labels": np.random.RandomState(1).randint(0, 32, (4,)),
            "ids": np.random.RandomState(0).randint(0, 256, (4, 16)),
            **{f"w:{k}": v.numpy() for k, v in tm.state_dict().items()}}


@pytest.fixture(scope="module")
def started(inputs, tmp_path_factory):
    return child.World("api", inputs, WORLD,
                       tmp_path_factory.mktemp("dist_api"))


@pytest.fixture(scope="module")
def ref(inputs, started):
    """(inputs, the JAX package's single-device results), computed while
    the world runs."""
    col = numpy_module(lambda: JD.ColumnParallelLinear(16, 32), 1)
    row = numpy_module(lambda: JD.RowParallelLinear(32, 16), 2)
    emb = numpy_module(lambda: JD.VocabParallelEmbedding(64, 8), 3)

    @jax.jit
    def reference(col, row, emb, x, emb_ids, logits, labels):
        def dense(cw, rw, xx):
            return jax.nn.relu(xx @ cw + col.bias) @ rw + row.bias
        y, vjp = jax.vjp(dense, col.weight, row.weight, x)
        ce, ce_vjp = jax.vjp(
            lambda z: JD.parallel_cross_entropy(z, labels), logits)
        return dict(
            colrow=y, **dict(zip(("col_dw", "row_dw", "dx"), vjp(2 * y))),
            embedding=emb(emb_ids), ce=ce,
            ce_ref=JF.cross_entropy(logits, labels, reduction="none"),
            ce_smooth=JD.parallel_cross_entropy(logits, labels,
                                                label_smoothing=0.1),
            ce_grad=ce_vjp(jnp.ones_like(ce))[0])

    want = {k: np.asarray(v) for k, v in reference(
        col, row, emb, *(jnp.asarray(inputs[k]) for k in (
            "x", "emb_ids", "ce_logits", "ce_labels"))).items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    with torch.no_grad():
        want["logits"] = tm(torch.as_tensor(inputs["ids"])).numpy()
    return inputs, want


@pytest.fixture(scope="module")
def world(started, ref):
    return started.result()


def test_distributed_namespace_complete():
    for name in ["init_parallel_env", "get_rank", "get_world_size",
                 "all_reduce", "all_gather", "all_gather_object", "broadcast",
                 "reduce", "scatter", "alltoall", "alltoall_single", "send",
                 "recv", "isend", "irecv", "reduce_scatter", "barrier",
                 "new_group", "get_group", "wait", "spawn", "launch",
                 "ParallelEnv", "DataParallel", "fleet", "split", "ReduceOp",
                 "get_backend", "destroy_process_group", "is_initialized"]:
        assert hasattr(D, name), name
    # every public name of the reference's package, but the ring /
    # Ulysses attention that ROADMAP.md queue 1 item 7 still queues
    queued = {"make_ring_attention", "make_zigzag_ring_attention",
              "ring_attention", "zigzag_inverse_permutation",
              "zigzag_permutation", "zigzag_ring_attention",
              "make_ulysses_attention", "ulysses_attention",
              "ring_attention", "ulysses", "sp", "moe", "pipeline",
              "mesh", "sharded", "tensor_parallel", "auto_parallel"}
    ref_names = {n for n in vars(JD) if not n.startswith("_")
                 and not isinstance(getattr(JD, n), type(jax))}
    missing = sorted(ref_names - queued - set(vars(D)))
    assert not missing, missing


def test_group_and_env(world):
    for r, res in enumerate(world):
        assert res["env"].tolist() == [r, WORLD, WORLD, r, r, WORLD, 1]
        assert str(res["backend"]) == "gloo"
        nranks, same, member = res["group"].tolist()
        assert nranks == 3 and same == 1 and member == int(r < 3)
        if r < 3:
            assert res["group_sum"].tolist() == [3.0]


def test_destroy_single_group(world):
    for res in world:
        assert res["destroy_one"].tolist() == [1, 1]
        assert int(res["destroy_all"]) == 1


def _member(r):
    return np.arange(8.0)[2 * r:2 * r + 2]


COLLECTIVES = {
    "all_reduce": lambda r: np.sum([_member(i) for i in range(4)], 0),
    "all_reduce_max": lambda r: _member(3),
    "all_reduce_min": lambda r: _member(0),
    "all_reduce_avg": lambda r: np.mean([_member(i) for i in range(4)], 0),
    "all_reduce_prod": lambda r: np.prod([_member(i) + 1 for i in range(4)],
                                         0),
    "all_gather": lambda r: np.arange(8.0),
    "all_gather_untiled": lambda r: np.arange(8.0).reshape(4, 2),
    "reduce_scatter": lambda r: (np.arange(8.0) * 10)[2 * r:2 * r + 2],
    "shift": lambda r: _member((r - 1) % 4),
    "permute": lambda r: (_member(2) if r == 0 else _member(0) if r == 2
                          else np.zeros(2)),
    "broadcast": lambda r: _member(2),
    "reduce": lambda r: (np.sum([_member(i) for i in range(4)], 0) if r == 1
                         else _member(r)),
    "scatter": lambda r: (np.arange(8.0) + 30)[2 * r:2 * r + 2],
    "gather": lambda r: np.arange(8.0),
    "send": lambda r: _member(1) if r == 3 else _member(r),
    "irecv": lambda r: _member(1) if r == 3 else _member(r),
    "axis_index": lambda r: np.asarray(r),
    "barrier": lambda r: np.asarray(0.0),
    "alltoall_single": lambda r: np.arange(16.0).reshape(4, 4).T[r:r + 1],
    "all_to_all": lambda r: np.concatenate(
        [np.arange(8.0).reshape(2, 4)[:, r:r + 1] + 100 * i
         for i in range(4)], 0),
}


@pytest.mark.parametrize("op", sorted(COLLECTIVES))
def test_collectives_over_a_mesh_axis(world, op):
    """Each collective over a dp axis of 4 ranks gives what the reference's
    lax collective gives each member (test_parallel.py's all_reduce /
    all_gather / shift; test_distributed_api.py's alltoall_single)."""
    for r, res in enumerate(world):
        if op == "all_reduce_prod":     # exp(sum(log x)), as the reference
            np.testing.assert_allclose(res[op], COLLECTIVES[op](r),
                                       rtol=1e-6, err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(res[op], COLLECTIVES[op](r),
                                          err_msg=f"rank {r}")


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "all_to_all"])
def test_collective_gradients_are_the_transposes(world, op):
    """all_reduce's gradient is the all-reduced cotangent, all_gather's the
    reduce-scattered one, all_to_all's the inverse exchange, as JAX
    transposes psum / all_gather / all_to_all."""
    for r, res in enumerate(world):
        if op == "all_reduce":
            want = np.full(2, 10.0)                  # sum of (rank + 1)
        elif op == "all_gather":
            want = 4 * np.arange(8.0)[2 * r:2 * r + 2]
        else:
            want = np.tile((np.arange(4) + 1.0)[None], (2, 1))
        np.testing.assert_array_equal(res[f"{op}_grad"], want)


def test_collectives_are_counted(world):
    # 8 all_reduce calls: sum, max, min, avg, prod, reduce's, the
    # barrier's and the gradient case's forward
    for res in world:
        assert float(res["ops_counted"]) == 8.0


def test_axis_groups_of_a_two_by_two_mesh(world):
    for r, res in enumerate(world):
        dp_i, tp_i = divmod(r, 2)
        assert res["index_tp_dp"].tolist() == [tp_i, dp_i]
        assert res["sum_tp"].tolist() == [float(2 * dp_i + 2 * dp_i + 1)]
        assert res["sum_dp"].tolist() == [float(tp_i + tp_i + 2)]
        assert res["sum_dp_tp"].tolist() == [6.0]


def test_object_gathers_and_per_rank_data_sharding(world):
    """test_multihost.py's host-level checks over the port's ranks: object
    gathers in rank order, DistributedBatchSampler's disjoint shards
    covering the data."""
    for res in world:
        assert res["objects"].tolist() == [0, 1, 2, 3]
        assert res["object_payload_3"].tolist() == [0, 1, 2, 3, 4]
        assert res["sampler"].tolist() == list(range(16))
        assert int(res["sampler_disjoint"]) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_column_row_parallel_match_dense(world, ref, n):
    want = ref[1]
    for r in range(n):
        res = world[r]
        np.testing.assert_allclose(res[f"colrow_{n}"], want["colrow"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res[f"colrow_dx_{n}"], want["dx"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res[f"col_dw_{n}"], want["col_dw"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res[f"row_dw_{n}"], want["row_dw"],
                                   rtol=RTOL, atol=ATOL)
        assert float(res[f"gather_output_{n}"]) < 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_embedding(world, ref, n):
    for r in range(n):
        np.testing.assert_allclose(world[r][f"embedding_{n}"],
                                   ref[1]["embedding"], rtol=RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_parallel_cross_entropy_matches_dense(world, ref, n):
    want = ref[1]
    np.testing.assert_allclose(want["ce"], want["ce_ref"], rtol=RTOL)
    for r in range(n):
        res = world[r]
        np.testing.assert_allclose(res[f"ce_{n}"], want["ce"], rtol=RTOL)
        np.testing.assert_allclose(res[f"ce_smooth_{n}"], want["ce_smooth"],
                                   rtol=RTOL)
        np.testing.assert_allclose(res[f"ce_grad_{n}"], want["ce_grad"],
                                   rtol=RTOL, atol=ATOL)


def test_parallel_cross_entropy_without_a_mesh_is_dense(ref):
    inputs, want = ref
    got = D.parallel_cross_entropy(torch.as_tensor(inputs["ce_logits"]),
                                   torch.as_tensor(inputs["ce_labels"]))
    np.testing.assert_allclose(got.numpy(), want["ce_ref"], rtol=RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_dist_split_linear_retained_and_deterministic(world, n):
    for r in range(n):
        res = world[r]
        assert res[f"split_{n}"].shape == (2, 4)
        np.testing.assert_array_equal(res[f"split_{n}"],
                                      res[f"split_again_{n}"])
        np.testing.assert_array_equal(res[f"split_{n}"],
                                      world[0][f"split_{n}"])
        assert int(res[f"split_kept_{n}"]) == 1


def test_auto_parallel_shard_tensor_keeps_this_ranks_piece(world):
    for r, res in enumerate(world):
        np.testing.assert_array_equal(res["shard_tensor"],
                                      np.arange(8.0)[2 * r:2 * r + 2])


def test_fleet_facade(world, ref):
    """fleet.init over the 4 ranks (mp 2 x sharding 2 leaves dp 1) and
    distributed_model's sharded tiny Llama: its logits equal the unsharded
    model's on every rank."""
    for r, res in enumerate(world):
        assert res["fleet_mesh"].tolist() == [1, 2, 2, 1]
        assert int(res["fleet_group"]) == 1
        assert res["fleet_worker"].tolist() == [r, WORLD]
        assert res["fleet_logits"].shape == (4, 16, 256)
        np.testing.assert_allclose(res["fleet_logits"], ref[1]["logits"],
                                   rtol=1e-4, atol=1e-5)


# -------------------------------------------------- single-process checks
def test_data_parallel_wrapper_forwards():
    m = Linear(4, 2, device="cpu")
    dp = D.DataParallel(m)
    x = torch.ones(3, 4)
    torch.testing.assert_close(dp(x), m(x))
    assert dp.state_dict().keys() == m.state_dict().keys()
    assert dp.in_features == 4


def test_wait_noop_and_one_process_world():
    x = torch.ones(3)
    assert D.wait(x) is x
    assert (D.get_rank(), D.get_world_size()) == (0, 1)
    assert not D.is_initialized() and D.get_backend() is None
    assert D.spawn(lambda a: a + 1, args=(1,)) == 2
    env = D.ParallelEnv()
    assert env.world_size == 1 and env.rank == 0


def test_mesh_shape_errors_and_queries():
    with pytest.raises(ValueError, match=r"mesh 2x1x1x1x1x1x1=2 != 1"):
        D.HybridMesh(dp=2, device="cpu")
    m = D.make_mesh({"tp": 1}, device="cpu")
    assert m.size("tp") == 1 and m.get_data_parallel_world_size() == 1
    assert D.single_device_mesh(device="cpu").size(("dp", "fsdp")) == 1
    assert D.current_mesh() is None
    with m:
        assert D.current_mesh() is m
        x = torch.arange(6.0).reshape(3, 2)
        assert D.all_reduce(x, axis_name="dp") is x
        assert m.batch_sharding()(x) is x
        assert D.maybe_shard(x, "dp") is x
    with pytest.raises(ValueError, match="no mesh is active"):
        D.all_reduce(torch.ones(1), axis_name="dp")


def test_launch_main_runs_the_script(tmp_path):
    script = tmp_path / "train.py"
    script.write_text("import sys, pathlib\n"
                      "pathlib.Path(sys.argv[1]).write_text('ran')\n")
    mark = tmp_path / "mark"
    assert D.launch.main(["--device", "cpu", str(script), str(mark)]) == 0
    assert mark.read_text() == "ran"
    assert D.launch.main([]) == 1


@pytest.mark.parametrize("env, want", [
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "2",
      "PROCESS_ID": "1"}, ("tcp://10.0.0.1:1234", 2, 1)),
    ({"COORDINATOR_ADDRESS": "file:///shared/store", "NUM_PROCESSES": "4",
      "PROCESS_ID": "3"}, ("file:///shared/store", 4, 3)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "8",
      "RANK": "5"}, ("env://", 8, 5))], ids=["reference", "file", "torchrun"])
def test_launch_reads_the_env_contract(monkeypatch, env, want):
    """launch.py's env contract (the reference's COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID, or torchrun's) reaches the rendezvous."""
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}

    def fake_init(backend, init_method, world_size, rank, **kw):
        seen.update(backend=backend, method=init_method, world=world_size,
                    rank=rank)

    monkeypatch.setattr(D.dist, "init_process_group", fake_init)
    monkeypatch.setattr(D.dist, "is_initialized", lambda: False)
    assert D.launch.initialize_cluster(device="cpu") is True
    assert (seen["method"], seen["world"], seen["rank"]) == want
    assert seen["backend"] == "gloo"


def test_failed_rendezvous_raises(tmp_path):
    """A world that names two ranks where one arrives raises, instead of
    training alone."""
    with pytest.raises(Exception):
        D.init_parallel_env(init_method=f"file://{tmp_path}/store",
                            world_size=2, rank=0, device="cpu", timeout=1)
    assert not D.is_initialized()


# ------------------------------------------------ fleet knobs (one process)
@pytest.fixture
def fleet_state():
    saved = dict(fleet._STATE)
    yield fleet._STATE
    fleet._STATE.clear()
    fleet._STATE.update(saved)


def _gm_pair(k_steps, avg, inner):
    w0 = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    gs = [np.random.RandomState(s).randn(4, 3).astype(np.float32)
          for s in (1, 2, 3, 4)]
    jo = __import__("paddle_tpu.optimizer", fromlist=["x"])
    jgm = jo.GradientMerge(getattr(jo, inner)(learning_rate=0.1),
                           k_steps=k_steps, avg=avg)
    tgm = topt.GradientMerge(getattr(topt, inner)(learning_rate=0.1),
                             k_steps=k_steps, avg=avg)
    return w0, gs, jgm, tgm


@pytest.mark.parametrize("inner", ["SGD", "AdamW"])
@pytest.mark.parametrize("k_steps, avg", [(2, True), (2, False), (3, True)])
def test_gradient_merge_matches_reference(inner, k_steps, avg):
    """Four calls of GradientMerge: the parameters and the accumulator
    after each equal the reference's (test_fleet_knobs.py's merged step,
    sum mode, frozen inner state). The accumulators are exact; an AdamW
    update of lr 0.1 differs from XLA's in the last ulps of the fp32
    moments (atol 1e-5 on parameters of order 1, as test_torch_train.py)."""
    w0, gs, jgm, tgm = _gm_pair(k_steps, avg, inner)
    jp, js = {"w": jnp.asarray(w0)}, None
    js = jgm.init(jp)
    tp = {"w": torch.tensor(w0)}
    ts = tgm.init(tp)
    for g in gs:
        jp, js = jgm.step(jp, {"w": jnp.asarray(g)}, js)
        _, ts = tgm.step(tp, {"w": torch.tensor(g)}, ts)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts["accum"]["w"].numpy(),
                                   np.asarray(js["accum"]["w"]), rtol=1e-6)
        assert ts["inner"]["step"] == int(js["inner"]["step"])


def test_gradient_merge_takes_the_guarded_update():
    """Under the Trainer's device-side skip (ok / lr / t): a skipped call
    adds nothing, and the kept calls give the unguarded wrapper's
    parameters bit for bit."""
    w0, gs, _, plain = _gm_pair(2, True, "AdamW")
    guarded = topt.GradientMerge(topt.AdamW(learning_rate=0.1), k_steps=2)
    pp, gp = {"w": torch.tensor(w0)}, {"w": torch.tensor(w0)}
    ps, gs_ = plain.init(pp), guarded.init(gp)
    kept = 0
    for i, g in enumerate([gs[0], gs[1], gs[1], gs[2], gs[3]]):
        ok = i != 2                       # the third call is a NaN skip
        if ok:
            _, ps = plain.step(pp, {"w": torch.tensor(g)}, ps)
            kept += 1
        _, gs_ = guarded.step(gp, {"w": torch.tensor(g)}, gs_,
                              ok=torch.tensor(ok), lr=0.1,
                              t=torch.tensor(kept if ok else kept + 1))
        torch.testing.assert_close(gp["w"], pp["w"], rtol=0, atol=0)


def test_gradient_merge_set_lr_routes_to_inner():
    gm = topt.GradientMerge(topt.SGD(learning_rate=0.1), k_steps=1)
    w = {"w": torch.ones(2)}
    state = gm.set_lr(0.5, gm.init(w))
    assert gm.get_lr(state) == pytest.approx(0.5)
    gm.step(w, {"w": torch.ones(2)}, state)
    torch.testing.assert_close(w["w"], torch.full((2,), 0.5))


def test_fleet_gradient_merge_knob(fleet_state):
    strategy = fleet.DistributedStrategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 4, "avg": False}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    opt = fleet.distributed_optimizer(topt.SGD(learning_rate=0.1))
    assert isinstance(opt, topt.GradientMerge)
    assert opt.k_steps == 4 and opt.avg is False
    opt2 = fleet.distributed_optimizer(opt)
    assert opt2 is opt and not isinstance(opt2.inner, topt.GradientMerge)
    with pytest.warns(UserWarning, match="gradient_merge.*IGNORED"):
        assert fleet.distributed_optimizer("opt") == "opt"


@pytest.mark.parametrize("key, dtype", [("use_pure_bf16", torch.bfloat16),
                                        ("use_pure_fp16", torch.float16)])
def test_fleet_amp_pure_knob(fleet_state, key, dtype):
    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    strategy.amp_configs = {key: True}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    assert fleet.distributed_optimizer(
        topt.AdamW(learning_rate=1e-3)).multi_precision is True
    wrapped = fleet.distributed_optimizer(
        topt.GradientMerge(topt.AdamW(learning_rate=1e-3), k_steps=2))
    assert wrapped.inner.multi_precision is True
    m = fleet.distributed_model(Linear(8, 8, device="cpu"), min_size=1)
    assert m.weight.dtype == dtype


def test_fleet_amp_o1_is_native_noop(fleet_state):
    strategy = fleet.DistributedStrategy()
    strategy.amp = True
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    opt = fleet.distributed_optimizer(topt.AdamW(learning_rate=1e-3))
    assert opt.multi_precision is False
    assert not isinstance(opt, topt.GradientMerge)


def test_fleet_recompute_knob(fleet_state):
    strategy = fleet.DistributedStrategy()
    strategy.recompute = True
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    cfg = LlamaConfig.tiny()
    assert cfg.remat is False
    fleet.distributed_model(LlamaForCausalLM(cfg, device="cpu"), min_size=1)
    assert cfg.remat is True
    with pytest.warns(UserWarning, match="recompute.*no remat"):
        fleet.distributed_model(Linear(4, 4, device="cpu"), min_size=1)
    # the reference's facade on one device: the same mesh from the same
    # strategy
    jstrategy = jfleet.DistributedStrategy()
    jmesh = jfleet.init(is_collective=True, strategy=jstrategy,
                        devices=jax.devices()[:1])
    assert (jmesh.dp, jmesh.tp) == (fleet.get_hybrid_communicate_group().dp,
                                    fleet.get_hybrid_communicate_group().tp)


def test_auto_parallel_partial_warns():
    from paddle_tpu_torch.distributed.auto_parallel import (Partial,
                                                            ProcessMesh,
                                                            Replicate,
                                                            shard_tensor)
    pm = ProcessMesh(np.arange(8), dim_names=["x"])
    x = torch.ones(4, 4)
    with pytest.warns(UserWarning, match="Partial placement"):
        y = shard_tensor(x, pm, [Partial()])
    torch.testing.assert_close(y, x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        shard_tensor(x, pm, [Replicate()])


def test_recompute_matches_plain():
    lin = Linear(4, 4, device="cpu")
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    D.recompute(lin, x, preserve_rng_state=False).sum().backward()
    g1 = x.grad.clone()
    x.grad = None
    fleet.utils.recompute(lin, x).sum().backward()
    torch.testing.assert_close(x.grad, g1)
