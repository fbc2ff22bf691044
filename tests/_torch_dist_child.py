"""Rank programs of the port's multi-process tests
(``tests/test_torch_dist_*``).

Each test file starts one gloo world of CPU processes once
(:func:`run_world`, through ``paddle_tpu_torch.distributed.spawn`` and a
FileStore in the test's temporary directory). Every process runs all of
that file's cases on the inputs the parent wrote (numpy, from the JAX
reference's weights and batches) and writes its results as numpy; the
parent's tests compare them with the JAX package's single-device runs.
A case over fewer ranks than the world runs on the first ranks, the others
skip it. This module imports torch and the port only (never JAX), so the
children start quickly.
"""
from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def run_world(kind: str, inputs: dict, nprocs: int, tmp, timeout=180):
    """Spawn ``nprocs`` ranks running ``CASES[kind]`` on ``inputs``; returns
    each rank's results ({name: array})."""
    from paddle_tpu_torch import distributed as D
    in_path = os.path.join(str(tmp), f"{kind}_inputs.npz")
    np.savez(in_path, **inputs)
    D.spawn(world_main, args=(kind, in_path, str(tmp)), nprocs=nprocs,
            init_method=f"file://{os.path.join(str(tmp), kind + '_store')}",
            timeout=timeout)
    out = []
    for r in range(nprocs):
        with np.load(os.path.join(str(tmp), f"{kind}_{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


class World:
    """A world started in the background (a thread running
    :func:`run_world`), so the parent computes the JAX references while
    the ranks run; :meth:`result` joins it."""

    def __init__(self, kind, inputs, nprocs, tmp, timeout=180):
        import threading
        self._out = self._exc = None

        def run():
            try:
                self._out = run_world(kind, inputs, nprocs, tmp, timeout)
            except BaseException as e:          # re-raised by result()
                self._exc = e

        self._thread = threading.Thread(target=run, name=f"world-{kind}",
                                        daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._out


def world_main(kind, in_path, out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import launch
    launch.initialize_cluster(device="cpu")      # the spawn env's world
    rank = dist.get_rank()
    with np.load(in_path) as f:
        inputs = {k: f[k] for k in f.files}
    out = {}
    try:
        CASES[kind](inputs, out)
    except BaseException:
        out["error"] = np.asarray(traceback.format_exc())
        raise
    finally:
        np.savez(os.path.join(out_dir, f"{kind}_{rank}.npz"), **out)
        dist.destroy_process_group()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().float().numpy()


def _mesh(n, **shape):
    from paddle_tpu_torch.distributed import HybridMesh
    return HybridMesh(**shape, ranks=range(n), device="cpu")


def _llama(inputs, prefix="w:", **cfg):
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    m = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_jax_state_dict(m, {k[len(prefix):]: v for k, v in inputs.items()
                            if k.startswith(prefix)})
    return m


# ------------------------------------------------------------ collectives
def api_cases(inputs, out):
    """Collectives, the communication API, the tp layers and the facades
    (4 ranks)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import auto_parallel as AP
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.observability.metrics import METRICS
    rank = D.get_rank()
    env = D.ParallelEnv()
    out["env"] = np.asarray([env.rank, env.world_size, env.nranks,
                             env.local_rank, D.get_rank(),
                             D.get_world_size(), int(D.is_initialized())])
    out["backend"] = np.asarray(D.get_backend())
    mesh = _mesh(4, dp=4)
    x = torch.arange(8.0)[2 * rank:2 * rank + 2]        # member r: 2 values
    ops0 = METRICS.counter("collective_ops_total", labelnames=("op",)).value(
        op="all_reduce")
    with mesh:
        out["all_reduce"] = _np(D.all_reduce(x, axis_name="dp"))
        out["all_reduce_max"] = _np(D.all_reduce(x, D.ReduceOp.MAX,
                                                 axis_name="dp"))
        out["all_reduce_min"] = _np(D.all_reduce(x, D.ReduceOp.MIN,
                                                 axis_name="dp"))
        out["all_reduce_avg"] = _np(D.all_reduce(x, D.ReduceOp.AVG,
                                                 axis_name="dp"))
        out["all_reduce_prod"] = _np(D.all_reduce(x + 1, D.ReduceOp.PROD,
                                                  axis_name="dp"))
        out["all_gather"] = _np(D.all_gather(x, axis_name="dp"))
        out["all_gather_untiled"] = _np(D.all_gather(x, axis_name="dp",
                                                     tiled=False))
        out["reduce_scatter"] = _np(D.reduce_scatter(
            torch.arange(8.0) * (rank + 1), axis_name="dp"))
        out["shift"] = _np(D.shift(x, 1, axis_name="dp"))
        out["permute"] = _np(D.permute(x, [(0, 2), (2, 0)], axis_name="dp"))
        out["broadcast"] = _np(D.broadcast(x, 2, axis_name="dp"))
        out["reduce"] = _np(D.reduce(x, 1, axis_name="dp"))
        out["scatter"] = _np(D.scatter(torch.arange(8.0) + 10 * rank, 3,
                                       axis_name="dp"))
        out["gather"] = _np(D.gather(x, axis_name="dp"))
        out["send"] = _np(D.send(x, 3, src=1, axis_name="dp"))
        out["irecv"] = _np(D.irecv(x, 1, dst=3, axis_name="dp"))
        out["axis_index"] = np.asarray(D.collective.axis_index("dp"))
        out["barrier"] = _np(D.barrier(axis_name="dp"))
        row = torch.arange(16.0).reshape(4, 4)[rank]
        out["alltoall_single"] = _np(D.alltoall_single(
            row.reshape(4, 1), axis_name="dp").reshape(1, 4))
        out["all_to_all"] = _np(D.alltoall(
            torch.arange(8.0).reshape(2, 4) + 100 * rank, axis_name="dp",
            split_axis=1, concat_axis=0))
        # gradients: d/dx sum_r sum(all_reduce(x)_r * (r + 1)) = sum(r + 1)
        xr = x.clone().requires_grad_(True)
        (D.all_reduce(xr, axis_name="dp") * (rank + 1)).sum().backward()
        out["all_reduce_grad"] = _np(xr.grad)
        xg = x.clone().requires_grad_(True)
        (D.all_gather(xg, axis_name="dp") * torch.arange(8.0)).sum(
        ).backward()
        out["all_gather_grad"] = _np(xg.grad)
        xa = torch.arange(8.0).reshape(2, 4).requires_grad_(True)
        (D.alltoall(xa, axis_name="dp", split_axis=1, concat_axis=0)
         * (rank + 1)).sum().backward()
        out["all_to_all_grad"] = _np(xa.grad)
    out["ops_counted"] = np.asarray(METRICS.counter(
        "collective_ops_total", labelnames=("op",)).value(
            op="all_reduce") - ops0)
    # a 2 x 2 mesh: groups along each axis
    with _mesh(4, dp=2, tp=2) as m2:
        v = torch.tensor([float(rank)])
        out["sum_tp"] = _np(D.all_reduce(v, axis_name="tp"))
        out["sum_dp"] = _np(D.all_reduce(v, axis_name="dp"))
        out["sum_dp_tp"] = _np(D.all_reduce(v, axis_name=("dp", "tp")))
        out["index_tp_dp"] = np.asarray([m2.index("tp"), m2.index("dp")])
    # object gathers, groups
    objs = D.all_gather_object({"rank": rank,
                                "payload": list(range(rank + 2))})
    out["objects"] = np.asarray([o["rank"] for o in objs])
    out["object_payload_3"] = np.asarray(objs[3]["payload"])
    D.destroy_process_group()
    g = D.new_group([0, 1, 2])
    got = D.get_group(g.id)
    out["group"] = np.asarray([g.nranks, int(got is g),
                               int(g.pg is not None)])
    if g.pg is not None:
        t = torch.ones(1)
        dist.all_reduce(t, group=g.pg)
        out["group_sum"] = _np(t)
    g1, g2 = D.new_group([0, 1]), D.new_group([2, 3])
    D.destroy_process_group(g1)
    out["destroy_one"] = np.asarray([int(D.get_group(g1.id) is None),
                                     int(D.get_group(g2.id) is g2)])
    D.destroy_process_group()
    out["destroy_all"] = np.asarray(int(D.get_group(g2.id) is None))
    # per-rank data: the sampler's shards are disjoint and cover the data
    from paddle_tpu_torch.io import DistributedBatchSampler
    local = [i for b in DistributedBatchSampler(list(range(16)), 2)
             for i in b]
    out["sampler"] = np.asarray(sorted(i for part in D.all_gather_object(
        local) for i in part))
    out["sampler_disjoint"] = np.asarray(int(not (
        set(local) & set(D.all_gather_object(local)[(rank + 1) % 4]))))
    # auto_parallel: this rank's piece of a global tensor
    pm = AP.ProcessMesh(np.arange(4), dim_names=["x"])
    out["shard_tensor"] = _np(AP.shard_tensor(torch.arange(8.0), pm,
                                              [AP.Shard(0)]))
    # the tp layers on 2 and 4 ranks, built from the reference's full weights
    _tp_layer_cases(inputs, out, rank)
    # the fleet facade over the world: mp 2 x sharding 2 -> dp 1
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2, "sharding_degree": 2}
    fm = fleet.init(is_collective=True, strategy=strategy, device="cpu")
    out["fleet_mesh"] = np.asarray([fm.dp, fm.fsdp, fm.tp, fm.pp])
    out["fleet_group"] = np.asarray(int(fleet.get_hybrid_communicate_group()
                                        is fm))
    out["fleet_worker"] = np.asarray([fleet.worker_index(),
                                      fleet.worker_num()])
    model = fleet.distributed_model(_llama(inputs), min_size=1)
    with torch.no_grad():
        out["fleet_logits"] = _np(model(_t(inputs["ids"])))
    fleet._STATE.update(mesh=None, strategy=None)


def _tp_layer_cases(inputs, out, rank):
    from paddle_tpu_torch import distributed as D
    col_w, col_b = _t(inputs["col_w"]), _t(inputs["col_b"])
    row_w, row_b = _t(inputs["row_w"]), _t(inputs["row_b"])
    x = _t(inputs["x"])
    for n in (2, 4):
        if rank >= n:
            continue
        mesh = _mesh(n, tp=n)
        col = D.ColumnParallelLinear(16, 32, device="cpu")
        row = D.RowParallelLinear(32, 16, device="cpu")
        with torch.no_grad():
            col.weight.copy_(col_w)
            col.bias.copy_(col_b)
            row.weight.copy_(row_w)
            row.bias.copy_(row_b)
        D.shard_module(col, mesh, min_size=1)
        D.shard_module(row, mesh, min_size=1)
        xr = x.clone().requires_grad_(True)
        y = row(torch.relu(col(xr)))
        y.square().sum().backward()
        out[f"colrow_{n}"] = _np(y)
        out[f"colrow_dx_{n}"] = _np(xr.grad)
        from paddle_tpu_torch.distributed.sharded import global_grads
        g = global_grads(col)
        out[f"col_dw_{n}"] = _np(g["weight"])
        out[f"row_dw_{n}"] = _np(global_grads(row)["weight"])
        gcol = D.ColumnParallelLinear(16, 32, gather_output=True,
                                      device="cpu", mesh=mesh)
        with torch.no_grad():
            dense = x @ gcol.state_dict()["weight"]
        out[f"gather_output_{n}"] = np.asarray(float(
            (gcol(x) - dense).abs().max()))
        emb = D.VocabParallelEmbedding(64, 8, device="cpu")
        with torch.no_grad():
            emb.weight.copy_(_t(inputs["emb_w"]))
        D.shard_module(emb, mesh, min_size=1)
        out[f"embedding_{n}"] = _np(emb(_t(inputs["emb_ids"])))
        logits = _t(inputs["ce_logits"])
        local = logits.chunk(n, -1)[mesh.index("tp")].clone()
        local.requires_grad_(True)
        with mesh:
            ce = D.parallel_cross_entropy(local, _t(inputs["ce_labels"]),
                                          axis_name="tp")
            ce_ls = D.parallel_cross_entropy(
                local, _t(inputs["ce_labels"]), axis_name="tp",
                label_smoothing=0.1)
        ce.sum().backward()
        out[f"ce_{n}"] = _np(ce)
        out[f"ce_smooth_{n}"] = _np(ce_ls)
        out[f"ce_grad_{n}"] = _np(mesh.gather(local.grad, (None, "tp")))
        with mesh:
            out[f"split_{n}"] = _np(D.split(torch.ones(2, 8), (8, 4),
                                            operation="linear", axis=1,
                                            name=f"tp_fc_{n}"))
            again = D.split(torch.ones(2, 8), (8, 4), operation="linear",
                            axis=1, name=f"tp_fc_{n}")
        out[f"split_again_{n}"] = _np(again)
        out[f"split_kept_{n}"] = np.asarray(int(
            D.get_split_layer(f"tp_fc_{n}") is not None))


# ------------------------------------------------------------- llama mesh
LLAMA_MESHES = {"tp2": dict(tp=2), "fsdp2": dict(fsdp=2), "dp2": dict(dp=2),
                "dp2_tp2": dict(dp=2, tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2)}


def _lm_loss(m, ids, labels):
    return m.loss(ids, labels)


def _llama_mesh_case(inputs, out, rank, name, shape):
    """The tiny Llama sharded over one mesh: logits, loss, every gradient,
    the global state_dict, 3 AdamW steps of the mesh train step, the
    guarded update and Trainer.fit; results written by rank 0."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.distributed.mesh import DATA_AXES
    from paddle_tpu_torch.distributed.sharded import global_grads
    from paddle_tpu_torch.train import (Trainer, TrainerArgs, init_state,
                                        make_train_step)
    from paddle_tpu_torch.train.step import loss_and_grads
    ids, labels = _t(inputs["ids"]), _t(inputs["labels"])
    mesh = _mesh(int(np.prod(list(shape.values()))), **shape)
    model = D.shard_module(_llama(inputs), mesh, min_size=1)
    rows = mesh.batch_sharding()
    with torch.no_grad():
        logits = mesh.gather(model(rows(ids)), (DATA_AXES,))
    loss, _ = loss_and_grads(model, _lm_loss, [(ids, labels)], mesh)
    grads = global_grads(model)
    sd = model.state_dict()
    if rank == 0:
        out[f"{name}:logits"] = _np(logits)
        out[f"{name}:loss"] = _np(loss)
        for k, g in grads.items():
            out[f"{name}:grad:{k}"] = _np(g)
        for k, v in sd.items():
            out[f"{name}:sd:{k}"] = _np(v)
    opt = O.AdamW(learning_rate=1e-3)
    state = init_state(_llama(inputs), opt, mesh)
    step = make_train_step(_lm_loss, opt, mesh=mesh)
    losses = []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    # the guarded update under the mesh: a skipped step keeps every
    # parameter bit for bit, a kept one moves them
    m = state.model
    loss_and_grads(m, _lm_loss, [(ids, labels)], mesh)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    kw = dict(lr=torch.tensor(1e-3, dtype=torch.float64),
              t=torch.tensor(float(state.opt_state["step"] + 1)))
    _, st = opt.step(m, None, state.opt_state, ok=torch.tensor(False), **kw)
    kept = all(torch.equal(before[k], v) for k, v in m.state_dict().items())
    opt.step(m, None, st, ok=torch.tensor(True), **kw)
    moved = any(not torch.equal(before[k], v)
                for k, v in m.state_dict().items())
    # Trainer.fit over the mesh (global batches in, each rank's rows over
    # the data axes, the NaN guard's update): the same trajectory
    tr = Trainer(_llama(inputs), O.AdamW(learning_rate=1e-3), _lm_loss,
                 TrainerArgs(max_steps=3, log_every=1), mesh=mesh,
                 device="cpu")
    tr.fit(iter([(ids, labels)] * 3))
    if rank == 0:
        out[f"{name}:train_losses"] = np.asarray(losses)
        out[f"{name}:guard"] = np.asarray([int(kept), int(moved)])
        out[f"{name}:trainer_losses"] = np.asarray(
            [h["loss"] for h in tr.history])
    if mesh.size(DATA_AXES) > 1:
        _llama_uneven_masks_case(inputs, out, rank, name, mesh)


def _llama_uneven_masks_case(inputs, out, rank, name, mesh):
    """A prompt-masked batch whose rows on each data rank keep different
    numbers of labels: the loss and every gradient of the mesh step, its 3
    AdamW steps, and Trainer.fit accumulating two microbatches a step."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.distributed.sharded import global_grads
    from paddle_tpu_torch.train import (Trainer, TrainerArgs, init_state,
                                        make_train_step)
    from paddle_tpu_torch.train.step import loss_and_grads
    ids, labels = _t(inputs["ids"]), _t(inputs["sft_labels"])
    model = D.shard_module(_llama(inputs), mesh, min_size=1)
    loss, _ = loss_and_grads(model, _lm_loss, [(ids, labels)], mesh)
    grads = global_grads(model)
    opt = O.AdamW(learning_rate=1e-3)
    state = init_state(_llama(inputs), opt, mesh)
    step = make_train_step(_lm_loss, opt, mesh=mesh)
    losses = []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    tr = Trainer(_llama(inputs), O.AdamW(learning_rate=1e-3), _lm_loss,
                 TrainerArgs(max_steps=3, log_every=1, grad_accum_steps=2),
                 mesh=mesh, device="cpu")
    tr.fit(iter([(ids[:4], labels[:4]), (ids[4:], labels[4:])] * 3))
    if rank == 0:
        out[f"{name}:sft:loss"] = _np(loss)
        for k, g in grads.items():
            out[f"{name}:sft:grad:{k}"] = _np(g)
        out[f"{name}:sft:train_losses"] = np.asarray(losses)
        out[f"{name}:sft:trainer_losses"] = np.asarray(
            [h["loss"] for h in tr.history])


def llama_cases(inputs, out):
    """Each of LLAMA_MESHES (a 2-rank mesh on ranks 0-1) and the refused
    tp degree (4 ranks)."""
    from paddle_tpu_torch import distributed as D
    rank = D.get_rank()
    for name, shape in LLAMA_MESHES.items():
        if rank < int(np.prod(list(shape.values()))):
            _llama_mesh_case(inputs, out, rank, name, shape)
    try:
        D.shard_module(_llama(inputs), _mesh(4, tp=4), min_size=1)
        out["tp4_refusal"] = np.asarray("")
    except ValueError as e:
        out["tp4_refusal"] = np.asarray(str(e))


# ---------------------------------------------------------------- pipeline
class Mlp(nn.Module):
    """The reference tests' block: Linear(w, 2w), exact GELU, Linear(2w, w),
    with the reference's parameter names (``layers.<i>.<weight|bias>``)."""

    def __init__(self, width):
        super().__init__()
        from paddle_tpu_torch.nn.layers import Linear
        self.layers = nn.ModuleList([Linear(width, 2 * width, device="cpu"),
                                     nn.GELU(),
                                     Linear(2 * width, width, device="cpu")])

    def forward(self, x):
        for lyr in self.layers:
            x = lyr(x)
        return x


def embed_fn(ep, ids):
    return ep[ids]


def head_loss(hp, y, labels):
    logp = torch.log_softmax(y @ hp, dim=-1)
    return -torch.gather(logp, -1, labels[..., None]).mean()


# (name, pp, dp, M, mb, schedule) of the generic pipeline cases; their
# inputs are "<setup>:<tensor>" written by the parent
PIPE_CASES = (("pp1", 1, 1, "m4", "1f1b"), ("pp2", 2, 1, "m4", "1f1b"),
              ("pp4", 4, 1, "m4", "1f1b"), ("pp2_m8", 2, 1, "m8", "1f1b"),
              ("pp2_dp2", 2, 2, "dp", "1f1b"),
              ("zb_pp2_m4", 2, 1, "m4", "zb1"),
              ("zb_pp4_m4", 4, 1, "m4", "zb1"),
              ("zb_pp4_m8", 4, 1, "m8", "zb1"),
              ("zb_pp2_dp2", 2, 2, "dp", "zb1"),
              ("mem_pp2_m16", 2, 1, "m16", "1f1b"),
              ("mem_pp4_m16", 4, 1, "m16", "1f1b"))


def _pipe(inputs, setup, pp, remat=False):
    """The setup's stacked blocks as a PipelineLayer over ``pp`` stages
    (without remat: its first checkpoint costs a process seconds of lazy
    imports, and the parent's test covers it)."""
    from paddle_tpu_torch.distributed.pipeline import PipelineLayer
    stacked = {k.split(":", 2)[2]: _t(v) for k, v in inputs.items()
               if k.startswith(f"{setup}:stack:")}
    width = stacked["layers.0.weight"].shape[1]
    n_layers = stacked["layers.0.weight"].shape[0]
    return PipelineLayer.from_stacked(
        stacked, n_layers=n_layers, num_stages=pp,
        num_microbatches=int(inputs[f"{setup}:M"]), remat=remat,
        template=Mlp(width).to("meta"))


def pipeline_cases(inputs, out):
    """The generic pipeline (the reference tests' MLP blocks) and the
    pipelined Llama (4 ranks)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import pipeline as P
    rank = D.get_rank()
    for name, pp, dp, setup, sched in PIPE_CASES:
        n = pp * dp
        if rank >= n:
            continue
        mesh = _mesh(n, dp=dp, pp=pp)
        pipe = _pipe(inputs, setup, pp)
        stats = {}
        loss, ds, de, dh = P.pipeline_train_step(
            pipe, mesh, _t(inputs[f"{setup}:tokens"]),
            _t(inputs[f"{setup}:labels"]), head_loss_fn=head_loss,
            head_params=_t(inputs[f"{setup}:head"]), embed_fn=embed_fn,
            embed_params=_t(inputs[f"{setup}:emb"]),
            batch_axes=("dp",) if dp > 1 else (), schedule=sched,
            stats=stats)
        peaks = mesh.gather(torch.tensor([float(stats["peak_saved_inputs"])]),
                            (("dp", "pp"),))
        full = {k: mesh.gather(v, ("pp",)) for k, v in ds.items()}
        if rank == 0:
            out[f"{name}:loss"] = _np(loss)
            out[f"{name}:dembed"] = _np(de)
            out[f"{name}:dhead"] = _np(dh)
            for k, v in full.items():
                out[f"{name}:dstage:{k}"] = _np(v)
            out[f"{name}:ticks"] = np.asarray(stats["ticks"])
            out[f"{name}:peak_saved"] = _np(peaks)
            out[f"{name}:peak_deferred"] = np.asarray(stats["peak_deferred"])
    # the GPipe forward of PipelineLayer over pp = 4
    pipe = _pipe(inputs, "m4", 4)
    h = embed_fn(_t(inputs["m4:emb"]), _t(inputs["m4:tokens"]))
    fwd = pipe(h, mesh=_mesh(4, pp=4))
    if rank == 0:
        out["gpipe_forward"] = _np(fwd)
    _llama_pipeline_cases(inputs, out, rank)


LLAMA_PP = {"pp2": dict(pp=2), "pp2_dp2": dict(pp=2, dp=2),
            "pp2_tp2": dict(pp=2, tp=2)}


PP_LLAMA = dict(num_hidden_layers=4, hidden_size=32, num_attention_heads=4,
                num_key_value_heads=2, vocab_size=64, attention_bias=True)


def _llama_pp_case(inputs, out, rank, model, name, shape):
    """llama_pipeline_train_step under 1f1b and zb1 (loss, the gathered
    and un-interleaved gradients) and 3 AdamW steps of
    make_llama_pp_train_step over one mesh; results written by rank 0."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import llama as L
    ids, labels = _t(inputs["pp:ids"]), _t(inputs["pp:labels"])
    mesh = _mesh(int(np.prod(list(shape.values()))), **shape)
    ba = ("dp",) if shape.get("dp", 1) > 1 else ()
    for sched in ("1f1b", "zb1"):
        loss, grads = L.llama_pipeline_train_step(
            model, mesh, ids, labels, 4, batch_axes=ba, schedule=sched)
        full = L.gather_llama_pp_params(grads, mesh)
        if mesh.size("tp") > 1:
            full = L.tp_shuffle_llama_params(full, model.cfg,
                                             mesh.size("tp"), inverse=True)
        if rank == 0:
            out[f"llama_{name}_{sched}:loss"] = _np(loss)
            for k, v in full.flat().items():
                out[f"llama_{name}_{sched}:grad:{k}"] = _np(v)
    params, st = L.init_llama_pp_state(model, O.AdamW(learning_rate=1e-3),
                                       mesh)
    step = L.make_llama_pp_train_step(model, mesh, O.AdamW(learning_rate=1e-3),
                                      4, batch_axes=ba)
    losses = []
    for _ in range(3):
        params, st, lo = step(params, st, ids, labels)
        losses.append(float(lo))
    if rank == 0:
        out[f"llama_{name}:train_losses"] = np.asarray(losses)
    return mesh


def _llama_pipeline_cases(inputs, out, rank):
    from paddle_tpu_torch.models import llama as L
    model = _llama(inputs, "pp:w:", **PP_LLAMA)
    for name, shape in LLAMA_PP.items():
        if rank >= int(np.prod(list(shape.values()))):
            continue
        mesh = _llama_pp_case(inputs, out, rank, model, name, shape)
        if name == "pp2_tp2":
            bad = L._pp_local(L._pp_params(model, copy=False), mesh)
            try:
                L._pp_loss_and_grads(model.cfg, 4, mesh, bad,
                                     _t(inputs["pp:ids"]),
                                     _t(inputs["pp:labels"]), 4, ())
                out["wrong_layout"] = np.asarray("")
            except ValueError as e:
                out["wrong_layout"] = np.asarray(str(e))


# ---------------------------------------------------------- the 8-rank world
def hybrid_cases(inputs, out):
    """The reference's 8-device hybrids (8 ranks): the tiny Llama over dp2 x
    fsdp2 x tp2, and the pipelined Llama over pp2 x tp2 x dp2."""
    from paddle_tpu_torch import distributed as D
    rank = D.get_rank()
    _llama_mesh_case(inputs, out, rank, "dp2_fsdp2_tp2",
                     dict(dp=2, fsdp=2, tp=2))
    _llama_pp_case(inputs, out, rank, _llama(inputs, "pp:w:", **PP_LLAMA),
                   "pp2_tp2_dp2", dict(pp=2, tp=2, dp=2))


# ------------------------------------------------- sequence parallelism
# (name, mesh shape, function, options) of the attention cases; the parent
# writes "<name>:q" / ":k" / ":v" (and ":lens", ":mask", ":bias") global
# arrays and reads back the gathered output and gradients
SP_ATTN = {
    "ring_full": (dict(sp=4), "ring", dict(causal=False)),
    "ring_causal": (dict(sp=4), "ring", dict(causal=True)),
    "ring_gqa": (dict(sp=4), "ring", dict(causal=True)),
    "ring_window4": (dict(sp=4), "ring", dict(window=4)),
    "ring_window9": (dict(sp=4), "ring", dict(window=9)),
    "ring_window5_grads": (dict(sp=4), "ring", dict(window=5)),
    "ring_kvlens": (dict(sp=4), "ring", dict(varlen=True)),
    "ring_mask": (dict(sp=4), "ring", dict(masked=True)),
    "ring_bias": (dict(sp=4), "ring", dict(bias=True)),
    "ring_bias_mask_gqa": (dict(sp=4), "ring", dict(masked=True,
                                                    bias=True)),
    "ring_tp2_sp2": (dict(tp=2, sp=2), "ring", dict(head_spec="tp")),
    "zigzag": (dict(sp=4), "zigzag", {}),
    "zigzag_gqa": (dict(sp=4), "zigzag", {}),
    "uly_kvlens": (dict(sp=4), "ulysses", dict(varlen=True)),
    "uly_mask": (dict(sp=4), "ulysses", dict(masked=True)),
    "uly_window": (dict(sp=4), "ulysses", dict(window=10)),
    "uly_bias": (dict(sp=4), "ulysses", dict(bias=True)),
    "uly_bias_tp2_sp2": (dict(tp=2, sp=2), "ulysses",
                         dict(bias=True, head_spec="tp")),
    "uly_gqa_rep": (dict(sp=4), "ulysses", {}),
    "uly_tp2_sp2": (dict(tp=2, sp=2), "ulysses", dict(head_spec="tp")),
}


def _sp_attn_case(inputs, out, rank, name, shape, kind, opts):
    """One attention function over a mesh: this rank's pieces of the global
    q, k, v (and lens, mask, bias) in, the objective sum(out^2) summed over
    the ranks, the output and every input's gradient gathered back."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.ring_attention import bias_spec
    mesh = _mesh(4, **shape)
    opts = dict(opts)
    hs = opts.pop("head_spec", None)
    spec = (None, "sp", hs, None)
    g = {k: _t(inputs[f"{name}:{k}"]) for k in ("q", "k", "v")}
    extra, specs = [], []
    if opts.pop("varlen", False):
        extra.append(_t(inputs[f"{name}:lens"]))
        specs.append((None,))
        opts["varlen"] = True
    if opts.pop("masked", False):
        extra.append(_t(inputs[f"{name}:mask"]))
        specs.append((None, "sp" if kind == "ring" else None, None))
        opts["masked"] = True
    if opts.pop("bias", False):
        bias = _t(inputs[f"{name}:bias"])
        heads = hs if kind == "ring" else (hs, "sp")
        bspec = bias_spec(tuple(bias.shape), heads, batch_axes=None,
                          rows_axis="sp" if kind == "ring" else None)
        extra.append(bias)
        specs.append(bspec)
        opts["bias_shape"] = tuple(bias.shape)
    loc = {k: mesh.local(v, spec).clone().requires_grad_(True)
           for k, v in g.items()}
    ex = [mesh.local(x, sp_).clone() for x, sp_ in zip(extra, specs)]
    if "bias_shape" in opts:
        ex[-1].requires_grad_(True)
    if kind == "ring":
        fn = D.make_ring_attention(mesh, head_spec=hs, **opts)
    elif kind == "ulysses":
        fn = D.make_ulysses_attention(mesh, head_spec=hs, **opts)
    else:
        fn = D.make_zigzag_ring_attention(mesh)
    o = fn(loc["q"], loc["k"], loc["v"], *ex)
    o.square().sum().backward()
    res = {"out": mesh.gather(o, spec)}
    for k in ("q", "k", "v"):
        res[f"d{k}"] = mesh.gather(loc[k].grad, spec)
    if "bias_shape" in opts:
        res["dbias"] = mesh.gather(ex[-1].grad, specs[-1])
    if rank == 0:
        for k, v in res.items():
            out[f"{name}:{k}"] = _np(v)


# (name, config overrides, mesh shape) of the sp model cases: loss, every
# gradient and the logits of the tiny Llama / Mistral over one mesh
SP_MODELS = {
    "llama_ring_sp4": (dict(sequence_parallel="ring"), dict(sp=4)),
    "llama_uly_sp4": (dict(sequence_parallel="ulysses",
                           num_key_value_heads=4), dict(sp=4)),
    "llama_uly_gqa_sp4": (dict(sequence_parallel="ulysses"), dict(sp=4)),
    "llama_ring_tp2_sp2": (dict(sequence_parallel="ring",
                                num_key_value_heads=4), dict(tp=2, sp=2)),
    "llama_uly_tp2_sp2": (dict(sequence_parallel="ulysses",
                               num_key_value_heads=4), dict(tp=2, sp=2)),
    "llama_ring_dp2_sp2": (dict(sequence_parallel="ring"), dict(dp=2, sp=2)),
    "mistral_ring_sp4": (dict(sequence_parallel="ring", sliding_window=10),
                         dict(sp=4)),
    "mistral_uly_sp4": (dict(sequence_parallel="ulysses", sliding_window=10),
                        dict(sp=4)),
    "qwen2_uly_sp4": (dict(sequence_parallel="ulysses", attention_bias=True),
                      dict(sp=4)),
}
# (name, mode, mask kind) of the masked model cases (logits on valid rows)
SP_MASKS = {"pad_ring": ("ring", "pad"), "bcast_ring": ("ring", "bcast"),
            "additive_ring": ("ring", "additive"),
            "perhead_ring": ("ring", "perhead"),
            "pad_uly": ("ulysses", "pad"),
            "perhead_uly": ("ulysses", "perhead"),
            "dense_ring": ("ring", "dense"), "dense_uly": ("ulysses", "dense")}


def _sp_logits(model, mesh, ids, attn_mask=None):
    """The model's logits of the global batch: each rank runs its rows and
    sequence block (the mask whole along its sequence dims), gathered."""
    from paddle_tpu_torch.distributed.mesh import DATA_AXES
    from paddle_tpu_torch.train.step import _shard_batch
    rows = mesh.batch_sharding()
    with mesh, torch.no_grad():
        got = model(_shard_batch(mesh, ids),
                    None if attn_mask is None else rows(attn_mask))
    return mesh.gather(got, (DATA_AXES, "sp"))


def _sp_model_case(inputs, out, rank, name, cfg, shape):
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.sharded import global_grads
    from paddle_tpu_torch.train.step import loss_and_grads
    ids, labels = _t(inputs["sp:ids"]), _t(inputs["sp:labels"])
    mesh = _mesh(4, **shape)
    model = D.shard_module(_llama(inputs, f"{name}:w:", **cfg), mesh,
                           min_size=1)
    loss, _ = loss_and_grads(model, _lm_loss, [(ids, labels)], mesh)
    grads = global_grads(model)
    logits = _sp_logits(model, mesh, ids)
    if rank == 0:
        out[f"{name}:loss"] = _np(loss)
        out[f"{name}:logits"] = _np(logits)
        for k, g in grads.items():
            out[f"{name}:grad:{k}"] = _np(g)


def _sp_mask_case(inputs, out, rank, name, mode, kind):
    ids = _t(inputs["mask:ids"])
    mesh = _mesh(4, sp=4)
    model = _llama(inputs, "mask:w:", sequence_parallel=mode,
                   **SP_MASK_CFG)
    got = _sp_logits(model, mesh, ids, _t(inputs[f"mask:{kind}"]))
    if rank == 0:
        out[f"{name}:logits"] = _np(got)


SP_MASK_CFG = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
                   num_key_value_heads=2, vocab_size=64)


def _sp_train_case(inputs, out, rank):
    """dp2 x sp2: 3 AdamW steps of make_train_step and of Trainer.fit."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.train import (Trainer, TrainerArgs, init_state,
                                        make_train_step)
    ids, labels = _t(inputs["sp:ids"]), _t(inputs["sp:labels"])
    mesh = _mesh(4, dp=2, sp=2)
    name = "llama_ring_dp2_sp2"
    cfg = SP_MODELS[name][0]
    opt = O.AdamW(learning_rate=1e-3)
    state = init_state(_llama(inputs, f"{name}:w:", **cfg), opt, mesh)
    step = make_train_step(_lm_loss, opt, mesh=mesh)
    losses = []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    tr = Trainer(_llama(inputs, f"{name}:w:", **cfg),
                 O.AdamW(learning_rate=1e-3), _lm_loss,
                 TrainerArgs(max_steps=3, log_every=1), mesh=mesh,
                 device="cpu")
    tr.fit(iter([(ids, labels)] * 3))
    if rank == 0:
        out["dp2_sp2:train_losses"] = np.asarray(losses)
        out["dp2_sp2:trainer_losses"] = np.asarray(
            [h["loss"] for h in tr.history])


def _sp_refusals(inputs, out):
    """A train step over cp refuses; a model without an sp mode under an
    sp mesh refuses."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.train import make_train_step
    from paddle_tpu_torch.train.step import loss_and_grads
    try:
        make_train_step(_lm_loss, O.AdamW(), mesh=_mesh(4, cp=4))
        out["cp_refusal"] = np.asarray("")
    except NotImplementedError as e:
        out["cp_refusal"] = np.asarray(str(e))
    try:
        loss_and_grads(_llama(inputs, "llama_ring_sp4:w:"), _lm_loss,
                       [(_t(inputs["sp:ids"]), _t(inputs["sp:labels"]))],
                       _mesh(4, sp=4))
        out["no_mode_refusal"] = np.asarray("")
    except ValueError as e:
        out["no_mode_refusal"] = np.asarray(str(e))


def _merge_cases(inputs, out, rank):
    """The cp partial merges over 4 ranks: each rank's triple in, the
    merged triple out on every rank."""
    from paddle_tpu_torch.distributed.ring_attention import (
        finalize_partials, psum_merge_partials, ring_merge_partials)
    from paddle_tpu_torch.distributed.ulysses import ulysses_merge_partials
    mesh = _mesh(4, cp=4)
    o, m, l = (_t(inputs[f"merge:{k}"])[rank] for k in ("o", "m", "l"))
    for name, fn in (("ring", ring_merge_partials),
                     ("psum", psum_merge_partials),
                     ("ulysses", ulysses_merge_partials)):
        mo, mm, ml = fn(o, m, l, axis_name="cp", mesh=mesh)
        fin = finalize_partials(mo, ml)
        allf = mesh.gather(fin[None], (("cp",),))
        out[f"merge_{name}:out"] = _np(fin)
        out[f"merge_{name}:same"] = np.asarray(int(all(
            torch.equal(allf[0], allf[i]) for i in range(4))))


def sp_cases(inputs, out):
    """Ring, zigzag and Ulysses attention, the Llama family over sp (and
    tp x sp, dp x sp), the sp train step, the cp partial merges (4
    ranks)."""
    from paddle_tpu_torch import distributed as D
    rank = D.get_rank()
    for name, (shape, kind, opts) in SP_ATTN.items():
        _sp_attn_case(inputs, out, rank, name, shape, kind, opts)
    for name, (cfg, shape) in SP_MODELS.items():
        _sp_model_case(inputs, out, rank, name, cfg, shape)
    for name, (mode, kind) in SP_MASKS.items():
        _sp_mask_case(inputs, out, rank, name, mode, kind)
    _sp_train_case(inputs, out, rank)
    _sp_refusals(inputs, out)
    _merge_cases(inputs, out, rank)


# -------------------------------------------------------------------- MoE
# (name, mesh shape, capacity factor) of the layer cases: hidden 16,
# intermediate 32, 8 experts, top-2 (the reference tests' layer); the
# global batch [8, 8, 16]
MOE_LAYERS = {
    "route_dp2_cf0.5": (dict(dp=2), 0.5),
    "route_dp2_cf1.25": (dict(dp=2), 1.25),
    "route_fsdp2_cf0.5": (dict(fsdp=2), 0.5),
    "route_fsdp2_cf1.25": (dict(fsdp=2), 1.25),
    "route_dp2_sp2_cf0.5": (dict(dp=2, sp=2), 0.5),
    "ep2": (dict(ep=2), 8.0), "ep4": (dict(ep=4), 8.0),
    "dp2_ep2": (dict(dp=2, ep=2), 8.0),
    "ep2_dense": (dict(ep=2), 8.0),
    "ep4_sat": (dict(ep=4), 0.3),
}


def _moe_layer(inputs, cf):
    from paddle_tpu_torch.distributed.moe import MoELayer
    from paddle_tpu_torch.models.llama import LlamaConfig, _Init
    cfg = LlamaConfig.tiny()
    moe = MoELayer(16, 32, 8, k=2, capacity_factor=cf,
                   init=_Init(cfg, torch.device("cpu"), 0))
    with torch.no_grad():
        for k, v in moe.named_parameters():
            v.copy_(_t(inputs[f"moe:w:{k}"]))
    return moe


def _moe_layer_case(inputs, out, rank, name, shape, cf):
    """The layer over one mesh: this rank's rows (and sequence block) of
    the global batch; the objective mean(y^2) + 0.01 aux of the global
    batch, as each rank's share (its squares scaled to the global mean
    times the shard count, plus the aux it holds) averaged by
    sync_grads; output, aux, drop rate and every gradient gathered."""
    import os

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.mesh import DATA_AXES
    from paddle_tpu_torch.distributed.sharded import (TOKEN_AXES,
                                                      global_grads,
                                                      sync_grads)
    mesh = _mesh(int(np.prod(list(shape.values()))), **shape)
    moe = D.shard_module(_moe_layer(inputs, cf), mesh, min_size=1)
    x = _t(inputs["moe:x"])
    xl = mesh.batch_sharding()(x)
    if mesh.size("sp") > 1:
        xl = mesh.local(xl, (None, "sp", None))
    xl = xl.clone().requires_grad_(True)
    n = mesh.size(TOKEN_AXES)
    dense = name.endswith("_dense")
    if dense:
        os.environ["PT_GROUPED_GEMM"] = "0"
    try:
        with mesh:
            y, aux, met = moe(xl, return_metrics=True)
            (y.square().sum() * n / x.numel() + 0.01 * aux).backward()
    finally:
        os.environ.pop("PT_GROUPED_GEMM", None)
    sync_grads(moe, mesh)
    grads = global_grads(moe)
    spec = (DATA_AXES, "sp", None)
    res = {"y": mesh.gather(y, spec), "aux": aux, "drop": met["drop_rate"],
           "dx": mesh.gather(xl.grad, spec) / n,
           **{f"grad:{k}": v for k, v in grads.items()}}
    if rank == 0:
        for k, v in res.items():
            out[f"{name}:{k}"] = _np(v)


# (name, mesh shape, capacity factor) of the MoE LLM cases (the reference
# test's MoEConfig: Llama tiny, 4 experts, top-2, every 2nd layer MoE)
MOE_LLMS = {"llm_ep2": (dict(ep=2), 8.0),
            "llm_dp2_ep2": (dict(dp=2, ep=2), 8.0),
            "llm_ep2_tp2": (dict(ep=2, tp=2), 8.0),
            "llm_dp2_cf1.25": (dict(dp=2), 1.25),
            "llm_fsdp2_cf1.25": (dict(fsdp=2), 1.25)}


def _moe_llm(inputs, cf):
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.moe_llm import MoEConfig, MoEForCausalLM
    m = MoEForCausalLM(MoEConfig(base=LlamaConfig.tiny(), num_experts=4,
                                 top_k=2, capacity_factor=cf, moe_every=2),
                       device="cpu")
    pre = f"llm{cf}:w:"
    load_jax_state_dict(m, {k[len(pre):]: v for k, v in inputs.items()
                            if k.startswith(pre)})
    return m


def _moe_llm_case(inputs, out, rank, name, shape, cf):
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.sharded import global_grads
    from paddle_tpu_torch.train.step import loss_and_grads
    ids, labels = _t(inputs["llm:ids"]), _t(inputs["llm:labels"])
    mesh = _mesh(int(np.prod(list(shape.values()))), **shape)
    model = D.shard_module(_moe_llm(inputs, cf), mesh, min_size=1)
    whole = _moe_llm(inputs, cf).state_dict()
    sd = model.state_dict()
    loss, _ = loss_and_grads(model, _lm_loss, [(ids, labels)], mesh)
    grads = global_grads(model)
    if rank == 0:
        # the sharded model's state_dict(): every global array (the expert
        # stacks gathered over ep) under its name
        out[f"{name}:state_dict_global"] = np.asarray(int(
            set(sd) == set(whole)
            and all(torch.equal(sd[k], whole[k]) for k in whole)))
        out[f"{name}:loss"] = _np(loss)
        for k, g in grads.items():
            out[f"{name}:grad:{k}"] = _np(g)


def _ep_serving_case(inputs, out, rank):
    """Mixtral tiny through LLMEngine built and stepped under
    HybridMesh(ep=2) (ranks 0-1), and on one rank without a mesh."""
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.models.mixtral import (MixtralConfig,
                                                 MixtralForCausalLM)
    from paddle_tpu_torch.serving import LLMEngine, Request
    model = MixtralForCausalLM(MixtralConfig.tiny(), device="cpu")
    load_jax_state_dict(model, {k[len("mix:w:"):]: v
                                for k, v in inputs.items()
                                if k.startswith("mix:w:")})
    prompts = [inputs[f"mix:prompt{i}"] for i in range(3)]

    def run():
        eng = LLMEngine(model, num_slots=4, block_size=8, max_prompt_len=16,
                        max_seq_len=48)
        ids = [eng.add_request(Request(p, max_new_tokens=10))
               for p in prompts]
        eng.run()
        eng.assert_quiescent()
        return np.asarray([list(map(int, eng.requests[i].tokens))
                           for i in ids])

    single = run()
    with _mesh(2, ep=2):
        ep = run()
    if rank == 0:
        out["serve:single"] = single
        out["serve:ep2"] = ep


def moe_cases(inputs, out):
    """MoE over meshes: routing over the global batch under data axes,
    expert parallelism over ep (layer and MoE LLM), EP serving (4
    ranks)."""
    from paddle_tpu_torch import distributed as D
    rank = D.get_rank()
    for name, (shape, cf) in MOE_LAYERS.items():
        if rank < int(np.prod(list(shape.values()))):
            _moe_layer_case(inputs, out, rank, name, shape, cf)
    for name, (shape, cf) in MOE_LLMS.items():
        if rank < int(np.prod(list(shape.values()))):
            _moe_llm_case(inputs, out, rank, name, shape, cf)
    if rank < 2:
        _ep_serving_case(inputs, out, rank)


CASES = {"api": api_cases, "llama": llama_cases, "pipeline": pipeline_cases,
         "hybrid": hybrid_cases, "sp": sp_cases, "moe": moe_cases}
