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


# ------------------------------------------------------------ checkpoints
# (ranks, mesh shape) of the checkpoint cases: two 2-rank meshes run side
# by side on ranks 0-1 and 2-3, the 4-rank one after them
CKPT_MESHES = {"fsdp2": ((0, 1), dict(fsdp=2)), "tp2": ((2, 3), dict(tp=2)),
               "dp2_fsdp2": ((0, 1, 2, 3), dict(dp=2, fsdp=2))}
# the resumed Trainer runs: mesh, then TrainerArgs of the interrupted run
CKPT_RESUME = {"fsdp2": ("fsdp2", {}), "tp2": ("tp2", {}),
               "dp2_fsdp2_async_pipelined": (
                   "dp2_fsdp2", dict(async_ckpt=True, pipeline_depth=1))}
CKPT_ELASTIC = {"kill_during_save": ("ckpt.rename", 1, 8),
                "step_exception": ("train.step", 4, 6)}


def _mesh_on(ranks, **shape):
    from paddle_tpu_torch.distributed import HybridMesh
    return HybridMesh(**shape, ranks=list(ranks), device="cpu")


def _sharded_llama(inputs, mesh, prefix="w:"):
    from paddle_tpu_torch import distributed as D
    return D.shard_module(_llama(inputs, prefix), mesh, min_size=1)


def _global_state(state):
    """{"p:<name>": global parameter, "s:<slot>:<name>": global slot} of a
    TrainState (a collective over the shard axes of a sharded one)."""
    from paddle_tpu_torch.distributed.sharded import _global, canonical_name
    m = state.model
    mesh = getattr(m, "_pt_mesh", None)
    out = {f"p:{k}": _np(v) for k, v in m.state_dict().items()}
    params = dict(m.named_parameters())
    for slot, d in state.opt_state.items():
        if not isinstance(d, dict):
            continue
        for n, t in d.items():
            if t is not None:
                g = (t if mesh is None else
                     _global(t, getattr(params[n], "_pt_shard", None), mesh))
                out[f"s:{slot}:{canonical_name(n)}"] = _np(g)
    return out


def _local_state(state):
    """This rank's live tensors of a TrainState (clones), its step and its
    generator's state."""
    out = {f"p:{n}": p.detach().clone()
           for n, p in state.model.named_parameters()}
    for slot, d in state.opt_state.items():
        if isinstance(d, dict):
            out.update({f"s:{slot}:{n}": t.clone() for n, t in d.items()
                        if t is not None})
    out["step"] = torch.tensor(int(state.step))
    out["rng"] = state.rng.get_state().clone()
    return out


def _equal_states(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _ckpt_trainer(inputs, mesh, prefix, d, steps, **args):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.train import Trainer, TrainerArgs
    return Trainer(_sharded_llama(inputs, mesh, prefix),
                   O.AdamW(learning_rate=1e-2), _lm_loss,
                   TrainerArgs(max_steps=steps, log_every=1, ckpt_dir=d,
                               **args), mesh=mesh, device="cpu")


def _resume_case(inputs, out, rank, name, mesh_name, args):
    """Trainer over a mesh: 3 steps straight, and 2 steps with a checkpoint
    at step 2 resumed by a fresh Trainer (a model of other weights, a new
    optimizer) for the third; the losses and the global parameters and
    AdamW slots of both."""
    ranks, shape = CKPT_MESHES[mesh_name]
    mesh = _mesh_on(ranks, **shape)
    root = os.path.join(str(inputs["ckpt:dir"]), f"resume_{name}")
    data = [(_t(inputs["ids"]), _t(inputs["labels"]))] * 3
    full = _ckpt_trainer(inputs, mesh, "w:", root + "_full", 3)
    full.fit(iter(data))
    part = _ckpt_trainer(inputs, mesh, "w:", root, 2, ckpt_every=2, **args)
    part.fit(iter(data))
    fresh = _ckpt_trainer(inputs, mesh, "w2:", root, 3, resume_reskip=True,
                          **args).resume()
    step_after = int(fresh.state.step)
    fresh.fit(iter(data))
    g_full, g_res = _global_state(full.state), _global_state(fresh.state)
    if rank == ranks[0]:
        key = f"resume:{name}"
        out[f"{key}:full_losses"] = np.asarray(
            [h["loss"] for h in full.history])
        out[f"{key}:resumed_losses"] = np.asarray(
            [h["loss"] for h in part.history + fresh.history])
        out[f"{key}:step"] = np.asarray(step_after)
        for k, v in g_full.items():
            out[f"{key}:full:{k}"] = v
        for k, v in g_res.items():
            out[f"{key}:resumed:{k}"] = v


def _roundtrip_case(inputs, out, rank, name):
    """Both formats, sync and async: a sharded TrainState after one AdamW
    step saved, restored into a fresh one (other weights, zero slots,
    another generator state); every live local tensor, the step and the
    generator equal, and the next step's loss the same bits."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.train import init_state, make_train_step
    from paddle_tpu_torch.train.checkpoint import CheckpointManager
    ranks, shape = CKPT_MESHES[name]
    mesh = _mesh_on(ranks, **shape)
    ids, labels = _t(inputs["ids"]), _t(inputs["labels"])
    opt = O.AdamW(learning_rate=1e-2)
    step = make_train_step(_lm_loss, opt, mesh=mesh)
    for fmt in ("global", "sharded"):
        for mode in ("sync", "async"):
            key = f"rt:{name}:{fmt}:{mode}"
            state = init_state(_sharded_llama(inputs, mesh), opt, mesh)
            state, _ = step(state, ids, labels)
            mgr = CheckpointManager(
                os.path.join(str(inputs["ckpt:dir"]), key.replace(":", "_")),
                use_orbax=fmt == "sharded", async_save=mode == "async")
            mgr.save(1, state)
            want = _local_state(state)
            mgr.wait()
            _, lo_a = step(state, ids, labels)
            fresh = init_state(_sharded_llama(inputs, mesh, "w2:"), opt, mesh)
            fresh.rng.manual_seed(12345)
            fresh = mgr.restore(fresh)
            got = _local_state(fresh)
            _, lo_b = step(fresh, ids, labels)
            out[f"{key}:eq"] = np.asarray(int(_equal_states(want, got)))
            out[f"{key}:next"] = np.asarray([float(lo_a), float(lo_b)])


def _cross_mesh_case(inputs, out, rank):
    """fsdp2 (ranks 0-1) saved in both formats, restored into tp2 on the
    same ranks and into one process on rank 0: the global parameters and
    slots equal what was saved."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.train import init_state, make_train_step
    from paddle_tpu_torch.train.checkpoint import CheckpointManager
    src = _mesh_on((0, 1), fsdp=2)
    opt = O.AdamW(learning_rate=1e-2)
    state = init_state(_sharded_llama(inputs, src), opt, src)
    state, _ = make_train_step(_lm_loss, opt, mesh=src)(
        state, _t(inputs["ids"]), _t(inputs["labels"]))
    mgrs = {fmt: CheckpointManager(
        os.path.join(str(inputs["ckpt:dir"]), f"cross_{fmt}"),
        use_orbax=fmt == "sharded") for fmt in ("global", "sharded")}
    for mgr in mgrs.values():
        mgr.save(1, state)
    want = _global_state(state)
    dst = _mesh_on((0, 1), tp=2)
    for fmt, mgr in mgrs.items():
        fresh = mgr.restore(init_state(_sharded_llama(inputs, dst, "w2:"),
                                       opt, dst))
        got = _global_state(fresh)
        if rank == 0:
            out[f"x:tp2:{fmt}:eq"] = np.asarray(int(
                set(got) == set(want) and all(np.array_equal(got[k], want[k])
                                              for k in want)))
            out[f"x:tp2:{fmt}:step"] = np.asarray(int(fresh.step))
    if rank == 0:
        for fmt, mgr in mgrs.items():
            fresh = mgr.restore(init_state(_llama(inputs, "w2:"), opt))
            got = _global_state(fresh)
            out[f"x:one:{fmt}:eq"] = np.asarray(int(
                set(got) == set(want) and all(np.array_equal(got[k], want[k])
                                              for k in want)))
            out[f"x:one:{fmt}:step"] = np.asarray(int(fresh.step))


def _jax_exchange_case(inputs, out, rank, name):
    """The JAX package's files (f32, bf16) loaded into a sharded model of
    the port (its global state_dict written back), and the port's global
    file of a sharded model for the parent to load in the JAX package."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.train.checkpoint import load, save
    from paddle_tpu_torch import distributed as D
    ranks, shape = CKPT_MESHES[name]
    mesh = _mesh_on(ranks, **shape)
    for dt, torch_dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m = D.shard_module(LlamaForCausalLM(LlamaConfig.tiny(dtype=torch_dt),
                                            device="cpu", seed=7),
                           mesh, min_size=1)
        load(str(inputs[f"ckpt:jax_{dt}"]), target=m)
        sd = m.state_dict()
        if rank == ranks[0]:
            for k, v in sd.items():
                out[f"jx:{name}:{dt}:{k}"] = (
                    v.view(torch.int16).numpy() if dt == "bf16" else _np(v))
    n = save(_sharded_llama(inputs, mesh), os.path.join(
        str(inputs["ckpt:dir"]), f"port_{name}.npz"))
    out[f"jx:{name}:written"] = np.asarray(n)


def _corrupt_shard_case(inputs, out, rank):
    """The sharded format over fsdp2 (ranks 0-1): steps 1 and 2 saved,
    rank 1's file of step 2 damaged; both ranks fall back to step 1 (rank
    0's own file of step 2 verifies: the decision is collective)."""
    import warnings
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.train import init_state, make_train_step
    from paddle_tpu_torch.train.checkpoint import CheckpointManager
    mesh = _mesh_on((0, 1), fsdp=2)
    ids, labels = _t(inputs["ids"]), _t(inputs["labels"])
    opt = O.AdamW(learning_rate=1e-2)
    step = make_train_step(_lm_loss, opt, mesh=mesh)
    d = os.path.join(str(inputs["ckpt:dir"]), "corrupt")
    mgr = CheckpointManager(d, max_to_keep=5, use_orbax=True)
    state = init_state(_sharded_llama(inputs, mesh), opt, mesh)
    state, _ = step(state, ids, labels)
    mgr.save(1, state)
    want = _local_state(state)
    state, _ = step(state, ids, labels)
    mgr.save(2, state)
    if rank == 1:
        f = os.path.join(d, "ckpt_00000002", "rank_00001.npz")
        with open(f, "r+b") as fh:
            fh.truncate(64)
    dist.barrier(group=mesh.group("fsdp"))
    fresh = init_state(_sharded_llama(inputs, mesh, "w2:"), opt, mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fresh = mgr.restore(fresh)
    out["corrupt:step"] = np.asarray(mgr.last_restored_step)
    out["corrupt:eq"] = np.asarray(int(_equal_states(want,
                                                     _local_state(fresh))))
    out["corrupt:warned"] = np.asarray(int(any(
        "fell back" in str(w.message) for w in caught)))


def _coordinated_case(inputs, out, rank):
    """The reference's multi-host checkpoint (tests/_multihost_child.py):
    rank 0 saves an unsharded state alone, a barrier, every rank restores
    rank 0's values."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.train.checkpoint import CheckpointManager
    state = {"w": torch.full((4,), 2.0 + rank), "step": 0}
    mgr = CheckpointManager(os.path.join(str(inputs["ckpt:dir"]), "coord"),
                            max_to_keep=2)
    if rank == 0:
        mgr.save(3, {"w": state["w"], "step": 3})
    D.barrier(axis_name="dp", mesh=_mesh(4, dp=4))
    restored = mgr.restore(state)
    out["coord:w"] = _np(restored["w"])
    out["coord:step"] = np.asarray(restored["step"])


def _elastic_case(inputs, out, rank, mesh_name):
    """ElasticRunner over a mesh: a kill in the step-4 save's rename (rank
    0 alone writes: the ranks' agreement fails the save on both) or an
    exception at the 5th step on every rank; one restart each, and the
    final parameters equal the uninterrupted run's bit for bit."""
    from paddle_tpu_torch.train.elastic import ElasticRunner
    from paddle_tpu_torch.utils.faults import FAULTS, InjectedCrash
    ranks, shape = CKPT_MESHES[mesh_name]
    mesh = _mesh_on(ranks, **shape)
    ids, labels = _t(inputs["ids"]), _t(inputs["labels"])

    def stream():
        while True:
            yield ids, labels

    for case, (site, hit, steps) in CKPT_ELASTIC.items():
        root = os.path.join(str(inputs["ckpt:dir"]),
                            f"elastic_{mesh_name}_{case}")

        def make(d, steps=steps):
            return lambda: _ckpt_trainer(inputs, mesh, "w:", d, steps,
                                         ckpt_every=2)

        FAULTS.install(site, on={hit}, exc=InjectedCrash)
        runner = ElasticRunner(make(root), max_restarts=2, backoff_s=0.0)
        state = runner.run(stream)
        FAULTS.clear()
        clean = ElasticRunner(make(root + "_clean"), max_restarts=0,
                              backoff_s=0.0).run(stream)
        key = f"el:{mesh_name}:{case}"
        out[f"{key}:restarts"] = np.asarray(runner.restarts)
        out[f"{key}:step"] = np.asarray(int(state.step))
        out[f"{key}:eq"] = np.asarray(int(all(
            torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                              clean.model.parameters()))))


def ckpt_cases(inputs, out):
    """Sharded checkpoints (4 ranks): the resumed Trainer, round trips in
    both formats, cross-mesh restores, the JAX package's files, a corrupt
    shard, the coordinated rank-0 checkpoint and elastic restarts."""
    from paddle_tpu_torch import distributed as D
    rank = D.get_rank()
    for name, (mesh_name, args) in CKPT_RESUME.items():
        if rank in CKPT_MESHES[mesh_name][0]:
            _resume_case(inputs, out, rank, name, mesh_name, args)
    for name, (ranks, _) in CKPT_MESHES.items():
        if rank in ranks:
            _roundtrip_case(inputs, out, rank, name)
    for name in ("fsdp2", "tp2"):
        if rank in CKPT_MESHES[name][0]:
            _jax_exchange_case(inputs, out, rank, name)
            _elastic_case(inputs, out, rank, name)
    if rank < 2:
        _cross_mesh_case(inputs, out, rank)
        _corrupt_shard_case(inputs, out, rank)
    dist.barrier()
    _coordinated_case(inputs, out, rank)


# ------------------------------------------------ context-parallel serving
# the reference tests' model (tests/test_cp_serving.py) and engine
CP_MODEL = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
                num_key_value_heads=2, vocab_size=64)
CP_DRAFT = dict(CP_MODEL, num_hidden_layers=1)
CP_ENGINE = dict(num_slots=2, block_size=4, max_prompt_len=16,
                 max_seq_len=48)
# name: (cp, prompt set, engine arguments, max_new_tokens, environment);
# the prompt sets are the reference tests' (the parent draws them)
CP_STREAMS = {
    "plain_cp2": (2, "plain", {}, 6, {}),
    "plain_cp4": (4, "plain", {}, 6, {}),
    "chunked_cp2": (2, "chunked", {}, 6, {}),
    "chunked_cp4": (4, "chunked", {}, 6, {}),
    "ulysses_cp2": (2, "ulysses", {}, 6, {"PT_CP_IMPL": "ulysses"}),
    "spec_cp2": (2, "spec", {"with_draft": True}, 8, {}),
    "preempt_cp2": (2, "preempt", dict(num_slots=3, num_blocks=18,
                                       preemption=True,
                                       prefix_caching=False), 6, {}),
    "int8_cp2": (2, "int8", dict(kv_dtype="int8"), 6, {}),
}


def _cp_models(inputs):
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    out = []
    for prefix, cfg in (("cpm:", CP_MODEL), ("cpd:", CP_DRAFT)):
        m = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
        load_jax_state_dict(m, {k[len(prefix):]: v for k, v in inputs.items()
                                if k.startswith(prefix)})
        out.append(m)
    return out


def _cp_prompts(inputs, name):
    return [inputs[k] for k in sorted(
        (k for k in inputs if k.startswith(f"cpp:{name}:")),
        key=lambda k: int(k.rsplit(":", 1)[1]))]


def cp_engine(model, draft=None, **kw):
    from paddle_tpu_torch.serving import LLMEngine
    args = dict(CP_ENGINE)
    if kw.pop("with_draft", False):
        args["draft_model"] = draft
    args.update(kw)
    return LLMEngine(model, **args)


def cp_run(model, draft, prompts, max_new, **kw):
    """The reference tests' ``_run``: every prompt submitted, the engine
    run dry; (streams [n, max_new], engine)."""
    from paddle_tpu_torch.serving import Request
    eng = cp_engine(model, draft, **kw)
    ids = [eng.add_request(Request(p, max_new_tokens=max_new))
           for p in prompts]
    eng.run()
    eng.assert_quiescent()
    return np.asarray([list(map(int, eng.requests[i].tokens))
                       for i in ids]), eng


def cp_radix(model, prompts, cp):
    """Sequential submission (each request run to its end before the
    next), so later prompts adopt the trie's blocks."""
    from paddle_tpu_torch.serving import Request
    eng = cp_engine(model, num_slots=2, cp=cp)
    out = []
    for p in prompts:
        rid = eng.add_request(Request(p, max_new_tokens=6))
        while not eng.requests[rid].done:
            eng.step()
        out.append(list(map(int, eng.requests[rid].tokens)))
    eng.assert_quiescent()
    return np.asarray(out), eng


def _cp_stream_cases(inputs, out, rank, model, draft):
    for name, (cp, pset, kw, max_new, env) in CP_STREAMS.items():
        if rank >= cp:
            continue
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            toks, eng = cp_run(model, draft, _cp_prompts(inputs, pset),
                               max_new, cp=cp, **kw)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[f"cp:{name}:tokens"] = toks
        out[f"cp:{name}:meta"] = np.asarray([
            eng.cp, int(eng.exe.mesh is not None), eng.stats["spec_ticks"],
            eng.stats["spec_accepted"], eng.stats["preemptions"],
            int(bool(eng.cache.k_scale_store)),
            eng.cache.k_store[0].shape[0] - 1])


def _cp_engine_cases(inputs, out, rank, model):
    """cp = 2 on ranks 0-1: radix reuse, admission, rounding, refusals,
    the fault site, the gauges."""
    from paddle_tpu_torch.observability.metrics import METRICS
    from paddle_tpu_torch.serving import Request
    from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
    toks, eng = cp_radix(model, _cp_prompts(inputs, "radix"), 2)
    st = eng.mgr.cache_stats
    out["cp:radix:tokens"] = toks
    out["cp:radix:hits"] = np.asarray(st.get("token_hits", 0)
                                      + st.get("hit_blocks", 0))
    out["cp:mesh"] = np.asarray([eng.exe.mesh.cp, eng.exe.mesh.size("cp"),
                                 int("cp" in eng.exe.mesh.axis_names)])
    # admission: 40 tokens in 16 global blocks of 4 (8 a rank)
    big = cp_engine(model, num_blocks=16, max_seq_len=64, cp=2)
    rid = big.add_request(Request(list(_cp_prompts(inputs, "long")[0]),
                                  max_new_tokens=4))
    queued = int(not big.requests[rid].done)
    res = big.run()
    big.assert_quiescent()
    out["cp:admit"] = np.asarray([queued, len(res[rid]),
                                  big.cache.k_store[0].shape[0] - 1,
                                  big.mgr.num_blocks])
    out["cp:rounded"] = np.asarray(cp_engine(model, num_blocks=9,
                                             cp=2).mgr.num_blocks)
    # refusals by name
    eng = cp_engine(model, cp=2)
    msgs = []
    for fn in (lambda: eng.add_request(Request([1, 2, 3], max_new_tokens=2,
                                               num_beams=2)),
               lambda: eng.extract_sequence(0),
               lambda: cp_engine(model, cp=2, adapter_store=object())):
        try:
            fn()
            msgs.append("")
        except NotImplementedError as e:
            msgs.append(str(e))
    out["cp:refusals"] = np.asarray(msgs)
    # the fault site: two injected aborts, the clean run's tokens
    prompts = _cp_prompts(inputs, "chaos")
    clean, _ = cp_run(model, None, prompts, 6, cp=2)
    eng = cp_engine(model, cp=2)
    ids = [eng.add_request(Request(p, max_new_tokens=6)) for p in prompts]
    fired = 0
    with FAULTS.scope("serving.cp_gather", on={1, 3}, exc=InjectedFault):
        while eng.has_work():
            try:
                eng.step()
            except InjectedFault:
                fired += 1
    fin = eng.pop_finished()
    got = np.asarray([list(map(int, fin[i].tokens)) for i in ids])
    eng.assert_quiescent()
    out["cp:chaos"] = np.asarray([fired, int(np.array_equal(got, clean)),
                                  int(eng.kv.reconcile()["ok"])])
    # the gauges and the gather histogram
    METRICS.reset()
    _, eng = cp_run(model, None, _cp_prompts(inputs, "gauges"), 6, cp=2)
    out["cp:gauges"] = np.asarray([
        METRICS.get("serving_cp_axis_size").value(),
        METRICS.get("serving_cp_gather_seconds").value()["count"],
        METRICS.get("serving_cp_shard_blocks").value(shard="0"),
        METRICS.get("serving_cp_shard_blocks").value(shard="1"),
        eng._geom.cp])


def cp_cases(inputs, out):
    """Context-parallel serving (4 ranks): the reference tests' greedy
    streams at cp 2 (ranks 0-1) and 4, and the engine's cp behaviours."""
    from paddle_tpu_torch import distributed as D
    rank = D.get_rank()
    model, draft = _cp_models(inputs)
    _cp_stream_cases(inputs, out, rank, model, draft)
    if rank < 2:
        _cp_engine_cases(inputs, out, rank, model)


# -------------------------------------------------------------- gpt mesh
GPT_MESHES = {"tp2": dict(tp=2), "dp2_tp2": dict(dp=2, tp=2)}
GPT_TINY = dict(num_attention_heads=4)


def _gpt(inputs, prefix="w:"):
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    m = GPTForCausalLM(GPTConfig.tiny(**GPT_TINY), device="cpu")
    load_jax_state_dict(m, {k[len(prefix):]: v for k, v in inputs.items()
                            if k.startswith(prefix)})
    return m


def _gpt_mesh_case(inputs, out, rank, name, shape):
    """The tiny GPT sharded over one mesh (``shard_module``'s rule: qkv /
    fc1 columns, proj / fc2 rows, wte vocab rows): loss, logits, every
    global gradient, the global state_dict and 3 steps of
    ``make_train_step(AdamW(2e-4, weight_decay=0.1), mesh=)``, as the
    reference's bench_gpt3_tp trains it; results written by rank 0."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.distributed.mesh import DATA_AXES
    from paddle_tpu_torch.distributed.sharded import global_grads
    from paddle_tpu_torch.train import init_state, make_train_step
    from paddle_tpu_torch.train.step import loss_and_grads
    ids, labels = _t(inputs["ids"]), _t(inputs["labels"])
    mesh = _mesh(int(np.prod(list(shape.values()))), **shape)
    model = D.shard_module(_gpt(inputs), mesh, min_size=1)
    rows = mesh.batch_sharding()
    with torch.no_grad():
        logits = mesh.gather(model(rows(ids)), (DATA_AXES,))
    loss, _ = loss_and_grads(model, _lm_loss, [(ids, labels)], mesh)
    grads = global_grads(model)
    sd = model.state_dict()
    opt = O.AdamW(learning_rate=2e-4, weight_decay=0.1)
    state = init_state(_gpt(inputs), opt, mesh)
    step = make_train_step(_lm_loss, opt, mesh=mesh)
    losses = []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    if rank == 0:
        out[f"{name}:logits"] = _np(logits)
        out[f"{name}:loss"] = _np(loss)
        for k, g in grads.items():
            out[f"{name}:grad:{k}"] = _np(g)
        for k, v in sd.items():
            out[f"{name}:sd:{k}"] = _np(v)
        out[f"{name}:train_losses"] = np.asarray(losses)
        out[f"{name}:local_wte"] = np.asarray(
            dict(model.named_parameters())["wte"].shape)


def gpt_cases(inputs, out):
    """Each of GPT_MESHES on its first ranks, and the refused tp degree
    (4 ranks: tp=4 over a GPT of 2 heads)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    rank = D.get_rank()
    for name, shape in GPT_MESHES.items():
        if rank < int(np.prod(list(shape.values()))):
            _gpt_mesh_case(inputs, out, rank, name, shape)
    try:
        D.shard_module(GPTForCausalLM(GPTConfig.tiny(), device="cpu"),
                       _mesh(4, tp=4), min_size=1)
        out["tp4_refusal"] = np.asarray("")
    except ValueError as e:
        out["tp4_refusal"] = np.asarray(str(e))


CASES = {"api": api_cases, "llama": llama_cases, "pipeline": pipeline_cases,
         "hybrid": hybrid_cases, "sp": sp_cases, "moe": moe_cases,
         "ckpt": ckpt_cases, "cp": cp_cases, "gpt": gpt_cases}
