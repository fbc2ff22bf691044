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


CASES = {"api": api_cases, "llama": llama_cases, "pipeline": pipeline_cases,
         "hybrid": hybrid_cases}
