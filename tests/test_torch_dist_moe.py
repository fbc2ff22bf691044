"""The port's MoE over a mesh, 4 gloo ranks, against the JAX package's
single-device functions on the gathered inputs.

Counterpart of the expert-parallel cases of ``tests/test_moe_dispatch.py``
and ``tests/test_seq_pipeline_moe.py`` and of the ep leg of
``tests/test_serving_moe.py``. The reference's own sharded runs fail on
this tree under jax 0.9.0 (ROADMAP.md queue 3), so the port is held to the
single-device ``MoELayer`` / ``MoEForCausalLM`` on the gathered batch.
Where the reference used 8 devices (``HybridMesh(ep=8)``, dp2 x fsdp4) the
port's cases use 4 (ep4, dp2 x ep2) or 2 (ep2, dp2, fsdp2).

* Routing over the global batch (dp2, fsdp2 and dp2 x sp2 with ep = 1, at
  capacity factors 0.5 and 1.25, which drop tokens): the layer's output,
  aux loss, drop rate and every gradient equal the single-device layer's
  on the whole batch — a rank routing only its own rows fails these.
* Expert parallelism (ep2, ep4, dp2 x ep2, the dense path behind
  ``PT_GROUPED_GEMM=0``) without drops equals the single-device layer;
  under saturation (ep4, factor 0.3) each rank's LOCAL capacity decides,
  held to the JAX ``top_k_route`` / ``sparse_dispatch`` applied per shard.
* The MoE LLM's sharded step (ep2, dp2 x ep2, ep2 x tp2, and dp2 / fsdp2
  at capacity factor 1.25): loss and every gradient, the ep-sharded expert
  stacks' gradients among them (summed over dp / fsdp only).
* Mixtral served by LLMEngine under HybridMesh(ep=2): greedy streams token
  for token those of the engine on one rank.

Tolerances as in PR 22 (fp32 on both sides): loss and aux rtol 2e-4,
outputs and every gradient within 1e-4 of their RMS; drop rates exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.distributed.moe import (MoELayer as JMoE, expert_mlp_apply,
                                        sparse_combine, sparse_dispatch,
                                        top_k_route)
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from paddle_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from paddle_tpu.models.moe_llm import MoEConfig as JMoEConfig
from paddle_tpu.models.moe_llm import MoEForCausalLM as JMoELLM
from tests import _torch_dist_child as child
from tests._torch_dist_ref import numpy_module, rel

ROUTE = sorted(n for n in child.MOE_LAYERS if n.startswith("route_"))
EP = ["ep2", "ep4", "dp2_ep2", "ep2_dense"]
SAT_SHARDS = 4


def _jmoe(cf):
    return numpy_module(lambda: JMoE(16, 32, 8, k=2, capacity_factor=cf,
                                     dtype=jnp.float32), 0)


def _x():
    return np.random.RandomState(0).randn(8, 8, 16).astype(np.float32)


def _jllm(cf):
    return numpy_module(lambda: JMoELLM(JMoEConfig(
        base=JLlamaConfig.tiny(), num_experts=4, top_k=2,
        capacity_factor=cf, moe_every=2)), 1)


def _llm_batch():
    ids = np.random.RandomState(0).randint(0, 64, (4, 16))
    return ids, np.concatenate([ids[:, 1:], np.full((4, 1), -100)], 1)


def _prompts(vocab, n=3, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (int(l),))
            for l in rs.randint(3, 12, size=n)]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    inputs = {"moe:x": _x()}
    inputs.update({f"moe:w:{k}": np.asarray(v, np.float32)
                   for k, v in _jmoe(1.25).state_dict().items()})
    ids, labels = _llm_batch()
    inputs.update({"llm:ids": ids, "llm:labels": labels})
    for cf in (8.0, 1.25):
        inputs.update({f"llm{cf}:w:{k}": np.asarray(v, np.float32)
                       for k, v in _jllm(cf).state_dict().items()})
    mix = numpy_module(lambda: JMixtral(JMixtralConfig.tiny()), 2)
    inputs.update({f"mix:w:{k}": np.asarray(v, np.float32)
                   for k, v in mix.state_dict().items()})
    for i, p in enumerate(_prompts(mix.cfg.vocab_size)):
        inputs[f"mix:prompt{i}"] = p
    return child.World("moe", inputs, 4, tmp_path_factory.mktemp("dist_moe"))


def _layer_ref(cf):
    """The single-device layer on the whole batch: y, aux, drop rate and
    the gradients of mean(y^2) + 0.01 aux."""
    def obj(m, x):
        y, aux, met = m(x, return_metrics=True)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux, met["drop_rate"])

    (_, (y, aux, drop)), (gm, gx) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(_jmoe(cf), jnp.asarray(_x()))
    return _pack(y, aux, drop, gm, gx)


def _pack(y, aux, drop, gm, gx):
    return {"y": np.asarray(y), "aux": float(aux), "drop": float(drop),
            "dx": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gm.state_dict().items()}}


def _per_shard_ref(cf):
    """Expert parallelism's semantics from the JAX routing pieces: each of
    SAT_SHARDS row shards routed at LOCAL capacity (top_k_route,
    sparse_dispatch, the experts, sparse_combine), me / ce averaged over
    the shards for the aux loss, the drop rate the shards' mean."""
    def obj(m, x):
        ys, mes, ces, keeps = [], [], [], []
        for xs in jnp.split(x, SAT_SHARDS, axis=0):
            b, s, h = xs.shape
            xt = xs.reshape(b * s, h)
            cap = m._capacity(b * s)
            route, _, _ = top_k_route(xt @ m.gate_w, m.k, cap)
            x_e, dest = sparse_dispatch(xt, route, m.num_experts, cap)
            y_e = expert_mlp_apply(x_e, m.experts.gate_up, m.experts.down)
            ys.append(sparse_combine(y_e, route, dest, b * s).reshape(b, s,
                                                                      h))
            mes.append(route["me"])
            ces.append(route["ce"])
            keeps.append(jnp.mean(route["keep"].astype(jnp.float32)))
        y = jnp.concatenate(ys, 0)
        aux = m.num_experts * jnp.sum(jnp.mean(jnp.stack(mes), 0)
                                      * jnp.mean(jnp.stack(ces), 0))
        drop = 1.0 - jnp.mean(jnp.stack(keeps))
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux, drop)

    (_, (y, aux, drop)), (gm, gx) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(_jmoe(cf), jnp.asarray(_x()))
    return _pack(y, aux, drop, gm, gx)


@pytest.fixture(scope="module")
def ref(started):
    """The JAX package's single-device results, computed while the world
    runs."""
    layers = {cf: _layer_ref(cf) for cf in {cf for _, cf in
                                            child.MOE_LAYERS.values()}}
    out = {name: layers[cf] for name, (_, cf) in child.MOE_LAYERS.items()}
    out["ep4_sat"] = _per_shard_ref(0.3)
    ids, labels = (jnp.asarray(a) for a in _llm_batch())
    step = jax.jit(jax.value_and_grad(lambda m: m.loss(ids, labels)))
    for cf in (8.0, 1.25):
        loss, grads = step(_jllm(cf))
        out[f"llm{cf}"] = {"loss": float(loss),
                           "grads": {k: np.asarray(v) for k, v in
                                     grads.state_dict().items()}}
    return out


@pytest.fixture(scope="module")
def world(started, ref):
    return started.result()[0]


def _check_layer(world, want, name):
    assert world[f"{name}:y"].shape == want["y"].shape
    assert rel(world[f"{name}:y"], want["y"]) <= 1e-4
    np.testing.assert_allclose(float(world[f"{name}:aux"]), want["aux"],
                               rtol=2e-4)
    assert float(world[f"{name}:drop"]) == pytest.approx(want["drop"],
                                                         abs=1e-6)
    assert rel(world[f"{name}:dx"], want["dx"]) <= 1e-4
    got = {k[len(f"{name}:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{name}:grad:")}
    assert set(got) == set(want["grads"])
    for k, g in got.items():
        assert rel(g, want["grads"][k]) <= 1e-4, k


@pytest.mark.parametrize("name", ROUTE)
def test_global_routing_matches_single_device(world, ref, name):
    """dp2 / fsdp2 / dp2 x sp2 with ep = 1: capacity from the global token
    count, global choice-major queue positions, me / ce / drop averaged
    over the token axes — the single-device layer on the gathered batch,
    tokens dropped included (factor 0.5 and 1.25). The reference's data
    mesh case is dp2 x fsdp4 (8 devices); here 2 and 4 ranks."""
    want = ref[name]
    if name.endswith("cf0.5"):
        assert want["drop"] > 0.0
    _check_layer(world, want, name)


@pytest.mark.parametrize("name", EP)
def test_expert_parallel_layer_matches_single_device(world, ref, name):
    """_forward_ep over ep2 / ep4 / dp2 x ep2 (the dense capacity path
    too): the all_to_all dispatch, compaction, grouped SwiGLU and reverse
    all_to_all give the single-device layer's output, aux and gradients
    (no drops at factor 8); the expert stacks' gradients gathered over
    ep. The reference's case runs ep=8; here ep4 is the widest."""
    assert ref[name]["drop"] == 0.0
    _check_layer(world, ref[name], name)


def test_ep_saturation_drops_at_local_capacity(world, ref):
    """ep4 at factor 0.3: each rank's capacity is local (the reference's
    per-rank semantics), so drops happen per shard: output, aux, drop rate
    and gradients equal the per-shard JAX routing (the reference
    saturates ep=4 too)."""
    want = ref["ep4_sat"]
    assert want["drop"] > 0.0
    assert np.isfinite(world["ep4_sat:y"]).all()
    _check_layer(world, want, "ep4_sat")


@pytest.mark.parametrize("name", sorted(child.MOE_LLMS))
def test_moe_llm_sharded_step_matches_single_device(world, ref, name):
    """The MoE LLM's mesh step (loss_and_grads): ep2, dp2 x ep2 and ep2 x
    tp2 at factor 8 (the reference's ep x tp loss equality), dp2 and
    fsdp2 at the default 1.25 (global routing): loss and every gradient,
    the ep-sharded expert stacks' reduced over dp / fsdp only, and the
    sharded model's state_dict() the global arrays."""
    want = ref[f"llm{child.MOE_LLMS[name][1]}"]
    assert int(world[f"{name}:state_dict_global"]) == 1
    np.testing.assert_allclose(float(world[f"{name}:loss"]), want["loss"],
                               rtol=2e-4)
    got = {k[len(f"{name}:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{name}:grad:")}
    assert set(got) == set(want["grads"])
    for k, g in got.items():
        assert rel(g, want["grads"][k]) <= 1e-4, k


def test_expert_parallel_serving_matches_single_device(world):
    """LLMEngine built and stepped inside HybridMesh(ep=2): each rank holds
    the whole batch, the MoE layers take their share of it over ep and
    gather the outputs — greedy streams token for token the one-rank
    engine's."""
    single, ep = world["serve:single"], world["serve:ep2"]
    assert single.shape == ep.shape == (3, 10)
    np.testing.assert_array_equal(ep, single)
