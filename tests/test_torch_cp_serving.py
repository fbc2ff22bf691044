"""Context-parallel serving of the port (``LLMEngine(cp=N)``), 4 gloo ranks
— counterpart of ``tests/test_cp_serving.py``, case for case, on its
fixtures: the tiny fp32 Llama (2 layers, hidden 32, 4 heads over 2 KV
heads, vocabulary 64), a 1-layer draft, ``num_slots=2, block_size=4,
max_prompt_len=16, max_seq_len=48``, and its prompts.

The contract is the reference's: a cp > 1 engine emits exactly the tokens
its cp = 1 twin emits — plain decode, chunked prefill (ring and Ulysses
merges), speculative decoding, preemption and replay, radix prefix
reuse, int8 KV pools — because every rank merges the per-rank
online-softmax partials into the same result. The ranks run
``_torch_dist_child.cp_cases`` (cp = 2 on ranks 0-1, cp = 4 on all four;
every rank of the group writes its own streams, and all must agree). The
reference's own cp engine fails on this tree under jax 0.9.0 (its
``shard_map`` TypeError, ROADMAP.md queue 3), so the port's cp streams are
held to the port's cp = 1 engine and to the JAX package's engine at cp =
1, which is what the reference holds its cp engine to. Besides: the
``PT_CP=0`` kill switch, the ``too_long`` admission, the cp-scaled
admissible length, ``num_blocks`` rounding, the refusals by name, the
``serving.cp_gather`` fault site's atomicity and arming, the cp gauges,
``shard_occupancy`` and the roofline's merge-traffic term.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import FLIGHT, METRICS
from paddle_tpu_torch.observability.roofline import (ModelGeometry,
                                                     phase_bytes)
from paddle_tpu_torch.serving import Request
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
from tests import _torch_dist_child as child
from tests._torch_threads import one_torch_thread  # noqa: F401

STREAMS = sorted(child.CP_STREAMS)


@pytest.fixture(autouse=True)
def _port_hygiene():
    def clean():
        FAULTS.clear()
        METRICS.reset()
        FLIGHT.clear()
    clean()
    yield
    clean()


def _rand_prompts(n, rs, lo=3, hi=14, vocab=64):
    return [rs.randint(1, vocab, (int(l),))
            for l in rs.randint(lo, hi, size=n)]


def _prompt_sets():
    """The reference tests' prompts, by the seeds they draw them with."""
    rs = {i: np.random.RandomState(i) for i in range(13)}
    base = rs[5].randint(1, 64, (9,)).tolist()
    return {
        "plain": _rand_prompts(3, rs[0]),
        "chunked": [rs[1].randint(1, 64, (30,)), rs[1].randint(1, 64, (21,))],
        "ulysses": [rs[2].randint(1, 64, (26,))],
        "spec": _rand_prompts(3, rs[3]),
        "preempt": [rs[4].randint(1, 64, (int(n),)) for n in (10, 12, 8)],
        "radix": [base + [7], base + [11, 13], base[:6] + [3, 2]],
        "int8": _rand_prompts(3, rs[6]),
        "kill_switch": [rs[7].randint(1, 64, (6,))],
        "too_long": [rs[8].randint(1, 64, (30,))],
        "long": [rs[9].randint(1, 64, (40,))],
        "chaos": _rand_prompts(3, rs[10]),
        "one": [rs[11].randint(1, 64, (5,))],
        "gauges": _rand_prompts(2, rs[12]),
    }


@pytest.fixture(scope="module")
def jax_models():
    pt.seed(0)
    m = JLlama(JLlamaConfig.tiny(**child.CP_MODEL, dtype=jnp.float32))
    pt.seed(1)
    d = JLlama(JLlamaConfig.tiny(**child.CP_DRAFT, dtype=jnp.float32))
    return m, d


@pytest.fixture(scope="module")
def models(jax_models):
    """The port's model and draft with the reference's weights."""
    out = []
    for jm, cfg in zip(jax_models, (child.CP_MODEL, child.CP_DRAFT)):
        tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
        load_jax_state_dict(tm, jm.state_dict())
        out.append(tm)
    return out


@pytest.fixture(scope="module")
def started(jax_models, tmp_path_factory):
    inputs = {}
    for prefix, jm in zip(("cpm:", "cpd:"), jax_models):
        inputs.update({f"{prefix}{k}": np.asarray(v, np.float32)
                       for k, v in jm.state_dict().items()})
    for name, ps in _prompt_sets().items():
        for i, p in enumerate(ps):
            inputs[f"cpp:{name}:{i}"] = np.asarray(p, np.int64)
    return child.World("cp", inputs, 4, tmp_path_factory.mktemp("dist_cp"))


def _jax_run(jax_models, prompts, max_new, draft=False, **kw):
    args = dict(child.CP_ENGINE)
    args.update(kw)
    if draft:
        args["draft_model"] = jax_models[1]
    eng = JEngine(jax_models[0], **args)
    ids = [eng.add_request(JRequest(p, max_new_tokens=max_new))
           for p in prompts]
    eng.run()
    eng.assert_quiescent()
    return (np.asarray([list(map(int, eng.requests[i].tokens))
                        for i in ids]), eng)


def _jax_radix(jax_models, prompts):
    args = dict(child.CP_ENGINE)
    eng = JEngine(jax_models[0], **args)
    out = []
    for p in prompts:
        rid = eng.add_request(JRequest(p, max_new_tokens=6))
        while not eng.requests[rid].done:
            eng.step()
        out.append(list(map(int, eng.requests[rid].tokens)))
    eng.assert_quiescent()
    return np.asarray(out)


@pytest.fixture(scope="module")
def ref(started, jax_models, models):
    """The cp = 1 streams, the JAX package's and the port's, computed
    while the world runs."""
    sets = _prompt_sets()
    out = {}
    for name, (_, pset, kw, max_new, _) in child.CP_STREAMS.items():
        jkw = dict(kw)
        draft = jkw.pop("with_draft", False)
        jt, je = _jax_run(jax_models, sets[pset], max_new, draft, **jkw)
        tt, te = child.cp_run(*models, sets[pset], max_new, **kw)
        out[name] = {"jax": jt, "port": tt,
                     "jax_accepted": je.stats["spec_accepted"],
                     "port_accepted": te.stats["spec_accepted"]}
    out["radix"] = {"jax": _jax_radix(jax_models, sets["radix"]),
                    "port": child.cp_radix(models[0], sets["radix"], 1)[0]}
    out["chaos"] = {"port": child.cp_run(*models, sets["chaos"], 6)[0],
                    "jax": _jax_run(jax_models, sets["chaos"], 6)[0]}
    return out


@pytest.fixture(scope="module")
def world(started, ref):
    return started.result()


# ------------------------------------------------------------ mesh axis

def test_hybrid_mesh_cp_axis(world):
    """The cp engine's mesh: a cp axis of 2 over ranks 0-1."""
    for r in (0, 1):
        np.testing.assert_array_equal(world[r]["cp:mesh"], [2, 2, 1])


# ------------------------------------------------- greedy identity suite

def _identity(world, ref, name):
    cp = child.CP_STREAMS[name][0]
    want = ref[name]["port"]
    np.testing.assert_array_equal(ref[name]["jax"], want)
    for r in range(cp):
        got = world[r][f"cp:{name}:tokens"]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        assert world[r][f"cp:{name}:meta"][0] == cp
        assert world[r][f"cp:{name}:meta"][1] == 1
    return [world[r][f"cp:{name}:meta"] for r in range(cp)]


@pytest.mark.parametrize("cp", [2, 4])
def test_greedy_identity_plain_decode(world, ref, cp):
    _identity(world, ref, f"plain_cp{cp}")


@pytest.mark.parametrize("cp", [2, 4])
def test_greedy_identity_chunked_prefill(world, ref, cp):
    """Prompts longer than max_prompt_len ride the chunked prefill: K3's
    per-rank partials merged by the ring rotation."""
    _identity(world, ref, f"chunked_cp{cp}")


def test_greedy_identity_ulysses_merge(world, ref):
    """PT_CP_IMPL=ulysses swaps the chunk merge for the all_to_all (4
    heads over cp 2); the tokens still match cp = 1."""
    _identity(world, ref, "ulysses_cp2")


def test_greedy_identity_spec_decode(world, ref):
    """Draft-and-verify under cp: the verify chunk's partials merged, the
    rewind on the replicated lengths; speculation ran and accepted what
    the cp = 1 engines accepted."""
    metas = _identity(world, ref, "spec_cp2")
    for meta in metas:
        assert meta[2] > 0
        assert meta[3] == ref["spec_cp2"]["port_accepted"] \
            == ref["spec_cp2"]["jax_accepted"]


def test_greedy_identity_preempt_replay(world, ref):
    """A starved pool (18 blocks, 9 a rank) preempts and replays through
    the chunked prefill: the cp = 1 twin's tokens under the same
    pressure."""
    metas = _identity(world, ref, "preempt_cp2")
    assert all(meta[6] == 9 for meta in metas)


def test_greedy_identity_radix_prefix_reuse(world, ref):
    """Shared prefixes adopt trie blocks; the boundary block's
    copy-on-write crosses ranks (one sum over cp); the tokens match and
    the trie was hit."""
    np.testing.assert_array_equal(ref["radix"]["jax"], ref["radix"]["port"])
    for r in (0, 1):
        np.testing.assert_array_equal(world[r]["cp:radix:tokens"],
                                      ref["radix"]["port"])
        assert int(world[r]["cp:radix:hits"]) > 0


def test_greedy_identity_int8_kv(world, ref):
    """int8 pools shard with their scale pools; quantize-on-write lands in
    the owning rank."""
    metas = _identity(world, ref, "int8_cp2")
    assert all(meta[5] == 1 for meta in metas)


# ------------------------------------------------------- kill switches

def test_pt_cp_zero_collapses_to_single_device(models, monkeypatch):
    monkeypatch.setenv("PT_CP", "0")
    eng = child.cp_engine(models[0], cp=4)
    assert eng.cp == 1 and eng.exe.cp == 1 and eng.exe.mesh is None
    rid = eng.add_request(Request(_prompt_sets()["kill_switch"][0],
                                  max_new_tokens=4))
    out = eng.run()
    assert len(out[rid]) == 4
    eng.assert_quiescent()


def test_cp1_engine_unchanged(models):
    """cp = 1 builds no mesh, no cp axis, and bills no merge traffic."""
    eng = child.cp_engine(models[0], cp=1)
    assert eng.exe.mesh is None and eng.exe._cp_axis is None
    assert eng._geom.cp == 1


# ------------------------------------------------- admission: too_long

def test_too_long_finishes_gracefully_instead_of_wedging(models):
    eng = child.cp_engine(models[0], num_blocks=4)
    rid = eng.add_request(Request(_prompt_sets()["too_long"][0],
                                  max_new_tokens=8))
    req = eng.requests[rid]
    assert req.done and req.finish_reason == "too_long"
    assert not eng.queue
    rid2 = eng.add_request(Request([1, 2, 3], max_new_tokens=3))
    out = eng.run()
    assert len(out[rid2]) == 3
    eng.assert_quiescent()
    assert eng.stats["rejected"] >= 1


def test_admissible_length_scales_with_cp(world, models):
    """A 40-token prompt is too long for 8 blocks of 4 at cp = 1 and
    admitted at cp = 2 over 16 blocks, 8 on each rank."""
    small = child.cp_engine(models[0], num_blocks=8, max_seq_len=64)
    rid = small.add_request(Request(_prompt_sets()["long"][0],
                                    max_new_tokens=4))
    assert small.requests[rid].finish_reason == "too_long"
    for r in (0, 1):
        queued, n_tok, local_blocks, global_blocks = world[r]["cp:admit"]
        assert queued == 1 and n_tok == 4
        assert local_blocks == 8 and global_blocks == 16


def test_num_blocks_rounds_up_to_cp_multiple(world):
    assert int(world[0]["cp:rounded"]) == 10


# ------------------------------------------------- punted combinations

def test_cp_refuses_beams_lora_and_handoff(world):
    beam, handoff, lora = (str(m) for m in world[0]["cp:refusals"])
    assert "beam" in beam
    assert "handoff" in handoff
    assert "LoRA" in lora


# ---------------------------------------------- serving.cp_gather chaos

def test_chaos_cp_gather_exception_atomic(world, ref):
    """Two injected aborts before table growth: the run finishes with the
    clean run's tokens (the cp = 1 engines' too), quiescent and
    reconciled."""
    np.testing.assert_array_equal(ref["chaos"]["jax"], ref["chaos"]["port"])
    for r in (0, 1):
        fired, same, reconciled = world[r]["cp:chaos"]
        assert fired == 2 and same == 1 and reconciled == 1


def test_cp_gather_site_only_arms_above_cp1(models):
    eng = child.cp_engine(models[0])
    eng.add_request(Request(_prompt_sets()["one"][0], max_new_tokens=4))
    with FAULTS.scope("serving.cp_gather", exc=InjectedFault):
        eng.run()
    eng.assert_quiescent()
    assert FAULTS.hits["serving.cp_gather"] == 0


# ----------------------------------------------------- metrics + roofline

def test_cp_gauges_and_gather_histogram(world):
    for r in (0, 1):
        axis, count, shard0, shard1, geom_cp = world[r]["cp:gauges"]
        assert axis == 2 and count > 0 and shard0 >= 0 and shard1 >= 0
        assert geom_cp == 2


def test_shard_occupancy_buckets_contiguous_split():
    from paddle_tpu_torch.serving.cp import shard_occupancy
    assert shard_occupancy([0, 1, 7, 8, 15], 16, 2) == [3, 2]
    assert shard_occupancy([], 16, 4) == [0, 0, 0, 0]


def test_roofline_bills_cp_merge_traffic(models):
    g1 = ModelGeometry.from_config(models[0].cfg, dtype_bytes=4)
    g2 = replace(g1, cp=2)
    b1 = phase_bytes(g1, tokens=64, weight_passes=1, kv_read_positions=640)
    b2 = phase_bytes(g2, tokens=64, weight_passes=1, kv_read_positions=640)
    extra = 64 * g1.num_layers * g1.heads * (g1.head_dim + 2) * 4.0 * 0.5 * 2
    assert b2 == pytest.approx(b1 + extra)


def test_cp_needs_a_process_group_of_cp_ranks(models):
    """Without a process group of two ranks a cp = 2 engine raises for
    want of one (one process a rank)."""
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        child.cp_engine(models[0], cp=2)
