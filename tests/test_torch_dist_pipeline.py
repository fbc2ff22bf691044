"""The port's 1F1B and zero-bubble pipeline schedules on 4 gloo ranks,
against the JAX package's sequential (single-device) runs.

Counterparts of ``tests/test_pipeline_1f1b.py`` and
``tests/test_pipeline_zb.py``: the same MLP blocks, embedding and head
(``_setup``, ``_seq_ref`` of the reference's file) and the tiny Llama's
pipeline functions. The reference proves its memory claim on the jaxpr (a
ring of 2pp-1 saved stage inputs, no [M, ...] stash); the port counts the
stage inputs each rank holds (``stats=``) and the ticks it runs.
The reference's ``test_1f1b_composes_with_tp[dp=2]`` (pp2 x tp2 x dp2)
needs 8 ranks: ``test_torch_dist_hybrid.py``.

Tolerances (fp32): losses rtol 2e-4 and every gradient within 1e-4 of its
RMS (max abs error) against the sequential reference, three AdamW steps
rtol 3e-4 (``test_parallel.py:126``); zb1 against 1f1b bit for bit (the
same forward, the deferred weight gradients added in the same microbatch
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.pipeline import PipelineLayer as JPipelineLayer
from paddle_tpu.models import llama as JL
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from paddle_tpu_torch.distributed import pipeline as P
from paddle_tpu_torch.models import llama as L
from tests import _torch_dist_child as child
from tests._torch_dist_ref import numpy_module, rel
from tests.test_pipeline_1f1b import _embed, _mlp, _seq_ref

# the reference files' _setup sizes: 8 blocks of width 8 (M microbatches
# of mb rows of 6 tokens, vocabulary 13)
SETUPS = {"m4": dict(M=4, mb=2), "m8": dict(M=8, mb=2),
          "dp": dict(M=4, mb=4), "m16": dict(M=16, mb=2)}
# qkv biases on: every pipelined-Llama case runs their interleave, slice
# and local add (the reference's qkv-bias optimizer loop)
LLAMA = child.PP_LLAMA


def _setup(name, width=8, vocab=13, seq=6):
    """(stacked blocks, embedding, head, tokens, labels) of a setup: the
    reference's MLP blocks with numpy-drawn weights."""
    M, mb = SETUPS[name]["M"], SETUPS[name]["mb"]
    stacked = numpy_module(lambda: JPipelineLayer(
        [_mlp(width) for _ in range(8)], num_stages=1).stacked, 0)
    rs = np.random.RandomState(0)
    emb_w = jnp.asarray(rs.randn(vocab, width).astype(np.float32) * 0.1)
    head_w = jnp.asarray(rs.randn(width, vocab).astype(np.float32) * 0.1)
    tokens = jnp.asarray(rs.randint(0, vocab, (M * mb, seq)))
    labels = jnp.asarray(rs.randint(0, vocab, (M * mb, seq)))
    return stacked, emb_w, head_w, tokens, labels


def _batch(seed, n, vocab=64, seq=16):
    ids = np.random.RandomState(seed).randint(0, vocab, (n, seq))
    return ids, np.concatenate([ids[:, 1:], np.full((n, 1), -100)], axis=1)


def _llama():
    return numpy_module(lambda: JL.LlamaForCausalLM(
        JL.LlamaConfig.tiny(**LLAMA)), 0)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    inputs = {}
    for name, kw in SETUPS.items():
        stacked, emb_w, head_w, tokens, labels = _setup(name)
        inputs.update({f"{name}:M": np.asarray(kw["M"]),
                       f"{name}:tokens": np.asarray(tokens),
                       f"{name}:labels": np.asarray(labels),
                       f"{name}:emb": np.asarray(emb_w),
                       f"{name}:head": np.asarray(head_w),
                       **{f"{name}:stack:{k}": np.asarray(v)
                          for k, v in stacked.state_dict().items()}})
    ids, labels = _batch(0, 8)
    inputs.update({"pp:ids": ids, "pp:labels": labels,
                   **{f"pp:w:{k}": np.asarray(v, np.float32)
                      for k, v in _llama().state_dict().items()}})
    world = child.World("pipeline", inputs, 4,
                        tmp_path_factory.mktemp("dist_pipeline"))
    world.inputs = inputs
    return world


@pytest.fixture(scope="module")
def ref(started):
    """(inputs, the JAX package's sequential results), computed while the
    world runs: each setup's loss and gradients through ``_seq_ref``, the
    GPipe forward's scan, and the single-device Llama's loss, stacked
    layer gradients and three AdamW steps."""
    want = {}
    seq_vg = jax.jit(jax.value_and_grad(_seq_ref, argnums=(0, 1, 2)))
    for name in SETUPS:
        stacked, emb_w, head_w, tokens, labels = _setup(name)
        loss, (ds, de, dh) = seq_vg(stacked, emb_w, head_w, tokens, labels)
        want[name] = dict(loss=float(loss), dembed=np.asarray(de),
                          dhead=np.asarray(dh),
                          dstage={k: np.asarray(v)
                                  for k, v in ds.state_dict().items()})
        if name == "m4":
            want["gpipe"] = np.asarray(jax.jit(lambda st, h: jax.lax.scan(
                lambda hh, lyr: (lyr(hh), None), h, st)[0])(
                    stacked, _embed(emb_w, tokens)))
    jm = _llama()
    ids, labels = (jnp.asarray(a) for a in _batch(0, 8))

    @jax.jit
    def vg(m, i, lab):
        return jax.value_and_grad(lambda mm: mm.loss(i, lab))(m)

    loss, grads = vg(jm, ids, labels)
    g = {k: np.asarray(v, np.float32) for k, v in grads.state_dict().items()}
    names = {k.split(".", 3)[3] for k in g if k.startswith("model.layers.")}
    flat = {f"layers.{k}": np.stack([g[f"model.layers.{i}.{k}"]
                                     for i in range(4)]) for k in names}
    flat.update(embed_tokens=g["model.embed_tokens"],
                norm_weight=g["model.norm.weight"], lm_head=g["lm_head"])
    opt = jopt.AdamW(learning_rate=1e-3)
    step = j_make_train_step(lambda m, i, lab: m.loss(i, lab), opt,
                             donate=False)
    state, losses = j_init_state(jm, opt), []
    for _ in range(3):
        state, lo = step(state, ids, labels)
        losses.append(float(lo))
    want["llama"] = dict(loss=float(loss), grads=flat, train=losses,
                         model=jm)
    return started.inputs, want


@pytest.fixture(scope="module")
def world(started, ref):
    return started.result()[0]


def _check_generic(world, want, case):
    np.testing.assert_allclose(float(world[f"{case}:loss"]), want["loss"],
                               rtol=2e-4)
    assert rel(world[f"{case}:dembed"], want["dembed"]) <= 1e-4
    assert rel(world[f"{case}:dhead"], want["dhead"]) <= 1e-4
    for k, v in want["dstage"].items():
        assert rel(world[f"{case}:dstage:{k}"], v) <= 1e-4, k


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_1f1b_matches_sequential(world, ref, pp):
    _check_generic(world, ref[1]["m4"], f"pp{pp}")


def test_1f1b_microbatch_count_exceeds_stages(world, ref):
    _check_generic(world, ref[1]["m8"], "pp2_m8")


def test_1f1b_composes_with_dp(world, ref):
    """pp x dp: each dp member pipelines its rows of every microbatch;
    loss and grads are averaged over dp."""
    _check_generic(world, ref[1]["dp"], "pp2_dp2")


@pytest.mark.parametrize("pp", [2, 4])
def test_1f1b_residual_memory_bounded_by_pp_not_m(world, ref, pp):
    """With M = 16 microbatches stage s holds at most 2(pp-1-s)+1 <= 2pp-1
    saved stage inputs at once, independent of M (no [M, ...] stash)."""
    case = f"mem_pp{pp}_m16"
    _check_generic(world, ref[1]["m16"], case)
    peaks = world[f"{case}:peak_saved"].astype(int).tolist()
    assert peaks == [2 * (pp - 1 - s) + 1 for s in range(pp)]
    assert max(peaks) <= 2 * pp - 1 < 16


@pytest.mark.parametrize("pp, M", [(2, 4), (4, 4), (4, 8)])
def test_zb1_matches_sequential(world, ref, pp, M):
    _check_generic(world, ref[1][f"m{M}"], f"zb_pp{pp}_m{M}")


def test_zb1_composes_with_dp(world, ref):
    _check_generic(world, ref[1]["dp"], "zb_pp2_dp2")


def test_zb1_loss_bit_identical_to_1f1b(world):
    """The forward is untouched by the W-split and the deferred weight
    gradients add in the same microbatch order: loss and every gradient
    equal 1F1B's bit for bit."""
    a, b = "pp4", "zb_pp4_m4"
    assert float(world[f"{a}:loss"]) == float(world[f"{b}:loss"])
    for k in world:
        if k.startswith(f"{a}:d"):
            np.testing.assert_array_equal(world[k],
                                          world[b + k[len(a):]], err_msg=k)


def test_zb1_tail_ticks_and_wq_structure(world):
    """zb1 runs M + 3(pp-1) ticks (pp-1 weight-gradient tail ticks past
    1F1B's M + 2(pp-1)); stage 0 defers its last pp-1 weight gradients,
    its (x, g) queue holding at most pp of them."""
    assert int(world["pp4:ticks"]) == 4 + 2 * 3
    assert int(world["zb_pp4_m8:ticks"]) == 8 + 3 * 3
    assert int(world["pp4:peak_deferred"]) == 0
    assert 0 < int(world["zb_pp4_m8:peak_deferred"]) <= 4


def test_bad_schedule_name_raises():
    pipe = P.PipelineLayer([child.Mlp(8)], num_stages=1, device="cpu")
    tokens = torch.zeros(8, 6, dtype=torch.long)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        P.pipeline_train_step(pipe, None, tokens, tokens, schedule="gpipe")


def test_gpipe_forward_matches_sequential(world, ref):
    """PipelineLayer's forward over pp = 4 (the GPipe wavefront, the last
    stage's output handed to every stage) against the sequential scan."""
    assert rel(world["gpipe_forward"], ref[1]["gpipe"]) <= 1e-5


def test_pipeline_layer_without_a_mesh_runs_in_order(ref):
    inputs = ref[0]
    stacked = {k.split(":", 2)[2]: torch.tensor(v)
               for k, v in inputs.items() if k.startswith("m4:stack:")}
    blocks = [child.Mlp(8) for _ in range(8)]
    for i, b in enumerate(blocks):
        b.load_state_dict({k: v[i] for k, v in stacked.items()})
    pipe = P.PipelineLayer(blocks, num_stages=2, num_microbatches=4,
                           device="cpu")
    h = torch.as_tensor(inputs["m4:emb"])[torch.as_tensor(
        inputs["m4:tokens"])]
    with torch.no_grad():
        got = pipe(h).numpy()
    assert rel(got, ref[1]["gpipe"]) <= 1e-5
    assert pipe.stage_specs()["layers.0.weight"] == ("pp", None, None)
    assert [len(u) for u in P.unstack_layers(pipe.stacked, 8)] == [4] * 8


# --------------------------------------------------------- the pipelined Llama
@pytest.mark.parametrize("sched", ["1f1b", "zb1"])
@pytest.mark.parametrize("mesh", sorted(child.LLAMA_PP))
def test_1f1b_llama_stages_match_model_loss(world, ref, mesh, sched):
    """llama_pipeline_train_step over pp2, pp2 x dp2 and pp2 x tp2 (the
    interleaved fused projections, row-parallel psums): loss and every
    gradient equal the single-device model's (tp grads gathered and
    un-interleaved)."""
    want = ref[1]["llama"]
    case = f"llama_{mesh}_{sched}"
    np.testing.assert_allclose(float(world[f"{case}:loss"]), want["loss"],
                               rtol=2e-4)
    got = {k[len(f"{case}:grad:"):]: v for k, v in world.items()
           if k.startswith(f"{case}:grad:")}
    assert set(got) == set(want["grads"])
    for k, v in got.items():
        assert rel(v, want["grads"][k]) <= 1e-4, k


@pytest.mark.parametrize("mesh", sorted(child.LLAMA_PP))
def test_zb1_llama_bit_identical_to_1f1b(world, mesh):
    a, b = f"llama_{mesh}_1f1b", f"llama_{mesh}_zb1"
    assert float(world[f"{a}:loss"]) == float(world[f"{b}:loss"])
    for k in world:
        if k.startswith(f"{a}:grad:"):
            np.testing.assert_array_equal(world[k], world[b + k[len(a):]],
                                          err_msg=k)


@pytest.mark.parametrize("mesh", sorted(child.LLAMA_PP))
def test_1f1b_optimizer_integrated_training_matches_adamw(world, ref, mesh):
    """make_llama_pp_train_step's AdamW loop tracks the reference's
    non-pipelined make_train_step trajectory (at pp2 x tp2 the reference's
    tp optimizer loop with qkv biases)."""
    np.testing.assert_allclose(world[f"llama_{mesh}:train_losses"],
                               ref[1]["llama"]["train"], rtol=3e-4)


def test_1f1b_with_stage_remat_matches_sequential(ref):
    """remat=True (each stage's recompute checkpointed, the reference's
    default) at pp = 1 in this process: the same loss and gradients."""
    inputs, want = ref[0], ref[1]["m4"]
    pipe = child._pipe(inputs, "m4", 1, remat=True)
    loss, ds, de, dh = P.pipeline_train_step(
        pipe, None, torch.as_tensor(inputs["m4:tokens"]),
        torch.as_tensor(inputs["m4:labels"]), head_loss_fn=child.head_loss,
        head_params=torch.as_tensor(inputs["m4:head"]),
        embed_fn=child.embed_fn, embed_params=torch.as_tensor(
            inputs["m4:emb"]))
    world = {"c:loss": loss.numpy(), "c:dembed": de.numpy(),
             "c:dhead": dh.numpy(),
             **{f"c:dstage:{k}": v.numpy() for k, v in ds.items()}}
    _check_generic(world, want, "c")


def test_wrong_layout_params_are_rejected(world):
    assert "tp_layout=1 but the mesh has tp=2" in str(world["wrong_layout"])


def test_tp_shuffle_layout_guards(ref):
    """The interleave equals the reference's column for column; double
    shuffles and wrong-direction unshuffles raise; the inverse restores."""
    jm = ref[1]["llama"]["model"]
    cfg = L.LlamaConfig.tiny(**LLAMA)
    tm = L.LlamaForCausalLM(cfg, device="cpu")
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    load_jax_state_dict(tm, jm.state_dict())
    jcanon = JL._pp_params(jm, copy=False)
    jshuf = JL.tp_shuffle_llama_params(jcanon, jm.cfg, 2)
    canonical = L._pp_params(tm, copy=False)
    shuffled = L.tp_shuffle_llama_params(canonical, cfg, 2)
    assert shuffled.tp_layout == 2
    jl = jshuf["layers"].state_dict()
    for k, v in shuffled["layers"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jl[k]),
                                      err_msg=k)
    with pytest.raises(ValueError):
        L.tp_shuffle_llama_params(shuffled, cfg, 2)
    with pytest.raises(ValueError):
        L.tp_shuffle_llama_params(canonical, cfg, 2, inverse=True)
    back = L.tp_shuffle_llama_params(shuffled, cfg, 2, inverse=True)
    assert back.tp_layout == 1
    for k, v in back["layers"].items():
        torch.testing.assert_close(v, canonical["layers"][k], rtol=0, atol=0)
    specs = L.llama_tp_stage_specs(canonical["layers"])
    assert specs["self_attn.qkv_proj"] == ("pp", None, "tp")
    assert specs["mlp.down_proj"] == ("pp", "tp", None)
    assert specs["input_layernorm.weight"] == ("pp", None)


def test_tp_layer_call_reduces_over_its_axis():
    """make_tp_layer_call's ``tp_axis`` names the group the layer's
    row-parallel products all-reduce over (the reference's psum axis); a
    size-1 axis leaves the layer unsharded, and with no mesh it refuses."""
    from types import SimpleNamespace

    from paddle_tpu_torch.distributed.sharded import TpInfo

    class Mesh:
        def size(self, axes):
            return {"sp": 2}.get(axes, 1)

        def group(self, axes):
            return f"group of {axes}"

        def index(self, axes):
            return 1

    class View:
        template = SimpleNamespace(self_attn=SimpleNamespace(),
                                   mlp=SimpleNamespace())

        def __call__(self, h, cos, sin, mask):
            return self.template.self_attn._pt_tp, self.template.mlp._pt_tp

    want = TpInfo("group of sp", 2, 1)
    assert L.make_tp_layer_call(None, None, tp_axis="sp", mesh=Mesh())(
        View(), None) == (want, want)
    assert L.make_tp_layer_call(None, None, mesh=Mesh())(
        View(), None) == (None, None)
    with pytest.raises(ValueError, match="needs a mesh"):
        L.make_tp_layer_call(None, None)
