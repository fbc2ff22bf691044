"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, no module of it imports either, and its entry points refuse to
carry on on the CPU unless asked to.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch"


def test_import_leaves_jax_and_paddle_tpu_out():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.models.paged, paddle_tpu_torch.models.convert, "
        "paddle_tpu_torch.ops.cuda, paddle_tpu_torch.observability.memledger, "
        "paddle_tpu_torch.train, paddle_tpu_torch.optimizer, "
        "paddle_tpu_torch.distributed.moe, paddle_tpu_torch.utils.faults, "
        "paddle_tpu_torch.models.mixtral, paddle_tpu_torch.models.qwen2_moe, "
        "paddle_tpu_torch.models.moe_llm, paddle_tpu_torch.models.mistral, "
        "paddle_tpu_torch.models.qwen, paddle_tpu_torch.ops.cuda.rope, "
        "paddle_tpu_torch.serving.quant, paddle_tpu_torch.models.bloom, "
        "paddle_tpu_torch.models.falcon, paddle_tpu_torch.nn.layers, "
        "paddle_tpu_torch.peft, paddle_tpu_torch.serving.adapters, "
        "paddle_tpu_torch.models.speculative, "
        "paddle_tpu_torch.serving.router, paddle_tpu_torch.serving.transfer, "
        "paddle_tpu_torch.models.auto, paddle_tpu_torch.quantization, "
        "paddle_tpu_torch.nn, paddle_tpu_torch.amp, paddle_tpu_torch.amp.fp8, "
        "paddle_tpu_torch.amp.debugging, paddle_tpu_torch.io, "
        "paddle_tpu_torch.train.trainer, paddle_tpu_torch.train.checkpoint, "
        "paddle_tpu_torch.train.elastic, paddle_tpu_torch.utils.watchdog, "
        "paddle_tpu_torch.utils.profiler, paddle_tpu_torch.distributed, "
        "paddle_tpu_torch.distributed.mesh, "
        "paddle_tpu_torch.distributed.collective, "
        "paddle_tpu_torch.distributed.sharded, "
        "paddle_tpu_torch.distributed.tensor_parallel, "
        "paddle_tpu_torch.distributed.pipeline, "
        "paddle_tpu_torch.distributed.fleet, "
        "paddle_tpu_torch.distributed.auto_parallel, "
        "paddle_tpu_torch.distributed.launch\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "paddle_tpu"), (f, n)


def test_entry_points_default_to_the_card():
    """The model constructors and the makers of rope tables, KV pools,
    ALiBi slopes and seeded generators, the mesh, the process group, the
    tensor-parallel layers and the pipeline layer put their tensors (and
    their ranks) on the card when no device is named: without one they
    raise, and with ``device="cpu"`` they run on the CPU."""
    from paddle_tpu_torch import generator
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.distributed.pipeline import PipelineLayer
    from paddle_tpu_torch.models.bloom import alibi_slopes
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.paged import PagedKVCache
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.ops.attention import rope_cos_sin

    def joined(**kw):
        assert D.init_parallel_env(**kw) is False    # one process, no env
        return torch.empty(0, device=resolve_device(kw.get("device")))

    makers = {
        "rope_cos_sin": lambda **kw: rope_cos_sin(8, 16, **kw)[0],
        "PagedKVCache.init": lambda **kw: PagedKVCache.init(
            1, 4, 4, 1, 16, 2, 2, torch.float32, **kw).k_store[0],
        "alibi_slopes": lambda **kw: alibi_slopes(6, **kw),
        "generator": lambda **kw: generator(0, **kw),
        "HybridMesh": lambda **kw: torch.empty(
            0, device=D.HybridMesh(**kw).device),
        "init_parallel_env": joined,
        "ColumnParallelLinear": lambda **kw: D.ColumnParallelLinear(
            4, 4, **kw).weight,
        "RowParallelLinear": lambda **kw: D.RowParallelLinear(
            4, 4, **kw).weight,
        "VocabParallelEmbedding": lambda **kw: D.VocabParallelEmbedding(
            8, 4, **kw).weight,
        "PipelineLayer": lambda **kw: PipelineLayer(
            [Linear(2, 2, device="cpu")], 1, **kw).stacked["weight"]}
    for name, make in makers.items():
        assert make(device="cpu").device.type == "cpu", name
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert all(make().device.type == "cuda" for make in makers.values())
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert m.device.type == "cpu"


def test_trainer_stack_entry_points_default_to_the_card():
    """Trainer, DevicePrefetch, GradScaler.init and make_lora_train_step
    run on the card when no device is named: without one they raise, and
    with ``device="cpu"`` they run on the CPU."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.io import DevicePrefetch
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.peft import lora_init, make_lora_train_step
    from paddle_tpu_torch.train import Trainer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    lora = lora_init(m, torch.Generator().manual_seed(0))

    def loss(mm, x):
        return mm(x).sum()

    makers = {
        "Trainer": lambda **kw: Trainer(Linear(2, 2, device="cpu"),
                                        O.SGD(0.1), loss, **kw).device,
        "DevicePrefetch": lambda **kw: DevicePrefetch(iter([]), 1,
                                                      **kw).device,
        "GradScaler.init": lambda **kw: GradScaler().init(
            **kw)["scale"].device,
        "make_lora_train_step": lambda **kw: make_lora_train_step(
            m, lora, O.AdamW(), loss, **kw)[1]["_scale"].device}
    for name, make in makers.items():
        assert make(device="cpu").type == "cpu", name
    if torch.cuda.is_available():
        return
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_unported_training_modes_refuse():
    """What item 7 still queues raises, naming its ROADMAP item, instead of
    running something else: a train step over a sequence-parallel (sp / cp)
    axis, expert-parallel MoE under an ep mesh and orbax checkpoints; a
    mesh train step over the other axes constructs; the selective remat
    policies construct and an unknown one raises."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.distributed import HybridMesh
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed.moe import MoELayer
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               _Init)
    from paddle_tpu_torch.train import init_state, make_train_step
    from paddle_tpu_torch.train.checkpoint import CheckpointManager

    class _SpMesh:       # the size queries of a mesh with sp = ep = 2
        def size(self, axes):
            return 2

    opt = O.AdamW()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 7"):
        make_train_step(lambda m, i, lab: m.loss(i, lab), opt,
                        mesh=_SpMesh())
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 7"):
        init_state(m, opt, mesh=_SpMesh())
    assert callable(make_train_step(lambda mm, i, lab: mm.loss(i, lab), opt,
                                    mesh=HybridMesh(device="cpu")))
    cfg = LlamaConfig.tiny()
    moe = MoELayer(cfg.hidden_size, 32, 4, init=_Init(cfg, "cpu", 0))
    x = torch.zeros(1, 2, cfg.hidden_size)
    M._CURRENT.append(_SpMesh())       # every axis of size 2: ep too
    try:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1 item 7"):
            moe(x)
    finally:
        M._CURRENT.pop()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 7"):
        CheckpointManager("unused", use_orbax=True)
    for policy in ("dots", "hidden", "no_ffn"):
        assert LlamaConfig(remat_policy=policy).save_names()
    with pytest.raises(ValueError):
        LlamaConfig(remat_policy="everything")
    assert LlamaConfig(remat_policy="full").remat_policy == "full"


def test_chip_smoke_stays_in_step_with_the_kernel_registry():
    """``chip_smoke.py`` spells the kernels of each path out (so that it can
    load an earlier tree): the lists equal ``ops.cuda``'s, every kernel has
    its source in the checkout, every source is built, and the script
    imports neither JAX nor the JAX package."""
    import chip_smoke
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.ops.cuda import _build
    assert chip_smoke.PATHS == {
        "serve": K.SERVE_KERNELS, "async_serve": K.SERVE_KERNELS,
        "train": K.TRAIN_KERNELS,
        "moe_serve": K.MOE_SERVE_KERNELS, "moe_train": K.MOE_TRAIN_KERNELS,
        "window_serve": K.WINDOW_SERVE_KERNELS,
        "quant_serve": K.QUANT_SERVE_KERNELS,
        "bloom_serve": K.ALIBI_SERVE_KERNELS,
        "bloom_train": K.ALIBI_TRAIN_KERNELS,
        "falcon_rw_serve": K.ALIBI_SERVE_KERNELS,
        "falcon_rw_train": K.ALIBI_TRAIN_KERNELS,
        "falcon7b_serve": K.ROPE_GENERATE_KERNELS,
        "lora_serve": K.LORA_SERVE_KERNELS,
        "spec_serve": K.SPEC_SERVE_KERNELS,
        "beam_serve": K.BEAM_SERVE_KERNELS,
        "beam_serve_i8": K.BEAM_SERVE_I8_KERNELS,
        "grammar_serve": K.GRAMMAR_SERVE_KERNELS,
        "tenant_serve": K.TENANT_SERVE_KERNELS,
        "gemma_train": K.GEMMA_TRAIN_KERNELS,
        "gemma7b_serve": K.GEMMA_SERVE_KERNELS,
        "gptj_serve": K.GPTJ_SERVE_KERNELS,
        "gptj_train": K.GPTJ_TRAIN_KERNELS,
        "router_serve": K.ROUTER_SERVE_KERNELS,
        "router_serve_disagg": K.ROUTER_SERVE_KERNELS,
        "router_serve_i8": K.ROUTER_SERVE_I8_KERNELS,
        "router_check": K.ROUTER_SERVE_KERNELS,
        "gptq_serve": K.GPTQ_SERVE_KERNELS,
        "spec_generate": K.SPEC_GENERATE_KERNELS,
        "remat_train": K.REMAT_TRAIN_KERNELS,
        "trainer_fit": K.TRAINER_FIT_KERNELS,
        "lora_train": K.LORA_TRAIN_KERNELS,
        "fp8_train": K.FP8_TRAIN_KERNELS,
        "paged_generate": K.PAGED_GENERATE_KERNELS,
        "f16_serve": K.F16_SERVE_KERNELS,
        "f16_serve_i8": K.F16_SERVE_I8_KERNELS,
        "f16_train": K.F16_TRAIN_KERNELS,
        "f16_moe_serve": K.F16_MOE_SERVE_KERNELS,
        "f16_moe_train": K.F16_MOE_TRAIN_KERNELS,
        "dist_train": K.DIST_TRAIN_KERNELS,
        "pp_train": K.PP_TRAIN_KERNELS}
    # K7 rotates every rotate-half rope of every path; the ALiBi paths
    # (BLOOM, falcon-rw) have no rope and run K2's (and K5's) ALiBi mode
    # instead, and GPT-J's interleaved rope is plain PyTorch, as the
    # reference's (no Pallas kernel behind it)
    alibi = {p for p in chip_smoke.PATHS if p.startswith(("bloom",
                                                          "falcon_rw"))}
    gptj = {p for p in chip_smoke.PATHS if p.startswith("gptj")}
    # (a float16 path's names are the float16 counters: "rope_f16")
    assert all({"rope", "rope_f16"} & set(names)
               for p, names in chip_smoke.PATHS.items()
               if p not in alibi | gptj)
    assert all(n.endswith("_f16") for p, names in chip_smoke.PATHS.items()
               if p.startswith("f16_") for n in names)
    assert all("rope" not in chip_smoke.PATHS[p]
               and "flash_fwd" in chip_smoke.PATHS[p] for p in gptj)
    assert all("flash_fwd_alibi" in chip_smoke.PATHS[p]
               and "rope" not in chip_smoke.PATHS[p] for p in alibi)
    assert "rope" in chip_smoke.SOURCES
    assert set(chip_smoke.SOURCES) == set(K.kernels())
    built = set()
    for src, replaces in chip_smoke.SOURCES.values():
        assert (PKG.parent / src).is_file(), src
        assert (PKG.parent / replaces.split(":")[0]).is_file(), replaces
        built.add(pathlib.Path(src).stem)
    assert built == set(_build.KERNEL_SOURCES)
    tree = ast.parse((PKG.parent / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        assert not any(n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
                       for n in names), names


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: a kernel wrapper
    given one takes its kernel path."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.mark.parametrize("case", ["no_library", "refused_shape",
                                  "misaligned"])
def test_lora_wrappers_on_the_card_launch_or_raise(case, monkeypatch):
    """K6a's two multi-LoRA wrappers on a CUDA tensor launch their kernel
    or raise: when the library cannot load, and for what the kernels
    refuse (k not a multiple of 8, a rank above LORA_MAX_RANK, an
    activation off 16-byte alignment). The plain versions are never
    reached and no launch is counted."""
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    def no_library(name):
        raise OSError(f"cannot load the library of csrc/{name}.cu")

    monkeypatch.setattr(GM, "lora_shrink_plain", no_plain)
    monkeypatch.setattr(GM, "lora_expand_add_plain", no_plain)
    monkeypatch.setattr(_build, "library", no_library)
    k, r, n = ((12, 4, 8) if case == "refused_shape" else (16, 4, 8))
    rb = GM.LORA_MAX_RANK + 1 if case == "refused_shape" else r
    x = torch.zeros(2, 1, k)
    y = torch.zeros(2, 1, n)
    if case == "misaligned":
        x = torch.zeros(2 * k + 1)[1:].view(2, 1, k)
        y = torch.zeros(2 * n + 1)[1:].view(2, 1, n)
    perm = _on_card(torch.tensor([1, 0], dtype=torch.int32))
    gs = _on_card(torch.tensor([1, 0, 1], dtype=torch.int32))
    a, b = _on_card(torch.zeros(3, k, r)), _on_card(torch.zeros(3, rb, n))
    t = _on_card(torch.zeros(2, rb))
    x, y = _on_card(x), _on_card(y)
    before = (GM.lora_shrink.launches, GM.lora_expand_add.launches)
    err = OSError if case == "no_library" else ValueError
    with pytest.raises(err):
        GM.lora_shrink(x, perm, a, gs)
    with pytest.raises(err):
        GM.lora_expand_add(y, t, b, gs, perm)
    assert (GM.lora_shrink.launches, GM.lora_expand_add.launches) == before
