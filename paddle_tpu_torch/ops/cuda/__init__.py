"""Hand-written CUDA kernels for Hopper, one module per Pallas kernel
file of the JAX package. Each wrapper launches its kernel on CUDA
tensors (or raises), runs its plain PyTorch version on CPU tensors, and
counts its launches in ``<wrapper>.launches``.

Importing this package builds nothing: sources compile at first launch
(:mod:`paddle_tpu_torch.ops.cuda._build`).
"""
from paddle_tpu_torch.ops.cuda import (flash_attention,  # noqa: F401
                                       grouped_matmul, norms, paged_attention,
                                       rope)


# the decode tick rotates q and k and writes k and v into a pool of the
# model's type in one launch (rope_kv); prefill and the chunk run K7
SERVE_KERNELS = ("rms_norm", "flash_fwd", "paged_chunk", "paged_decode",
                 "rope", "rope_kv")
TRAIN_KERNELS = ("rms_norm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "rope")
# the MoE families: the dense paths' kernels plus the grouped GEMM
MOE_SERVE_KERNELS = SERVE_KERNELS + ("grouped_fwd",)
MOE_TRAIN_KERNELS = TRAIN_KERNELS + ("grouped_fwd", "grouped_dw")
# sliding-window serving (Mistral): whole-prompt prefill and decode only —
# chunked prefill under a window is refused, as in the reference engine
WINDOW_SERVE_KERNELS = ("rms_norm", "flash_fwd", "paged_decode", "rope",
                        "rope_kv")
# quantized serving (int8 KV pool): K3 and K4 in their int8 mode; the
# pool quantizes on write, so the decode tick keeps K7 and its own writes
QUANT_SERVE_KERNELS = ("rms_norm", "flash_fwd", "paged_chunk_i8",
                       "paged_decode_i8", "rope")
# the ALiBi families (BLOOM, falcon-rw) through generic_generate (every
# step re-forwards the whole buffer: K2 only) and make_train_step
ALIBI_SERVE_KERNELS = ("flash_fwd_alibi",)
ALIBI_TRAIN_KERNELS = ("flash_fwd_alibi", "flash_bwd_dq_alibi",
                       "flash_bwd_dkv_alibi")
# Falcon-7B (rope, multi-query) through generic_generate
ROPE_GENERATE_KERNELS = ("flash_fwd", "rope")
# multi-LoRA serving: the serving kernels plus K6a's two LoRA kernels (the
# rank-r shrink and the expand that adds into the projection)
LORA_SERVE_KERNELS = SERVE_KERNELS + ("lora_shrink", "lora_expand")
# speculative serving: the target's verify batch runs K3 (paged_chunk),
# the draft's norms and ropes K1 and K7
SPEC_SERVE_KERNELS = ("rms_norm", "flash_fwd", "paged_chunk",
                      "paged_decode", "rope")
# beam groups ride the serve path (a group's prompt is one row of the
# whole-prompt prefill, its beams decode in the tick graph); over an int8
# pool, the quantized path's kernels
BEAM_SERVE_KERNELS = SERVE_KERNELS
BEAM_SERVE_I8_KERNELS = QUANT_SERVE_KERNELS
# grammar serving: the serve path without chunked prefill (the grammar
# mix's prompts fit max_prompt_len and share no prefix)
GRAMMAR_SERVE_KERNELS = ("rms_norm", "flash_fwd", "paged_decode", "rope",
                         "rope_kv")
# tenants, the degradation ladder and the SLO tracker ride the serve path
# (the ladder's rungs change budgets and admission, not shapes)
TENANT_SERVE_KERNELS = SERVE_KERNELS
# head dim 256 (Gemma, GPT-J): Gemma's train step runs K2, K5a, K5b and K7
# (its zero-centred RMSNorm is plain PyTorch, as the reference's), its
# generate path K2 and K7; GPT-J's interleaved rope is plain PyTorch (the
# reference's has no kernel), so its paths run the flash kernels alone
GEMMA_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rope")
GEMMA_SERVE_KERNELS = ROPE_GENERATE_KERNELS
GPTJ_SERVE_KERNELS = ("flash_fwd",)
GPTJ_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the other decoder families through make_train_step / generic_generate:
# GPT-3 1.3B's step runs the flash kernels (its LayerNorms and learned
# positions are plain PyTorch, as the reference's are XLA's); GPT-NeoX
# and Phi rotate their partial rotary slice on K7 (Phi's attention at head
# dim 80), OPT has learned positions (K2 alone) and GLM-4's RMSNorm is K1
# (its interleaved rope plain PyTorch, as GPT-J's)
GPT3_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
NEOX_SERVE_KERNELS = ROPE_GENERATE_KERNELS
OPT_SERVE_KERNELS = ("flash_fwd",)
PHI_SERVE_KERNELS = ROPE_GENERATE_KERNELS
PHI_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rope")
GLM_SERVE_KERNELS = ("rms_norm", "flash_fwd")
# the BERT-family encoders: their LayerNorms and learned positions are
# plain PyTorch, as the reference's are XLA's. BERT's fine-tune step with
# varlen padding and no attention dropout runs K2 and K5 without a causal
# mask at head dim 64 (kv_lens); its eval encoding K2 alone, as does each
# other encoder's maskless forward. BERT pretraining with attention
# dropout 0.1 runs none: dropout takes the eager path, as the reference's
# takes xla_attention
BERT_FINETUNE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BERT_ENCODE_KERNELS = ("flash_fwd",)
ENCODER_SERVE_KERNELS = ("flash_fwd",)
# the router: replicas serving end to end run the serve path; split into a
# prefill replica (K1, K2, K3, K7) and a decode replica (K1, K4, K7's
# fold) they run it between them; over int8 pools the quantized path
ROUTER_SERVE_KERNELS = SERVE_KERNELS
ROUTER_SERVE_I8_KERNELS = QUANT_SERVE_KERNELS
# a GPTQ / smoothed weight-only model serves the serve path over a bf16
# pool (its calibration capture runs K1, K2 and K7 too)
GPTQ_SERVE_KERNELS = SERVE_KERNELS
# the standalone speculative API: the dense-cache forwards run K1 and K7
# (their attention is plain PyTorch, as the reference's is XLA's)
SPEC_GENERATE_KERNELS = ("rms_norm", "rope")
# the train step under every remat policy and with scanned layers
REMAT_TRAIN_KERNELS = TRAIN_KERNELS
# the trainer stack: Trainer.fit over the token-bin data path, the
# adapter-only LoRA step (its merged forward runs the full step's
# kernels) and the fp8 step (its four projections on torch._scaled_mm,
# the reference's being XLA's, not a Pallas kernel)
TRAINER_FIT_KERNELS = TRAIN_KERNELS
LORA_TRAIN_KERNELS = TRAIN_KERNELS
FP8_TRAIN_KERNELS = TRAIN_KERNELS
# the hybrid-mesh train step (make_train_step over a HybridMesh) and the
# 1F1B / zero-bubble pipeline (make_llama_pp_train_step): the layers run
# the train step's kernels on each rank's local shards
DIST_TRAIN_KERNELS = TRAIN_KERNELS
PP_TRAIN_KERNELS = TRAIN_KERNELS
# sequence parallelism: Ulysses's inner attention is K2 forward and K5
# backward (the ring's block step is plain PyTorch, as the reference's is
# XLA einsums); expert parallelism: the compacted experts' grouped GEMM
SP_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
EP_TRAIN_KERNELS = ("grouped_fwd", "grouped_dw")
# context-parallel serving (LLMEngine(cp=N)): the whole-prompt prefill as
# the serve path (K2 over the prompt's own K/V, no merge), the chunked
# prefill / verify chunk on K3 and the decode tick on K4, both in their
# partials mode, merged over cp; the decode tick keeps K7's fold
CP_SERVE_KERNELS = ("rms_norm", "flash_fwd", "paged_chunk_partials",
                    "paged_decode_partials", "rope", "rope_kv")


def f16_names(names) -> tuple:
    """The float16 counters (``kernels()``'s ``<name>_f16``) of ``names``."""
    return tuple(f"{n}_f16" for n in names)


# float16 models: each path's kernels on their float16 instantiations
F16_SERVE_KERNELS = f16_names(SERVE_KERNELS)
F16_SERVE_I8_KERNELS = f16_names(QUANT_SERVE_KERNELS)
F16_TRAIN_KERNELS = f16_names(TRAIN_KERNELS)
F16_MOE_SERVE_KERNELS = f16_names(MOE_SERVE_KERNELS)
F16_MOE_TRAIN_KERNELS = f16_names(MOE_TRAIN_KERNELS)
# models.paged.paged_generate: the whole-prompt prefill (K1, K2, K7) and
# the decode step (K1, K4, K7 folded with the pool write)
PAGED_GENERATE_KERNELS = ("rms_norm", "flash_fwd", "paged_decode", "rope",
                          "rope_kv")


def kernels() -> dict:
    """{name: the object that counts its launches in ``.launches``} of
    every kernel of the port: the serving path's (K3 and K4 counted apart
    over int8 pools), the train step's backward, the grouped GEMM of the
    MoE families (forward/dlhs, drhs), the rotary embedding of every
    path, then the ALiBi mode of K2, K5a and K5b (counted apart),
    K6a's two kernels at the multi-LoRA call site, and K7 folded with the
    decode tick's KV pool write (K3 and K4 in their partials mode counted
    apart too); then, as ``<name>_f16``, each one's
    float16 launches (also counted in its total)."""
    base = _base_kernels()
    return {**base, **{f"{n}_f16": fn.f16 for n, fn in base.items()}}


def _base_kernels() -> dict:
    return {
        "rms_norm": norms.rms_norm,
        "flash_fwd": flash_attention.flash_attention,
        "paged_chunk": paged_attention.paged_chunk_attention,
        "paged_decode": paged_attention.paged_decode_attention,
        "paged_chunk_i8": paged_attention.paged_chunk_i8,
        "paged_decode_i8": paged_attention.paged_decode_i8,
        "paged_chunk_partials": paged_attention.paged_chunk_partials,
        "paged_decode_partials": paged_attention.paged_decode_partials,
        "flash_bwd_dq": flash_attention.flash_bwd_dq,
        "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
        "grouped_fwd": grouped_matmul.grouped_matmul,
        "grouped_dw": grouped_matmul.grouped_dw,
        "rope": rope.fused_rope,
        "flash_fwd_alibi": flash_attention.flash_fwd_alibi,
        "flash_bwd_dq_alibi": flash_attention.flash_bwd_dq_alibi,
        "flash_bwd_dkv_alibi": flash_attention.flash_bwd_dkv_alibi,
        "lora_shrink": grouped_matmul.lora_shrink,
        "lora_expand": grouped_matmul.lora_expand_add,
        "rope_kv": rope.rope_kv_write,
    }


def reset_launches():
    for fn in kernels().values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", ()):
            fn.route_launches[route] = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in kernels().items()}


def route_launches() -> dict:
    """{name: {kernel: launches}} of the wrappers that choose between
    kernels and count each where it launches (K6a: ``"decode"``,
    ``"wgmma"``, ``"fma"``; K6b: ``"wgmma"``, ``"fma"``)."""
    return {name: dict(fn.route_launches) for name, fn in kernels().items()
            if hasattr(fn, "route_launches")}


def add_launches(counts: dict, routes: dict | None = None, sign: int = 1):
    """Add ``sign`` times ``counts`` ({name: launches}) and ``routes``
    ({name: {kernel: launches}}) to the counters. A CUDA graph's capture
    runs the wrappers' Python (which counts) but launches nothing, and each
    replay launches every captured kernel without running that Python: the
    executor takes the capture's counts back (``sign=-1``) and adds them
    at every replay (``serving/executor.py``)."""
    fns = kernels()
    for name, n in counts.items():
        fns[name].launches += sign * n
    for name, per in (routes or {}).items():
        for route, n in per.items():
            fns[name].route_launches[route] += sign * n
