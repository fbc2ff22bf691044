#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA card. Run from the root of a checkout::

    python3 chip_smoke.py            # every phase, one card

Phases (each one fails the run when it fails; nothing is caught):

  build     compile every kernel in ``paddle_tpu_torch/csrc`` with nvcc
            (one process per source, all at once) and print the ptxas
            register/spill lines, plus the card's name and power limit
  kernels   each kernel against its plain PyTorch version on the card, at
            the shapes the Llama-2-7B serving path and the train step give
            it (bf16, tolerance 2e-2) and again in float32 (tolerance 1e-4),
            and at the shapes the MoE paths give them (bf16):
            K1 (timed eager and replayed from a CUDA graph over inputs
            larger than the L2, as are F.rms_norm and a copy of the same
            bytes) also with a bf16 x
            under an fp32 weight, K2's log-sum-exp against
            torch.logsumexp of the plain scores, K5 (dq, dk/dv) at the
            training shapes and on a small GQA + kv_lens + window case,
            K6a/K6b (grouped GEMM forward, dlhs, drhs) at the Qwen decode,
            prefill and train shapes (drhs of both train products), at
            Mixtral-8x7B width and on a small ragged case (an empty
            group's drhs exactly 0), each K6a and K6b line naming its route
            (decode, tensor-core or FMA; K6b's read from the wrapper's
            count of each kernel's launches); K7 (rope) on the
            strided q/k views of every path's shapes, its forward equal to
            the plain version bit for bit and its backward within the
            tolerance (timed eager and replayed from a CUDA graph); K2 at
            the banded timing script's shape (4 heads, S 4096, window 1024
            and full causal); K1, K2 and K4 at Mistral-7B's window shapes;
            K6a's two multi-LoRA kernels (the shrink t = x[perm] @ A and
            the expand y += cast(t @ B) in place; x [8, 1 | 5 | 128, 4096]
            in bf16 and fp32, A [cap, 4096, r], B [cap, r, 12288 | 4096], r
            4/8/16, cap 4 and 1, an empty group and a null tail; fp32 t and
            y within 1e-5, bf16 y within one bf16 step; timed eager and
            from a CUDA graph beside the gather baseline's arithmetic and
            the unfused composition on the general K6a routes, which are
            still checked at these shapes) and K3 at the speculative
            verify width (q [8, 5, 32, 128], bf16 / float32 / int8 pools);
            the int8-pool modes of K4 (serve and Mistral window shapes) and
            K3 (serve chunk shape) on int8 pools with fp32 scales, bf16 and
            float32 q, the same codes on both sides; K3 and K4 also in
            their partials mode (the triple against the plain one over a
            table with a quarter of its entries another shard's), each K3
            row naming its route (``variant``) and each K4 row its split
            count (``nsplit``), both also timed from a CUDA graph (their
            eager calls time the wrapper's host work at the decode
            shapes), and K4 at Qwen2-7B's decode shape (GQA 28/4, a
            group of 7); K2, K5a and K5b in
            their ALiBi mode (bf16 and float32) at the BLOOM-560m and
            Falcon-RW-1B generate ([8, 160, H, 64]) and train ([4, 2048, H,
            64]) shapes, each also timed without ALiBi at the same shape,
            the library call being F.scaled_dot_product_attention with
            the float ALiBi mask (and its backward); K2 and K7 at
            Falcon-7B's generate shapes (GQA 71:1); K2, K5a and K5b at
            head dim 256 (bf16 and float32, K2's LSE too) at Gemma-2B's
            train shape (q [2, 2048, 8, 256] over one KV head, GQA 8:1)
            and GPT-J-6B's (q [4, 2048, 16, 256]), beside SDPA (is_causal,
            GQA) and its backward, K2 at the generate shape of Gemma-7B
            and GPT-J-6B ([8, 160, 16, 256]) and K7 at Gemma's shapes;
            K1, K2, K5a, K5b and K7 at the LoRA step's Llama-2-7B shapes
            (x [2048, 4096], q/k/v [1, 2048, 32, 128]); K2, K5a and K5b at
            GPT-3 1.3B's train shape ([4, 1024, 16, 128]) and at head dim
            80 at Phi-2's ([4, 2048, 32, 80]; f32, f16 and bf16), K2 at
            the generate shapes of Pythia-6.9B / OPT-6.7B, Phi-2 and
            GLM-4-9B ([8, 160, 32, 128 | 80], GLM over 2 KV heads), K1 at
            GLM-4-9B's generate rows ([1280, 4096]) and K7 on the
            partial-rotary slices (32 of 128 and of 80 lanes); then every
            kernel's float16 instantiation at the same shapes (the f16
            paths' rows timed; ALiBi, head dim 256, the window and the
            LoRA kernels checked and logged; tolerance 2e-2 * (1 + |x|),
            bf16's); times of the kernel, the plain version and, where one PyTorch
            call computes the same function, that call (``library_ms``),
            with CUDA events; the bound max(bytes / 3.35 TB/s, flops / 989
            TFLOP/s) from this run's shapes and data
  serve     ``LlamaConfig.llama2_7b()`` at full width (random weights from
            a seed, made on the card) served by ``LLMEngine``: 12 requests
            covering whole-prompt prefill, chunked prefill, radix prefix
            hits and temperature/top-p sampling; every request must finish,
            ``assert_quiescent()`` must pass and every kernel's launch count
            must have risen during the run (``check`` and ``anatomy`` run
            it too, as they read its model and requests). Its decode ticks
            are replays of a CUDA graph: each engine phase prints their
            replays, wall and device ms a tick (CUDA events around each
            replay) and the bytes the graphs' private pools reserved.
            It prints the engine's ``serving_roofline_report()``: MFU,
            MBU and arithmetic intensity per phase against the peaks
            resolved from the card's name; a decode MBU of 0, or an MFU
            or MBU above ROOF_MAX (1.05), fails it
  cp_serve  context-parallel serving's forwards at Llama-2-7B width on
            the serve phase's model over a one-rank NCCL cp group
            (``HybridMesh(cp=1)``): the serve mix's 8 greedy prompts
            prefilled (whole-prompt for their first 128 tokens, the 300-
            and 384-token rows chunked on), CP_TICKS greedy decode ticks
            and one 5-token verify chunk, each forward with ``cp_axis="cp"``
            (K3 and K4 in their partials mode, the merges, finalize) from
            the same cache state as the same forward with ``cp_axis=None``:
            greedy tokens identical, logits within the kernels' bf16
            tolerance; K3 / K4 partials launches; the decode tick's ms
            with and without partials + merge (CUDA events, eager)
  check     prefill (flash), chunked prefill (paged chunk) and one decode
            step (paged decode) of served prompts, in bf16 through the
            kernels and through the plain versions, and in float32 through
            the plain versions; the kernel path must be no further from the
            float32 logits than twice the plain bf16 path, and each
            bf16 path within 0.15 of the float32 logits' RMS; then (with
            ``train``) the train model's loss and three gradients on one
            2048-token row, held to the same rule
  graph_check  the decode tick as the engine runs it on the card, a
            replay of the executor's CUDA graph, against the eager
            ``llama_decode_tick`` at the serve phase's geometry (8 slots
            decoding), over a bf16 pool and over an int8 pool: from one
            cache state (copied and put back) identical greedy tokens,
            bit-identical log-probabilities and identical caches after the
            tick; at temperature 0.8 two replays draw different tokens, a
            replay from a restored generator state repeats the draw and the
            eager tick from that state draws the same
  async_serve  the serve phase's model, geometry and 12-request mix
            through ``LLMEngine(async_depth=2)``: all 12 streams must equal
            the serve phase's token for token, every request finish,
            ``assert_quiescent()`` pass, the serve path's kernels launch (the
            replays counted) and the pipeline cruise (async replays and
            drained windows); tokens/s, TTFT and the windows drained by
            reason
  lora_serve  the serve phase's model, geometry and 12-request mix with
            multi-LoRA: ``AdapterStore(capacity=4, max_rank=16)`` holding
            three adapters of ranks 4, 8 and 16 on qkv_proj and o_proj
            (numpy seeds; B ~ N(0, 0.05^2) as the reference's test), nine
            requests on them (three each), three on the base, the warm-up
            on a fourth adapter; after the fourth step a fifth adapter is
            registered and a request on it must evict the warm-up one
            (LRU). Every request finishes, K1-K4, K7 and K6a's two LoRA
            kernels launch; tokens/s, TTFT, the LoRA graph's replays,
            wall against device ms a tick, uploads, hits and evictions,
            graph pools. Then the same mix with PT_MULTILORA_IMPL=gather
            (the dense per-row baseline): the grouped-to-gather ratio of
            the LoRA tick's device time
  lora_check  (a) each adapter's prompt logits at 7B bf16 through the
            kernels and the plain versions against a float32 copy with
            that adapter merged (``peft.lora_merge``), CHECK_REL; (b) at
            Llama-2-7B's widths cut to 4 layers, float32: every stream of
            the mixed batch equals a dedicated single-adapter engine's and
            the base rows a storeless engine's, token for token; (c) the
            LoRA graph's replay against the eager LoRA tick at 7B bf16
            (``graph_against_eager``: bit-identical)
  spec_serve  the serve mix on the 7B bf16 target with ``spec_k=4``,
            adaptive: with the target as its own draft, then with
            TinyLlama-1.1B's published widths (random weights, nearly every
            proposal rejected, so the rewind runs), then that draft over an
            int8 KV pool; tokens/s, acceptance rate, tokens a slot and
            round, the draft's and the verify's ms a round, K3 launches
            and fallbacks
            (each run also prints its roofline report, under the serve
            phase's rule, and GOODPUT's good, saved and wasted tokens by
            reason)
  beam_serve  the serve mix on the 7B bf16 model with requests 1 and 4
            turned into beam requests (4 beams, 48 new tokens): the
            groups ride with the greedy rows and oversubscribe the 8
            slots; every request finishes (the beams with reason "beam"),
            the serve path's kernels launch; tokens/s, TTFT, the peak
            blocks the groups hold beside the count if each beam held its
            own prompt blocks (they must share), the beam select's and
            the group update's ms a group and tick. Then a third beam
            request over an int8 pool beside the two long prompts (path
            ``beam_serve_i8``: int8 K3/K4)
  beam_check  at 4 layers, float32: the engine's beams (two groups riding
            with greedy rows) equal ``paged_beam_search`` of each prompt
            on the card token for token, scores within 1e-5 relative; the
            best score within 1e-4 of ``paged_beam_search`` through the
            plain versions; the same engine with every tick eager gives
            the same beams bit for bit; a replay mid-group equals the
            eager tick (``graph_against_eager``), and the beam reorders
            leave the captured tensors in place
  grammar_serve  the 7B bf16 model over a synthetic vocabulary of 32000
            token strings from the seed (``grammar_vocab``; EOS id 2): 12
            requests, 4 under a two-field JSON schema, 2 under
            ``[0-9]{3}-[0-9]{4}``, 6 free, greedy and at temperature 0.8;
            tokens/s, the biased graph's device ms a tick against the
            unbiased graph's, the host ms a tick building bias rows and
            each automaton's build time over all its states
  grammar_check  every grammar stream that ended on EOS matches its
            pattern (``re.fullmatch``); every free greedy stream equals
            its stream from a run with no grammar row; the biased graph's
            replay equals the eager biased tick (``graph_against_eager``)
  tenant_serve  the serve phase's model and engine settings with
            tenants, the degradation ladder and the SLO tracker: (a) the
            mix with no tenants, a controller held at L0 and a tracker
            gives the serve phase's greedy rows token for token, also
            under PT_DEGRADE=0 and PT_SLO=0; (b) the mix split into
            tenants A (weight 2: requests 0-5), B (weight 1: 6-9) and C
            (best effort, a token bucket of 200 tokens/s and a burst of
            50: the sampled 10-11; C must be throttled) under the default
            signals: the admission order, per-tenant admissions,
            finishes, throttles and sheds, the rungs the ladder visited
            and the signal behind each move, tokens/s beside the serve
            phase's, the host ms a step of the ladder's poll, the
            tracker's poll and its tick charge, and the decode replays'
            share of the wall; (c) forced rungs: L1 launches no K3
            verify with the self-draft (L0 does), L2 chunks a 300- and a
            384-token prompt in at most max_prompt_len // 4 tokens, L3
            keeps best-effort C queued while A and B finish, L4 rejects
            with OverloadError, back at L0 everything drains quiescent;
            (d) the cost ledger's device seconds equal pass (b)'s
            serving_tick_seconds within 1e-6 s and its good tokens by
            tenant sum to the tokens emitted
  endpoint_check  the metrics server on a free port and a shipper into a
            temporary file; a client thread scrapes every route every 50
            ms from before the engines are built (their graph captures
            run under it) while pass (a) serves again: the greedy rows
            must equal pass (a)'s, every route answer 200 (``/healthz``
            200 or 503, with its JSON); then 8 rows in steady decode under
            one ``/profile?seconds=1`` (``torch.profiler``), whose trace
            must name the decode kernels (``paged_decode``,
            ``rope_kv``): its wall and bytes; the shipper's lines carry
            deltas and the ``device_bytes_*`` gauges of the card
  hf_load   the serve phase's model written as an HF checkpoint directory
            (meta-llama/Llama-2-7b-hf's config.json, bf16 safetensors
            shards of at most 5 GB in HF's names and [out, in] layouts,
            written by this script) and read back onto the card with
            ``models.auto.auto_from_pretrained(dir, dtype=bf16)``: every
            parameter bit-equal to the served model's; the same for
            Qwen1.5-MoE-A2.7B's widths at 2 layers (expert stacks, the fp32
            router). Seconds to write and to load, the host's peak RSS in
            each, the device bytes; the directories (under TMPDIR) are
            deleted (with too little room there for 13.5 GB, the first 8
            layers only)
  router_serve  the serve mix through ``serving.Router`` on hf_load's
            reloaded model, each replica built with the serve phase's
            engine arguments: (a) two "both" replicas sharing the model,
            in sequential rounds and with ``run(parallel=True)``; (b) a
            prefill-role and a decode-role replica, every sequence handed
            over sealed (12 transfers); (c) (b) over int8 pools on
            quant_serve's quantized model. Greedy rows equal serve's in (a)
            and (b) and quant_serve's in (c); tokens/s and TTFT, the
            handoffs' blocks, bytes and ms (p50, p95), each replica's
            launches (graph replays counted)
  router_check  at the same width: a corrupted shipment
            (``router.kv_partial``) rejected by validation and retried
            exactly once; a failed extraction (``router.kv_transfer``)
            requeued with no leaked block; two replica deaths, requeued
            exactly once and then restored from a snapshot
            (``snapshot_every=1``); ``drain_replica`` on the prefill
            replica mid-chunk flushing its handoffs; a bf16 replica
            refusing an int8 payload by name; every replica quiescent
  gptq_serve  the serve phase's model (Llama-2-7B width, all 32 layers)
            quantized three ways, each on a copy, from calibration ids
            [2, 512] of np.random.RandomState(19): (a) GPTQ int4
            (``quantize_for_serving(copy, "gptq_int4", calib_ids=...)``:
            one capture forward, then the card's float64 Hessians and
            lazy-batch recursion), (b) weight-only int8 after calibrated
            smoothing (``smooth=True, calib_ids=...``), (c) RTN int4; each
            served with the serve mix over a bf16 pool through
            ``LLMEngine`` (every request its full token count; K1-K4, K7
            and rope_kv launched): the quantize seconds (capture, Hessians,
            recursion), weight bytes, ``quant_quality`` against the bf16
            model on a held-out [4, 128] batch, tokens/s. (a)'s output MSE
            on the first layer's calibration activations must be below
            (c)'s for all four projections, and (b)'s smoothed bf16 model
            within SMOOTH_REL of the unsmoothed one's logits (RMS)
  gptq_check  GPTQ on the card against the port's CPU path (the
            reference's float64 loop) over the same weights and captured
            activations: the first layer's four projections at full K and
            their first GPTQ_CHECK_COLS output channels (the recursion is
            row-independent), scales bit-equal and at least 99.9% of the
            codes equal (the count that differ printed); then calibrated
            smoothing of a CHECK_LAYERS-layer float32 copy at 7B width on
            the card and on the CPU, every folded weight within
            SMOOTH_CHECK_RTOL
  spec_generate  the standalone speculative API: four prompts of 64-128
            tokens (RandomState(19)), 64 new tokens, gamma 4, with the
            target itself as draft and TinyLlama-1.1B's widths with random
            weights (nearly every proposal rejected). On the served bf16
            model ``speculative_generate`` per prompt beside ``generate``:
            tokens/s, rounds, acceptance, draft and verify ms a round, and
            the leading tokens each stream shares with generate's (a
            5-token verify rounds differently from one-token decode in
            bf16); on float32 copies of both models (the target's first
            SPEC_FP32_LAYERS layers, the draft whole) every
            ``speculative_generate`` stream equal to ``generate``'s, the
            rows of ``speculative_generate_batched`` over the ragged four
            equal to their solo runs, ``speculative_sample`` at temperature
            1.0 the same tokens twice at one seed and at temperature 0
            generate's
  spec_check  (a) at 4 layers, float32: greedy speculative streams with
            both drafts (TinyLlama's widths cut to 4 layers too) equal the
            non-speculative engine's token for token; (b) at 7B bf16 one
            verify chunk's logits (5 a row) through the kernels and the
            plain versions against float32, CHECK_REL
  train     the ``bench.py`` headline train step on the port (Llama 0.74B:
            hidden 2048, 12 layers, 16 heads, vocab 32000, bf16, no remat;
            AdamW with fp32 master weights, global-norm clip 1.0) at batch
            4 x 2048 with random weights from a seed: 2 warm-up and 8 timed
            steps on one fixed batch; every loss finite, the last below the
            first, and the rms_norm, flash forward and both flash backward
            kernels launched; step ms, tokens/s, MFU and peak memory
  dist_train  the train step over a HybridMesh: ``init_parallel_env`` joins
            a world of one rank with NCCL (the rendezvous through a
            FileStore in a temporary directory), then 3 steps of
            ``make_train_step(..., mesh=HybridMesh())`` on the train
            phase's configuration, seed, batch and AdamW; its losses must
            equal the train phase's first three bit for bit, and each
            train kernel launch as often a step as the unsharded step's;
            ms/step beside train's
  pp_train  ``make_llama_pp_train_step`` at pp = 1 over the same world, 4
            microbatches of 1 x 2048, under the 1f1b and zb1 schedules:
            the pipeline's loss and the gradients of GRAD_NAMES against the
            unsharded step's on the same weights and batch (LOSS_REL,
            GRAD_REL of the RMS), zb1's loss and every gradient equal to
            1f1b's bit for bit, then 3 AdamW steps in each arm (1f1b,
            zb1; losses equal bit for bit); ms/step beside train's.
            ``--phases ...,pp_train,pp_anatomy`` adds a third arm (1f1b
            again, for the order's share of a gap) and then profiles 2
            unsharded train steps and 2 1f1b steps (device kernels, then
            host functions under cProfile)
  sp_train  sequence parallelism over a one-rank sp group (NCCL):
            ``ulysses_attention``, ``ring_attention`` and
            ``zigzag_ring_attention`` at the train phase's attention shape
            (q/k/v [4, 2048, 16, 128] bf16), forward and backward, against
            the unsharded ``scaled_dot_product_attention`` (K2 / K5):
            Ulysses bit for bit (its exchange is the identity at sp = 1,
            so K2, K5a and K5b run once each on the unsharded shape), the
            ring and zigzag ring (plain PyTorch block steps) within SP_REL
            of the RMS; the forward and forward + backward times of each
  ep_train  expert parallelism over a one-rank ep group (NCCL): one MoE
            layer at moe_train's widths and tokens (2048 / 60 experts of
            1408 / top-4, 2 x 2048 tokens, bf16, capacity factor 1.25)
            through ``_forward_ep`` against ``_forward_local``: output,
            aux, drop rate and every gradient (EP_REL of the RMS); K6a
            launched 4 times (2 forward, 2 dlhs) and K6b twice, and both
            held to their plain versions and timed at the compacted rows
            the ep path hands them
  remat_train  the same configuration and batch with remat on: 2 steps
            from one seed under each remat_policy (None, hidden, no_ffn,
            dots) and with scan_layers=True (None), then 4 more timed; loss
            and every gradient of the first two steps bit-identical across
            the five, the tensors the checkpoints keep growing None <
            hidden < no_ffn < dots (bytes of the distinct storages autograd
            packs), K2 launched in the backward no more often under dots
            than under hidden; step ms, peak memory, and K2 / K7 launches in
            the backward per run
  trainer_fit  ``Trainer.fit`` on the same configuration (AdamW with fp32
            masters, the NaN guard on) at batch 4 x 2048, fed by
            ``TokenBinDataset`` (one reader thread) over a seeded 64 M-token
            uint16 file in a temp directory through ``prefetch_to_device``:
            8 steps in each of three arms from seed 0 (pipeline_depth 0, 2,
            2 with device_double_buffer), every loss and the final lm_head
            bit-identical across the arms; ms/step, tokens/s, train_mfu
            against the card's row, the host's share of the fit blocked on
            loss fetches, peak memory; then the Trainer's
            grad_accum_steps=2 over 2 x 2048 halves against one 4 x 2048
            batch (loss within ACCUM_LOSS_REL, gradients within
            ACCUM_GRAD_REL of their RMS)
  sharded_ckpt  bench.py's headline train model and AdamW (lr 1e-4,
            weight decay 0.01) as a ``Trainer`` over a one-rank NCCL
            ``HybridMesh(fsdp=1)`` at 4 x 2048: 2 steps, a save in the
            global format (``CheckpointManager``), 2 more steps (the
            uninterrupted run); a fresh sharded Trainer (another seed)
            restores it, saves the sharded format
            (``use_orbax=True``: the rank's file and the index) and takes
            the 2 steps, a third restores that and takes them: both
            resumed runs' losses bit-identical to the uninterrupted run's.
            Each format's write and restore seconds, bytes and GB/s (the
            files under TMPDIR, deleted)
  ckpt_resume  the same width at 4 layers under ``ElasticRunner`` with
            ``CheckpointManager(async_save=True)`` every 2 steps: a clean
            4-step run, then one whose 4th step raises at the
            ``train.step`` fault site (one restart from the step-2
            checkpoint, the token stream fast-forwarded), final parameters
            bit-identical to the clean run's; save / restore seconds, GB/s
            and bytes; a truncated latest checkpoint falls back to the
            previous one
  lora_train  ``LlamaConfig.llama2_7b()`` (random bf16 weights, frozen,
            remat on), rank-8 adapters on qkv_proj / o_proj trained by
            ``peft.make_lora_train_step`` with AdamW at 1 x 2048, 4 steps:
            ms/step, peak memory, the loss falling, every base parameter
            bit-identical and without a gradient
  fp8_train  ``fp8_matmul`` (``torch._scaled_mm``) against its plain
            version at the qkv shape (forward, dx, dw within FP8_CHECK_REL
            of the product's largest value; histories equal), then the
            headline model with ``fp8=True`` beside its bf16 run from one
            seed, 6 steps at 4 x 2048: on fresh batches of the token file
            every loss within the reference's bound 0.15 |a| + 0.05 of the
            bf16 loss; on the headline's fixed batch the card's fp8 run
            within FP8_PATH_REL of the same run with plain products
            (``amp.fp8.plain_products``), the gap to bf16 reported; ms/step
  amp_check  ``amp.decorate(level="O2")`` of a 2-layer float32 model
            trained 3 steps in bf16 with fp32 masters; an enabled
            ``GradScaler`` on the float32 model with an injected inf
            gradient (the scale halves, the step is skipped, no host sync
            inside the scaler under ``set_sync_debug_mode("warn")``); a
            float16 model's loss on the card (finite) and
            ``amp.is_float16_supported`` True
  paged_generate  ``models.paged.paged_generate`` on the serve phase's
            model (Llama-2-7B width, bf16): 8 ragged prompts, greedy, 64
            new tokens, twice with the same shapes: without EOS, then
            with row 0's ninth token as EOS; row 0 stops there and is
            padded with it, every row equals the first call's up to its
            EOS, the pool is the ragged bound; tokens/s of the second call
  f16_serve  ``LlamaConfig.llama2_7b()`` at full width in float16 (random
            weights from the seed) serving the 12-request mix through
            ``LLMEngine`` (CUDA-graph tick, chunked prefill), then again
            over an int8 KV pool (path ``f16_serve_i8``); every launch on
            a kernel's float16 instantiation (each total equal to its
            ``<name>_f16`` count); tokens/s beside serve's bf16
  f16_check  the f16 model's prefill, chunk and first-decode logits
            through the kernels and the float16 plain versions against
            float32 (limit F16_CHECK_REL 0.03 of the RMS; the kernel path
            within 2x the plain path's distance), then six greedy streams
            token for token with the float16 plain path up to the first
            step whose float32 top-2 margin is under 2 * F16_CHECK_REL of
            that step's logit RMS
  f16_train  the train phase's model in float16 with fp32 masters through
            ``GradScaler`` from 2**24: overflowed steps skipped (every
            parameter, master and moment kept) while the scale halves,
            then steps taken; losses falling and, before each update, no
            further from the same loop's float32 run than twice the bf16
            run is (floor F16_LOSS_REL 0.02 of the loss); ms/step of f16
            and bf16; first, K5 at float16 under cotangent scales 1 to
            2**28 against the fp32 backward (error, flushed share,
            non-finite outputs)
  f16_moe   Qwen1.5-MoE-A2.7B's widths at 4 layers in float16: the
            12-request mix through ``LLMEngine`` (K6a's decode route in the
            tick, its tensor-core route at prefill; path
            ``f16_moe_serve``), then two train steps at 2 x 2048 (K6a and
            K6b on the tensor cores; path ``f16_moe_train``)
  moe_serve ``Qwen/Qwen1.5-MoE-A2.7B`` whole and at full width (its
            published config written out in ``qwen_moe_config``: 24 layers,
            60 experts of 1408 top-4 plus a shared expert, vocab 151 936;
            14.3 B parameters in bf16, random weights from a seed made on
            the card) served by ``LLMEngine`` with the serve phase's engine
            geometry and request mix; every request must finish,
            ``assert_quiescent()`` must pass, and K1-K4 and the grouped GEMM
            (``grouped_fwd``, 2 launches per layer and forward) must have
            been launched
  moe_check the serve check's three logit blocks on the same widths cut to
            6 layers (a float32 copy of all 24 does not fit the card):
            kernels vs plain vs float32 under the check's rule with the
            limit MOE_CHECK_REL (bf16 and float32 may route a near-tie
            token to different experts), and the kernel path run twice
            must give identical bits; then (with ``moe_train``) the MoE
            train model's loss and three gradients on one 2048-token row
  moe_train the same widths at 4 layers (2.9 B parameters) trained through
            ``make_train_step`` with the train phase's AdamW settings at
            batch 2 x 2048: 2 warm-up and 8 timed steps on one fixed batch;
            every loss finite, the last below the first, K1, K2, K5 and the
            grouped GEMM forward and drhs kernels launched (16 and 8 per
            step, every drhs on K6b's tensor-core kernel by that kernel's
            own count); step ms, tokens/s and peak memory
  window_serve  ``MistralConfig.mistral_7b()`` whole (7.24 B parameters,
            sliding window 4096, random weights from a seed made on the
            card) served by ``LLMEngine`` in 4 slots: four prompts of 4200
            to 4600 tokens and two short ones, 48 new tokens each; every
            request must finish, ``assert_quiescent()`` pass, each long row
            recycle (prompt - 4096) // 16 blocks right after its prefill and
            never hold more than 258 live blocks, and K1, K2, K4 and K7
            must have been launched
  window_check  the 4600-token row's prefill (K2 windowed) and one decode
            step (K4 windowed) under the check's rule: kernels vs plain vs
            float32, limit CHECK_REL
  quant_serve  the serve phase's Llama-2-7B quantized in place by
            ``quantize_for_serving(model, "weight_only_int8")`` and served
            by ``LLMEngine(kv_dtype="int8")`` with the serve phase's
            geometry and request mix: every request must finish,
            ``assert_quiescent()`` must pass, K1, K2, K7 and the int8 modes
            of K3 and K4 (``paged_chunk_i8``, ``paged_decode_i8``) must have
            been launched and the bf16 K3/K4 not at all; tokens/s, TTFT,
            KV bytes per token, weight bytes and peak memory beside the
            serve phase's
  quant_check  the check's three logit blocks over an int8 KV pool, with
            the bf16 weights (before the quantization) and with the int8
            weights (after it), each through the kernels and through the
            plain versions, under the check's rule (limit CHECK_REL)
            against a float32 run of the weights served: the unquantized
            model's, then the dequantized int8 weights'. With the int8
            weights the kernel path is also held to the unquantized
            float32 logits, limit QUANT_WEIGHT_REL (a quantizer fault that
            the dequantized reference shares shows there); the logit MSE
            and the greedy match against the bf16 model are reported
  bloom_serve  ``BloomConfig()`` as it stands (``bigscience/bloom-560m``:
            24 layers, hidden 1024, 16 heads of 64, vocab 250 880, tied
            head; 0.56 B parameters, bf16, random weights from a seed made
            on the card) through ``generic_generate``: 8 prompts of 128
            tokens, 32 new tokens each, greedy, every step a forward of the
            fixed [8, 160] buffer; K2 must run in its ALiBi mode, once a
            layer and step, and never without it; tokens/s, ms a step and
            peak memory; then the prompt logits (one forward of [8, 128])
            through the kernels, through the plain versions and in float32
            under the check's rule (limit CHECK_REL)
  bloom_train  the same model (no remat) through ``make_train_step`` with
            the train phase's AdamW at batch 4 x 2048: first the loss and
            three gradients (first block's qkv, last block's 4h->h, the
            tied embeddings) on one row against the plain versions and
            float32 (GRAD_REL, LOSS_REL), then 2 warm-up and 8 timed steps;
            K2, K5a and K5b in their ALiBi mode once a layer and step each,
            never without it; ms/step, tokens/s, MFU (the headline's
            formula at these widths) and peak memory
  falcon_rw_serve, falcon_rw_train  the same two at ``tiiuae/falcon-rw-1b``
            (``falcon_rw_1b_config``: 24 layers, hidden 2048, 32 heads of
            64, vocab 50 304, sequential block, biases, ALiBi at 2/sqrt(64)
            times BLOOM's slopes; 1.31 B parameters)
  falcon7b_serve  ``FalconConfig()`` as it stands (``tiiuae/falcon-7b``: 32
            layers, hidden 4544, 71 heads of 64 over one shared K/V head,
            parallel block, rope; 6.92 B parameters) through
            ``generic_generate`` with the same mix: K2 without ALiBi at GQA
            71:1 and K7; then the prompt logits at 8 of its 32 layers
            (a float32 copy of all 32 would not fit beside it) under the
            check's rule
  gemma_train  ``google/gemma-2b`` whole (``gemma_2b_config``: 18 layers,
            hidden 2048, 8 heads of 256 over one KV head, MLP 16 384,
            vocab 256 000, tied head; 2.51 B parameters, bf16, random
            weights from a seed made on the card) through
            ``make_train_step`` with the train phase's AdamW at batch
            2 x 2048, remat on (``GemmaConfig``'s default): first the loss
            and three gradients on one row against the plain versions and
            float32, then 2 warm-up and 8 timed steps; K2 twice a layer
            and step (the forward and remat's recompute), K5a and K5b once,
            all at head dim 256 on the tensor cores (GQA 8:1), K7 on every
            rope, and neither ``eager_attention`` nor a plain version of
            K2/K5/K7 ever; ms/step, tokens/s, MFU and peak memory
  gemma7b_serve  ``GemmaConfig()`` as it stands (``google/gemma-7b``: 28
            layers, hidden 3072, 16 heads of 256, MLP 24 576, vocab
            256 000; 8.54 B parameters) through ``generic_generate`` with
            the generate mix: K2 at head dim 256 once a layer and step and
            K7, never ``eager_attention`` or a plain version; then the
            prompt logits at 8 of its 28 layers under the check's rule
  gptj_serve  ``GPTJConfig()`` as it stands (``EleutherAI/gpt-j-6b``: 28
            layers, hidden 4096, 16 heads of 256, interleaved rope on 64
            lanes, plain PyTorch as the reference's; 6.05 B parameters)
            the same way (K2 alone: GPT-J's rope has no kernel), the
            prompt check at 8 layers
  gptj_train  GPT-J-6B's widths at 4 layers (1.22 B parameters), batch
            4 x 2048, remat off, as ``bloom_train``: K2, K5a (group 1) and
            K5b (group 1) at head dim 256 once a layer and step each
  gpt3_train  ``bench.py``'s ``bench_gpt3_tp``: ``GPTConfig()`` whole
            (GPT-3 1.3B, remat on) through ``make_train_step`` with
            AdamW(2e-4, weight_decay=0.1) over a one-rank NCCL
            ``HybridMesh(tp=1)``, batch 4 x 1024: the train check, then 10
            steps (K2 twice a layer and step, K5a and K5b once, exactly;
            no plain version); ms/step, tokens/s, MFU, peak memory
  neox_serve, opt_serve, phi_serve, glm_serve  Pythia-6.9B, OPT-6.7B,
            Phi-2 (32 heads of 80: K2 at head dim 80) and GLM-4-9B (GQA
            16:1, K1 norms) whole through ``generic_generate`` as
            ``bloom_serve`` (exact launch counts: K2 once a layer and
            step, K7 twice for Pythia and Phi-2, K1 twice and once at the
            end for GLM), the prompt check at 8 layers
  phi_train  Phi-2's widths at 4 layers, batch 4 x 2048, remat off: K2,
            K5a and K5b at head dim 80 once a layer and step, K7 four
            times (q, k; forward and backward)
  bert_train  ``bench.py``'s ``bench_bert_dp`` (BASELINE config 2) at
            dp = 1: ``BertForPretraining(BertConfig.base())`` in bf16,
            batch 8 x 128, AdamW(1e-4, weight_decay=0.01) through
            ``make_train_step(..., with_rng=True)`` over a one-rank NCCL
            ``HybridMesh(dp=1)``, hidden and attention dropout 0.1: the
            loss and three gradients at dropout 0 against float32
            (GRAD_REL), then 10 steps in which attention runs the eager
            path (its dropout, as the reference's goes to
            ``xla_attention``) and no kernel launches; samples/s, ms/step,
            MFU, peak memory
  bert_finetune  ``BertForSequenceClassification`` at BERT-base, bf16,
            ``varlen_attention``, attention dropout 0, hidden dropout
            0.1: batch 32 x 128 right-padded to seeded lengths in
            16-128, 8 steps; K2, K5a and K5b without a causal mask at head
            dim 64 with kv_lens, exactly 12 launches of each a step, no
            plain version
  bert_encode  ``BertModel`` at BERT-base in eval, bf16, varlen, the same
            batch: exactly 12 K2 launches a forward, sequences/s, the
            valid rows' hidden states held to float32 (CHECK_REL)
  encoder_serve  one eval forward each of RoBERTa, ERNIE, ELECTRA,
            LayoutLM, DistilBERT, ALBERT and ERNIE-M (the auto registry's
            classes at their configs' published default widths, bf16)
            on 32 full-length rows of 128 tokens without a mask: K2
            exactly once a layer (ALBERT: once an application of its
            shared layer), no plain version, sequences/s, each output held
            to float32 (CHECK_REL)
  anatomy   (only when asked for: --phases build,anatomy or
            build,train,anatomy) 16 steady decode ticks and, with
            ``train``, ``bloom_train`` or ``falcon_rw_train``, 2 steps of
            each of those train steps: wall time of three plain runs, then
            device kernel time per tick or step under torch.profiler with
            the kernels that take it, and the Python functions that take
            the host time under cProfile; then the decode tick's graph
            replays timed with CUDA events against the step's wall. With
            ``async_serve`` too, the same for the decode tick of
            ``LLMEngine(async_depth=2)``
  lora_anatomy  (only when asked for, after lora_serve) the same for the
            multi-LoRA decode tick: 8 slots on the three adapters and the
            base (the LoRA graph's kernels, K6a's LoRA kernels among them)
  moe_anatomy  (only when asked for) the same for the MoE model's decode
            tick (with ``moe_serve``) and train step (with ``moe_train``)
  quant_anatomy  (only when asked for) the same for the quantized model's
            decode tick over an int8 pool (after ``quant_serve``'s
            quantization)
  k4_splits  (only when asked for) K4 at the window, serve (bf16 and
            int8) and Qwen2-7B decode shapes with its live key range cut
            into splits of 128, 256, 512 and 1024 keys, each checked and
            timed from a CUDA graph, beside the split ``decode_schedule``
            picks: the measurement behind that schedule
  k3_tiles  (only when asked for) K3's tensor-core route at serving width
            with every block walking 1, 4 or 8 key tiles (prefixes of 0,
            192 and 448 keys before 64 queries): time and the K/V bytes a
            second its blocks stream
  k6_decode_strips  (only when asked for) K6a's decode route at each
            column-strip width of K6_DECODE_STRIPS (128 and 256 bytes,
            built into a library of their own), both fused MoE products
            at the Qwen-MoE and Mixtral decode shapes, checked and timed
            from CUDA graphs: the measurement behind the width the source
            builds
  k6_tiles  (only when asked for) K6a's tensor-core route at each tile
            shape of K6_TILES (64 or 128 rows by 128 or 256 columns), each
            against the plain version and timed at the MoE train and
            prefill shapes: the measurement behind the tile the kernel
            source builds; then, for K6b's tensor-core route at both train
            shapes, the bytes its 128 x 256 tiles read from L2 and how
            evenly its static tile stride spreads the routed rows over
            the persistent blocks

``--root DIR`` imports the package from another checkout (an earlier
commit unpacked with ``git archive``), so that two trees can be compared
under the same measurement in one call: parent, change, change, parent.

The line before the last is a JSON object with one entry per kernel and
path (``"path": "serve"``, ``"async_serve"``, ``"lora_serve"``,
``"spec_serve"``, ``"beam_serve"``, ``"beam_serve_i8"``,
``"grammar_serve"``, ``"tenant_serve"``, ``"router_serve"``,
``"router_serve_disagg"``, ``"router_serve_i8"``, ``"router_check"``,
``"gptq_serve"``, ``"spec_generate"``, ``"train"``, ``"dist_train"``,
``"pp_train"``, ``"sp_train"``, ``"ep_train"``, ``"remat_train"``,
``"trainer_fit"``, ``"lora_train"``, ``"fp8_train"``, ``"moe_serve"``,
``"moe_train"``,
``"window_serve"``, ``"quant_serve"``, ``"bloom_serve"``, ``"bloom_train"``,
``"falcon_rw_serve"``, ``"falcon_rw_train"``, ``"falcon7b_serve"``,
``"gemma_train"``, ``"gemma7b_serve"``, ``"gptj_serve"``,
``"gptj_train"``, ``"gpt3_train"``, ``"neox_serve"``, ``"opt_serve"``,
``"phi_serve"``, ``"phi_train"``, ``"glm_serve"``, ``"bert_finetune"``,
``"bert_encode"``, ``"encoder_serve"``, ``"paged_generate"``,
or a float16 path,
``"f16_serve"``, ``"f16_serve_i8"``, ``"f16_train"``, ``"f16_moe_serve"``
or ``"f16_moe_train"``, whose entries name the float16 counters,
``"<kernel>_f16"``): its
launches are counted in that
path's own run, with every count set to 0 just before it, and its times are
taken at the shapes that path gives the kernel; ``"variant"`` names the
kernel that ran within the CUDA route where a wrapper picks one by dtype
and shape (K2/K5 and K3: ``"wgmma"`` or ``"fma"``; K6a: ``"decode"``,
``"wgmma"`` or ``"fma"``, and at moe_serve one entry for each of the two
fused decode products, ``"decode gate_up"`` and ``"decode down"``; K6b: ``"wgmma"`` or ``"fma"``, from its launch
counts), and each K4 entry carries ``"nsplit"``, the splits of its live
key range at that path's shape. The last line is
``{"ok": true, "device": {...}}``. The script exits non-zero,
printing no result, when there is no card or the port is not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import struct
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PEAK_BYTES_S = 3.35e12      # H100 SXM device memory, bytes/s
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12     # H100 SXM fp32 rate outside the tensor cores
TOL = {"bf16": 2e-2, "f16": 2e-2, "f32": 1e-4}
# The 2-byte type of the kernels phase's checked and timed rows: bf16, or
# f16 inside ``half_rows("f16")``, which also leaves out the float32
# checks that the bf16 pass already made.
HALF = {"name": "bf16", "f32": True}


def _hn():
    return HALF["name"]


def _hdt(torch):
    return {"bf16": torch.bfloat16, "f16": torch.float16}[HALF["name"]]


def _dts(torch, fp32=True):
    """The (name, dtype) pairs a kernel check runs: float32 (unless
    ``fp32`` is False or inside an f16 rerun), then the 2-byte type."""
    f32 = (("f32", torch.float32),) if fp32 and HALF["f32"] else ()
    return f32 + ((_hn(), _hdt(torch)),)


@contextlib.contextmanager
def half_rows(name):
    """The kernel entries inside run and time ``name`` ("f16") rows."""
    old = dict(HALF)
    HALF.update(name=name, f32=False)
    try:
        yield
    finally:
        HALF.update(old)
CHECK_REL = 0.15            # whole-path check: RMS(bf16 - fp32) / RMS(fp32)
# int8 weights against the unquantized fp32 model: sound runs read
# 0.18-0.20 of the RMS, a planted quantizer fault 0.27 or more (truncating
# codes), which the dequantized reference shares (PERF.md §6)
QUANT_WEIGHT_REL = 0.23
SOURCES = {
    "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                 "paddle_tpu/ops/pallas/norms.py:16"),
    "flash_fwd": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                  "paddle_tpu/ops/pallas/flash_attention.py:137"),
    "paged_chunk": ("paddle_tpu_torch/csrc/paged_chunk.cu",
                    "paddle_tpu/ops/pallas/paged_attention.py:373"),
    "paged_decode": ("paddle_tpu_torch/csrc/paged_decode.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:90"),
    "paged_chunk_i8": ("paddle_tpu_torch/csrc/paged_chunk.cu",
                       "paddle_tpu/ops/pallas/paged_attention.py:373"),
    "paged_decode_i8": ("paddle_tpu_torch/csrc/paged_decode.cu",
                        "paddle_tpu/ops/pallas/paged_attention.py:90"),
    # the partials mode of K3 / K4 (context-parallel serving)
    "paged_chunk_partials": ("paddle_tpu_torch/csrc/paged_chunk.cu",
                             "paddle_tpu/ops/pallas/paged_attention.py:373"),
    "paged_decode_partials": ("paddle_tpu_torch/csrc/paged_decode.cu",
                              "paddle_tpu/ops/pallas/paged_attention.py:90"),
    "flash_bwd_dq": ("paddle_tpu_torch/csrc/flash_bwd.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:271"),
    "flash_bwd_dkv": ("paddle_tpu_torch/csrc/flash_bwd.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:321"),
    "grouped_fwd": ("paddle_tpu_torch/csrc/grouped_matmul.cu",
                    "paddle_tpu/ops/pallas/grouped_matmul.py:133"),
    "grouped_dw": ("paddle_tpu_torch/csrc/grouped_matmul.cu",
                   "paddle_tpu/ops/pallas/grouped_matmul.py:178"),
    # K6a at the multi-LoRA call site: the rank-r shrink and the expand
    "lora_shrink": ("paddle_tpu_torch/csrc/grouped_lora.cu",
                    "paddle_tpu/ops/pallas/grouped_matmul.py:133"),
    "lora_expand": ("paddle_tpu_torch/csrc/grouped_lora.cu",
                    "paddle_tpu/ops/pallas/grouped_matmul.py:133"),
    "rope": ("paddle_tpu_torch/csrc/rope.cu",
             "paddle_tpu/ops/pallas/rope.py:14"),
    # K7 folded with the decode tick's KV pool write
    "rope_kv": ("paddle_tpu_torch/csrc/rope.cu",
                "paddle_tpu/ops/pallas/rope.py:14"),
    # the ALiBi mode of K2, K5a and K5b (``_alibi_add`` in each kernel)
    "flash_fwd_alibi": ("paddle_tpu_torch/csrc/flash_fwd.cu",
                        "paddle_tpu/ops/pallas/flash_attention.py:165"),
    "flash_bwd_dq_alibi": ("paddle_tpu_torch/csrc/flash_bwd.cu",
                           "paddle_tpu/ops/pallas/flash_attention.py:295"),
    "flash_bwd_dkv_alibi": ("paddle_tpu_torch/csrc/flash_bwd.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:346"),
}
# each kernel's float16 launches, counted apart (ops.cuda's <name>_f16)
SOURCES.update({f"{k}_f16": v for k, v in list(SOURCES.items())})
# the kernels each path launches (every one must rise in that path's run):
# ops.cuda's SERVE_KERNELS / TRAIN_KERNELS / MOE_SERVE_KERNELS /
# MOE_TRAIN_KERNELS / WINDOW_SERVE_KERNELS / QUANT_SERVE_KERNELS /
# ALIBI_SERVE_KERNELS / ALIBI_TRAIN_KERNELS / ROPE_GENERATE_KERNELS /
# LORA_SERVE_KERNELS / SPEC_SERVE_KERNELS / BEAM_SERVE_KERNELS /
# BEAM_SERVE_I8_KERNELS / GRAMMAR_SERVE_KERNELS / TENANT_SERVE_KERNELS /
# GEMMA_TRAIN_KERNELS /
# GEMMA_SERVE_KERNELS / GPTJ_SERVE_KERNELS / GPTJ_TRAIN_KERNELS /
# GPT3_TRAIN_KERNELS / NEOX_SERVE_KERNELS / OPT_SERVE_KERNELS /
# PHI_SERVE_KERNELS / PHI_TRAIN_KERNELS / GLM_SERVE_KERNELS /
# ROUTER_SERVE_KERNELS / ROUTER_SERVE_I8_KERNELS / GPTQ_SERVE_KERNELS /
# SPEC_GENERATE_KERNELS / REMAT_TRAIN_KERNELS / TRAINER_FIT_KERNELS /
# LORA_TRAIN_KERNELS / FP8_TRAIN_KERNELS / PAGED_GENERATE_KERNELS /
# DIST_TRAIN_KERNELS / PP_TRAIN_KERNELS / CP_SERVE_KERNELS and the
# F16_*_KERNELS, spelled out here so that
# --root can load an earlier tree that lacks them (a kernel that such a
# tree does not have is then left out of its checks)
PATHS = {"serve": ("rms_norm", "flash_fwd", "paged_chunk", "paged_decode",
                   "rope", "rope_kv"),
         "train": ("rms_norm", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "rope"),
         "moe_serve": ("rms_norm", "flash_fwd", "paged_chunk", "paged_decode",
                       "rope", "rope_kv", "grouped_fwd"),
         "moe_train": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                       "flash_bwd_dkv", "rope", "grouped_fwd", "grouped_dw"),
         "window_serve": ("rms_norm", "flash_fwd", "paged_decode", "rope",
                          "rope_kv"),
         "quant_serve": ("rms_norm", "flash_fwd", "paged_chunk_i8",
                         "paged_decode_i8", "rope"),
         "async_serve": ("rms_norm", "flash_fwd", "paged_chunk",
                         "paged_decode", "rope", "rope_kv"),
         "tenant_serve": ("rms_norm", "flash_fwd", "paged_chunk",
                          "paged_decode", "rope", "rope_kv"),
         "bloom_serve": ("flash_fwd_alibi",),
         "bloom_train": ("flash_fwd_alibi", "flash_bwd_dq_alibi",
                         "flash_bwd_dkv_alibi"),
         "falcon_rw_serve": ("flash_fwd_alibi",),
         "falcon_rw_train": ("flash_fwd_alibi", "flash_bwd_dq_alibi",
                             "flash_bwd_dkv_alibi"),
         "falcon7b_serve": ("flash_fwd", "rope"),
         "lora_serve": ("rms_norm", "flash_fwd", "paged_chunk",
                        "paged_decode", "rope", "rope_kv", "lora_shrink",
                        "lora_expand"),
         "spec_serve": ("rms_norm", "flash_fwd", "paged_chunk",
                        "paged_decode", "rope"),
         "beam_serve": ("rms_norm", "flash_fwd", "paged_chunk",
                        "paged_decode", "rope", "rope_kv"),
         "beam_serve_i8": ("rms_norm", "flash_fwd", "paged_chunk_i8",
                           "paged_decode_i8", "rope"),
         "grammar_serve": ("rms_norm", "flash_fwd", "paged_decode", "rope",
                           "rope_kv"),
         "gemma_train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "rope"),
         "gemma7b_serve": ("flash_fwd", "rope"),
         "gptj_serve": ("flash_fwd",),
         "gptj_train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
         "gpt3_train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
         "neox_serve": ("flash_fwd", "rope"),
         "opt_serve": ("flash_fwd",),
         "phi_serve": ("flash_fwd", "rope"),
         "phi_train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rope"),
         "glm_serve": ("rms_norm", "flash_fwd"),
         "bert_finetune": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
         "bert_encode": ("flash_fwd",),
         "encoder_serve": ("flash_fwd",),
         "router_serve": ("rms_norm", "flash_fwd", "paged_chunk",
                          "paged_decode", "rope", "rope_kv"),
         "router_serve_disagg": ("rms_norm", "flash_fwd", "paged_chunk",
                                 "paged_decode", "rope", "rope_kv"),
         "router_serve_i8": ("rms_norm", "flash_fwd", "paged_chunk_i8",
                             "paged_decode_i8", "rope"),
         "router_check": ("rms_norm", "flash_fwd", "paged_chunk",
                          "paged_decode", "rope", "rope_kv"),
         "gptq_serve": ("rms_norm", "flash_fwd", "paged_chunk",
                        "paged_decode", "rope", "rope_kv"),
         "spec_generate": ("rms_norm", "rope"),
         "remat_train": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                         "flash_bwd_dkv", "rope"),
         "trainer_fit": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                         "flash_bwd_dkv", "rope"),
         "lora_train": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                        "flash_bwd_dkv", "rope"),
         "fp8_train": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                       "flash_bwd_dkv", "rope"),
         "paged_generate": ("rms_norm", "flash_fwd", "paged_decode", "rope",
                            "rope_kv"),
         "dist_train": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                        "flash_bwd_dkv", "rope"),
         "pp_train": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                      "flash_bwd_dkv", "rope"),
         "sp_train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
         "ep_train": ("grouped_fwd", "grouped_dw"),
         "sharded_ckpt": ("rms_norm", "flash_fwd", "flash_bwd_dq",
                          "flash_bwd_dkv", "rope"),
         "cp_serve": ("rms_norm", "flash_fwd", "paged_chunk_partials",
                      "paged_decode_partials", "rope", "rope_kv")}
# float16 models (ops.cuda's F16_*_KERNELS): a path's kernels on their
# float16 instantiations, counted apart
PATHS.update({f16: tuple(f"{k}_f16" for k in PATHS[path])
              for f16, path in (("f16_serve", "serve"),
                                ("f16_serve_i8", "quant_serve"),
                                ("f16_train", "train"),
                                ("f16_moe_serve", "moe_serve"),
                                ("f16_moe_train", "moe_train"))})
# kernels of PATHS that the imported tree does not have (only with --root)
ABSENT: set = set()
# the train check: share of the fp32 gradients' RMS that each bf16 path
# may be from them, and of the fp32 loss
GRAD_REL = 0.1
LOSS_REL = 1e-2
TRAIN_SHAPE = (4, 2048, 16, 128)   # the headline step's q/k/v [B, S, H, D]
# the mesh phases: dist_train's steps, pp_train's microbatches (one row of
# the train batch each: q/k/v [1, 2048, 16, 128]) and AdamW steps
DIST_STEPS = 3
PP_MICROBATCHES = 4
PP_MICRO_SHAPE = (1, 2048, 16, 128)
PP_STEPS = 3
# the sp / ep phases: the ring's and zigzag ring's outputs and gradients
# may be this share of the unsharded attention's RMS from it (bf16 P @ V
# rounded where the kernels keep fp32); the ep layer's against the local
# layer's; the ep layer's capacity factor (the MoE LLM's default)
SP_REL = 2e-2
EP_REL = 1e-2
EP_CAPACITY_FACTOR = 1.25
# the train phase's losses, ms/step and launches, which the mesh phases
# are held to
TRAIN_RECORD: dict = {}
# the MoE slice: Qwen1.5-MoE-A2.7B's widths (hidden 2048, 16 heads of 128,
# 60 experts of 1408, top-4) and its train batch 2 x 2048
MOE_HIDDEN, MOE_HEADS, MOE_EXPERTS, MOE_TOPK, MOE_INTER = 2048, 16, 60, 4, 1408
MOE_TRAIN_SHAPE = (2, 2048, 16, 128)
MOE_TRAIN_LAYERS = 4
MOE_CHECK_LAYERS = 6
# the MoE checks' limits: three times the largest first reading on the
# card (logits 0.012-0.017 of the fp32 RMS at 6 layers, gradients
# 0.049-0.097); bf16 and fp32 may route a near-tie token to different
# experts, which these readings include
MOE_CHECK_REL = 0.05
MOE_GRAD_REL = 0.3
# the ALiBi families and Falcon-7B through generic_generate: 8 prompts of
# 128 tokens, 32 new tokens each (greedy), so every step re-forwards the
# fixed [8, 160] buffer; trained at batch 4 x 2048 (BLOOM's training
# length). Falcon-7B's logits are checked at 8 of its 32 layers (a float32
# copy of all 32 beside the bf16 model would take 41 GB)
GEN_ROWS, GEN_PROMPT, GEN_NEW = 8, 128, 32
ALIBI_TRAIN_BATCH, ALIBI_TRAIN_SEQ = 4, 2048
FALCON7B_CHECK_LAYERS = 8
# head dim 256: Gemma-2B trained at its batch 2 x 2048 (q [2, 2048, 8, 256]
# over one KV head), GPT-J-6B's widths at 4 layers and 4 x 2048; Gemma-7B
# and GPT-J-6B generate whole and are checked at 8 of their 28 layers
GEMMA_TRAIN_BATCH, GPTJ_TRAIN_BATCH, HD256_TRAIN_SEQ = 2, 4, 2048
GPTJ_TRAIN_LAYERS = 4
HD256_CHECK_LAYERS = 8
# the other decoder families: GPT-3 1.3B trained whole as bench.py's
# bench_gpt3_tp trains it (4 x 1024, AdamW(2e-4, weight decay 0.1), over a
# one-rank HybridMesh(tp=1)); Pythia-6.9B, OPT-6.7B, Phi-2 and GLM-4-9B
# generate whole (GEN_*), their prompt logits checked at
# DECODER_CHECK_LAYERS layers; Phi-2's widths trained at PHI_TRAIN_LAYERS
# layers, 4 x 2048, remat off (as gptj_train)
GPT3_TRAIN_BATCH, GPT3_TRAIN_SEQ = 4, 1024
PHI_TRAIN_LAYERS, PHI_TRAIN_BATCH, PHI_TRAIN_SEQ = 4, 4, 2048
DECODER_CHECK_LAYERS = 8
# (family of build_generate_model, path): the generate phases
DECODER_SERVE = (("neox", "neox_serve"), ("opt", "opt_serve"),
                 ("phi", "phi_serve"), ("glm", "glm_serve"))
# the BERT-family encoders: bench_bert_dp's batch 8 x 128 (bert_train,
# 10 AdamW steps), and a fine-tune / encoding batch of 32 rows of 128
# positions right-padded to lengths drawn from BERT_LENS_SEED in 16-128
# (bert_finetune's steps; bert_encode's and encoder_serve's timed
# forwards)
BERT_TRAIN_BATCH, BERT_SEQ = 8, 128
BERT_BATCH, BERT_LENS_SEED = 32, 26
BERT_FINETUNE_STEPS, ENCODE_ITERS = 8, 10


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(fn, iters=50):
    """Device time per call of ``fn``: ``iters`` calls captured into one
    CUDA graph and replayed, so no host work stands between the launches
    (``time_ms`` times back-to-back eager calls, which the host bounds
    when a kernel takes less time than its wrapper)."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    del g
    return e0.elapsed_time(e1) / (5 * iters)


def _view_copy(x):
    """A copy of the view ``x`` with its strides: a view of a clone of the
    tensor it views (``x`` itself when it views nothing)."""
    base = x._base
    if base is None:
        return x.clone()
    return base.clone().as_strided(x.size(), x.stride(), x.storage_offset())


def cold_graph_ms(fn, x, iters_min=50):
    """Device time per call of ``fn(x')``, replayed from a CUDA graph as
    in ``graph_ms``, over copies x' of ``x`` (of a view: views, with its
    strides, of copies of the tensor it views): so many that the copies
    and the outputs, all kept alive, fill four times the card's L2. Every
    call then reads its input from device memory and writes bytes no other
    call wrote, as the bytes bound assumes (``graph_ms`` on one tensor
    that fits the L2 would time the L2)."""
    import torch
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    held = (x if x._base is None else x._base)
    n = max(2, -(-4 * l2 // (held.numel() * held.element_size()
                             + x.numel() * x.element_size())))
    xs = [_view_copy(x) for _ in range(n)]
    reps = -(-iters_min // n)
    fn(xs[0])
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(g):
        for xi in xs:
            outs.append(fn(xi))
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    del g, outs, xs
    torch.cuda.empty_cache()
    return e0.elapsed_time(e1) / (reps * n)


def bound(nbytes, flops, peak_flops=PEAK_BF16_FLOPS):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and flops over ``peak_flops`` (the tensor-core bf16 rate, or the
    fp32 rate for work that no tensor core can do)."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak_flops
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _port_has(module):
    """Whether the imported tree has ``paddle_tpu_torch.<module>`` (an
    earlier tree loaded with --root may not)."""
    import importlib.util
    return importlib.util.find_spec(f"paddle_tpu_torch.{module}") is not None


def _missing(path, counts):
    """The kernels of ``path`` that its run did not launch."""
    return [k for k in PATHS[path] if k not in ABSENT and counts[k] <= 0]


# ------------------------------------------------------------------ build
def phase_build():
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.monotonic()
    logs = _build.build()
    log(f"[build] {len(logs)} kernels built for sm_90a in "
        f"{time.monotonic() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry",
                                       "(C75")):
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------- kernels
def _route(FA, name, t):
    """The kernel a K2 / K5 row ran for inputs like ``t``: the route
    ``kernel_route`` names ("wgmma" for bf16: the tensor cores) for each
    kernel of ``ROUTED``. An earlier tree without ``ROUTED`` ran K5a on
    FMAs, one without ``kernel_route`` every kernel."""
    routed = getattr(FA, "ROUTED", ("flash_fwd", "flash_bwd_dkv"))
    if name not in routed or not hasattr(FA, "kernel_route"):
        return "fma"
    return FA.kernel_route(t.dtype, t.shape[-1])


def _k6_route(GM, m, e, k, n, dtype, trans=False):
    """The kernel a K6a launch ran: the route ``fwd_route`` names (an
    earlier tree without it: the few-rows kernel at the decode shape, the
    FMA tile elsewhere)."""
    if hasattr(GM, "fwd_route"):
        return GM.fwd_route(m, e, k, n, dtype, trans)
    rows = (not trans and m <= GM.ROWS_KERNEL_MAX_ROWS_PER_GROUP * e
            and n % (16 // dtype.itemsize) == 0)
    return "rows" if rows else "fma"


def _k6b_ran(GM, call):
    """(``call()``, the kernel its one K6b launch ran), read from the
    wrapper's count of each kernel's launches (an earlier tree without
    those counts had the FMA tile only)."""
    per = getattr(GM.grouped_dw, "route_launches", None)
    if per is None:
        return call(), "fma"
    before = dict(per)
    out = call()
    ran = [r for r, n in per.items() if n != before[r]]
    if len(ran) != 1 or per[ran[0]] != before[ran[0]] + 1:
        raise AssertionError(f"grouped_dw: one launch counted as {per} "
                             f"after {before}")
    return out, ran[0]


def _max_err(a, b, mask=None):
    """(max |a - b|, max |a - b| / (1 + |b|)) over the masked elements."""
    a, b = a.float(), b.float()
    if mask is not None:
        a, b = a[mask], b[mask]
    if not a.numel():
        return 0.0, 0.0
    d = (a - b).abs()
    return float(d.max()), float((d / (1.0 + b.abs())).max())


def _agree(name, dtype, errs):
    """Pass when |kernel - plain| <= tol * (1 + |plain|) everywhere: the
    two round to bf16 at different places (e.g. the plain attention casts
    its probabilities to bf16 before P@V, the kernels keep them in fp32),
    so one bf16 ulp of a value of magnitude 2..8 (1/64..1/16) may differ."""
    tol = TOL[dtype]
    err, scaled = errs
    log(f"[kernels] {name} {dtype}: max_abs_err {err:.3e}, scaled "
        f"{scaled:.3e} (tolerance {tol} * (1 + |plain|))")
    if not scaled <= tol:
        raise AssertionError(f"{name} {dtype}: kernel disagrees with its "
                             f"plain version: {scaled} > {tol}")
    return err


def _paged_new(PA):
    """Whether the imported tree has K4 split over the key range, K3's
    routes and the partials mode of both (an earlier tree: one K4 block
    per (kv head, row), K3 on FMAs, no partials)."""
    return hasattr(PA, "decode_schedule")


def _k3_variant(PA, q):
    """The kernel a K3 row ran: ``chunk_route`` ("wgmma" for bf16 q, "fma"
    for float32; an earlier tree had the FMA kernel only)."""
    return PA.chunk_route(q.dtype) if hasattr(PA, "chunk_route") else "fma"


def _k4_nsplit(PA):
    """The split count of the last K4 launch (1 in an earlier tree)."""
    return getattr(PA.paged_decode_attention, "nsplit", None) or 1


def _triple_agree(label, dtype, got, ref):
    """A partials triple against the plain one under ``_agree``'s rule: m,
    l and acc / l (0 where l == 0); the largest error."""
    errs = [_max_err(a, b) for a, b in (
        (got[0] / got[2].clamp(min=1e-30)[..., None],
         ref[0] / ref[2].clamp(min=1e-30)[..., None]),
        (got[1], ref[1]), (got[2], ref[2]))]
    err = (max(e[0] for e in errs), max(e[1] for e in errs))
    return _agree(f"{label} partials", dtype, err)


def _partials_agree(torch, label, dtype, kernel, plain, q, kp, vp, tables,
                    rest, kw):
    """A kernel's partials triple (acc, m, l) against its plain version's
    over the same table with about a quarter of its entries another
    shard's (the sentinel N, skipped): m, l and acc / l (0 where l == 0)
    under ``_agree``'s rule. acc is held in units of its own l because the
    tensor-core route rounds P to bf16 before P V (as K2 and the plain
    attention do) while the plain partials keep P in fp32, so acc's error
    grows with l; acc / l is what a merge's result is made of."""
    g = torch.Generator(device=tables.device).manual_seed(7)
    drop = torch.rand(tables.shape, generator=g, device=tables.device) < 0.25
    part = torch.where(drop, torch.full_like(tables, kp.shape[0]), tables)
    _triple_agree(label, dtype,
                  kernel(q, kp, vp, part, *rest, partials=True, **kw),
                  plain(q, kp, vp, part, *rest, partials=True, **kw))


def kernel_cases(torch, dev, h=4096, nh=32):
    """Inputs at the serving shapes of a model of hidden size ``h`` with
    ``nh`` heads (default: Llama-2-7B; B = 8 slots, S = C = 128, H = Hkv =
    nh, D = 128, pool [256, 16, nh, 128], MB = 32), made from a seed on the
    card."""
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    d = 128
    n, bs, mb = 256, 16, 32
    cases = {}
    cases["rms_norm"] = [dict(x=randn(8 * 128, h), w=1.0 + 0.1 * randn(h)),
                         dict(x=randn(8, h), w=1.0 + 0.1 * randn(h))]
    kv_lens = torch.tensor([17, 45, 64, 77, 96, 110, 120, 128],
                           dtype=torch.int32, device=dev)
    cases["flash_fwd"] = dict(q=randn(8, 128, nh, d), k=randn(8, 128, nh, d),
                              v=randn(8, 128, nh, d), kv_lens=kv_lens)
    tables = torch.randperm(n, generator=g, device=dev).reshape(8, mb).to(
        torch.int32)
    offsets = torch.tensor([0, 128, 256, 384, 64, 200, 0, 300],
                           dtype=torch.int32, device=dev)
    chunk_lens = torch.tensor([128, 128, 128, 100, 128, 56, 17, 84],
                              dtype=torch.int32, device=dev)
    kp, vp = randn(n, bs, nh, d), randn(n, bs, nh, d)
    cases["paged_chunk"] = dict(q=randn(8, 128, nh, d), kp=kp, vp=vp,
                                tables=tables, offsets=offsets,
                                chunk_lens=chunk_lens)
    lens = torch.tensor([1, 17, 100, 129, 256, 300, 444, 512],
                        dtype=torch.int32, device=dev)
    cases["paged_decode"] = dict(q=randn(8, nh, d), kp=kp, vp=vp,
                                 tables=tables, lens=lens)
    return cases


def _k3_graph(PA, fn):
    """{"graph_ms": K3's device time from a CUDA graph}, in a tree whose K3
    sets its kernel's attributes once (an earlier tree's K3 set them at
    every launch, so it is timed eager only): {}."""
    return {"graph_ms": graph_ms(fn)} if _paged_new(PA) else {}


def serve_kernel_entries(torch, dev, h=4096, nh=32, fp32=True):
    """K1-K4 against their plain versions at the serving shapes of a model
    of hidden size ``h`` with ``nh`` heads, in bf16 and (``fp32``) float32;
    the bf16 entries with their times and bounds."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import norms
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    cases = kernel_cases(torch, dev, h, nh)
    out = {}
    dtypes = _dts(torch, fp32)
    for dtype, dt in dtypes:
        main = dtype == _hn()     # the timed rows: the path's 2-byte type

        def cast(t):
            return t.to(dt) if t.is_floating_point() else t

        # K1
        errs = []
        for c in cases["rms_norm"]:
            x, w = cast(c["x"]), cast(c["w"])
            errs.append(_max_err(norms.rms_norm(x, w, 1e-5),
                                 norms.rms_norm_plain(x, w, 1e-5)))
        err = _agree("rms_norm", dtype, (max(e[0] for e in errs),
                                         max(e[1] for e in errs)))
        if main:
            out["rms_norm"] = _k1_entry(
                torch, cast(cases["rms_norm"][0]["x"]),
                cast(cases["rms_norm"][0]["w"]), err)
        # K2
        c = cases["flash_fwd"]
        q, k, v, kl = cast(c["q"]), cast(c["k"]), cast(c["v"]), c["kv_lens"]
        b, s, nh, d = q.shape
        valid = (torch.arange(s, device=dev)[None, :] < kl[:, None])
        err = _agree("flash_fwd", dtype, _max_err(
            FA.flash_attention(q, k, v, causal=True, kv_lens=kl),
            FA.flash_attention_plain(q, k, v, causal=True, kv_lens=kl),
            valid))
        if main:
            # only the valid rows count: query row i < kv_lens[b] reads
            # keys 0..i; K/V past kv_lens and the padded q/o/LSE rows
            # (unspecified) need not be moved at all
            rows = int(kl.long().sum())
            keys = int((kl.long() * (kl.long() + 1) // 2).sum())
            es = q.element_size()
            nbytes = 4 * rows * nh * d * es + rows * nh * 4 + 4 * b
            b_ms, b_by = bound(nbytes, 4 * d * nh * keys)
            mask = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None]
                    & valid[:, None, :])[:, None]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            out["flash_fwd"] = dict(
                max_abs_err=err, variant=_route(FA, "flash_fwd", q),
                ms=time_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                                      kv_lens=kl)),
                plain_ms=time_ms(lambda: FA.flash_attention_plain(
                    q, k, v, causal=True, kv_lens=kl)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)),
                bound_ms=b_ms, bound_by=b_by,
                shape=f"q/k/v [{b}, {s}, {nh}, {d}] {_hn()}, causal, kv_lens; "
                      f"{_route(FA, 'flash_fwd', q)} route")
        # K3
        c = cases["paged_chunk"]
        q, kp, vp = cast(c["q"]), cast(c["kp"]), cast(c["vp"])
        tb, offs, cls = c["tables"], c["offsets"], c["chunk_lens"]
        a, cc, nh, d = q.shape
        live = torch.arange(cc, device=dev)[None, :] < cls[:, None]
        err = _agree("paged_chunk", dtype, _max_err(
            PA.paged_chunk_attention(q, kp, vp, tb, offs, cls),
            PA.paged_chunk_attention_plain(q, kp, vp, tb, offs, cls), live))
        if _paged_new(PA):
            _partials_agree(torch, "paged_chunk", dtype,
                            PA.paged_chunk_attention,
                            PA.paged_chunk_attention_plain, q, kp, vp, tb,
                            (offs, cls), {})
        if main:
            es = q.element_size()
            row_len = (offs + cls).long()
            keys = sum(int(offs[i]) * int(cls[i])
                       + int(cls[i]) * (int(cls[i]) + 1) // 2
                       for i in range(a))
            # q/o: the live chunk rows only; K/V: each row's prefix once
            nbytes = (2 * int(cls.sum()) * nh * d * es
                      + 2 * int(row_len.sum()) * nh * d * es + tb.numel() * 4)
            b_ms, b_by = bound(nbytes, 4 * d * nh * keys)
            out["paged_chunk"] = dict(
                max_abs_err=err, variant=_k3_variant(PA, q),
                ms=time_ms(lambda: PA.paged_chunk_attention(q, kp, vp, tb,
                                                            offs, cls)),
                **_k3_graph(PA, lambda: PA.paged_chunk_attention(
                    q, kp, vp, tb, offs, cls)),
                plain_ms=time_ms(lambda: PA.paged_chunk_attention_plain(
                    q, kp, vp, tb, offs, cls)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=f"q [{a}, {cc}, {nh}, {d}] {_hn()}, pool "
                      f"{list(kp.shape)}, MB {tb.shape[1]}")
        # K4
        c = cases["paged_decode"]
        q = cast(c["q"])
        lens = c["lens"]
        err = _agree("paged_decode", dtype, _max_err(
            PA.paged_decode_attention(q, kp, vp, tb, lens),
            PA.paged_decode_attention_plain(q, kp, vp, tb, lens)))
        nsplit = _k4_nsplit(PA)
        if _paged_new(PA):
            _partials_agree(torch, "paged_decode", dtype,
                            PA.paged_decode_attention,
                            PA.paged_decode_attention_plain, q, kp, vp, tb,
                            (lens,), {})
        if main:
            bq, nh, d = q.shape
            es = q.element_size()
            nbytes = (2 * bq * nh * d * es + 2 * int(lens.sum()) * nh * d * es
                      + tb.numel() * 4)
            b_ms, b_by = bound(nbytes, 4 * d * nh * int(lens.sum()))
            out["paged_decode"] = dict(
                max_abs_err=err, nsplit=nsplit,
                ms=time_ms(lambda: PA.paged_decode_attention(q, kp, vp, tb,
                                                             lens)),
                graph_ms=graph_ms(lambda: PA.paged_decode_attention(
                    q, kp, vp, tb, lens)),
                plain_ms=time_ms(lambda: PA.paged_decode_attention_plain(
                    q, kp, vp, tb, lens)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=f"q [{bq}, {nh}, {d}] {_hn()}, pool {list(kp.shape)}, "
                      f"lens sum {int(lens.sum())}")
    return out


def phase_kernels(torch, dev):
    out = serve_kernel_entries(torch, dev)
    k1_fp32_weight(torch, dev)
    train = {"rms_norm": k1_train(torch, dev),
             "flash_fwd": k2_train(torch, dev), **k5(torch, dev)}
    # the MoE slice: K6 at its shapes, K1-K5 at the shapes it gives them
    k6_entries = k6(torch, dev)
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    k6_dec = k6_decode(torch, dev) if hasattr(GM, "moe_gate_up") else {}
    b, s, _, _ = MOE_TRAIN_SHAPE
    # K6a at moe_serve: the two fused decode products and the prefill's
    # gate_up on the tensor cores, one entry each (a parent tree without
    # the decode route: its rows kernel at the decode shape)
    moe_serve = {**serve_kernel_entries(torch, dev, MOE_HIDDEN, MOE_HEADS,
                                        fp32=False),
                 "grouped_fwd": ([*k6_dec["moe_serve"],
                                  {**k6_entries["prefill_fwd"],
                                   "variant": "wgmma prefill gate_up"}]
                                 if "moe_serve" in k6_dec
                                 else k6_entries["serve_fwd"])}
    moe_train = {"rms_norm": k1_train(torch, dev, b * s, MOE_HIDDEN),
                 "flash_fwd": k2_train(torch, dev, MOE_TRAIN_SHAPE),
                 **k5(torch, dev, MOE_TRAIN_SHAPE),
                 "grouped_fwd": k6_entries["train_fwd"],
                 "grouped_dw": k6_entries["train_dw"]}
    # the rope and sliding-window slice: K7 at every path's shapes, K2 at
    # the banded script's shape, K1/K2/K4 at Mistral-7B's serving shapes
    k7_entries = k7(torch, dev)
    k2_banded(torch, dev)
    window = window_kernel_entries(torch, dev)
    results = {"serve": out, "train": train, "moe_serve": moe_serve,
               "moe_train": moe_train, "window_serve": window,
               "falcon7b_serve": falcon7b_kernel_entries(torch, dev)}
    # head dim 256: K2, K5a and K5b at Gemma-2B's and GPT-J-6B's train
    # shapes, K2 at their generate shape
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    if 256 in getattr(FA, "HEAD_DIMS", ()):
        results.update(hd256_kernel_entries(torch, dev))
    # GPT, GPT-NeoX, OPT, Phi (head dim 80) and GLM
    if 80 in getattr(FA, "HEAD_DIMS", ()):
        results.update(decoder_kernel_entries(torch, dev))
    # the encoders: K2 / K5 without a causal mask at BERT-base's shape
    if _port_has("models.bert"):
        import numpy as np
        results.update(encoder_kernel_entries(torch, dev, np))
    # the trainer stack: Trainer.fit and the fp8 step run the headline
    # step's shapes; the LoRA step Llama-2-7B's at 1 x 2048
    b, s, h, d = LORA_TRAIN_SHAPE
    results["lora_train"] = {
        "rms_norm": k1_train(torch, dev, b * s, h * d),
        "flash_fwd": k2_train(torch, dev, LORA_TRAIN_SHAPE),
        **k5(torch, dev, LORA_TRAIN_SHAPE)}
    rope_decode = k7_entries.pop("serve decode")
    for path, r in k7_entries.items():
        results.setdefault(path, {})["rope"] = r
    if "rope_kv" not in ABSENT:
        for path, r in k7_fold(torch, dev).items():
            results[path]["rope_kv"] = r
    # the async engine serves the serve mix, the beam and grammar phases
    # the serve geometry (8 slots, prompts of at most 128 tokens): the same
    # shapes
    results["async_serve"] = results["serve"]
    results["tenant_serve"] = results["serve"]
    results["beam_serve"] = results["serve"]
    results["grammar_serve"] = {k: v for k, v in results["serve"].items()
                                if k != "paged_chunk"}
    # multi-LoRA and speculative serving run the serve mix too: K6a's LoRA
    # kernels at their shapes, K3 at the verify width (the other kernels
    # at the serve rows' shapes)
    if _port_has("serving.adapters"):
        results["lora_serve"] = {**results["serve"],
                                 **(lora_kernel_entries(torch, dev)
                                    if "lora_shrink" not in ABSENT else {})}
        results["spec_serve"] = {**results["serve"], "rope": rope_decode,
                                 "paged_chunk": verify_kernel_entries(
                                     torch, dev)[0]}
    # the ALiBi families: K2, K5a and K5b in their ALiBi mode
    if "flash_fwd_alibi" not in ABSENT:
        results.update(alibi_kernel_entries(torch, dev))
    # K4 at Qwen2-7B's decode shape (GQA 28/4, a group of 7; not a path)
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    if _paged_new(PA):
        _log_entry("not a path paged_decode (qwen2-7b decode)",
                   qwen2_decode_entry(torch, dev))
    # quantized serving: the int8 modes of K3/K4; K1 and K2 run there at
    # the serve path's shapes, K7 on its int8 decode tick
    if "paged_decode_i8" not in ABSENT:
        results["quant_serve"] = {
            **{k: results["serve"][k] for k in ("rms_norm", "flash_fwd")},
            "rope": rope_decode, **int8_kernel_entries(torch, dev)}
        results["beam_serve_i8"] = results["quant_serve"]
        results["router_serve_i8"] = results["quant_serve"]
    # the router's replicas run the serve geometry: the serve path's shapes
    # (a prefill replica the prefill kernels, a decode replica K4 and K7's
    # fold at the decode shape)
    for path in ("router_serve", "router_serve_disagg", "router_check"):
        results[path] = results["serve"]
    # a GPTQ / smoothed model serves the serve geometry, the remat policies
    # run the train step's shapes (their recompute repeats those
    # launches), the speculative API's dense-cache decode K1 and K7 at the
    # serve path's decode widths
    results["gptq_serve"] = results["serve"]
    results["remat_train"] = results["train"]
    # the mesh train step runs the train step's shapes on its one rank;
    # the pipeline its microbatches' (K7's row set by its ROPE_CASES entry)
    results["dist_train"] = results["train"]
    # Ulysses at sp = 1 hands K2 / K5 the train step's attention shape
    results["sp_train"] = {k: results["train"][k] for k in
                           ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    b, s, h, d = PP_MICRO_SHAPE
    results.setdefault("pp_train", {}).update(
        rms_norm=k1_train(torch, dev, b * s, h * d),
        flash_fwd=k2_train(torch, dev, PP_MICRO_SHAPE),
        **k5(torch, dev, PP_MICRO_SHAPE))
    results["trainer_fit"] = results["train"]
    results["fp8_train"] = results["train"]
    # the sharded Trainer runs the train step's shapes; the cp forwards
    # K3 / K4 in their partials mode at the serve shapes, the other
    # kernels at the serve rows' shapes
    results["sharded_ckpt"] = results["train"]
    if "paged_decode_partials" not in ABSENT:
        results["cp_serve"] = {
            **{k: results["serve"][k] for k in ("rms_norm", "flash_fwd",
                                                "rope", "rope_kv")
               if k in results["serve"]},
            **cp_kernel_entries(torch, dev)}
    results["spec_generate"] = {"rms_norm": results["serve"]["rms_norm"],
                                "rope": rope_decode}
    results["paged_generate"] = {k: results["serve"][k]
                                 for k in PATHS["paged_generate"]}
    # every kernel's float16 instantiation at its bf16 rows' shapes
    if "rms_norm_f16" not in ABSENT:
        results.update(f16_kernel_entries(torch, dev))
    torch.cuda.synchronize()
    for path, rs in results.items():
        for name, r in rs.items():
            for ri in (r if isinstance(r, list) else [r]):
                _log_entry(f"{path} {name}", ri)
    return results


def _log_entry(label, r):
    """One kernel row of the kernels phase: times, bound, and where they
    were taken the CUDA-graph times (K1 also its library call's and a copy
    of x's), K3's route (``variant``) and K4's split count."""
    lib = r["library_ms"]
    graph = ""
    if "graph_ms" in r:
        graph = (f" (graph {r['graph_ms']:.4f} ms, "
                 f"{100 * r['bound_ms'] / r['graph_ms']:.1f}% of bound")
        if "library_graph_ms" in r:
            graph += (f", library graph {r['library_graph_ms']:.4f} ms, copy "
                      f"of x graph {r['copy_graph_ms']:.4f} ms")
        graph += ")"
    how = "".join(f", {k} {r[k]}" for k in ("variant", "nsplit")
                  if r.get(k) is not None)
    log(f"[kernels] {label} ({r['shape']}{how}): {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms, library "
        f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']}), "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound{graph}")


def _k1_entry(torch, x, w, err):
    """Times and bound of K1 on x [rows, H] under the weight w."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import norms
    rows, h = x.shape
    es = x.element_size()
    b_ms, b_by = bound(2 * rows * h * es + h * w.element_size(), 4 * rows * h)
    # the small shapes are bound by the host in eager calls: the device
    # times of the kernel and the library call come from CUDA graphs over
    # inputs that do not fit the L2, as does a copy of x (the same bytes
    # read and written: the rate a stream reaches on this card)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: norms.rms_norm(x, w, 1e-5)),
        graph_ms=cold_graph_ms(lambda t: norms.rms_norm(t, w, 1e-5), x),
        plain_ms=time_ms(lambda: norms.rms_norm_plain(x, w, 1e-5)),
        library_ms=time_ms(lambda: F.rms_norm(x, (h,), w, 1e-5)),
        library_graph_ms=cold_graph_ms(
            lambda t: F.rms_norm(t, (h,), w, 1e-5), x),
        copy_graph_ms=cold_graph_ms(lambda t: t.clone(), x),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"x [{rows}, {h}] {_short(x.dtype)}, weight "
              f"{_short(w.dtype)}")


def _short(dt):
    return (str(dt).replace("torch.", "").replace("bfloat16", "bf16")
            .replace("float16", "f16"))


def k1_train(torch, dev, rows=8192, h=2048):
    """K1 at a train step's shapes (default: the headline's x [4 * 2048,
    2048]) under a weight of the model's type (bf16), against the plain
    version."""
    from paddle_tpu_torch.ops.cuda import norms
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(rows, h, generator=g, device=dev).to(_hdt(torch))
    w = (1.0 + 0.1 * torch.randn(h, generator=g, device=dev)).to(_hdt(torch))
    err = _agree("rms_norm (train shapes)", _hn(), _max_err(
        norms.rms_norm(x, w, 1e-5), norms.rms_norm_plain(x, w, 1e-5)))
    return _k1_entry(torch, x, w, err)


def k1_fp32_weight(torch, dev):
    """K1 with a bf16 x under an fp32 weight whose values bf16 cannot hold:
    the kernel must match the Pallas kernel and the plain version on such
    a mixed-type call (no path of the port makes one today: the train
    model's norm weights are bf16, its fp32 masters live in the optimizer
    state). It must read the weight in fp32, as the plain version does: then
    the two differ only by fp32 summation order, which changes under 1%
    of the bf16 results; a weight rounded to bf16 changes ~15% of them."""
    from paddle_tpu_torch.ops.cuda import norms
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(8192, 2048, generator=g, device=dev).to(_hdt(torch))
    w = 1.0 + 1e-3 * torch.randn(2048, generator=g, device=dev)
    got = norms.rms_norm(x, w, 1e-5)
    ref = norms.rms_norm_plain(x, w, 1e-5)
    _agree("rms_norm (fp32 weight)", _hn(), _max_err(got, ref))
    same = float((got == ref).float().mean())
    log(f"[kernels] rms_norm {_hn()} x, fp32 weight: {same:.5f} of the "
        f"results bit-equal to the plain version (limit 0.99)")
    if not same >= 0.99:
        raise AssertionError(f"rms_norm rounds the fp32 weight: only "
                             f"{same} of the results equal the plain ones")


def _train_qkv(torch, dev, dt, shape=TRAIN_SHAPE):
    g = torch.Generator(device=dev).manual_seed(99)
    return [torch.randn(*shape, generator=g, device=dev).to(dt)
            for _ in range(4)]


def _attn_bound(b, s, h, d, es, n_in, n_out, n_rows, products,
                extra_bytes=0):
    """Bound of a causal attention pass at [b, s, h, d]: n_in inputs and
    n_out outputs of that shape read / written once, ``n_rows`` fp32 row
    vectors [b, h, s] (1 for K2: its LSE; 2 for K5a/K5b: LSE and delta)
    plus ``extra_bytes`` (e.g. ALiBi slopes), ``products`` matrix products
    over the causal half (2 * d flops per live (query, key) pair each)."""
    pairs = b * h * s * (s + 1) // 2
    rows = b * s * h
    return bound(rows * d * es * (n_in + n_out) + n_rows * rows * 4
                 + extra_bytes, products * 2 * d * pairs)


def k2_train(torch, dev, shape=TRAIN_SHAPE):
    """K2 at a train step's shapes (bf16, causal, no kv_lens): its
    output against the plain version and its log-sum-exp, which the
    backward reads, against torch.logsumexp of the plain fp32 scores."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    q, k, v, _ = _train_qkv(torch, dev, _hdt(torch), shape)
    b, s, h, d = q.shape
    o, lse = FA.flash_fwd_cuda(q, k, v, True, d ** -0.5, None, None)
    err = _agree("flash_fwd (train shapes)", _hn(), _max_err(
        o, FA.flash_attention_plain(q, k, v, causal=True)))
    scores = torch.matmul(q.transpose(1, 2).float(),
                          k.transpose(1, 2).float().transpose(-1, -2))
    scores = scores * d ** -0.5
    scores = scores.masked_fill(
        ~torch.ones(s, s, dtype=torch.bool, device=dev).tril(), float("-inf"))
    _agree("flash_fwd log-sum-exp", "f32",
           _max_err(lse, torch.logsumexp(scores, -1)))
    del scores
    # the serving case: rows with kv_lens, valid rows only
    c = kernel_cases(torch, dev)["flash_fwd"]
    q2, k2, v2, kl = c["q"], c["k"], c["v"], c["kv_lens"]
    _, lse2 = FA.flash_fwd_cuda(q2, k2, v2, True, d ** -0.5, None, kl)
    _, ref2 = FA.flash_attention_fwd_plain(q2, k2, v2, causal=True,
                                           kv_lens=kl)
    valid = (torch.arange(q2.shape[1], device=dev)[None, :]
             < kl[:, None])[:, None, :].expand_as(lse2)
    _agree("flash_fwd log-sum-exp (kv_lens)", "f32",
           _max_err(lse2, ref2, valid))
    b_ms, b_by = _attn_bound(b, s, h, d, q.element_size(), 3, 1, 1, 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        max_abs_err=err, variant=_route(FA, "flash_fwd", q),
        ms=time_ms(lambda: FA.flash_fwd_cuda(q, k, v, True, d ** -0.5, None,
                                             None), iters=20),
        plain_ms=time_ms(lambda: FA.flash_attention_fwd_plain(
            q, k, v, causal=True), iters=5, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=20),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q/k/v {list(shape)} {_hn()}, causal; "
              f"{_route(FA, 'flash_fwd', q)} route")


def _k5_case(torch, FA, q, k, v, do, causal, window=None, kv_lens=None):
    """Kernel and plain gradients of one case from the same saved O/LSE."""
    args = (causal, q.shape[-1] ** -0.5, window, kv_lens)
    o, lse = FA.flash_fwd_cuda(q, k, v, *args)
    got = FA.flash_bwd_cuda(q, k, v, o, lse, do, *args)
    ref = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, *args)
    return got, ref


def k5(torch, dev, shape=TRAIN_SHAPE):
    """K5a (dq) and K5b (dk, dv) against flash_attention_bwd_plain: at a
    train step's shapes and on a small GQA + kv_lens + sliding-window case
    (padded query rows get a zero cotangent, as callers give them), in
    bf16 and fp32. Times of each kernel at the train shapes; the plain
    version and the library yardstick (the backward of
    F.scaled_dot_product_attention, is_causal) compute dq, dk and dv in
    one call, so both entries carry that call's time."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(5)
    small = [torch.randn(2, 200, h, 128, generator=g, device=dev)
             for h in (8, 2, 2, 8)]
    kl = torch.tensor([200, 137], dtype=torch.int32, device=dev)
    rows = (torch.arange(200, device=dev)[None, :] < kl[:, None])
    small[3] = small[3] * rows[:, :, None, None]
    errs = {}
    for dtype, dt in _dts(torch):
        cases = [_k5_case(torch, FA, *(t.to(dt) for t in small), True, 64,
                          kl)]
        cases.append(_k5_case(torch, FA, *_train_qkv(torch, dev, dt, shape),
                              True))
        for got, ref in cases:
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                e = _agree(f"flash_bwd {name}", dtype, _max_err(a, r))
                if dtype == _hn():
                    errs[key] = max(errs.get(key, 0.0), e)
        del cases
    q, k, v, do = _train_qkv(torch, dev, _hdt(torch), shape)
    b, s, h, d = q.shape
    o, lse = FA.flash_fwd_cuda(q, k, v, True, d ** -0.5, None, None)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (_build.dtype_code(q, "k5"), q, k, v, do, lse, delta, True,
            d ** -0.5, None, None)
    plain_ms = time_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), iters=20)
    out = {}
    es = q.element_size()
    for key, fn, n_in, n_out, products in (
            ("flash_bwd_dq", FA.flash_bwd_dq, 4, 1, 3),
            ("flash_bwd_dkv", FA.flash_bwd_dkv, 4, 2, 4)):
        b_ms, b_by = _attn_bound(b, s, h, d, es, n_in, n_out, 2, products)
        out[key] = dict(
            max_abs_err=errs[key], variant=_route(FA, key, q),
            ms=time_ms(lambda: fn(*args), iters=10),
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
            bound_by=b_by,
            shape=f"q/k/v/dO {list(shape)} {_hn()}, causal; "
                  f"{_route(FA, key, q)} route")
    return out


# --------------------------------------------------- ALiBi (K2, K5a, K5b)
def alibi_families():
    """{family: (heads, head dim, the slopes the model hands the kernels)},
    read from the configs the bloom/falcon_rw paths build: BLOOM-560m (its
    ALiBi schedule) and Falcon-RW-1B (the schedule as its forward folds
    it)."""
    import torch
    from paddle_tpu_torch.models.bloom import BloomConfig, alibi_slopes
    from paddle_tpu_torch.models.falcon import falcon_alibi_slopes
    bc, fc = BloomConfig(), falcon_rw_1b_config(torch)
    return {"bloom": (bc.n_head, bc.hidden_size // bc.n_head,
                      lambda dev: alibi_slopes(bc.n_head, dev)),
            "falcon_rw": (fc.num_attention_heads,
                          fc.hidden_size // fc.num_attention_heads,
                          lambda dev: falcon_alibi_slopes(fc, dev))}


def _alibi_mask(torch, slopes, s, dt):
    """The float bias mask of F.scaled_dot_product_attention that computes
    causal ALiBi: -m (i - j) on and below the diagonal, -inf above; [1, H,
    S, S] in ``dt`` (the yardstick; the port never builds it)."""
    i = torch.arange(s, device=slopes.device)
    dist = (i[:, None] - i[None, :]).float()
    bias = -slopes[:, None, None] * dist[None]
    return bias.masked_fill(dist[None] < 0, float("-inf"))[None].to(dt)


def alibi_kernel_entries(torch, dev):
    """K2, K5a and K5b in their ALiBi mode against the plain versions with
    the same slopes, on both routes (bf16 tensor cores, fp32 FMAs), at the
    shapes the BLOOM-560m and Falcon-RW-1B paths give them: generate
    [8, 160, H, 64] (K2; every step re-forwards the buffer) and train
    [4, 2048, H, 64] (K2, K5a, K5b), causal. The bf16 entries carry times
    of the kernel, the plain version, F.scaled_dot_product_attention with
    the float ALiBi mask (its backward for K5) and the same kernel without
    ALiBi at the same shape (``no_alibi_ms``: the bias's cost). Returns
    {path: {kernel: entry}}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    out = {}
    shapes = {"serve": (GEN_ROWS, GEN_PROMPT + GEN_NEW),
              "train": (ALIBI_TRAIN_BATCH, ALIBI_TRAIN_SEQ)}
    for fam, (h, d, slopes_of) in alibi_families().items():
        m = slopes_of(dev)
        for kind, (b, s) in shapes.items():
            path = f"{fam}_{kind}"
            g = torch.Generator(device=dev).manual_seed(61)
            base = [torch.randn(b, s, h, d, generator=g, device=dev)
                    for _ in range(4)]
            slopes = FA._slopes(m, base[0])
            scale = d ** -0.5
            entries = {}
            for dtype, dt in _dts(torch):
                q, k, v, do = (t.to(dt) for t in base)
                args = (True, scale, None, None, slopes)
                o, lse = FA.flash_fwd_cuda(q, k, v, *args)
                ref_o, ref_lse = FA.flash_attention_fwd_plain(q, k, v, *args)
                err = _agree(f"flash_fwd_alibi ({path} shape)", dtype,
                             _max_err(o, ref_o))
                _agree(f"flash_fwd_alibi log-sum-exp ({path} shape, "
                       f"{dtype} inputs)", "f32", _max_err(lse, ref_lse))
                del ref_o, ref_lse
                errs = {"flash_fwd_alibi": err}
                if kind == "train":
                    got = FA.flash_bwd_cuda(q, k, v, o, lse, do, *args)
                    ref = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       *args)
                    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                        key = ("flash_bwd_dq_alibi" if name == "dq"
                               else "flash_bwd_dkv_alibi")
                        e = _agree(f"flash_bwd_alibi {name} ({path} shape)",
                                   dtype, _max_err(a, r))
                        errs[key] = max(errs.get(key, 0.0), e)
                    del got, ref
                if dtype != _hn():
                    continue
                entries.update(_alibi_times(torch, F, FA, _build, q, k, v, do,
                                            o, lse, m, slopes, kind, errs))
            out[path] = entries
            del base
            torch.cuda.empty_cache()
    for path, rs in out.items():
        for name, r in rs.items():
            log(f"[kernels] {path} {name} ({r['shape']}): {r['ms']:.4f} ms "
                f"with ALiBi, {r['no_alibi_ms']:.4f} ms without (x"
                f"{r['ms'] / r['no_alibi_ms']:.3f}); plain {r['plain_ms']:.4f}"
                f" ms, SDPA with the ALiBi mask {r['library_ms']:.4f} ms")
    return out


def _alibi_times(torch, F, FA, _build, q, k, v, do, o, lse, m, slopes, kind,
                 errs):
    """The bf16 entries of one ALiBi shape: K2 (and at the train shape K5a,
    K5b), each with and without ALiBi, the plain version, the library
    yardstick and the bound (the slopes add B * H * 4 bytes)."""
    b, s, h, d = q.shape
    es, scale = q.element_size(), d ** -0.5
    args = (True, scale, None, None, slopes)
    mask = _alibi_mask(torch, m, s, q.dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    shape = (f"q/k/v [{b}, {s}, {h}, {d}] {_hn()}, causal, ALiBi; "
             f"{_route(FA, 'flash_fwd', q)} route")
    heavy = kind == "train"
    b_ms, b_by = _attn_bound(b, s, h, d, es, 3, 1, 1, 2, slopes.numel() * 4)
    out = {"flash_fwd_alibi": dict(
        max_abs_err=errs["flash_fwd_alibi"],
        variant=_route(FA, "flash_fwd", q),
        ms=time_ms(lambda: FA.flash_fwd_cuda(q, k, v, *args),
                   iters=20 if heavy else 50),
        no_alibi_ms=time_ms(lambda: FA.flash_fwd_cuda(q, k, v, True, scale,
                                                      None, None),
                            iters=20 if heavy else 50),
        plain_ms=time_ms(lambda: FA.flash_attention_fwd_plain(q, k, v, *args),
                         iters=5 if heavy else 20, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=20),
        bound_ms=b_ms, bound_by=b_by, shape=shape)}
    if not heavy:
        return out
    code = _build.dtype_code(q, "alibi")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    kargs = (code, q, k, v, do, lse, delta, True, scale, None, None)
    plain_ms = time_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, o, lse, do, *args), iters=5, warmup=1)
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dot, retain_graph=True), iters=10)
    for key, fn, n_in, n_out, products in (
            ("flash_bwd_dq_alibi", FA.flash_bwd_dq, 4, 1, 3),
            ("flash_bwd_dkv_alibi", FA.flash_bwd_dkv, 4, 2, 4)):
        b_ms, b_by = _attn_bound(b, s, h, d, es, n_in, n_out, 2, products,
                                 slopes.numel() * 4)
        out[key] = dict(
            max_abs_err=errs[key], variant=_route(FA, key[:-6], q),
            ms=time_ms(lambda: fn(*kargs, slopes), iters=10),
            no_alibi_ms=time_ms(lambda: fn(*kargs), iters=10),
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
            bound_by=b_by, shape=shape.replace("q/k/v", "q/k/v/dO"))
    return out


def falcon7b_kernel_entries(torch, dev):
    """K2 at the shape Falcon-7B's generate path gives it: q [8, 160, 71,
    64], one shared K/V head (GQA 71:1), causal, without ALiBi; against
    the plain version in fp32 and bf16, timed in bf16 beside the plain
    version and F.scaled_dot_product_attention (is_causal, GQA)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(71)
    b, s, h, d = GEN_ROWS, GEN_PROMPT + GEN_NEW, 71, 64
    base = (torch.randn(b, s, h, d, generator=g, device=dev),
            torch.randn(b, s, 1, d, generator=g, device=dev),
            torch.randn(b, s, 1, d, generator=g, device=dev))
    for dtype, dt in _dts(torch):
        q, k, v = (t.to(dt) for t in base)
        err = _agree("flash_fwd (falcon7b_serve shape, GQA 71:1)", dtype,
                     _max_err(FA.flash_attention(q, k, v, causal=True),
                              FA.flash_attention_plain(q, k, v, causal=True)))
    es = q.element_size()
    pairs = b * h * s * (s + 1) // 2
    b_ms, b_by = bound((2 * b * s * h + 2 * b * s) * d * es + b * h * s * 4,
                       4 * d * pairs)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {"flash_fwd": dict(
        max_abs_err=err, variant=_route(FA, "flash_fwd", q),
        ms=time_ms(lambda: FA.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                          causal=True),
                         iters=20),
        library_ms=time_ms(lambda: _sdpa_gqa(torch, F, qt, kt, vt,
                                             is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q [{b}, {s}, {h}, {d}], k/v [{b}, {s}, 1, {d}] {_hn()}, "
              f"causal; {_route(FA, 'flash_fwd', q)} route")}


# ------------------------------------------- head dim 256 (K2, K5a, K5b)
# (path, q [B, S, H, D], KV heads): Gemma-2B's train step (GQA 8:1) and
# GPT-J-6B's (one KV head a query head)
HD256_TRAIN_CASES = (("gemma_train", (GEMMA_TRAIN_BATCH, HD256_TRAIN_SEQ, 8,
                                      256), 1),
                     ("gptj_train", (GPTJ_TRAIN_BATCH, HD256_TRAIN_SEQ, 16,
                                     256), 16))


def _hd256_bound(b, s, h, hkv, d, es, q_io, kv_io, n_rows, products):
    """Bound of a causal attention pass with ``h`` query heads over ``hkv``
    KV heads: ``q_io`` tensors of q's shape and ``kv_io`` of k's read or
    written once, ``n_rows`` fp32 rows [b, h, s] (LSE, delta), and
    ``products`` matrix products over the causal half (2 d flops per live
    (query, key) pair each)."""
    pairs = b * h * s * (s + 1) // 2
    return bound((q_io * h + kv_io * hkv) * b * s * d * es
                 + n_rows * b * h * s * 4, products * 2 * d * pairs)


def _hd256_inputs(torch, dev, dt, shape, hkv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, s, h, d = shape
    q, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev).to(dt)
            for _ in range(2))
    return q, k, v, do


def hd256_train_entries(torch, dev, path, shape, hkv, label=None, dts=None):
    """K2, K5a and K5b at a head dim 256 train shape (causal, no kv_lens):
    each against its plain version in fp32 (the FMA routes) and bf16 (the
    tensor-core routes; K5b at 256 a dV block and a dK block a k tile),
    K2's LSE against the plain one; times in bf16 of each kernel, the
    plain forward / backward, and SDPA (``is_causal``, GQA by
    ``enable_gqa``) forward / backward, the backward's time on both K5
    rows as ``k5`` gives it. Another head dim's train shape passes its
    ``label``; ``dts``: the (name, dtype) pairs checked (default
    ``_dts``), the timed type last (its errors are the entries'). Returns
    {kernel: entry}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    b, s, h, d = shape
    scale = d ** -0.5
    label = label or f"{path} shape, head dim 256, GQA {h}:{hkv}"
    errs = {}
    for dtype, dt in dts or _dts(torch):
        q, k, v, do = _hd256_inputs(torch, dev, dt, shape, hkv, 256)
        o, lse = FA.flash_fwd_cuda(q, k, v, True, scale, None, None)
        ref_o, ref_lse = FA.flash_attention_fwd_plain(q, k, v, causal=True)
        errs["flash_fwd"] = _agree(f"flash_fwd ({label})", dtype,
                                   _max_err(o, ref_o))
        _agree(f"flash_fwd log-sum-exp ({label}, {dtype} inputs)", "f32",
               _max_err(lse, ref_lse))
        del ref_o, ref_lse
        got = FA.flash_bwd_cuda(q, k, v, o, lse, do, True, scale, None,
                                None)
        ref = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
        e = [_agree(f"flash_bwd {n} ({label})", dtype, _max_err(a, r))
             for n, a, r in zip(("dq", "dk", "dv"), got, ref)]
        errs["flash_bwd_dq"], errs["flash_bwd_dkv"] = e[0], max(e[1:])
        del got, ref, o, lse, q, k, v, do
        torch.cuda.empty_cache()
    q, k, v, do = _hd256_inputs(torch, dev, _hdt(torch), shape, hkv, 256)
    o, lse = FA.flash_fwd_cuda(q, k, v, True, scale, None, None)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (_build.dtype_code(q, "hd256"), q, k, v, do, lse, delta, True,
            scale, None, None)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_fwd = time_ms(lambda: _sdpa_gqa(torch, F, qt, kt, vt,
                                        is_causal=True), iters=20)
    lib_out = _sdpa_gqa(torch, F, qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), iters=20)
    plain_bwd = time_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
    es = q.element_size()
    out = {}
    for key, fn, q_io, kv_io, products, plain_ms, lib_ms in (
            ("flash_fwd", lambda: FA.flash_fwd_cuda(q, k, v, True, scale,
                                                    None, None), 2, 2, 2,
             time_ms(lambda: FA.flash_attention_fwd_plain(q, k, v,
                                                          causal=True),
                     iters=3, warmup=1), lib_fwd),
            ("flash_bwd_dq", lambda: FA.flash_bwd_dq(*args), 3, 2, 3,
             plain_bwd, lib_bwd),
            ("flash_bwd_dkv", lambda: FA.flash_bwd_dkv(*args), 2, 4, 4,
             plain_bwd, lib_bwd)):
        n_rows = 1 if key == "flash_fwd" else 2
        b_ms, b_by = _hd256_bound(b, s, h, hkv, d, es, q_io, kv_io, n_rows,
                                  products)
        out[key] = dict(
            max_abs_err=errs[key], variant=_route(FA, key, q),
            ms=time_ms(fn, iters=10), plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by,
            shape=f"q [{b}, {s}, {h}, {d}], k/v [{b}, {s}, {hkv}, {d}] "
                  f"{_hn()}, causal; {_route(FA, key, q)} route")
    del lib_out, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def hd256_kernel_entries(torch, dev):
    """The head dim 256 paths' attention rows: K2, K5a and K5b at
    HD256_TRAIN_CASES, and K2 at the generate shape both 256-wide serving
    families give it (Gemma-7B and GPT-J-6B: q/k/v [8, 160, 16, 256],
    causal) against its plain version in fp32 and bf16, timed beside the
    plain version and SDPA. Returns {path: {kernel: entry}}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    res = {path: hd256_train_entries(torch, dev, path, shape, hkv)
           for path, shape, hkv in HD256_TRAIN_CASES}
    shape = (GEN_ROWS, GEN_PROMPT + GEN_NEW, 16, 256)
    for dtype, dt in _dts(torch):
        q, k, v, _ = _hd256_inputs(torch, dev, dt, shape, 16, 257)
        err = _agree("flash_fwd (gemma7b_serve / gptj_serve shape)", dtype,
                     _max_err(FA.flash_attention(q, k, v, causal=True),
                              FA.flash_attention_plain(q, k, v,
                                                       causal=True)))
    b, s, h, d = shape
    b_ms, b_by = _hd256_bound(b, s, h, h, d, q.element_size(), 2, 2, 1, 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gen = dict(
        max_abs_err=err, variant=_route(FA, "flash_fwd", q),
        ms=time_ms(lambda: FA.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                          causal=True),
                         iters=20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q/k/v [{b}, {s}, {h}, {d}] {_hn()}, causal; "
              f"{_route(FA, 'flash_fwd', q)} route")
    res["gemma7b_serve"] = {"flash_fwd": gen}
    res["gptj_serve"] = {"flash_fwd": gen}
    return res


# ------------------------- the other decoder families (K1, K2, K5, K7)
# (label, path, leading dims, heads of the viewed part, width of the fused
# QKV product in heads, head dim, rotated lanes): K7 on the partial rotary
# slice x[..., :rot] of a q view, as GPT-NeoX and Phi hand it over (rows
# ``head dim`` apart, so the wrapper copies the slice to a contiguous
# buffer first)
ROPE_PARTIAL_CASES = (
    ("pythia-6.9b generate q, 32 of 128 lanes", "neox_serve", (8, 160), 32,
     96, 128, 32),
    ("phi-2 generate q, 32 of 80 lanes", "phi_serve", (8, 160), 32, 96, 80,
     32),
    ("phi-2 train q, 32 of 80 lanes", "phi_train", (4, 2048), 32, 96, 80,
     32),
)


def _all_dts(torch):
    """float32, float16, then bfloat16 (the timed type last): the head dim
    80 rows and the new families' rows are checked in every type."""
    return (("f32", torch.float32), ("f16", torch.float16),
            ("bf16", torch.bfloat16))


def k7_partial(torch, dev):
    """K7 on the partial-rotary slices of ROPE_PARTIAL_CASES against
    fused_rope_plain, bit for bit in f32, f16 and bf16; times (bf16) of
    the wrapper, which copies the strided slice to a contiguous buffer
    first, eager and from CUDA graphs over cold copies, beside the plain
    version; the bound counts the slice read once, the output written
    once and the tables (no single PyTorch call computes rope: library
    n/a). Returns {path: entry}."""
    from paddle_tpu_torch.ops.cuda import rope as R
    out = {}
    for i, (label, path, lead, h, width, d, rot) in enumerate(
            ROPE_PARTIAL_CASES):
        for dtype, dt in _all_dts(torch):
            g = torch.Generator(device=dev).manual_seed(80 + i)
            qkv = torch.randn(*lead, width * d, generator=g,
                              device=dev).to(dt)
            x = qkv[..., :h * d].reshape(*lead, h, d)[..., :rot]
            pos = torch.arange(lead[-1], device=dev).float()
            inv = 1.0 / 1e4 ** (torch.arange(0, rot, 2, device=dev).float()
                                / rot)
            c, sn = torch.cos(pos[:, None] * inv), torch.sin(pos[:, None]
                                                              * inv)
            differ = int((R.fused_rope(x, c, sn)
                          != R.fused_rope_plain(x, c, sn)).sum())
            log(f"[kernels] rope {label} {dtype}: {differ} results differ "
                f"from the plain version (must be 0)")
            if differ:
                raise AssertionError(f"rope {label} {dtype}: not bit-"
                                     f"identical to the plain version")
        n = x.numel() // (h * rot)
        es = x.element_size()
        b_ms, b_by = bound(2 * n * h * rot * es + 2 * c.numel() * 4,
                           3 * n * h * rot, PEAK_FP32_FLOPS)
        r = dict(max_abs_err=0.0,
                 ms=time_ms(lambda: R.fused_rope(x, c, sn), iters=100),
                 plain_ms=time_ms(lambda: R.fused_rope_plain(x, c, sn),
                                  iters=20),
                 graph_ms=cold_graph_ms(lambda t: R.fused_rope(t, c, sn), x),
                 library_ms=None, bound_ms=b_ms, bound_by=b_by,
                 shape=f"{label}: x [{n}, {h}, {rot}] of heads of {d} "
                       f"{_hn()} (row stride {x.stride(-3)}), tables "
                       f"[{c.shape[0]}, {rot // 2}]")
        out[path] = r
        del qkv, x
    torch.cuda.empty_cache()
    return out


def _gen_attn_entry(torch, dev, label, shape, hkv, seed):
    """K2 at a generate shape (q [B, S, H, D] over ``hkv`` KV heads,
    causal) against its plain version in f32, f16 and bf16 (O and LSE),
    timed in bf16 beside the plain version and SDPA (GQA by
    ``enable_gqa``)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    b, s, h, d = shape
    for dtype, dt in _all_dts(torch):
        q, k, v, _ = _hd256_inputs(torch, dev, dt, shape, hkv, seed)
        o, lse = FA.flash_fwd_cuda(q, k, v, True, d ** -0.5, None, None)
        ref_o, ref_lse = FA.flash_attention_fwd_plain(q, k, v, causal=True)
        err = _agree(f"flash_fwd ({label})", dtype, _max_err(o, ref_o))
        _agree(f"flash_fwd log-sum-exp ({label}, {dtype} inputs)", "f32",
               _max_err(lse, ref_lse))
    b_ms, b_by = _hd256_bound(b, s, h, hkv, d, q.element_size(), 2, 2, 1, 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        max_abs_err=err, variant=_route(FA, "flash_fwd", q),
        ms=time_ms(lambda: FA.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: FA.flash_attention_plain(q, k, v,
                                                          causal=True),
                         iters=20),
        library_ms=time_ms(lambda: _sdpa_gqa(torch, F, qt, kt, vt,
                                             is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"{label}: q [{b}, {s}, {h}, {d}], k/v [{b}, {s}, {hkv}, {d}] "
              f"bf16, causal; {_route(FA, 'flash_fwd', q)} route")


def decoder_kernel_entries(torch, dev):
    """The rows of the other decoder families' paths: K2 / K5a / K5b at
    GPT-3 1.3B's train shape [4, 1024, 16, 128] (``k2_train`` / ``k5``)
    and at Phi-2's [4, 2048, 32, 80] (head dim 80, checked in f32, f16
    and bf16); K2 at the generate shapes [8, 160, H, D] of Pythia-6.9B and
    OPT-6.7B (32 heads of 128), Phi-2 (32 of 80) and GLM-4-9B (32 over 2
    KV heads of 128); K1 at GLM-4-9B's generate rows x [1280, 4096] (its
    epsilon 1.5625e-7, a bf16 weight); K7 on the partial-rotary slices.
    Returns {path: {kernel: entry}}."""
    from paddle_tpu_torch.ops.cuda import norms
    shape = (GPT3_TRAIN_BATCH, GPT3_TRAIN_SEQ, 16, 128)
    res = {"gpt3_train": {"flash_fwd": k2_train(torch, dev, shape),
                          **k5(torch, dev, shape)}}
    rope = k7_partial(torch, dev)
    phi = (PHI_TRAIN_BATCH, PHI_TRAIN_SEQ, 32, 80)
    res["phi_train"] = {
        **hd256_train_entries(torch, dev, "phi_train", phi, 32,
                              label="phi_train shape, head dim 80",
                              dts=_all_dts(torch)),
        "rope": rope["phi_train"]}
    gen = (GEN_ROWS, GEN_PROMPT + GEN_NEW)
    d128 = _gen_attn_entry(torch, dev, "neox_serve / opt_serve shape",
                           (*gen, 32, 128), 32, 90)
    res["neox_serve"] = {"flash_fwd": d128, "rope": rope["neox_serve"]}
    res["opt_serve"] = {"flash_fwd": d128}
    res["phi_serve"] = {
        "flash_fwd": _gen_attn_entry(torch, dev, "phi_serve shape, head dim "
                                     "80", (*gen, 32, 80), 32, 91),
        "rope": rope["phi_serve"]}
    g = torch.Generator(device=dev).manual_seed(92)
    rows, hid, eps = GEN_ROWS * (GEN_PROMPT + GEN_NEW), 4096, 1.5625e-07
    x32 = torch.randn(rows, hid, generator=g, device=dev)
    w32 = 1.0 + 0.1 * torch.randn(hid, generator=g, device=dev)
    for dtype, dt in _all_dts(torch):
        x, w = x32.to(dt), w32.to(dt)
        err = _agree("rms_norm (glm_serve shape, eps 1.5625e-7)", dtype,
                     _max_err(norms.rms_norm(x, w, eps),
                              norms.rms_norm_plain(x, w, eps)))
    res["glm_serve"] = {
        "rms_norm": _k1_entry(torch, x, w, err),
        "flash_fwd": _gen_attn_entry(torch, dev, "glm_serve shape, GQA 16:1",
                                     (*gen, 32, 128), 2, 93)}
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------ the encoders (K2/K5)
def bert_batch(torch, dev, np, vocab):
    """The fine-tune / encoding batch: BERT_BATCH rows of BERT_SEQ
    positions right-padded to lengths drawn in 16-128 from BERT_LENS_SEED
    (ids from 1 up, 0 in the padding), the 1/0 mask, two-class labels;
    on the card. Returns (lens int32, ids, mask, labels)."""
    rs = np.random.RandomState(BERT_LENS_SEED)
    lens = rs.randint(16, BERT_SEQ + 1, BERT_BATCH)
    mask = np.arange(BERT_SEQ)[None, :] < lens[:, None]
    ids = np.where(mask, rs.randint(1, vocab, (BERT_BATCH, BERT_SEQ)), 0)
    labels = rs.randint(0, 2, BERT_BATCH)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        lens.astype(np.int32), ids, mask.astype(np.int64), labels))


def _varlen_bound(b, s, h, d, es, lens, n_q, n_kv, n_out_q, n_out_kv,
                  n_rows, products):
    """Bound of a non-causal attention pass at q [b, s, h, d] whose keys
    stop at each row's ``lens`` (all s without): ``n_q`` query-shaped
    inputs (q, dO) read whole, ``n_kv`` key-shaped ones (k, v) read up to
    each row's length, ``n_out_q`` / ``n_out_kv`` outputs of each shape
    written whole, ``n_rows`` fp32 row vectors [b, h, s] (LSE, delta),
    and ``products`` matrix products over the live (query, key) pairs:
    every query row (a padded one too: nothing masks queries without a
    causal bound) against its row's live keys."""
    live = b * s if lens is None else int(sum(lens))
    full = b * s * h * d * es
    return bound(full * (n_q + n_out_q + n_out_kv) + live * h * d * es * n_kv
                 + n_rows * b * h * s * 4, products * 2 * d * h * s * live)


def encoder_kernel_entries(torch, dev, np):
    """K2, K5a and K5b without a causal mask at BERT-base's attention shape
    q/k/v [32, 128, 12, 64] (head dim 64): with the fine-tune batch's
    kv_lens (bert_finetune, bert_encode) and without (encoder_serve's
    full rows), against the plain versions in f32, f16 and bf16. Every
    query row, the padded ones too, gets a nonzero cotangent (they attend
    the valid keys, so their dO reaches those keys' dk and dv); the keys
    past a row's length must get dk = dv = 0 exactly. Timed in bf16
    beside the plain versions and SDPA over the same keys (a boolean key
    mask [B, 1, 1, S] with kv_lens; its backward by autograd for K5).
    Returns {path: {kernel: entry}}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    b, s, h, d = BERT_BATCH, BERT_SEQ, 12, 64
    kl = bert_batch(torch, dev, np, 100)[0]
    lens = kl.tolist()
    keys = torch.arange(s, device=dev)[None, :] < kl[:, None]   # [B, S]
    g = torch.Generator(device=dev).manual_seed(27)
    base = [torch.randn(b, s, h, d, generator=g, device=dev)
            for _ in range(4)]
    errs = {}
    for dtype, dt in _all_dts(torch):
        q, k, v, do = (t.to(dt) for t in base)
        for tag, lens_arg in (("kv_lens", kl), ("full", None)):
            args = (False, d ** -0.5, None, lens_arg)
            o, lse = FA.flash_fwd_cuda(q, k, v, *args)
            ref_o, ref_lse = FA.flash_attention_fwd_plain(q, k, v, *args)
            e = _agree(f"flash_fwd (bert shape, non-causal, {tag})", dtype,
                       _max_err(o, ref_o))
            _agree(f"flash_fwd log-sum-exp (bert shape, {tag}, {dtype} "
                   f"inputs)", "f32", _max_err(lse, ref_lse))
            if dtype == _hn():
                errs[f"flash_fwd {tag}"] = e
            if lens_arg is None:
                continue
            got = FA.flash_bwd_cuda(q, k, v, o, lse, do, *args)
            ref = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, *args)
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                key = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                e = _agree(f"flash_bwd {name} (bert shape, non-causal, "
                           f"kv_lens, padded rows' dO nonzero)", dtype,
                           _max_err(a, r))
                if dtype == _hn():
                    errs[key] = max(errs.get(key, 0.0), e)
            for name, t in (("dk", got[1]), ("dv", got[2])):
                if t[~keys].any():
                    raise AssertionError(f"flash_bwd {name} ({dtype}): keys "
                                         f"past kv_lens got a nonzero "
                                         f"gradient")
            del got, ref
    q, k, v, do = (t.to(_hdt(torch)) for t in base)
    es = q.element_size()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kmask = keys[:, None, None, :]
    out = {}
    for tag, lens_arg, lb in (("kv_lens", kl, lens), ("full", None, None)):
        args = (False, d ** -0.5, None, lens_arg)
        b_ms, b_by = _varlen_bound(b, s, h, d, es, lb, 1, 2, 1, 0, 1, 2)
        mask = kmask if lens_arg is not None else None
        out[tag] = dict(
            max_abs_err=errs[f"flash_fwd {tag}"],
            variant=_route(FA, "flash_fwd", q),
            ms=time_ms(lambda: FA.flash_fwd_cuda(q, k, v, *args)),
            plain_ms=time_ms(lambda: FA.flash_attention_fwd_plain(
                q, k, v, *args), iters=10, warmup=2),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"q/k/v [{b}, {s}, {h}, {d}] {_hn()}, non-causal, "
                  + (f"kv_lens {min(lens)}-{max(lens)} (sum {sum(lens)})"
                     if lens_arg is not None else "no mask")
                  + f"; {_route(FA, 'flash_fwd', q)} route")
    args = (False, d ** -0.5, None, kl)
    o, lse = FA.flash_fwd_cuda(q, k, v, *args)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (_build.dtype_code(q, "encoder k5"), q, k, v, do, lse, delta,
             *args)
    plain_ms = time_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, o, lse, do, *args), iters=10, warmup=2)
    ql, kl_, vl = (t.transpose(1, 2).detach().requires_grad_()
                   for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl_, vl, attn_mask=kmask)
    dot = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl_, vl), dot, retain_graph=True), iters=20)
    bwd = {}
    for key, fn, n_out_q, n_out_kv, products in (
            ("flash_bwd_dq", FA.flash_bwd_dq, 1, 0, 3),
            ("flash_bwd_dkv", FA.flash_bwd_dkv, 0, 2, 4)):
        b_ms, b_by = _varlen_bound(b, s, h, d, es, lens, 2, 2, n_out_q,
                                   n_out_kv, 2, products)
        bwd[key] = dict(
            max_abs_err=errs[key], variant=_route(FA, key, q),
            ms=time_ms(lambda: fn(*bargs), iters=20),
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
            bound_by=b_by,
            shape=f"q/k/v/dO [{b}, {s}, {h}, {d}] {_hn()}, non-causal, "
                  f"kv_lens {min(lens)}-{max(lens)}; "
                  f"{_route(FA, key, q)} route")
    del lib_out
    torch.cuda.empty_cache()
    return {"bert_finetune": {"flash_fwd": out["kv_lens"], **bwd},
            "bert_encode": {"flash_fwd": out["kv_lens"]},
            "encoder_serve": {"flash_fwd": out["full"]}}


# -------------------------------------------------------------------- K6
def _k6_inputs(torch, dev, tokens, e, topk, k, n, dt, seed):
    """A routed batch: every token picks ``topk`` distinct experts at
    random; rows sorted by expert. Returns (lhs [m, k], rhs [e, k, n],
    cotangent [m, n], sizes [e] int32), m = tokens * topk."""
    g = torch.Generator(device=dev).manual_seed(seed)
    choice = torch.rand(tokens, e, generator=g, device=dev).topk(
        topk).indices
    sizes = torch.bincount(choice.reshape(-1), minlength=e).to(torch.int32)
    m = tokens * topk
    lhs = torch.randn(m, k, generator=g, device=dev).to(dt)
    rhs = (torch.randn(e, k, n, generator=g, device=dev) * k ** -0.5).to(dt)
    cot = torch.randn(m, n, generator=g, device=dev).to(dt)
    return lhs, rhs, cot, sizes


def _library_grouped_mm(torch, a, b, sizes):
    """The time of PyTorch's own grouped product (``F.grouped_mm`` /
    ``torch._grouped_mm``) on the same inputs, as a yardstick only: None
    where the installed torch has none or refuses these operands."""
    fn = (getattr(torch.nn.functional, "grouped_mm", None)
          or getattr(torch, "_grouped_mm", None))
    if fn is None or a.dtype not in (torch.bfloat16, torch.float16):
        return None
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    try:
        fn(a, b, offs=offs)
    except (RuntimeError, TypeError, NotImplementedError) as exc:
        log(f"[kernels] library grouped_mm refused {list(a.shape)} x "
            f"{list(b.shape)}: {str(exc).splitlines()[0][:120]}")
        return None
    return time_ms(lambda: fn(a, b, offs=offs), iters=20)


def _k6_fwd_entry(torch, lhs, rhs, sizes, err, trans=False, iters=20,
                  graph=False):
    """Times and bound of one K6a launch (``graph``: also from a CUDA
    graph, the decode shape's device time)."""
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    m, k = lhs.shape
    e = rhs.shape[0]
    n = rhs.shape[1] if trans else rhs.shape[2]
    es = lhs.element_size()
    live = int((sizes > 0).sum())
    b_ms, b_by = bound((m * k + m * n + live * k * n) * es + 4 * e,
                       2 * m * k * n)
    lib_rhs = rhs.transpose(1, 2) if trans else rhs
    route = _k6_route(GM, m, e, k, n, lhs.dtype, trans)
    extra = ({"graph_ms": graph_ms(
        lambda: GM.grouped_fwd_cuda(lhs, rhs, sizes, trans), iters=20)}
        if graph else {})
    return dict(
        **extra, max_abs_err=err, variant=route,
        ms=time_ms(lambda: GM.grouped_fwd_cuda(lhs, rhs, sizes, trans),
                   iters=iters),
        plain_ms=time_ms(lambda: GM.grouped_matmul_plain(lhs, rhs, sizes,
                                                         trans),
                         iters=3, warmup=1),
        library_ms=_library_grouped_mm(torch, lhs, lib_rhs, sizes),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"lhs [{m}, {k}] x rhs [{e}, "
              f"{rhs.shape[1]}, {rhs.shape[2]}]"
              f"{' read transposed' if trans else ''} "
              f"{_short(lhs.dtype)}, {live} of {e} groups live; {route} "
              f"route")


def k6(torch, dev):
    """K6a (forward, and read-transposed as the backward's dlhs) and K6b
    (drhs) against the plain versions, bf16 and fp32, at the MoE slice's
    shapes: Qwen decode (32 rows over 60 experts, both expert products),
    Qwen prefill (4096 rows), Qwen train (16 384 rows: forward, dlhs and
    drhs of the gate_up and of the down product), Mixtral-8x7B width (8
    experts, 4096 -> 28 672, 2048 rows) and a small ragged case with empty
    and one-row groups whose m, k and n are no multiples of the tiles (both
    forward kernels). An empty group's drhs must be exactly 0. Returns the
    entries of the decode forward (path moe_serve) and of the train forward
    and drhs (gate_up: path moe_train); every other shape's times, the
    down product's drhs among them, are logged."""
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    h, inter, e, topk = MOE_HIDDEN, MOE_INTER, MOE_EXPERTS, MOE_TOPK
    out = {}
    # small ragged cases: the tiled kernel, the decode route (one group
    # of several row tiles) and the decode shape at an n that its 16-byte
    # copies cannot take (back to the tiled kernel)
    for sizes, n in (([5, 0, 1, 130, 0, 70, 1, 0], 200),
                     ([1, 0, 2, 0, 0, 17, 1, 0, 3, 0], 200),
                     ([1, 0, 2, 0, 0, 17, 1, 0, 3, 0], 50)):
        for dtype, dt in _dts(torch):
            g = torch.Generator(device=dev).manual_seed(11)
            m, ne, k = sum(sizes), len(sizes), 72
            lhs = torch.randn(m, k, generator=g, device=dev).to(dt)
            rhs = torch.randn(ne, k, n, generator=g, device=dev).to(dt)
            cot = torch.randn(m, n, generator=g, device=dev).to(dt)
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            tag = f"ragged m={m} n={n}, K6a {_k6_route(GM, m, ne, k, n, dt)}"
            _agree(f"grouped_fwd ({tag})", dtype, _max_err(
                GM.grouped_fwd_cuda(lhs, rhs, gs),
                GM.grouped_matmul_plain(lhs, rhs, gs)))
            dlhs, drhs = GM.grouped_matmul_bwd_plain(lhs, rhs, gs, cot)
            _agree(f"grouped_fwd transposed ({tag})", dtype, _max_err(
                GM.grouped_fwd_cuda(cot, rhs, gs, True), dlhs))
            got = GM.grouped_dw(lhs, cot, gs)
            _agree(f"grouped_dw ({tag})", dtype, _max_err(got, drhs))
            # K6b and the plain version both add a group's rows in order
            # with fp32 FMAs and so often agree to the bit: hold K6b to a
            # float64 product as well, where its own rounding shows
            ref64 = torch.zeros(ne, k, n, dtype=torch.float64, device=dev)
            start = 0
            for i, size in enumerate(sizes):
                rows64 = slice(start, start + size)
                ref64[i] = lhs[rows64].double().T @ cot[rows64].double()
                start += size
            _agree(f"grouped_dw vs float64 ({tag})", dtype,
                   _max_err(got, ref64))
            empty = gs == 0
            if float(got[empty].abs().sum()) != 0.0:
                raise AssertionError("grouped_dw: an empty group's drhs is "
                                     "not exactly 0")
    cases = (
        # label, tokens, experts, topk, k, n, backward too
        ("qwen decode gate_up", 8, e, topk, h, 2 * inter, False),
        ("qwen decode down", 8, e, topk, inter, h, False),
        ("qwen prefill gate_up", 1024, e, topk, h, 2 * inter, False),
        ("qwen train gate_up", 4096, e, topk, h, 2 * inter, True),
        ("qwen train down", 4096, e, topk, inter, h, True),
        ("mixtral-8x7b gate_up", 1024, 8, 2, 4096, 28672, False),
    )
    for label, tokens, ne, tk, k, n, bwd in cases:
        for dtype, dt in _dts(torch):
            lhs, rhs, cot, gs = _k6_inputs(torch, dev, tokens, ne, tk, k, n,
                                           dt, 21)
            err = _agree(f"grouped_fwd ({label})", dtype, _max_err(
                GM.grouped_fwd_cuda(lhs, rhs, gs),
                GM.grouped_matmul_plain(lhs, rhs, gs)))
            entries = {}
            if dtype == _hn():
                entries["fwd"] = _k6_fwd_entry(
                    torch, lhs, rhs, gs, err,
                    iters=50 if tokens <= 8 else 10, graph=tokens <= 8)
            if bwd:
                dlhs, drhs = GM.grouped_matmul_bwd_plain(lhs, rhs, gs, cot)
                err_t = _agree(f"grouped_fwd transposed ({label})", dtype,
                               _max_err(GM.grouped_fwd_cuda(cot, rhs, gs,
                                                            True), dlhs))
                got_w, route = _k6b_ran(
                    GM, lambda: GM.grouped_dw(lhs, cot, gs))
                err_w = _agree(f"grouped_dw ({label}, {route})", dtype,
                               _max_err(got_w, drhs))
                del got_w
                del dlhs, drhs
                if dtype == _hn():
                    entries["dlhs"] = _k6_fwd_entry(torch, cot, rhs, gs,
                                                    err_t, trans=True,
                                                    iters=10)
                    m = lhs.shape[0]
                    es = lhs.element_size()
                    b_ms, b_by = bound((m * k + m * n + ne * k * n) * es,
                                       2 * m * k * n)
                    entries["dw"] = dict(
                        max_abs_err=err_w, variant=route,
                        ms=time_ms(lambda: GM.grouped_dw(lhs, cot, gs),
                                   iters=10),
                        plain_ms=time_ms(
                            lambda: GM.grouped_matmul_bwd_plain(
                                lhs, rhs, gs, cot), iters=3, warmup=1),
                        library_ms=_library_grouped_mm(torch, lhs.t(), cot,
                                                       gs),
                        bound_ms=b_ms, bound_by=b_by,
                        shape=f"lhs [{m}, {k}], g [{m}, {n}] -> "
                              f"[{ne}, {k}, {n}] {_hn()}; {route} route "
                              f"(plain: dlhs and drhs in one call)")
            for kind, r in entries.items():
                lib = r["library_ms"]
                gr = (f" (graph {r['graph_ms']:.4f} ms)" if "graph_ms" in r
                      else "")
                log(f"[kernels] K6 {label} {kind} ({r['shape']}): "
                    f"{r['ms']:.4f} ms{gr}, plain {r['plain_ms']:.4f} ms, "
                    f"library {'n/a' if lib is None else f'{lib:.4f} ms'}, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                    f"{100 * r['bound_ms'] / r['ms']:.2f}% of bound")
            if label == "qwen decode gate_up" and entries:
                out["serve_fwd"] = entries["fwd"]
            if label == "qwen prefill gate_up" and entries:
                out["prefill_fwd"] = entries["fwd"]
            if label == "qwen train gate_up" and entries:
                out["train_fwd"] = entries["fwd"]
                out["train_dw"] = entries["dw"]
            del lhs, rhs, cot, gs, entries
            torch.cuda.empty_cache()
    return out


# ----------------------------------------------- K6a's decode route (MoE)
# (label, tokens, experts, top-k, hidden, intermediate, path whose JSON
# entries they are or None): the MoE layer's decode at the served models'
# widths, 8 slots a token each
MOE_DECODE_CASES = (
    ("qwen1.5-moe decode", 8, MOE_EXPERTS, MOE_TOPK, MOE_HIDDEN, MOE_INTER,
     "moe_serve"),
    ("mixtral-8x7b decode", 8, 8, 2, 4096, 14336, None),
)
# groups of 0, 1, 4, 5, 8 and 32 rows: the route's row tiles at their edges
MOE_DECODE_RAGGED = (0, 1, 4, 0, 5, 8, 32, 1, 0, 4)


def _moe_decode_inputs(torch, dev, tokens, e, topk, h, inter, dt, seed,
                       sizes=None):
    """A decode batch routed as the MoE layer routes it: xt [tokens, h],
    the route of random logits (dropless; ``sizes``: a forced ragged
    routing instead, a third of it dropped), the expert stacks and gu,
    a gate_up product."""
    from paddle_tpu_torch.distributed import moe as M
    g = torch.Generator(device=dev).manual_seed(seed)
    if sizes is None:
        logits = torch.randn(tokens, e, generator=g, device=dev)
        route, _, _ = M.top_k_route(logits, topk, max(tokens, 4))
    else:
        m = sum(sizes)
        route = dict(
            counts=torch.tensor(sizes, dtype=torch.int32, device=dev),
            tok=torch.randint(0, tokens, (m,), generator=g, device=dev),
            order=torch.randperm(m, generator=g, device=dev),
            gate=torch.rand(m, generator=g, device=dev),
            keep=torch.rand(m, generator=g, device=dev) > 0.33)
    m = route["order"].shape[0]
    xt = torch.randn(tokens, h, generator=g, device=dev).to(dt)
    gate_up = (torch.randn(e, h, 2 * inter, generator=g, device=dev)
               * h ** -0.5).to(dt)
    down = (torch.randn(e, inter, h, generator=g, device=dev)
            * inter ** -0.5).to(dt)
    gu = torch.randn(m, 2 * inter, generator=g, device=dev).to(dt)
    return xt, route, gate_up, down, gu


def _grouped_mm_fn(torch):
    return (getattr(torch.nn.functional, "grouped_mm", None)
            or getattr(torch, "_grouped_mm", None))


def k6_decode(torch, dev):
    """K6a's decode route with the MoE glue folded in (``moe_gate_up``,
    ``moe_down``) against the plain versions (the unfused composition),
    bf16 and fp32: at Qwen1.5-MoE-A2.7B's and Mixtral-8x7B's decode
    (8 tokens), and over groups of 0, 1, 4, 5, 8 and 32 rows with a k and
    an n that are no multiples of a ring stage or a strip, a third of the
    assignments dropped; a dropped row must be exactly 0 and a rerun give
    the same bits. Times of each product (bf16): eager, from a CUDA graph,
    the plain version, the library (``F.grouped_mm`` composed with the
    same glue: the gather, SwiGLU, the weighting and the unsort), and the
    unfused composition on this tree's kernels from a graph; the bound
    counts every live group's weights, the lhs and the output once.
    Returns {path: [gate_up entry, down entry]}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    out = {}
    cases = [(f"ragged h=72 inter=104 ({list(MOE_DECODE_RAGGED)})", 11,
              len(MOE_DECODE_RAGGED), 2, 72, 104, None, MOE_DECODE_RAGGED)]
    cases += [(*c, None) for c in MOE_DECODE_CASES]
    gmm = _grouped_mm_fn(torch)
    for i, (label, tokens, e, topk, h, inter, path, sizes) in enumerate(
            cases):
        for dtype, dt in _dts(torch):
            if path is None and sizes is None and dtype == "f32":
                continue        # Mixtral's fp32 stacks: 3.8 GB, bf16 only
            xt, route, gate_up, down, gu = _moe_decode_inputs(
                torch, dev, tokens, e, topk, h, inter, dt, 60 + i, sizes)
            tok, cnt, order = route["tok"], route["counts"], route["order"]
            gate, keep = route["gate"], route["keep"]
            m = order.shape[0]
            n0 = GM.grouped_matmul.route_launches["decode"]
            got_gu = GM.moe_gate_up(xt, tok, gate_up, cnt)
            got_y = GM.moe_down(gu, down, cnt, gate, keep, order)
            ran = GM.grouped_matmul.route_launches["decode"] - n0
            if ran != 2:
                raise AssertionError(f"moe decode {label}: {ran} launches "
                                     f"on the decode route, not 2")
            err_gu = _agree(f"moe_gate_up ({label})", dtype, _max_err(
                got_gu, GM.moe_gate_up_plain(xt, tok, gate_up, cnt)))
            err_y = _agree(f"moe_down ({label})", dtype, _max_err(
                got_y, GM.moe_down_plain(gu, down, cnt, gate, keep, order)))
            dropped = order[~keep]
            if dropped.numel() and float(got_y[dropped].abs().max()) != 0:
                raise AssertionError(f"moe_down ({label}): a dropped "
                                     f"assignment's row is not 0")
            if not (torch.equal(got_gu, GM.moe_gate_up(xt, tok, gate_up, cnt))
                    and torch.equal(got_y, GM.moe_down(gu, down, cnt, gate,
                                                       keep, order))):
                raise AssertionError(f"moe decode {label}: a rerun gave "
                                     f"other bits")
            if dtype != _hn() or sizes is not None:
                continue
            es = xt.element_size()
            live = int((cnt > 0).sum())
            offs = torch.cumsum(cnt, 0).to(torch.int32)
            g_, u_ = torch.chunk(gu, 2, dim=-1)

            def lib_gate_up():
                return gmm(xt.index_select(0, tok), gate_up, offs=offs)

            def lib_down():
                y = gmm(F.silu(g_) * u_, down, offs=offs)
                wgt = (gate * keep).to(y.dtype)
                return torch.empty_like(y).index_copy_(0, order,
                                                       y * wgt[:, None])

            def unfused_gate_up():
                return GM.grouped_fwd_cuda(xt.index_select(0, tok), gate_up,
                                           cnt)

            def unfused_down():
                y = GM.grouped_fwd_cuda(F.silu(g_) * u_, down, cnt)
                wgt = (gate * keep).to(y.dtype)
                return torch.empty_like(y).index_copy_(0, order,
                                                       y * wgt[:, None])

            entries = []
            for kind, fn, plain, lib, unf, k, n, lhs_bytes, err in (
                    ("gate_up",
                     lambda: GM.moe_gate_up(xt, tok, gate_up, cnt),
                     lambda: GM.moe_gate_up_plain(xt, tok, gate_up, cnt),
                     lib_gate_up, unfused_gate_up, h, 2 * inter,
                     tokens * h * es + 8 * m, err_gu),
                    ("down",
                     lambda: GM.moe_down(gu, down, cnt, gate, keep, order),
                     lambda: GM.moe_down_plain(gu, down, cnt, gate, keep,
                                               order),
                     lib_down, unfused_down, inter, h,
                     m * 2 * inter * es + 13 * m, err_y)):
                b_ms, b_by = bound(live * k * n * es + lhs_bytes
                                   + m * n * es + 4 * e, 2 * m * k * n)
                r = dict(max_abs_err=err, variant=f"decode {kind}",
                         ms=time_ms(fn, iters=50),
                         graph_ms=graph_ms(fn, iters=20),
                         plain_ms=time_ms(plain, iters=3, warmup=1),
                         library_ms=(time_ms(lib, iters=20) if gmm
                                     else None),
                         # F.grouped_mm at f16 copies from host memory on
                         # every call (its f16 route is not the bf16
                         # one), which no CUDA graph may capture
                         library_glue_graph_ms=(
                             graph_ms(lib, iters=20)
                             if gmm and dt == torch.bfloat16 else None),
                         unfused_graph_ms=graph_ms(unf, iters=20),
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"{label} {kind}: [{m}, {k}] x [{e}, {k}, "
                               f"{n}] {_hn()}, {live} of {e} groups live")
                lib_g = r["library_glue_graph_ms"]
                log(f"[kernels] K6a {r['shape']}: {r['ms']:.4f} ms eager, "
                    f"graph {r['graph_ms']:.4f} ms "
                    f"({100 * b_ms / r['graph_ms']:.1f}% of bound "
                    f"{b_ms:.4f} ms, {b_by}); unfused on this tree's "
                    f"kernels (graph) {r['unfused_graph_ms']:.4f} ms; "
                    f"library (F.grouped_mm + the glue) "
                    f"{'n/a' if lib_g is None else f'{lib_g:.4f} ms'} "
                    f"(graph); plain {r['plain_ms']:.4f} ms "
                    f"({card_line()})")
                entries.append(r)
            if path is not None:
                out[path] = entries
            del xt, route, gate_up, down, gu, got_gu, got_y
            torch.cuda.empty_cache()
    return out


# K6a's decode route: the column-strip widths (bytes) the k6_decode_strips
# phase builds and times; csrc/grouped_matmul.cu builds kDecStrip (256)
K6_DECODE_STRIPS = (128, 256)


def phase_k6_decode_strips(torch, dev):
    """K6a's decode route at each column-strip width of K6_DECODE_STRIPS,
    both fused products at Qwen1.5-MoE-A2.7B's and Mixtral-8x7B's decode:
    each against its plain version and timed from a CUDA graph beside its
    bytes bound: the measurement behind the width the source builds. The
    widths are compiled into one extra library that includes the kernel
    source, as k6_tiles does, so what is timed is the kernel the port
    runs, strip aside."""
    import ctypes
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    src = _build.BUILD_DIR / "k6_decode_strips.cu"
    lib_path = _build.BUILD_DIR / "k6_decode_strips.so"
    args = "lhs, idx, rhs, sizes, gate, keep, out, m, k, n, e, stream"
    cases = "\n".join(
        f"    case {c}: return down ? launch_decode<__nv_bfloat16, true, "
        f"{c}>({args}) : launch_decode<__nv_bfloat16, false, {c}>({args});"
        for c in K6_DECODE_STRIPS)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(
        '#include "grouped_matmul.cu"\n'
        'extern "C" int grouped_decode_strip(int strip, int down, '
        'const void* lhs, const void* idx, const void* rhs, '
        'const void* sizes, const void* gate, const void* keep, void* out, '
        'int m, int k, int n, int e, void* stream) {\n  switch (strip) {\n'
        + cases + "\n  }\n  return 1;\n}\n")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    v, i_ = ctypes.c_void_p, ctypes.c_int
    lib.grouped_decode_strip.argtypes = [i_, i_, v, v, v, v, v, v, v, i_, i_,
                                         i_, i_, v]
    for i, (label, tokens, e, topk, h, inter, _) in enumerate(
            MOE_DECODE_CASES):
        xt, route, gate_up, down, gu = _moe_decode_inputs(
            torch, dev, tokens, e, topk, h, inter, torch.bfloat16, 60 + i)
        tok, cnt, order = route["tok"], route["counts"], route["order"]
        gate, keep = route["gate"], route["keep"]
        m, live = order.shape[0], int((cnt > 0).sum())
        out_gu = torch.empty(m, 2 * inter, dtype=xt.dtype, device=dev)
        out_y = torch.empty(m, h, dtype=xt.dtype, device=dev)
        products = (
            ("gate_up", 0, xt, tok, gate_up, None, None, out_gu, h,
             2 * inter, GM.moe_gate_up_plain(xt, tok, gate_up, cnt)),
            ("down", 1, gu, order, down, gate, keep, out_y, inter, h,
             GM.moe_down_plain(gu, down, cnt, gate, keep, order)))
        for strip in K6_DECODE_STRIPS:
            for kind, dn, lhs, idx, rhs, gt, kp, out, k, n, ref in products:
                def run():
                    rc = lib.grouped_decode_strip(
                        strip, dn, lhs.data_ptr(), idx.data_ptr(),
                        rhs.data_ptr(), cnt.data_ptr(),
                        None if gt is None else gt.data_ptr(),
                        None if kp is None else kp.data_ptr(),
                        out.data_ptr(), m, k, n, e,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"k6_decode_strips: launch "
                                           f"failed ({rc})")
                run()
                _agree(f"moe {kind} ({label}, strip {strip})", "bf16",
                       _max_err(out, ref))
                b_ms, _ = bound(live * k * n * 2, 2 * m * k * n)
                t = graph_ms(run, iters=20)
                log(f"[k6_decode_strips] {label} {kind}, strip {strip} "
                    f"bytes: {t:.4f} ms from a graph, "
                    f"{100 * b_ms / t:.1f}% of the weights' bytes bound "
                    f"{b_ms:.4f} ms ({card_line()})")
        del xt, route, gate_up, down, gu, out_gu, out_y, products
        torch.cuda.empty_cache()


def _k6b_static_balance(torch, sizes, k, n):
    """How evenly K6b's static tile stride spreads this routing's work:
    one persistent block an SM takes tiles b, b + SMs, ... of the
    group-major list of 128 x 256 tiles; a tile's products are its
    group's 16-row steps. Returns the busiest block's steps and tiles
    over the mean (a schedule that balances by a counter could gain at
    most the excess)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_group = -(-k // 128) * -(-n // 256)
    sizes = [int(x) for x in sizes.tolist()]
    steps, tiles = [0] * sms, [0] * sms
    for t in range(len(sizes) * per_group):
        b = t % sms
        steps[b] += -(-sizes[t // per_group] // 16)
        tiles[b] += 1
    mean_steps, mean_tiles = sum(steps) / sms, sum(tiles) / sms
    return (f"{sms} blocks, busiest block {max(steps) / mean_steps:.4f}x "
            f"the mean 16-row steps, {max(tiles) / mean_tiles:.4f}x the "
            f"mean tiles")


# K6a's tensor-core tile shapes: (warpgroups, columns); the first is the
# one csrc/grouped_matmul.cu builds (kGemmWG, kGemmBN)
K6_TILES = ((2, 256), (2, 128), (1, 256), (1, 128))


def phase_k6_tiles(torch, dev):
    """K6a's tensor-core route at each tile shape of K6_TILES, at the
    MoE train shapes (gate_up and down, forward and dlhs) and the moe_serve
    prefill shape: each held to the plain version, then timed. The shapes
    are compiled into one extra library that includes the kernel source,
    so what is timed is the kernel the port runs, tile aside."""
    import ctypes
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    src = _build.BUILD_DIR / "k6_tiles.cu"
    lib_path = _build.BUILD_DIR / "k6_tiles.so"
    cases = "\n".join(
        f"    case {i}: return launch_fwd_wgmma<__nv_bfloat16, {wg}, {bn}>("
        f"trans, lhs, rhs, "
        f"sizes, out, m, k, n, e, stream);"
        for i, (wg, bn) in enumerate(K6_TILES))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(
        '#include "grouped_matmul.cu"\n'
        'extern "C" int grouped_fwd_tile(int tile, int trans, const void* lhs,'
        ' const void* rhs, const void* sizes, void* out, int m, int k, int n,'
        ' int e, void* stream) {\n  switch (tile) {\n' + cases +
        "\n  }\n  return 1;\n}\n")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    v, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_fwd_tile.argtypes = [i, i, v, v, v, v, i, i, i, i, v]
    h, inter, e = MOE_HIDDEN, MOE_INTER, MOE_EXPERTS
    shapes = (("train gate_up", 4096, h, 2 * inter, False),
              ("train gate_up dlhs", 4096, 2 * inter, h, True),
              ("train down", 4096, inter, h, False),
              ("train down dlhs", 4096, h, inter, True),
              ("prefill gate_up", 1024, h, 2 * inter, False))
    for label, tokens, k, n, trans in shapes:
        lhs, rhs, _, gs = _k6_inputs(torch, dev, tokens, e, MOE_TOPK, k, n,
                                     torch.bfloat16, 21)
        if trans:
            rhs = rhs.transpose(1, 2).contiguous()
        m = lhs.shape[0]
        out = torch.empty(m, n, dtype=lhs.dtype, device=dev)
        ref = GM.grouped_matmul_plain(lhs, rhs, gs, trans)
        live = int((gs > 0).sum())
        b_ms, b_by = bound((m * k + m * n + live * k * n) * 2 + 4 * e,
                           2 * m * k * n)

        def run(tile):
            rc = lib.grouped_fwd_tile(
                tile, int(trans), lhs.data_ptr(), rhs.data_ptr(),
                gs.data_ptr(), out.data_ptr(), m, k, n, e,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k6_tiles: launch failed ({rc})")
        for tile, (wg, bn) in enumerate(K6_TILES):
            run(tile)
            _agree(f"grouped_fwd {64 * wg} x {bn} ({label})", _hn(),
                   _max_err(out, ref))
            ms = time_ms(lambda: run(tile), iters=20)
            log(f"[k6_tiles] {label} (lhs [{m}, {k}], n {n}"
                f"{', rhs read transposed' if trans else ''}): tile "
                f"{64 * wg} x {bn}: {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {100 * b_ms / ms:.1f}% of bound")
        del lhs, rhs, gs, out, ref
        torch.cuda.empty_cache()
    # K6b's tensor-core route at both train shapes (the routing depends on
    # the seed alone): the bytes its 128 x 256 tiles read from L2, each
    # group's rows once a tile (k wide for every n tile, n wide for every
    # k tile), and how evenly its static stride spreads them
    *_, gs = _k6_inputs(torch, dev, 4096, e, MOE_TOPK, 8, 8, torch.bfloat16,
                        21)
    m = int(gs.sum())
    for label, k, n in (("train gate_up", h, 2 * inter),
                        ("train down", inter, h)):
        slab_gb = m * (-(-n // 256) * k + -(-k // 128) * n) * 2 / 1e9
        log(f"[k6_tiles] K6b {label} (lhs [{m}, {k}], g [{m}, {n}]): "
            f"{slab_gb:.3f} GB of slab reads by 128 x 256 tiles; "
            f"{_k6b_static_balance(torch, gs, k, n)}")


# -------------------------------------------------------------------- K7
# (label, path whose JSON entry it is or None ("serve decode": the entry of
# the paths that run K7 at the Llama decode shape, quant_serve's int8 tick
# and spec_serve's draft), leading dims of x, heads of
# x, heads of the fused QKV product (q + 2 kv), x is q or k, head_dim,
# tables "shared" [S, D/2] or "per_row" [N, D/2], rope base)
ROPE_CASES = (
    ("llama serve prefill q", "serve", (8, 128), 32, 96, "q", 128, "shared",
     1e4),
    ("llama serve prefill k", None, (8, 128), 32, 96, "k", 128, "shared",
     1e4),
    ("llama serve decode q", "serve decode", (8, 1), 32, 96, "q", 128,
     "per_row", 1e4),
    ("llama train q", "train", (4, 2048), 16, 48, "q", 128, "shared", 1e4),
    ("qwen-moe serve prefill q", "moe_serve", (8, 128), 16, 48, "q", 128,
     "shared", 1e6),
    ("qwen-moe serve decode q", None, (8, 1), 16, 48, "q", 128, "per_row",
     1e6),
    ("qwen-moe train q", "moe_train", (2, 2048), 16, 48, "q", 128, "shared",
     1e6),
    ("mistral prefill q", "window_serve", (4, 4608), 32, 48, "q", 128,
     "shared", 1e6),
    ("mistral prefill k", None, (4, 4608), 8, 48, "k", 128, "shared", 1e6),
    ("mistral decode q", None, (4, 1), 32, 48, "q", 128, "per_row", 1e6),
    ("mistral prefill q, per-row tables (dynamic NTK)", None, (4, 4608), 32,
     48, "q", 128, "per_row", 1e6),
    ("small, head_dim 64", None, (2, 77), 2, 12, "k", 64, "per_row", 1e4),
    ("falcon-7b generate q", "falcon7b_serve", (8, 160), 71, 71, "q", 64,
     "shared", 1e4),
    ("falcon-7b generate k", None, (8, 160), 1, 1, "q", 64, "shared", 1e4),
    ("gemma-2b train q", "gemma_train", (2, 2048), 8, 10, "q", 256,
     "shared", 1e4),
    ("gemma-2b train k", None, (2, 2048), 1, 10, "k", 256, "shared", 1e4),
    ("gemma-7b generate q", "gemma7b_serve", (8, 160), 16, 48, "q", 256,
     "shared", 1e4),
    ("llama-2-7b lora train q", "lora_train", (1, 2048), 32, 96, "q", 128,
     "shared", 1e4),
    ("llama train q, one pipeline microbatch", "pp_train", (1, 2048), 16, 48,
     "q", 128, "shared", 1e4),
)


def _rope_case(torch, dev, dt, lead, h, width, part, d, tables, base, seed):
    """x as the model hands it to K7: a q or k view of a fused QKV product
    [*lead, width * d]; tables of real rope angles (positions up to 4608
    for per-row tables)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(*lead, width * d, generator=g, device=dev).to(dt)
    nq = width - 2 * h if part == "k" else h
    start = nq * d if part == "k" else 0
    x = qkv[..., start:start + h * d].reshape(*lead, h, d)
    n = x.numel() // (h * d)
    pos = (torch.arange(lead[-1], device=dev).float() if tables == "shared"
           else torch.randint(0, 4608, (n,), generator=g, device=dev).float())
    inv = 1.0 / base ** (torch.arange(0, d, 2, device=dev).float() / d)
    f = pos[:, None] * inv[None, :]
    return x, torch.cos(f), torch.sin(f)


def k7(torch, dev):
    """K7 against fused_rope_plain at every path's shapes, on the strided
    q/k views the models give it: the forward must equal the plain version
    bit for bit (bf16 and fp32), the backward (the kernel with -sin) agree
    with autograd through the plain version within TOL. Times of the
    kernel and the plain version, eager (the entry's) and replayed from a
    CUDA graph (device time alone: the small shapes are bound by the
    wrapper's host work; over copies of x that do not fit the L2, so no
    call reads what another left there, and % of bound comes from that
    time); no single PyTorch call computes rope (library n/a). The bound
    counts x read once, the output written once
    and the two tables; its 6 fp32 flops per pair of elements go at the
    fp32 rate. Returns {path: entry}."""
    from paddle_tpu_torch.ops.cuda import rope as R
    out = {}
    for i, (label, path, lead, h, width, part, d, tables, base) in enumerate(
            ROPE_CASES):
        for dtype, dt in _dts(torch):
            x, c, s = _rope_case(torch, dev, dt, lead, h, width, part, d,
                                 tables, base, 30 + i)
            got = R.fused_rope(x, c, s)
            ref = R.fused_rope_plain(x, c, s)
            differ = int((got != ref).sum())
            log(f"[kernels] rope {label} {dtype}: {differ} of {got.numel()} "
                f"results differ from the plain version (must be 0)")
            if differ:
                raise AssertionError(f"rope {label} {dtype}: forward not "
                                     f"bit-identical to the plain version")
            xr = x.detach().clone().requires_grad_()
            cot = torch.randn_like(got)
            (dx,) = torch.autograd.grad(R.fused_rope(xr, c, s), xr, cot)
            (dref,) = torch.autograd.grad(R.fused_rope_plain(xr, c, s), xr,
                                          cot)
            _agree(f"rope backward ({label})", dtype, _max_err(dx, dref))
            del xr, cot, dx, dref
            if dtype != _hn():
                continue
            n = x.numel() // (h * d)
            es = x.element_size()
            b_ms, b_by = bound(2 * n * h * d * es + 2 * c.numel() * 4,
                               3 * n * h * d, PEAK_FP32_FLOPS)
            small = n * h * d < 1 << 20
            r = dict(max_abs_err=0.0,
                     ms=time_ms(lambda: R.fused_rope(x, c, s),
                                iters=200 if small else 50),
                     plain_ms=time_ms(lambda: R.fused_rope_plain(x, c, s),
                                      iters=50 if small else 10),
                     library_ms=None, bound_ms=b_ms, bound_by=b_by,
                     shape=f"{label}: x [{n}, {h}, {d}] {_hn()} (row stride "
                           f"{x.stride(-3)}), {tables} tables "
                           f"[{c.shape[0]}, {d // 2}]")
            # device time from CUDA graphs over copies of x (and of the
            # product it views) filling four times the L2, as K1's: one
            # tensor replayed from the L2 would read faster than the bound
            r["graph_ms"] = cold_graph_ms(
                lambda t: R.fused_rope(t, c, s), x,
                iters_min=100 if small else 20)
            plain_dev = graph_ms(lambda: R.fused_rope_plain(x, c, s),
                                 iters=20 if small else 5)
            log(f"[kernels] rope {r['shape']}: {r['ms']:.4f} ms eager, "
                f"plain {r['plain_ms']:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by}); in CUDA graphs over cold copies (device only) "
                f"{r['graph_ms']:.4f} ms ({100 * b_ms / r['graph_ms']:.1f}% "
                f"of bound), plain {plain_dev:.4f} ms (one tensor)")
            if r["graph_ms"] < b_ms:
                raise AssertionError(f"rope {label}: graph time "
                                     f"{r['graph_ms']:.5f} ms under its "
                                     f"bound {b_ms:.5f} ms")
            if path is not None:
                out[path] = r
        del x, c, s, got, ref
    torch.cuda.empty_cache()
    return out


# (label, path whose JSON entry it is, decode rows, q heads, kv heads,
# head dim, rope base, pool blocks): K7 folded with the decode tick's pool
# write at the served models' decode shapes (the serve phases' slots and
# pools)
ROPE_KV_CASES = (
    ("llama-2-7b decode", "serve", 8, 32, 32, 128, 1e4, 256),
    ("qwen1.5-moe decode", "moe_serve", 8, 16, 16, 128, 1e6, 256),
    ("mistral-7b decode", "window_serve", 4, 32, 8, 128, 1e6, 1200),
)


def k7_fold(torch, dev):
    """``rope_kv_write`` against the unfused composition
    (``rope_kv_write_plain``: K7's plain version on q and k, the pools'
    ``index_put_``) bit for bit, bf16 and fp32: q rotated and every pool
    row but the sink block's, over pools of garbage, per-row tables of
    positions up to 4608 and one inactive row writing to the sink. Times
    (bf16): eager, from a CUDA graph, the plain version, and from a graph
    the four launches it replaces on this tree's kernels (K7 on q and k,
    two ``index_put_``); no one PyTorch call computes it. Bound: q, k, v
    and the two table rows read, q and the two pool rows written. Returns
    {path: entry}."""
    from paddle_tpu_torch.models import paged as P
    from paddle_tpu_torch.ops.cuda import rope as R
    out = {}
    for i, (label, path, b, hq, hkv, d, base, nb) in enumerate(
            ROPE_KV_CASES):
        for dtype, dt in _dts(torch):
            g = torch.Generator(device=dev).manual_seed(80 + i)
            qkv = torch.randn(b, 1, (hq + 2 * hkv) * d, generator=g,
                              device=dev).to(dt)
            q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
            q, k, v = (q.reshape(b, 1, hq, d), k.reshape(b, 1, hkv, d),
                       v.reshape(b, 1, hkv, d))
            pos = torch.randint(0, 4608, (b,), generator=g, device=dev)
            inv = 1.0 / base ** (torch.arange(0, d, 2, device=dev).float()
                                 / d)
            f = pos.float()[:, None] * inv[None, :]
            c, s = torch.cos(f), torch.sin(f)
            pools = [torch.randn(nb + 1, 16, hkv, d, generator=g,
                                 device=dev).to(dt) for _ in range(2)]
            ref_pools = [p.clone() for p in pools]
            dest = torch.randperm(nb * 16, generator=g, device=dev)[:b]
            dest[b - 1] = nb * 16                 # an inactive row
            got = R.rope_kv_write(q, k, v, c, s, *pools, dest)
            ref = R.rope_kv_write_plain(q, k, v, c, s, *ref_pools, dest)
            differ = int((got != ref).sum()) + sum(
                int((p[:nb] != rp[:nb]).sum())
                for p, rp in zip(pools, ref_pools))
            log(f"[kernels] rope_kv {label} {dtype}: {differ} results "
                f"differ from the unfused composition (must be 0)")
            if differ:
                raise AssertionError(f"rope_kv {label} {dtype}: not "
                                     f"bit-identical to the unfused "
                                     f"composition")
            del ref_pools
            if dtype != _hn():
                continue
            es = q.element_size()
            b_ms, b_by = bound(2 * b * (hq + 2 * hkv) * d * es
                               + 2 * b * (d // 2) * 4 + 8 * b,
                               3 * b * (hq + hkv) * d, PEAK_FP32_FLOPS)

            def fold():
                return R.rope_kv_write(q, k, v, c, s, *pools, dest)

            def unfused():
                qr = R.fused_rope(q, c, s)
                P._scatter(pools[0], R.fused_rope(k, c, s), dest)
                P._scatter(pools[1], v, dest)
                return qr

            r = dict(max_abs_err=0.0, ms=time_ms(fold, iters=200),
                     graph_ms=graph_ms(fold, iters=100),
                     plain_ms=time_ms(lambda: R.rope_kv_write_plain(
                         q, k, v, c, s, *pools, dest), iters=50),
                     unfused_graph_ms=graph_ms(unfused, iters=100),
                     library_ms=None, bound_ms=b_ms, bound_by=b_by,
                     shape=f"{label}: q [{b}, {hq}, {d}], k/v [{b}, {hkv}, "
                           f"{d}] {_hn()} views of the QKV product, pools "
                           f"[{nb + 1}, 16, {hkv}, {d}]")
            log(f"[kernels] rope_kv {r['shape']}: {r['ms']:.4f} ms eager, "
                f"graph {r['graph_ms']:.4f} ms "
                f"({100 * b_ms / r['graph_ms']:.1f}% of bound "
                f"{b_ms:.5f} ms, {b_by}); the four launches it replaces "
                f"(graph) {r['unfused_graph_ms']:.4f} ms; plain "
                f"{r['plain_ms']:.4f} ms ({card_line()})")
            out[path] = r
            del qkv, q, k, v, pools, got, ref
    torch.cuda.empty_cache()
    return out


def _window_pairs(torch, lens, window):
    """(query, key) pairs a causal sliding window of ``window`` keys leaves
    live over rows of the given valid lengths: sum_i min(i + 1, window)."""
    total = 0
    for n in lens:
        n = int(n)
        w = min(n, window)
        total += w * (w + 1) // 2 + (n - w) * window
    return total


def _sdpa_gqa(torch, F, q, k, v, mask=None, is_causal=False):
    """F.scaled_dot_product_attention over [B, H, S, D] with fewer KV
    heads: ``enable_gqa`` where the installed torch has it."""
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=is_causal,
                                              enable_gqa=True)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            attn_mask=mask, is_causal=is_causal)


def k2_banded(torch, dev):
    """K2 at the shape of the repo's banded-flash timing script
    (benchmarks/_perf_banded.py: B*H = 4, S = 4096, D = 128, bf16, causal)
    with window 1024 and without, against the plain version; the library
    yardstick is F.scaled_dot_product_attention with a boolean band mask
    (is_causal for the full case). Logged, not a path's entry."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(41)
    q, k, v = (torch.randn(1, 4096, 4, 128, generator=g, device=dev)
               .to(_hdt(torch)) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    i = torch.arange(4096, device=dev)
    for window in (1024, None):
        err = _agree(f"flash_fwd (banded shape, window {window})", "bf16",
                     _max_err(FA.flash_attention(q, k, v, causal=True,
                                                 window=window),
                              FA.flash_attention_plain(q, k, v, causal=True,
                                                       window=window)))
        pairs = 4 * _window_pairs(torch, [4096], window or 4096)
        b_ms, b_by = bound(4 * 4 * 4096 * 128 * 2 + 4 * 4096 * 4,
                           4 * 128 * pairs)
        if window:
            band = ((i[:, None] >= i[None, :])
                    & (i[:, None] - i[None, :] < window))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band), iters=20)
        else:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters=20)
        ms = time_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                                window=window), iters=20)
        plain = time_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal=True, window=window), iters=5, warmup=1)
        log(f"[kernels] flash_fwd at the banded shape (q/k/v [1, 4096, 4, "
            f"128] {_hn()}, {_route(FA, 'flash_fwd', q)} route, causal, window "
            f"{window}): {ms:.4f} ms, plain "
            f"{plain:.4f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / ms:.2f}% of bound; max_abs_err "
            f"{err:.3e}")


# Mistral-7B serving (the window_serve path): 4 slots, prompts up to 4608
# tokens, window 4096, 8 KV heads of 128
WIN_SLOTS, WIN_BS, WIN_PROMPT, WIN_SEQ = 4, 16, 4608, 4672
WIN_BLOCKS = 1200           # four 4608-token prompts (1152) + growth
WIN_LONG = (4200, 4350, 4480, 4600)
WIN_SHORT = (96, 128)
WIN_NEW = 48


def qwen2_decode_entry(torch, dev):
    """K4 at ``Qwen2Config.qwen2_7b()``'s decode shape: q [8, 28, 128] over
    4 KV heads (a GQA group of 7), the serve case's
    pool geometry and lens, bf16 and float32 against the plain version,
    the partials triple too; the bf16 entry with its times and bound."""
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    c = kernel_cases(torch, dev)["paged_decode"]
    g = torch.Generator(device=dev).manual_seed(45)
    n, bs = 256, 16
    kp = torch.randn(n, bs, 4, 128, generator=g, device=dev)
    vp = torch.randn(n, bs, 4, 128, generator=g, device=dev)
    q = torch.randn(8, 28, 128, generator=g, device=dev)
    tb, lens = c["tables"], c["lens"]
    for dtype, dt in _dts(torch):
        qq, kk, vv = q.to(dt), kp.to(dt), vp.to(dt)
        err = _agree("paged_decode (qwen2-7b decode)", dtype, _max_err(
            PA.paged_decode_attention(qq, kk, vv, tb, lens),
            PA.paged_decode_attention_plain(qq, kk, vv, tb, lens)))
        _partials_agree(torch, "paged_decode (qwen2-7b decode)", dtype,
                        PA.paged_decode_attention,
                        PA.paged_decode_attention_plain, qq, kk, vv, tb,
                        (lens,), {})
    keys = int(lens.sum())
    b_ms, b_by = bound(2 * 8 * 28 * 128 * 2 + 2 * keys * 4 * 128 * 2
                       + tb.numel() * 4, 4 * 128 * 28 * keys)
    PA.paged_decode_attention(qq, kk, vv, tb, lens)
    return dict(
        max_abs_err=err, nsplit=_k4_nsplit(PA),
        ms=time_ms(lambda: PA.paged_decode_attention(qq, kk, vv, tb, lens)),
        graph_ms=graph_ms(lambda: PA.paged_decode_attention(qq, kk, vv, tb,
                                                            lens)),
        plain_ms=time_ms(lambda: PA.paged_decode_attention_plain(
            qq, kk, vv, tb, lens)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"q [8, 28, 128] {_hn()} over 4 kv heads, pool [{n}, {bs}, 4, "
              f"128], lens sum {keys}")


def window_kernel_entries(torch, dev):
    """K1, K2 and K4 against their plain versions at the shapes the
    Mistral-7B window_serve path gives them (bf16): K1 on the prefill's x
    [4 * 4608, 4096]; K2 on the windowed prefill (q [4, 4608, 32, 128], k/v
    8 heads, window 4096, kv_lens = the long prompts); K4 on a windowed
    decode step of those rows (lens = prompt + 48, pool [1200, 16, 8,
    128]). Returns {kernel: entry}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import norms
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    g = torch.Generator(device=dev).manual_seed(43)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(_hdt(torch))

    out = {}
    x, w = randn(WIN_SLOTS * WIN_PROMPT, 4096), 1.0 + 0.1 * randn(4096)
    err = _agree("rms_norm (mistral prefill)", _hn(), _max_err(
        norms.rms_norm(x, w, 1e-5), norms.rms_norm_plain(x, w, 1e-5)))
    out["rms_norm"] = _k1_entry(torch, x, w, err)
    del x
    # K2: the windowed prefill, valid rows only
    window, s, d = 4096, WIN_PROMPT, 128
    q, k, v = randn(4, s, 32, d), randn(4, s, 8, d), randn(4, s, 8, d)
    kl = torch.tensor(WIN_LONG, dtype=torch.int32, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < kl[:, None]
    err = _agree("flash_fwd (mistral windowed prefill)", _hn(), _max_err(
        FA.flash_attention(q, k, v, causal=True, window=window, kv_lens=kl),
        FA.flash_attention_plain(q, k, v, causal=True, window=window,
                                 kv_lens=kl), valid))
    rows = int(kl.sum())
    pairs = _window_pairs(torch, WIN_LONG, window)
    b_ms, b_by = bound(2 * rows * (32 + 8) * d * 2 + rows * 32 * 4,
                       4 * d * 32 * pairs)
    i = torch.arange(s, device=dev)
    keep = ((i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
            )[None] & valid[:, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["flash_fwd"] = dict(
        max_abs_err=err, variant=_route(FA, "flash_fwd", q),
        ms=time_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                              window=window, kv_lens=kl),
                   iters=5, warmup=1),
        plain_ms=time_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal=True, window=window, kv_lens=kl), iters=1,
            warmup=1),
        library_ms=time_ms(lambda: _sdpa_gqa(torch, F, qt, kt, vt,
                                             keep[:, None]), iters=5,
                           warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q [4, {s}, 32, {d}], k/v [4, {s}, 8, {d}] {_hn()} "
              f"({_route(FA, 'flash_fwd', q)} route), causal, "
              f"window {window}, kv_lens {list(WIN_LONG)}")
    del q, k, v, qt, kt, vt, keep
    torch.cuda.empty_cache()
    # K4: one windowed decode step of the long rows
    mb = -(-WIN_SEQ // WIN_BS)
    kp, vp = randn(WIN_BLOCKS, WIN_BS, 8, d), randn(WIN_BLOCKS, WIN_BS, 8, d)
    tables = torch.randperm(WIN_BLOCKS, generator=g, device=dev)[
        :4 * mb].reshape(4, mb).to(torch.int32)
    lens = kl + WIN_NEW
    qd = randn(4, 32, d)
    err = _agree("paged_decode (mistral windowed decode)", _hn(), _max_err(
        PA.paged_decode_attention(qd, kp, vp, tables, lens, window=window),
        PA.paged_decode_attention_plain(qd, kp, vp, tables, lens,
                                        window=window)))
    nsplit = _k4_nsplit(PA)
    if _paged_new(PA):
        _partials_agree(torch, "paged_decode (mistral windowed decode)",
                        _hn(), PA.paged_decode_attention,
                        PA.paged_decode_attention_plain, qd, kp, vp, tables,
                        (lens,), dict(window=window))
    live = int(torch.clamp(lens, max=window).sum())
    b_ms, b_by = bound(2 * 4 * 32 * d * 2 + 2 * live * 8 * d * 2
                       + tables.numel() * 4, 4 * d * 32 * live)
    out["paged_decode"] = dict(
        max_abs_err=err, nsplit=nsplit,
        ms=time_ms(lambda: PA.paged_decode_attention(qd, kp, vp, tables, lens,
                                                     window=window)),
        graph_ms=graph_ms(lambda: PA.paged_decode_attention(
            qd, kp, vp, tables, lens, window=window)),
        plain_ms=time_ms(lambda: PA.paged_decode_attention_plain(
            qd, kp, vp, tables, lens, window=window), iters=10),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"q [4, 32, {d}] {_hn()}, pool [{WIN_BLOCKS}, {WIN_BS}, 8, {d}], "
              f"lens {lens.tolist()}, window {window}")
    del kp, vp
    torch.cuda.empty_cache()
    return out


def phase_k3_tiles(torch, dev):
    """K3's tensor-core route at Llama-2-7B serving width (8 rows, 32
    heads, pool [256, 16, 32, 128]) with every row's 64 queries behind a
    prefix of 0, 192 or 448 keys, so that every block walks 1, 4 or 8 key
    tiles: each against the plain version and timed from a CUDA graph,
    with the K/V bytes its blocks read over that time — the rate at which
    the route streams the pool when its blocks are even."""
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    g = torch.Generator(device=dev).manual_seed(47)
    kp = torch.randn(256, 16, 32, 128, generator=g, device=dev).to(_hdt(torch))
    vp = torch.randn(256, 16, 32, 128, generator=g, device=dev).to(_hdt(torch))
    tb = torch.randperm(256, generator=g, device=dev).reshape(8, 32).int()
    q = torch.randn(8, 64, 32, 128, generator=g, device=dev).to(_hdt(torch))
    cls = torch.full((8,), 64, dtype=torch.int32, device=dev)
    for prefix in (0, 192, 448):
        offs = torch.full((8,), prefix, dtype=torch.int32, device=dev)
        args = (q, kp, vp, tb, offs, cls)
        _agree(f"k3_tiles prefix {prefix}", _hn(), _max_err(
            PA.paged_chunk_attention(*args),
            PA.paged_chunk_attention_plain(*args)))
        ms = graph_ms(lambda: PA.paged_chunk_attention(*args))
        nbytes = 8 * 32 * (prefix + 64) * 128 * 2 * 2
        log(f"[k3_tiles] prefix {prefix} ({(prefix + 64) // 64} key tiles a "
            f"block, 256 blocks, {_k3_variant(PA, q)}): {ms:.4f} ms, K/V "
            f"{nbytes / 1e6:.1f} MB read at {nbytes / ms / 1e9:.2f} TB/s")


K4_SPLITS = (128, 256, 512, 1024)   # split sizes k4_splits times


def phase_k4_splits(torch, dev):
    """K4 at Mistral-7B's window decode, Llama-2-7B's serve decode (bf16
    and int8 pools) and Qwen2-7B's decode with the live range cut into
    splits of each of K4_SPLITS keys (the wrapper's ``decode_schedule``
    replaced for the call), each against the plain version and timed from
    a CUDA graph, beside the split the schedule picks: the measurement
    behind DEC_TARGET_BLOCKS and DEC_MIN_CHUNK."""
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    g = torch.Generator(device=dev).manual_seed(46)
    c = kernel_cases(torch, dev)
    mb = -(-WIN_SEQ // WIN_BS)
    cases = {
        "window": (torch.randn(4, 32, 128, generator=g, device=dev),
                   torch.randn(WIN_BLOCKS, WIN_BS, 8, 128, generator=g,
                               device=dev),
                   torch.randn(WIN_BLOCKS, WIN_BS, 8, 128, generator=g,
                               device=dev),
                   torch.randperm(WIN_BLOCKS, generator=g, device=dev)[
                       :4 * mb].reshape(4, mb).int(),
                   torch.tensor(WIN_LONG, dtype=torch.int32, device=dev)
                   + WIN_NEW, 4096),
        "serve": (c["paged_decode"]["q"], c["paged_decode"]["kp"],
                  c["paged_decode"]["vp"], c["paged_decode"]["tables"],
                  c["paged_decode"]["lens"], None),
        "qwen2-7b": (torch.randn(8, 28, 128, generator=g, device=dev),
                     torch.randn(256, 16, 4, 128, generator=g, device=dev),
                     torch.randn(256, 16, 4, 128, generator=g, device=dev),
                     c["paged_decode"]["tables"], c["paged_decode"]["lens"],
                     None)}
    scheduled = PA.decode_schedule
    for name, (q, kp, vp, tb, lens, window) in cases.items():
        pools = {"bf16": (kp.to(_hdt(torch)), vp.to(_hdt(torch)), {})}
        if name == "serve":
            kq, ks = _quantize_pool(torch, kp)
            vq, vs = _quantize_pool(torch, vp)
            pools["int8"] = (kq, vq, dict(k_scale=ks, v_scale=vs))
        q = q.to(_hdt(torch))
        rows = tb.shape[1] * kp.shape[1]
        for pool, (kk, vv, kw) in pools.items():
            args = (q, kk, vv, tb, lens)
            ref = PA.paged_decode_attention_plain(*args, window=window, **kw)
            pick = scheduled(q.shape[0], kk.shape[2], rows, window)
            out = []
            try:
                for chunk in K4_SPLITS:
                    live = min(rows, window or rows)
                    split = (-(-live // chunk), chunk)
                    PA.decode_schedule = lambda *a, split=split: split
                    _agree(f"k4_splits {name} {pool} chunk {chunk}", _hn(),
                           _max_err(PA.paged_decode_attention(
                               *args, window=window, **kw), ref))
                    ms = graph_ms(lambda: PA.paged_decode_attention(
                        *args, window=window, **kw))
                    out.append(f"{chunk} keys x {split[0]}: {ms:.4f} ms")
            finally:
                PA.decode_schedule = scheduled
            log(f"[k4_splits] {name} {pool} (q {list(q.shape)}, "
                f"{kk.shape[2]} kv heads, schedule: {pick[1]} keys x "
                f"{pick[0]}): " + "; ".join(out))
    torch.cuda.empty_cache()


def _quantize_pool(torch, f):
    """int8 codes and fp32 per-(position, head) absmax / 127 scales of a
    pool [N, bs, Hkv, D]: what the serving path's quantize-on-write
    stores."""
    f = f.float()
    scale = torch.clamp(f.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


def _int8_case(torch, label, kernel, plain, q, args, kw, live, nbytes, flops,
               shape, plain_iters=50):
    """One int8-pool kernel against its plain version on the same codes
    and scales, with q in float32 (tolerance 1e-4) and in bf16 (2e-2),
    the partials triple too; the entry's times at bf16 q, the serving
    path's, with K3's route or K4's split count."""
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    decode = kernel is PA.paged_decode_attention
    for dtype, dt in _dts(torch):
        qq = q.to(dt)
        err = _agree(f"{label} int8", dtype, _max_err(
            kernel(qq, *args, **kw), plain(qq, *args, **kw), live))
        how = (dict(nsplit=_k4_nsplit(PA)) if decode
               else dict(variant=_k3_variant(PA, qq)))
        if _paged_new(PA):
            _partials_agree(torch, f"{label} int8", dtype, kernel, plain, qq,
                            *args[:3], args[3:], kw)
    b_ms, b_by = bound(nbytes, flops)
    graph = (dict(graph_ms=graph_ms(lambda: kernel(qq, *args, **kw)))
             if decode else _k3_graph(PA, lambda: kernel(qq, *args, **kw)))
    r = dict(max_abs_err=err, ms=time_ms(lambda: kernel(qq, *args, **kw)),
             plain_ms=time_ms(lambda: plain(qq, *args, **kw),
                              iters=plain_iters),
             library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=shape,
             **how, **graph)
    _log_entry(f"{label} int8", r)
    return r


def int8_kernel_entries(torch, dev):
    """The int8-pool modes of K4 and K3 against their plain int8 versions:
    K4 at the serve shape (8 rows, pool [256, 16, 32, 128], GQA 32/32)
    and at Mistral-7B's windowed decode (4 rows over 4096 keys, GQA 32/8,
    window 4096), K3 at the serve chunk shape. The pools are the serve
    cases' K/V quantized as the serving path stores them; the bound
    counts 1-byte codes plus a 4-byte scale per (position, KV head).
    Returns the quant_serve path's {kernel: entry}."""
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    c = kernel_cases(torch, dev)
    kq, ks = _quantize_pool(torch, c["paged_chunk"]["kp"])
    vq, vs = _quantize_pool(torch, c["paged_chunk"]["vp"])
    sc = dict(k_scale=ks, v_scale=vs)
    out = {}
    # K4, serve shape
    q, tb, lens = (c["paged_decode"][k] for k in ("q", "tables", "lens"))
    b, nh, d = q.shape
    keys = int(lens.sum())
    out["paged_decode_i8"] = _int8_case(
        torch, "paged_decode", PA.paged_decode_attention,
        PA.paged_decode_attention_plain, q, (kq, vq, tb, lens), sc, None,
        2 * b * nh * d * 2 + 2 * keys * nh * (d + 4) + tb.numel() * 4,
        4 * d * nh * keys,
        f"q [{b}, {nh}, {d}] {_hn()}, int8 pool {list(kq.shape)} + fp32 "
        f"scales, lens sum {keys}")
    # K3, serve chunk shape
    q = c["paged_chunk"]["q"]
    offs, cls = c["paged_chunk"]["offsets"], c["paged_chunk"]["chunk_lens"]
    a, cc, nh, d = q.shape
    live = torch.arange(cc, device=dev)[None, :] < cls[:, None]
    keys = sum(int(offs[i]) * int(cls[i]) + int(cls[i]) * (int(cls[i]) + 1)
               // 2 for i in range(a))
    out["paged_chunk_i8"] = _int8_case(
        torch, "paged_chunk", PA.paged_chunk_attention,
        PA.paged_chunk_attention_plain, q, (kq, vq, tb, offs, cls), sc, live,
        2 * int(cls.sum()) * nh * d * 2
        + 2 * int((offs + cls).sum()) * nh * (d + 4) + tb.numel() * 4,
        4 * d * nh * keys,
        f"q [{a}, {cc}, {nh}, {d}] {_hn()}, int8 pool {list(kq.shape)} + fp32 "
        f"scales, MB {tb.shape[1]}")
    del kq, vq, ks, vs, c
    # K4, Mistral-7B's windowed decode (not a path: window_serve is bf16)
    g = torch.Generator(device=dev).manual_seed(44)
    window, d, mb = 4096, 128, -(-WIN_SEQ // WIN_BS)
    kq, ks = _quantize_pool(torch, torch.randn(
        WIN_BLOCKS, WIN_BS, 8, d, generator=g, device=dev))
    vq, vs = _quantize_pool(torch, torch.randn(
        WIN_BLOCKS, WIN_BS, 8, d, generator=g, device=dev))
    tables = torch.randperm(WIN_BLOCKS, generator=g, device=dev)[
        :4 * mb].reshape(4, mb).to(torch.int32)
    lens = torch.tensor(WIN_LONG, dtype=torch.int32, device=dev) + WIN_NEW
    keys = int(torch.clamp(lens, max=window).sum())
    _int8_case(
        torch, "paged_decode (mistral windowed decode)",
        PA.paged_decode_attention, PA.paged_decode_attention_plain,
        torch.randn(4, 32, d, generator=g, device=dev),
        (kq, vq, tables, lens), dict(k_scale=ks, v_scale=vs, window=window),
        None, 2 * 4 * 32 * d * 2 + 2 * keys * 8 * (d + 4)
        + tables.numel() * 4, 4 * d * 32 * keys,
        f"q [4, 32, {d}] {_hn()}, int8 pool [{WIN_BLOCKS}, {WIN_BS}, 8, {d}] "
        f"+ fp32 scales, lens {lens.tolist()}, window {window}",
        plain_iters=10)
    del kq, vq, ks, vs
    torch.cuda.empty_cache()
    return out


def _lora_k6_case(torch, GM, g, m, cap, sizes, k, n, label):
    """One K6a launch at a multi-LoRA shape (fp32, the store's type)
    against grouped_matmul_plain: rows past sum(sizes) — the null-adapter
    tail, which the caller masks — are left out of the comparison. The
    route is the one ``fwd_route`` names from the static shapes; the
    wrapper's own count must show that kernel launched once."""
    dev = g.device
    lhs = torch.randn(m, k, generator=g, device=dev)
    rhs = torch.randn(cap, k, n, generator=g, device=dev) * k ** -0.5
    sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
    live = torch.arange(m, device=dev) < sum(sizes)
    before = dict(GM.grouped_matmul.route_launches)
    out = GM.grouped_matmul(lhs, rhs, sz)
    route = GM.fwd_route(m, cap, k, n, torch.float32)
    ran = {r: c - before[r] for r, c in GM.grouped_matmul.route_launches.items()
           if c != before[r]}
    if ran != {route: 1}:
        raise AssertionError(f"grouped_fwd {label}: launches by route {ran}, "
                             f"fwd_route names {route}")
    err = _agree(f"grouped_fwd lora {label} (m {m}, cap {cap}, k {k}, "
                 f"n {n}, sizes {sizes}; {route} route)", "f32",
                 _max_err(out, GM.grouped_matmul_plain(lhs, rhs, sz), live))
    return lhs, rhs, sz, route, err


# K6a's multi-LoRA kernels at Llama-2-7B's LoRA shapes: 8 slots of width
# 1 (decode), 5 (the speculative verify) and 128 (prefill); each slot's
# cache index (-1: the base), so that cap 4 has an empty group (1) and both
# caps a null tail of two slots (at width 1 the sizes [3, 0, 2, 1] and
# [6] of the general routes' checks below)
LORA_WIDTHS = {"decode": 1, "verify": 5, "prefill": 128}
LORA_AIDX = {4: (0, 2, -1, 0, 3, 2, 0, -1), 1: (0, 0, -1, 0, 0, 0, -1, 0)}
# fp32 results (t, and y in float32) against the plain versions, scaled;
# bf16 y: one bf16 step (the fp32 correction summed in another order may
# round to the neighbouring bf16 value, before and after the add)
LORA_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7, "f16": 2.0 ** -7}


def _lora_inputs(torch, g, cap, width, k, n, r, dt):
    """x [8, width, k] and y [8, width, n] in ``dt``, A [cap, k, r] ~ N(0,
    1/k) and B [cap, r, n] ~ N(0, 0.1^2) fp32 (lora_sd's B times the
    folded scale 2), and the engine's perm / gs for LORA_AIDX[cap]."""
    import numpy as np
    dev = g.device
    aidx = np.asarray(LORA_AIDX[cap])
    order = np.argsort(np.where(aidx < 0, cap, aidx), kind="stable")
    gs = np.bincount(aidx[aidx >= 0], minlength=cap) * width
    x = torch.randn(8, width, k, generator=g, device=dev).to(dt)
    y = torch.randn(8, width, n, generator=g, device=dev).to(dt)
    a = torch.randn(cap, k, r, generator=g, device=dev) * k ** -0.5
    b = torch.randn(cap, r, n, generator=g, device=dev) * 0.1
    perm = torch.as_tensor(order.astype(np.int32), device=dev)
    sz = torch.as_tensor(gs.astype(np.int32), device=dev)
    lora = {"a": a, "b": b, "perm": perm, "gs": sz,
            "inv": torch.argsort(perm).to(torch.int32),
            "aidx": torch.as_tensor(aidx.astype(np.int32), device=dev)}
    return x, y, lora


def _lora_pair_case(torch, GM, g, cap, width, kind, r, dt):
    """One shrink and one expand launch (each counted once by its wrapper)
    against their plain versions on the same inputs; the expand also
    leaves the null tail's y rows bit for bit as they were. Both kernels
    then timed eager and from a CUDA graph. Returns (x, y, lora, shrink
    error, expand error)."""
    k, n = 4096, (3 * 4096 if kind == "qkv" else 4096)
    x, y, lora = _lora_inputs(torch, g, cap, width, k, n, r, dt)
    label = (f"cap {cap} width {width} {kind} r{r} x {_short(dt)}: x "
             f"[8, {width}, {k}], A [{cap}, {k}, {r}], B [{cap}, {r}, {n}]")
    before = (GM.lora_shrink.launches, GM.lora_expand_add.launches)
    t = GM.lora_shrink(x, lora["perm"], lora["a"], lora["gs"])
    t_ref = GM.lora_shrink_plain(x, lora["perm"], lora["a"], lora["gs"])
    got = GM.lora_expand_add(y.clone(), t, lora["b"], lora["gs"],
                             lora["perm"])
    want = GM.lora_expand_add_plain(y.clone(), t, lora["b"], lora["gs"],
                                    lora["perm"])
    if (GM.lora_shrink.launches - before[0],
            GM.lora_expand_add.launches - before[1]) != (1, 1):
        raise AssertionError(f"lora kernels {label}: launches not counted "
                             f"once each")
    null = lora["aidx"] < 0
    if not torch.equal(got[null], y[null]):
        raise AssertionError(f"lora_expand {label}: a null-adapter row "
                             f"changed")
    errs = []
    for name, a_, b_, tol in (("lora_shrink", t, t_ref, LORA_TOL["f32"]),
                              ("lora_expand", got, want,
                               LORA_TOL[_short(dt).replace("float32",
                                                           "f32")])):
        err, scaled = _max_err(a_, b_)
        log(f"[kernels] {name} {label}: max_abs_err {err:.3e}, scaled "
            f"{scaled:.3e} (tolerance {tol:.3g} * (1 + |plain|))")
        if not scaled <= tol:
            raise AssertionError(f"{name} {label}: kernel disagrees with "
                                 f"its plain version: {scaled} > {tol}")
        errs.append(err)
    yk = y.clone()
    times = [fn(call, iters=20) for call in (
        lambda: GM.lora_shrink(x, lora["perm"], lora["a"], lora["gs"]),
        lambda: GM.lora_expand_add(yk, t, lora["b"], lora["gs"],
                                   lora["perm"])) for fn in (time_ms,
                                                             graph_ms)]
    log(f"[kernels] lora {label}: shrink {times[0]:.4f} ms (graph "
        f"{times[1]:.4f}), expand {times[2]:.4f} ms (graph {times[3]:.4f})")
    return x, y, lora, errs[0], errs[1]


def _lora_timed(torch, GM, P, case, kind, dt, label):
    """Times of the two kernels of one case: eager and from a CUDA graph,
    the plain versions, the gather baseline's arithmetic for the same
    projection (``y + _lora_delta`` under ``PT_MULTILORA_IMPL=gather``)
    and the unfused composition on the general K6a routes (``y +
    _lora_delta``, grouped), both from a CUDA graph; bounds from this
    case's shapes and live rows."""
    x, y, lora, err_s, err_e = case
    b, s, k = x.shape
    cap, r, n = lora["b"].shape
    rows = int(lora["gs"].sum())
    groups = int((lora["gs"] > 0).sum())
    xe, ye = x.element_size(), y.element_size()
    t = GM.lora_shrink(x, lora["perm"], lora["a"], lora["gs"])
    yk = y.clone()
    ld = {f"{kind}_a": lora["a"][None], f"{kind}_b": lora["b"][None],
          **{key: lora[key] for key in ("perm", "inv", "gs", "aidx")}}

    def delta(impl):
        os.environ["PT_MULTILORA_IMPL"] = impl
        try:
            return graph_ms(lambda: y + P._lora_delta(x, ld, kind, 0),
                            iters=20)
        finally:
            os.environ.pop("PT_MULTILORA_IMPL")
    gather_ms, unfused_ms = delta("gather"), delta("grouped")
    pair_ms = graph_ms(lambda: GM.lora_expand_add(
        yk, GM.lora_shrink(x, lora["perm"], lora["a"], lora["gs"]),
        lora["b"], lora["gs"], lora["perm"]))
    out = {}
    shape = (f"lora {label}: x [{b}, {s}, {k}] {_short(x.dtype)}, {rows} "
             f"live rows in {groups} of {cap} groups, r {r}")
    sb = bound(rows * k * xe + groups * k * r * 4 + b * s * r * 4 + 4 * (
        cap + b), 2 * rows * k * r, PEAK_FP32_FLOPS)
    out["lora_shrink"] = dict(
        max_abs_err=err_s,
        ms=time_ms(lambda: GM.lora_shrink(x, lora["perm"], lora["a"],
                                          lora["gs"])),
        graph_ms=graph_ms(lambda: GM.lora_shrink(x, lora["perm"], lora["a"],
                                                 lora["gs"])),
        plain_ms=time_ms(lambda: GM.lora_shrink_plain(
            x, lora["perm"], lora["a"], lora["gs"]), iters=10),
        library_ms=None, bound_ms=sb[0], bound_by=sb[1],
        gather_graph_ms=gather_ms, unfused_graph_ms=unfused_ms,
        pair_graph_ms=pair_ms, shape=f"{shape}, A [{cap}, {k}, {r}]")
    eb = bound(2 * rows * n * ye + groups * r * n * 4 + rows * r * 4 + 4 * (
        cap + b), 2 * rows * r * n + rows * n, PEAK_FP32_FLOPS)
    out["lora_expand"] = dict(
        max_abs_err=err_e,
        ms=time_ms(lambda: GM.lora_expand_add(yk, t, lora["b"], lora["gs"],
                                              lora["perm"])),
        graph_ms=graph_ms(lambda: GM.lora_expand_add(
            yk, t, lora["b"], lora["gs"], lora["perm"])),
        plain_ms=time_ms(lambda: GM.lora_expand_add_plain(
            yk, t, lora["b"], lora["gs"], lora["perm"]), iters=10),
        library_ms=None, bound_ms=eb[0], bound_by=eb[1],
        gather_graph_ms=gather_ms, unfused_graph_ms=unfused_ms,
        pair_graph_ms=pair_ms, shape=f"{shape}, B [{cap}, {r}, {n}]")
    for name, e in out.items():
        _log_entry(f"lora_serve {name} ({label})", e)
        log(f"[kernels] lora_serve {name} ({label}): shrink + expand graph "
            f"{pair_ms:.4f} ms; the same projection's gather baseline "
            f"(y + _lora_delta, gather) graph {gather_ms:.4f} ms, the "
            f"unfused composition on the general K6a routes graph "
            f"{unfused_ms:.4f} ms "
            f"({card_line()})")
    return out


def lora_kernel_entries(torch, dev):
    """K6a's two multi-LoRA kernels at the shapes multi-LoRA serving gives
    them on Llama-2-7B (k = 4096; n = 12288 for qkv, 4096 for o): 8 slots
    of width 1, 5 and 128 (decode, verify, prefill), ranks 4, 8 and 16,
    caps 4 (an empty group) and 1, a null tail, x and y in bf16 and fp32,
    each against its plain version (``_lora_pair_case``); at rank 16 (the
    store's max_rank in lora_serve), cap 4 and bf16 each width and
    projection timed (``_lora_timed``). The general K6a routes stay
    checked at these shapes (``_lora_k6_case``, fp32, untimed). Returns
    the lora_serve path's entries: the decode qkv row of each kernel."""
    from paddle_tpu_torch.models import paged as P
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    g = torch.Generator(device=dev).manual_seed(77)
    h, nqkv = 4096, 3 * 4096
    out = {}
    for label, width in LORA_WIDTHS.items():
        for cap in (4, 1):
            for r in (4, 8, 16):
                for _, dt in _dts(torch):
                    for kind in ("qkv", "o"):
                        case = _lora_pair_case(torch, GM, g, cap, width,
                                               kind, r, dt)
                        if (cap, r, dt) == (4, 16, _hdt(torch)):
                            rows = _lora_timed(torch, GM, P, case, kind, dt,
                                               f"{label} {kind}")
                            if (label, kind) == ("decode", "qkv"):
                                out = rows
                        del case
    torch.cuda.empty_cache()
    if not HALF["f32"]:
        return out          # a float16 rerun: the kernels alone
    # the general K6a routes at these shapes: checks only
    dec4, dec1 = [3, 0, 2, 1], [6]          # 8 rows: tails of 2 rows
    pre4, pre1 = [256, 0, 384, 128], [896]  # 1024 rows: tails of 256, 128
    for cap, sizes in ((4, dec4), (1, dec1)):
        for r in (4, 8, 16):
            for name, k, n in (("A", h, r), ("B qkv", r, nqkv),
                               ("B o", r, h)):
                case = _lora_k6_case(torch, GM, g, 8, cap, sizes, k, n,
                                     f"decode {name} r{r}")
                if case[3] not in ("rows", "decode"):
                    raise AssertionError(f"decode {name} r{r}: {case[3]}")
    for cap, sizes in ((4, pre4), (1, pre1)):
        for name, k, n in (("A", h, 16), ("B qkv", 16, nqkv)):
            case = _lora_k6_case(torch, GM, g, 1024, cap, sizes, k, n,
                                 f"prefill {name} r16")
            if case[3] != "fma":
                raise AssertionError(f"prefill {name}: {case[3]}")
    if _lora_k6_case(torch, GM, g, 8, 4, dec4, h, 6, "decode A n6")[3] != \
            "fma":
        raise AssertionError("n = 6 must be routed to the FMA kernel")
    return out


def verify_kernel_entries(torch, dev):
    """K3 at the speculative verify width on Llama-2-7B: 8 rows of at most
    spec_k + 1 = 5 queries, q [8, 5, 32, 128], at offsets whose chunk
    crosses a 16-token block boundary, over the serve cases' bf16 pool
    (q, pool in float32 too) and the same pool quantized to int8 with
    fp32 scales, each against its plain version; times eager and from a
    CUDA graph. Returns (the spec_serve path's paged_chunk entry, the int8
    entry)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    c = kernel_cases(torch, dev)
    g = torch.Generator(device=dev).manual_seed(55)
    kp, vp, tb = c["paged_chunk"]["kp"], c["paged_chunk"]["vp"], \
        c["paged_chunk"]["tables"]
    offs = torch.tensor([15, 31, 47, 100, 127, 200, 300, 406],
                        dtype=torch.int32, device=dev)
    cls = torch.tensor([5, 5, 5, 5, 3, 5, 2, 5], dtype=torch.int32,
                       device=dev)
    q32 = torch.randn(8, 5, 32, 128, generator=g, device=dev)
    a, cc, nh, d = q32.shape
    live = torch.arange(cc, device=dev)[None, :] < cls[:, None]
    keys = sum(int(offs[i]) * int(cls[i]) + int(cls[i]) * (int(cls[i]) + 1)
               // 2 for i in range(a))
    for dtype, dt in _dts(torch):
        q, kc, vc = q32.to(dt), kp.to(dt), vp.to(dt)
        err = _agree("paged_chunk verify", dtype, _max_err(
            PA.paged_chunk_attention(q, kc, vc, tb, offs, cls),
            PA.paged_chunk_attention_plain(q, kc, vc, tb, offs, cls), live))
    nbytes = (2 * int(cls.sum()) * nh * d * 2
              + 2 * int((offs + cls).sum()) * nh * d * 2 + tb.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * d * nh * keys)
    bf16 = dict(
        max_abs_err=err, variant=_k3_variant(PA, q),
        ms=time_ms(lambda: PA.paged_chunk_attention(q, kc, vc, tb, offs,
                                                    cls)),
        graph_ms=graph_ms(lambda: PA.paged_chunk_attention(q, kc, vc, tb,
                                                           offs, cls)),
        plain_ms=time_ms(lambda: PA.paged_chunk_attention_plain(
            q, kc, vc, tb, offs, cls)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"verify q [{a}, {cc}, {nh}, {d}] {_hn()}, pool "
              f"{list(kp.shape)}, offsets {offs.tolist()}, chunk lens "
              f"{cls.tolist()}")
    _log_entry("spec_serve paged_chunk (verify)", bf16)
    kq, ks = _quantize_pool(torch, kp)
    vq, vs = _quantize_pool(torch, vp)
    i8 = _int8_case(
        torch, "paged_chunk verify", PA.paged_chunk_attention,
        PA.paged_chunk_attention_plain, q32, (kq, vq, tb, offs, cls),
        dict(k_scale=ks, v_scale=vs), live,
        2 * int(cls.sum()) * nh * d * 2
        + 2 * int((offs + cls).sum()) * nh * (d + 4) + tb.numel() * 4,
        4 * d * nh * keys,
        f"verify q [{a}, {cc}, {nh}, {d}] {_hn()}, int8 pool {list(kq.shape)} "
        f"+ fp32 scales")
    return bf16, i8


# ------------------------------------------------------------------ serve
def serve_requests(rs, vocab=32000):
    """The 12-request mix: 6 short prompts (whole-prompt prefill), 2 long
    ones (chunked prefill), 2 sharing a 64-token prefix with an earlier
    prompt (radix prefix hit, resumed through the chunk kernel) and 2 at
    temperature 0.8 / top-p 0.9; 32 new tokens each."""
    from paddle_tpu_torch.serving import Request
    prompts = [rs.randint(3, vocab, size=n) for n in (17, 33, 50, 72, 96, 120)]
    prompts += [rs.randint(3, vocab, size=n) for n in (300, 384)]
    shared = prompts[5][:64]
    prompts += [list(shared) + list(rs.randint(3, vocab, size=n))
                for n in (20, 41)]
    reqs = [Request(p, max_new_tokens=32) for p in prompts]
    reqs += [Request(rs.randint(3, vocab, size=n), max_new_tokens=32,
                     temperature=0.8, top_p=0.9) for n in (40, 90)]
    return reqs


def build_model(dev):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig.llama2_7b(), device=dev, seed=0)


def _tick_stats(torch, exe):
    """{kind: (replays, mean wall ms of the executor's call, mean device
    ms between the CUDA events around the replay)} of the decode ticks the
    executor logged (``tick_log``: "sync" ticks and "async" dispatches);
    {} for a tree whose executor logs none."""
    log_ = getattr(exe, "tick_log", None)
    if not log_:
        return {}
    torch.cuda.synchronize()
    acc = {}
    for kind, wall, e0, e1 in log_:
        n, w, d = acc.get(kind, (0, 0.0, 0.0))
        acc[kind] = (n + 1, w + wall, d + e0.elapsed_time(e1))
    return {k: (n, 1e3 * w / n, d / n) for k, (n, w, d) in acc.items()}


def _log_ticks(torch, path, exe, card):
    """One line per kind of decode tick the executor replayed: replays
    (each adds the launches its capture counted), wall and device ms, and
    the bytes the graphs' private pools reserved."""
    for kind, (n, wall, dev_ms) in _tick_stats(torch, exe).items():
        what = "dispatch call" if kind == "async" else "call incl. fetch"
        log(f"[{path}] {kind} decode ticks: {n} graph replays, wall "
            f"{wall:.3f} ms/tick ({what}), device {dev_ms:.3f} ms/tick "
            f"(CUDA events around the replay); graph pools "
            f"{exe.graph_pool_bytes / 2**20:.1f} MiB ({card})")


def _drains_now():
    """{why: async windows drained so far} (the port's metrics)."""
    from paddle_tpu_torch.observability import METRICS
    c = METRICS.get("serving_async_drains_total")
    return {} if c is None else {k[0]: v[0] for k, v in c._series.items()}


def phase_serve(torch, dev, model, np, path="serve", kv_dtype=None,
                async_depth=0, label=None, engine_kw=None, adapter_ids=None,
                warm_adapter=None, late=None, mix=None, on_step=None,
                need_hits=True, roofline=False, make_kw=None, setup=None):
    """Serve the 12-request mix with ``model`` through ``LLMEngine`` (an
    int8 KV pool with ``kv_dtype="int8"``, async pipelined decode with
    ``async_depth``, further engine arguments in ``engine_kw``: an adapter
    store, a draft model); every kernel of ``PATHS[path]`` must be
    launched. ``adapter_ids``: one LoRA adapter id (or None) per request
    of the mix; ``warm_adapter``: the warm-up requests' adapter; ``late``:
    called with the engine after its fourth step, returns requests it
    submitted (served and checked with the mix). ``mix``: the requests
    instead of the 12-request mix (beam requests finish with reason
    "beam"; TTFT is taken over the requests that emit tokens one by one);
    ``on_step``: called with the engine after every step; ``need_hits``:
    the mix must hit the radix prefix cache; ``roofline``: print the
    engine's roofline report and fail on a decode MBU of 0 or any MBU or
    MFU above 1.05. ``make_kw``: called for each engine (the warm-up's
    and the measured one), returns further engine arguments of its own (a
    degradation controller, an SLO tracker); ``setup``: called with the
    measured engine before its requests are added. ``label`` names the
    run in the log (default ``path``). Returns (launch counts, the
    requests, {metric: value})."""
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    from paddle_tpu_torch.serving.kv import cache_block_bytes
    label = label or path
    vocab = model.cfg.vocab_size
    kw = dict(num_slots=8, block_size=16, max_prompt_len=128,
              max_seq_len=512, num_blocks=256, seed=0, device=dev,
              **(engine_kw or {}))
    if kv_dtype is not None:
        kw["kv_dtype"] = kv_dtype
    if async_depth:
        kw["async_depth"] = async_depth
    # warm-up (library handles, allocator, kernel loads) on a throwaway
    # engine: one whole-prompt and one chunked request
    warm = LLMEngine(model, **kw, **(make_kw() if make_kw else {}))
    rs = np.random.RandomState(1)
    for n in (40, 200):
        warm.add_request(Request(rs.randint(3, vocab, size=n),
                                 max_new_tokens=4, adapter_id=warm_adapter))
    warm.run()
    del warm
    eng = LLMEngine(model, **kw, **(make_kw() if make_kw else {}))
    if hasattr(eng.exe, "tick_log"):
        eng.exe.tick_log = []
    if setup is not None:
        setup(eng)
    reqs = (serve_requests(np.random.RandomState(0), vocab) if mix is None
            else list(mix))
    for r, aid in zip(reqs, adapter_ids or ()):
        r.adapter_id = aid
    drains0 = _drains_now()
    if roofline:
        from paddle_tpu_torch.observability.roofline import \
            reset_serving_roofline
        reset_serving_roofline()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.monotonic()
    for r in reqs:
        eng.add_request(r)
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        if late is not None and steps == 4:
            reqs = reqs + list(late(eng))
        if on_step is not None:
            on_step(eng)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = K.launches()
    routes = K.route_launches() if hasattr(K, "route_launches") else {}
    hits = eng.mgr.cache_stats.get("token_hits", 0)
    for r in reqs:
        ok = ("beam",) if r.num_beams > 1 else ("length", "eos")
        if not r.done or r.finish_reason not in ok:
            raise AssertionError(f"request {r.req_id} did not finish: "
                                 f"{r.finish_reason}")
    eng.assert_quiescent()
    missing = _missing(path, counts)
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing} ({counts})")
    if need_hits and hits <= 0:
        raise AssertionError("no radix prefix hit in the serving mix")
    ntok = sum(len(r.tokens) for r in reqs)
    ttft = [r._first_tok_t - r._submit_t for r in reqs
            if r._first_tok_t is not None]
    stats = dict(
        tokens_s=ntok / wall, ttft_mean_ms=1e3 * sum(ttft) / len(ttft),
        ttft_max_ms=1e3 * max(ttft),
        kv_bytes_token=cache_block_bytes(eng.cache) / eng.block_size,
        weight_bytes=sum(t.numel() * t.element_size()
                         for t in (*model.parameters(), *model.buffers())),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        routes=routes, engine=dict(eng.stats), steps=steps, wall=wall,
        pool_mib=getattr(eng.exe, "graph_pool_bytes", 0) / 2**20)
    card = card_line()
    log(f"[{label}] {len(reqs)} requests, {ntok} tokens in {wall:.3f} s: "
        f"{stats['tokens_s']:.1f} tokens/s, {eng.stats['ticks']} decode "
        f"ticks ({card})")
    log(f"[{label}] mean TTFT {stats['ttft_mean_ms']:.1f} ms, "
        f"max {stats['ttft_max_ms']:.1f} ms ({card})")
    log(f"[{label}] peak allocated {stats['peak_gib']:.2f} GiB ({card}); "
        f"KV {stats['kv_bytes_token']:.0f} bytes/token, weights "
        f"{stats['weight_bytes'] / 2**30:.2f} GiB; prefix token hits "
        f"{hits}; launches {counts}")
    _log_ticks(torch, label, eng.exe, card)
    _check_tick_graphs(label, eng.exe, model)
    stats["ticks"] = _tick_stats(torch, eng.exe)
    if roofline:
        stats["roofline"] = _log_roofline(label, eng, card)
    if async_depth:
        drains = _drains_now()
        stats["drains"] = {k: v - drains0.get(k, 0) for k, v in drains.items()
                           if v != drains0.get(k, 0)}
        log(f"[{label}] async_depth {async_depth}: windows drained by reason "
            f"{stats['drains']}, rows run for torn-down slots "
            f"{eng.stats['async_overrun']}")
    del eng
    torch.cuda.empty_cache()
    return counts, reqs, stats


ROOF_MAX = 1.05      # above this an MFU or MBU is a fault of the model


def _log_roofline(label, eng, card):
    """The engine's ``serving_roofline_report()`` after its run: MFU, MBU
    and arithmetic intensity per phase against the peaks resolved from
    the card's name. Fails when the decode phase's MBU is 0 (the peaks
    did not resolve, or no decode tick was billed) or any phase's MFU or
    MBU exceeds ROOF_MAX (the bytes model or the timed window is
    wrong). Returns {phase: (mfu, mbu, intensity)}."""
    if not _port_has("observability.roofline"):
        return {}
    from paddle_tpu_torch.observability.roofline import \
        serving_roofline_report
    eng._push_roofline()
    doc = serving_roofline_report()
    m = doc["machine"]
    log(f"[{label}] roofline peaks {m['peak_flops'] / 1e12:.0f} TFLOP/s, "
        f"{m['peak_hbm_bps'] / 1e12:.2f} TB/s (from "
        f"{eng.device} = {card.split(',')[0]}); balance "
        f"{m['balance_flops_per_byte']:.1f} FLOP/byte")
    out = {}
    for ph, r in sorted(doc["phases"].items()):
        out[ph] = (r["mfu"], r["mbu"], r["arith_intensity"])
        log(f"[{label}] roofline {ph}: serving_mfu {r['mfu']:.4f}, "
            f"serving_mbu {r['mbu']:.4f}, intensity "
            f"{r['arith_intensity']:.2f} FLOP/byte ({r['bound']}); "
            f"{r['tokens']} tokens, {r['weight_passes']} weight passes, "
            f"{r['kv_read_positions']} KV positions in {r['seconds']:.4f} "
            f"s ({card})")
    dec = out.get("decode", (0.0, 0.0, 0.0))
    over = {ph: v for ph, v in out.items()
            if v[0] > ROOF_MAX or v[1] > ROOF_MAX}
    if dec[1] <= 0.0 or over:
        raise AssertionError(f"{label}: decode MBU {dec[1]}, phases above "
                             f"{ROOF_MAX}: {over}")
    return out


def _check_tick_graphs(label, exe, model):
    """Each decode-tick graph the executor captured, from the counts a
    replay adds: over a pool of the model's type K7 folded with the pool
    write (one ``rope_kv`` launch a layer) and no ``rope``; over an int8
    pool K7 on q and k (two a layer) and no fold; every K6a launch of an
    MoE model's tick on the decode route. (An earlier tree without the
    fold is not checked.)"""
    if "rope_kv" in ABSENT:
        return
    from paddle_tpu_torch.models.paged import model_config
    layers = model_config(model).num_hidden_layers
    int8 = bool(exe.cache.k_scale_store)
    want = ({"rope": 2 * layers, "rope_kv": 0} if int8
            else {"rope": 0, "rope_kv": layers})
    for kind in ("_tick", "_atick", "_ltick", "_btick"):
        g = getattr(exe, kind, None)
        if g is None:
            continue
        got = {k: g.launches.get(k, 0) for k in want}
        gf = g.launches.get("grouped_fwd", 0)
        dec = g.route_launches.get("grouped_fwd", {}).get("decode", 0)
        log(f"[{label}] {kind[1:]} graph: a replay launches {g.launches}; "
            f"K6a on the decode route {dec} of {gf}")
        if got != want or dec != gf:
            raise AssertionError(f"{label}: the {kind[1:]} graph launches "
                                 f"{got} (want {want}) and K6a {dec} of "
                                 f"{gf} on the decode route")


def _tick_tokens(out):
    """The sampled tokens of ``ModelExecutor.decode_tick``'s result: the
    array itself in a tree whose executor returns only them, else the
    first of its (tokens, log-probs) pair."""
    return out[0] if isinstance(out, tuple) else out


def _cache_tensors(cache):
    return [*cache.k_store, *cache.v_store, *cache.k_scale_store,
            *cache.v_scale_store, cache.block_tables, cache.lens]


def graph_against_eager(torch, eng, lora=None, bias=None):
    """On an engine whose slots are decoding (its tick graph captured),
    from one cache state (copied, and put back in place between runs):
    one replay of the graph and one eager ``llama_decode_tick``, greedy,
    give identical tokens, bit-identical log-probabilities (log_softmax of
    the replay's logits against the eager tick's ``want_logp``) and
    identical caches after the tick; at temperature 0.8 two replays draw
    different tokens, a replay from the generator's first state repeats
    the first draw, and the eager tick from that state draws it too.
    ``lora``: the engine's host description of a multi-LoRA batch (the
    executor then replays its LoRA graph, the eager tick takes the same
    batch); ``bias``: a [slots, V] fp32 numpy logit bias (the executor
    then replays its biased graph, the eager tick adds the same bias).
    Raises on any difference; returns {check: reading}."""
    import numpy as np
    from paddle_tpu_torch.models import paged as P
    exe = eng.exe
    live = _cache_tensors(exe.cache)
    snap = [t.clone() for t in live]

    def restore():
        for t, c in zip(live, snap):
            t.copy_(c)
    b = eng.num_slots
    tok, mask = eng.last_tok.copy(), eng.active.copy()
    none = (np.full(b, b, np.int32), np.zeros(b, np.int32),
            np.zeros(b, np.int32))
    greedy, hot, top1 = (np.zeros(b, np.float32), np.full(b, 0.8, np.float32),
                         np.ones(b, np.float32))
    s0 = exe.gen.get_state()
    lk = {} if lora is None else {"lora": lora}
    if bias is not None:
        lk["bias"] = bias

    def eager(temps):
        restore()
        exe.gen.set_state(s0)
        nxt, logp, _ = P.llama_decode_tick(
            eng.model, tok, exe.cache, mask, *none, exe.gen, temps, top1,
            exe.top_k, want_logp=True,
            **({} if lora is None else {"lora": exe._lora(lora)}),
            **({} if bias is None else {"logit_bias": bias}))
        return nxt.cpu().numpy(), logp

    g_tok = _tick_tokens(exe.decode_tick(tok, mask, *none, greedy, top1,
                                         **lk))
    g_logp = torch.log_softmax(exe.tick_logits, dim=-1)
    g_cache = [t.clone() for t in live]
    e_tok, e_logp = eager(greedy)
    out = dict(
        tokens_equal=bool(np.array_equal(g_tok, e_tok)),
        logp_bit_equal=bool(torch.equal(g_logp, e_logp)),
        cache_bit_equal=all(torch.equal(a, c) for a, c in zip(live,
                                                              g_cache)),
        logp_max_abs_diff=float((g_logp - e_logp).abs().max()))
    del g_cache
    draws = []
    for state in (s0, None, s0):
        restore()
        if state is not None:
            exe.gen.set_state(state)
        draws.append(_tick_tokens(exe.decode_tick(tok, mask, *none, hot,
                                                  top1, **lk)))
    e_hot, _ = eager(hot)
    restore()
    exe.gen.set_state(s0)
    out.update(hot_rows_differ=int((draws[0] != draws[1])[mask].sum()),
               hot_replay_repeats=bool(np.array_equal(draws[0], draws[2])),
               hot_eager_equal=bool(np.array_equal(draws[0], e_hot)))
    bad = [k for k in ("tokens_equal", "logp_bit_equal", "cache_bit_equal",
                       "hot_replay_repeats", "hot_eager_equal") if not out[k]]
    if bad or out["hot_rows_differ"] == 0:
        raise AssertionError(f"graph tick against the eager tick: {out}")
    return out


def phase_graph_check(torch, dev, model, np, kv_dtype=None):
    """``graph_against_eager`` at the serve phase's geometry (8 slots, all
    decoding, prompts of 20-120 tokens) on ``model`` (a pool of its type,
    or int8 with ``kv_dtype="int8"``)."""
    from paddle_tpu_torch.serving import LLMEngine, Request
    eng = LLMEngine(model, num_slots=8, block_size=16, max_prompt_len=128,
                    max_seq_len=512, num_blocks=256, seed=0, device=dev,
                    **({} if kv_dtype is None else {"kv_dtype": kv_dtype}))
    rs = np.random.RandomState(3)
    for n in rs.randint(20, 120, 8):
        eng.add_request(Request(rs.randint(3, model.cfg.vocab_size,
                                           size=int(n)), max_new_tokens=64))
    while not (eng.active.all() and eng.stats["ticks"] >= 2):
        eng.step()
    res = graph_against_eager(torch, eng)
    label = "int8 pool" if kv_dtype else "bf16 pool"
    log(f"[graph_check] {label}: {res}; graph pools "
        f"{eng.exe.graph_pool_bytes / 2**20:.1f} MiB ({card_line()})")
    del eng
    torch.cuda.empty_cache()


def phase_quant_serve(torch, dev, model, np, serve_stats):
    """The serve mix over an int8 KV pool with ``model`` (already
    weight-only quantized): the int8 modes of K3/K4 must run and the bf16
    ones not at all. Prints its metrics beside the serve phase's.
    Returns (launch counts, the requests)."""
    counts, reqs, stats = phase_serve(torch, dev, model, np, "quant_serve",
                                      kv_dtype="int8")
    bf16 = {k: counts[k] for k in ("paged_chunk", "paged_decode")}
    if any(bf16.values()):
        raise AssertionError(f"quant_serve launched the bf16 paged kernels: "
                             f"{bf16}")
    for key, unit in (("tokens_s", "tokens/s"), ("ttft_mean_ms", "ms"),
                      ("ttft_max_ms", "ms"), ("kv_bytes_token", "bytes"),
                      ("weight_bytes", "bytes"), ("peak_gib", "GiB")):
        log(f"[quant_serve] {key}: {stats[key]:.4f} {unit} (int8 weights, "
            f"int8 KV) vs {serve_stats[key]:.4f} {unit} (serve: bf16)")
    return counts, reqs


# ------------------------------------------------------------------ check
class plain_kernels:
    """Swap every kernel wrapper for its plain version (the check phase's
    reference run on the same card); restores them on exit."""

    def __enter__(self):
        from paddle_tpu_torch.ops.cuda import flash_attention as FA
        from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
        from paddle_tpu_torch.ops.cuda import norms
        from paddle_tpu_torch.ops.cuda import paged_attention as PA
        self.saved = [(norms, "rms_norm", norms.rms_norm),
                      (GM, "grouped_matmul", GM.grouped_matmul),
                      *((GM, name, getattr(GM, name))
                        for name in ("lora_shrink", "lora_expand_add",
                                     "moe_gate_up", "moe_down")
                        if hasattr(GM, name)),
                      (FA, "flash_attention", FA.flash_attention),
                      (PA, "paged_chunk_attention", PA.paged_chunk_attention),
                      (PA, "paged_decode_attention", PA.paged_decode_attention)]
        norms.rms_norm = norms.rms_norm_plain
        GM.grouped_matmul = GM.grouped_matmul_plain
        if hasattr(GM, "lora_shrink"):
            GM.lora_shrink = GM.lora_shrink_plain
            GM.lora_expand_add = GM.lora_expand_add_plain
        if hasattr(GM, "moe_gate_up"):
            GM.moe_gate_up = GM.moe_gate_up_plain
            GM.moe_down = GM.moe_down_plain

        def fa(q, k, v, causal=False, scale=None, window=None, kv_lens=None,
               alibi_slopes=None):
            # (without slopes, as an earlier tree's plain version takes it)
            extra = () if alibi_slopes is None else (alibi_slopes,)
            return FA.flash_attention_plain(q, k, v, causal, scale, window,
                                            kv_lens, *extra)
        FA.flash_attention = fa
        PA.paged_chunk_attention = lambda *a, partials=False, **kw: \
            PA.paged_chunk_attention_plain(*a, **kw)
        PA.paged_decode_attention = lambda *a, partials=False, **kw: \
            PA.paged_decode_attention_plain(*a, **kw)
        if "rope" not in ABSENT:
            from paddle_tpu_torch.ops.cuda import rope
            self.saved.append((rope, "fused_rope", rope.fused_rope))
            rope.fused_rope = rope.fused_rope_plain
        if "rope_kv" not in ABSENT:
            from paddle_tpu_torch.ops.cuda import rope
            self.saved.append((rope, "rope_kv_write", rope.rope_kv_write))
            rope.rope_kv_write = rope.rope_kv_write_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _path_logits(torch, model, prompts, long_prompt, toks, kv_dtype=None):
    """Prefill (flash) of ``prompts``, the chunked prefill (paged chunk)
    of ``long_prompt`` in 128-token chunks, then one decode step (paged
    decode) feeding every row its served first token ``toks``: the three
    logit blocks of the serving path (over an int8 KV pool with
    ``kv_dtype="int8"``)."""
    import numpy as np
    from paddle_tpu_torch.models import paged as P
    cfg, dev = model.cfg, model.device
    bs, nb, mb = 16, 128, 32
    cache = P.PagedKVCache.init(cfg.num_hidden_layers, nb, bs,
                                cfg.num_key_value_heads,
                                cfg.hidden_size // cfg.num_attention_heads,
                                len(prompts) + 1, mb, cfg.dtype,
                                kv_dtype=kv_dtype, device=dev)
    b = len(prompts)
    ids = np.zeros((b, 128), np.int64)
    lens = np.array([len(p) for p in prompts], np.int32)
    tables = np.full((b + 1, mb), nb, np.int32)
    nxt = 0
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
        need = -(-(len(p) + 1) // bs)
        tables[i, :need] = np.arange(nxt, nxt + need)
        nxt += need
    need = -(-(len(long_prompt) + 1) // bs)
    tables[b, :need] = np.arange(nxt, nxt + need)
    pre, _ = P.llama_prefill_paged(
        model, torch.as_tensor(ids, device=dev), lens, cache,
        slot_ids=np.arange(b, dtype=np.int32), table_rows=tables[:b])
    chunk = None
    for off in range(0, len(long_prompt), 128):
        piece = long_prompt[off:off + 128]
        cid = np.zeros((1, 128), np.int64)
        cid[0, :len(piece)] = piece
        chunk, _ = P.llama_prefill_chunk_paged(
            model, torch.as_tensor(cid, device=dev),
            np.array([len(piece)], np.int32), np.array([off], np.int32),
            cache, np.array([b], np.int32), tables[b:b + 1])
    dec, _ = P.llama_decode_step_paged(
        model, torch.as_tensor(toks, device=dev), cache,
        torch.ones(b + 1, dtype=torch.bool, device=dev))
    return pre.float(), chunk.float(), dec.float()


class count_plain_calls:
    """Count, while active, the calls of ``eager_attention`` and of the
    plain versions of K1, K2, K5 and K7: a path whose norms, attention and
    rope run on the kernels makes none (``calls`` empty)."""
    WATCHED = (("paddle_tpu_torch.ops.attention", "eager_attention"),
               ("paddle_tpu_torch.ops.cuda.norms", "rms_norm_plain"),
               ("paddle_tpu_torch.ops.cuda.flash_attention",
                "flash_attention_fwd_plain"),
               ("paddle_tpu_torch.ops.cuda.flash_attention",
                "flash_attention_bwd_plain"),
               ("paddle_tpu_torch.ops.cuda.rope", "fused_rope_plain"))

    def __enter__(self):
        import importlib
        self.calls, self.saved = {}, []
        for mod_name, name in self.WATCHED:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))

            def counted(*a, _orig=orig, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _orig(*a, **kw)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def fp32_copy(torch, model, layers=None):
    """The same weights in float32 (the check's reference model); a
    weight-only quantized projection gives its dequantized weight, the
    function the quantized model serves. ``layers``: the first that many
    layers only."""
    cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    m32 = type(model)(cfg, device=model.device)
    with torch.no_grad():
        for name, p32 in m32.named_parameters():
            src = model
            for part in name.split("."):
                src = getattr(src, part)
            p32.copy_(src if isinstance(src, torch.Tensor)
                      else src.dequantize(torch.float32))
    return m32


def _rms(x):
    return float(x.float().square().mean().sqrt())


def phase_check(torch, model, reqs, label="check", rel=CHECK_REL,
                twice=False):
    """Prefill, chunk and decode logits of served prompts: bf16 through the
    kernels, bf16 through the plain versions, and float32 through the
    plain versions as the reference. Tolerance: with random weights,
    bf16 rounding after every op of 32 layers moves the logits by a few
    percent of their range whichever way the rounding is done, so the
    kernel path is held to the plain bf16 path's own distance from the
    float32 result: RMS(kernel - fp32) <= 2 * RMS(plain - fp32). A fault
    shared by both bf16 paths would pass that test, so each is also held
    to an absolute limit: RMS(path - fp32) <= CHECK_REL * RMS(fp32)
    (sound runs read about 6% of the logits' RMS; ``rel`` is the limit).
    ``twice``: the kernel path is run a second time from fresh caches and
    must give the same bits (no atomics anywhere on the path). Returns
    (the kernel path's logit blocks, the float32 ones)."""
    prompts, long_prompt, toks = _check_inputs(reqs)
    with torch.no_grad():
        got = _path_logits(torch, model, prompts, long_prompt, toks)
        if twice:
            again = _path_logits(torch, model, prompts, long_prompt, toks)
            for name, a, b in zip(("prefill", "chunk", "decode"), got, again):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{name}: two runs of the kernel path differ in "
                        f"{int((a != b).sum())} of {a.numel()} logits")
            log(f"[{label}] prefill, chunk and decode logits of two runs "
                f"are bit-identical")
            del again
        with plain_kernels():
            ref = _path_logits(torch, model, prompts, long_prompt, toks)
            m32 = fp32_copy(torch, model)
            ref32 = _path_logits(torch, m32, prompts, long_prompt, toks)
            del m32
    torch.cuda.empty_cache()
    _hold_logits(label, ("prefill", "chunk", "decode"), got, ref, ref32, rel)
    return got, ref32


def _check_inputs(reqs):
    """The check's prompts (the six short ones), its chunked prompt and
    every row's served first token."""
    return ([list(r.prompt) for r in reqs[:6]], list(reqs[6].prompt),
            [r.tokens[0] for r in reqs[:7]])


def phase_quant_check(torch, model, reqs, got_bf16, ref32, weights):
    """The check's three logit blocks over an int8 KV pool, through the
    kernels (K3/K4's int8 modes) and through the plain versions, held by
    the check's rule (limit CHECK_REL) against a float32 run of the
    weights the model serves: with ``weights="bf16"`` the unquantized
    model's ``ref32``; with "int8" the dequantized int8 weights in
    float32 (the weights' rounding is the quantization's, not the path's:
    with random weights it moves the prefill logits ~0.18 of their RMS
    from ``ref32``, the path's bf16 rounding ~0.06). That reference
    shares any fault of the quantizer, so with "int8" the kernel path is
    also held to ``ref32`` at QUANT_WEIGHT_REL of its RMS. Reported: the
    logit MSE and greedy match against the bf16 model's kernel-path
    logits ``got_bf16``."""
    from paddle_tpu_torch.serving.quant import quant_quality
    prompts, long_prompt, toks = _check_inputs(reqs)
    with torch.no_grad():
        got = _path_logits(torch, model, prompts, long_prompt, toks, "int8")
        with plain_kernels():
            ref = _path_logits(torch, model, prompts, long_prompt, toks,
                               "int8")
            hold = ref32
            if weights != "bf16":
                m32 = fp32_copy(torch, model)
                hold = _path_logits(torch, m32, prompts, long_prompt, toks)
                del m32
    torch.cuda.empty_cache()
    names = ("prefill", "chunk", "decode")
    label = f"quant_check {weights} weights, int8 KV"
    far = []
    for name, q, b, f in zip(names, got, got_bf16, ref32):
        r = quant_quality(b, q)
        d = _rms(q - f) / _rms(f)
        log(f"[{label}] {name}: RMS kernel-unquantized fp32 {d:.4f} of "
            f"RMS (limit {QUANT_WEIGHT_REL if weights != 'bf16' else '-'})"
            f"; logit MSE {r['logit_mse']:.6f}, greedy match "
            f"{r['greedy_match_rate']:.3f} against the bf16 model (report)")
        if weights != "bf16" and not d <= QUANT_WEIGHT_REL:
            far.append(f"{name} {d:.4f}")
    _hold_logits(label, names, got, ref, hold, CHECK_REL)
    if far:
        raise AssertionError(
            f"{label}: kernel path over {QUANT_WEIGHT_REL} of the RMS from "
            f"the unquantized fp32 logits: {', '.join(far)}")


def _hold_logits(label, names, got, ref, ref32, rel):
    """The check's rule on each logit block: finite and of the float32
    block's shape, each bf16 path within ``rel`` of the float32 RMS, and
    the kernel path no further from float32 than twice the plain path."""
    import torch
    for name, a, r, f in zip(names, got, ref, ref32):
        if tuple(a.shape) != tuple(f.shape) or not bool(
                torch.isfinite(a).all()):
            raise AssertionError(f"{name} logits: shape {list(a.shape)} "
                                 f"or not finite")
        e_k, e_p, e_kp = _rms(a - f), _rms(r - f), _rms(a - r)
        rms_f = _rms(f)
        agree = float((a.argmax(-1) == f.argmax(-1)).float().mean())
        agree_p = float((r.argmax(-1) == f.argmax(-1)).float().mean())
        log(f"[{label}] {name} logits {list(a.shape)} (RMS {rms_f:.4f}): "
            f"RMS kernel-fp32 {e_k:.5f} ({e_k / rms_f:.4f} of RMS), "
            f"plain-fp32 {e_p:.5f} ({e_p / rms_f:.4f} of RMS), "
            f"kernel-plain {e_kp:.5f}; argmax vs fp32: kernel {agree:.3f}, "
            f"plain {agree_p:.3f} (limit {rel} of RMS)")
        for path, e in (("kernel", e_k), ("plain", e_p)):
            if not e <= rel * rms_f:
                raise AssertionError(
                    f"{name}: {path} bf16 path is {e} from the fp32 "
                    f"result, over {rel} * RMS {rms_f}")
        if not e_k <= 2 * e_p:
            raise AssertionError(f"{name}: kernel path is further from the "
                                 f"fp32 result than 2x the plain bf16 path: "
                                 f"{e_k} > 2 * {e_p}")


# ------------------------------------------------------- sliding window
def build_mistral(torch, dev):
    """``MistralConfig.mistral_7b()`` exactly as the repo defines it (32
    layers, hidden 4096, intermediate 14336, 32 heads, 8 KV heads, vocab
    32000, rope theta 1e6, window 4096, bf16), random weights from seed 0
    made on the card."""
    from paddle_tpu_torch.models.mistral import (MistralConfig,
                                                 MistralForCausalLM)
    tm = time.monotonic()
    model = MistralForCausalLM(MistralConfig.mistral_7b(), device=dev, seed=0)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"[window_serve] mistral_7b, {model.cfg.num_hidden_layers} layers, "
        f"window {model.cfg.sliding_window}, {nparams / 1e9:.3f} B params, "
        f"random weights in {time.monotonic() - tm:.1f} s")
    return model


def phase_window_serve(torch, dev, model, np):
    """Six greedy requests at once into 4 slots: four prompts past the
    4096-token window (WIN_LONG) and two short ones, 48 new tokens each.
    The window bites in the prefill (K2 windowed at S = 4608) and in every
    decode step of the long rows (K4 windowed); right after its prefill a
    long row has recycled (prompt - 4096) // 16 blocks and no row ever
    holds more than blocks_needed(4096 + 2 * 16) = 258. Every request must
    finish, ``assert_quiescent()`` pass and every kernel of the path
    launch. Returns (launch counts, the requests)."""
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    vocab = model.cfg.vocab_size
    kw = dict(num_slots=WIN_SLOTS, block_size=WIN_BS,
              max_prompt_len=WIN_PROMPT, max_seq_len=WIN_SEQ,
              num_blocks=WIN_BLOCKS, seed=0, device=dev)
    # warm-up on a throwaway engine (the prefill forward has one shape)
    warm = LLMEngine(model, **kw)
    warm.add_request(Request(np.random.RandomState(1).randint(3, vocab, 64),
                             max_new_tokens=4))
    warm.run()
    del warm
    eng = LLMEngine(model, **kw)
    if hasattr(eng.exe, "tick_log"):
        eng.exe.tick_log = []
    rs = np.random.RandomState(0)
    reqs = [Request(rs.randint(3, vocab, size=n), max_new_tokens=WIN_NEW)
            for n in WIN_LONG + WIN_SHORT]
    bound_live = eng.mgr.blocks_needed(model.cfg.sliding_window + 2 * WIN_BS)
    peak_live, holes = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.monotonic()
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
        for slot in np.nonzero(eng.active)[0]:
            rid = int(eng.slot_req[slot])
            peak_live[rid] = max(peak_live.get(rid, 0),
                                 eng.kv.live_blocks(rid))
            # the first tick a row is seen active is right after its prefill
            holes.setdefault(rid, sum(b is None for b in eng.mgr.tables[rid]))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = K.launches()
    for r in reqs:
        if not r.done or r.finish_reason not in ("length", "eos"):
            raise AssertionError(f"request {r.req_id} did not finish: "
                                 f"{r.finish_reason}")
    eng.assert_quiescent()
    missing = _missing("window_serve", counts)
    if missing:
        raise AssertionError(f"kernels not launched on the window_serve "
                             f"path: {missing} ({counts})")
    for r in reqs:
        p = len(r.prompt)
        want = max(0, p - model.cfg.sliding_window) // WIN_BS
        log(f"[window_serve] prompt {p}: {holes[r.req_id]} blocks recycled "
            f"right after prefill (expected {want}), peak live "
            f"{peak_live[r.req_id]} (limit {bound_live})")
        if holes[r.req_id] != want or peak_live[r.req_id] > bound_live:
            raise AssertionError(f"window recycling: prompt {p} recycled "
                                 f"{holes[r.req_id]} blocks after prefill, "
                                 f"held up to {peak_live[r.req_id]}")
    ntok = sum(len(r.tokens) for r in reqs)
    ttft = [r._first_tok_t - r._submit_t for r in reqs]
    peak = torch.cuda.max_memory_allocated()
    card = card_line()
    log(f"[window_serve] {len(reqs)} requests ({sum(len(r.prompt) for r in reqs)}"
        f" prompt tokens), {ntok} tokens in {wall:.3f} s: "
        f"{ntok / wall:.1f} tokens/s, {eng.stats['ticks']} decode ticks "
        f"({card})")
    log(f"[window_serve] mean TTFT {1e3 * sum(ttft) / len(ttft):.1f} ms, "
        f"max {1e3 * max(ttft):.1f} ms ({card})")
    log(f"[window_serve] peak allocated {peak / 2**30:.2f} GiB ({card}); "
        f"launches {counts}")
    _log_ticks(torch, "window_serve", eng.exe, card)
    _check_tick_graphs("window_serve", eng.exe, model)
    return counts, reqs


def _window_logits(torch, model, prompt, tok):
    """The whole-prompt prefill (K2 windowed) of one long prompt and one
    decode step (K4 windowed) feeding it ``tok``: both logit blocks."""
    import numpy as np
    from paddle_tpu_torch.models import paged as P
    cfg, dev = model.cfg, model.device
    n = len(prompt)
    nb = -(-(n + 1) // WIN_BS)
    cache = P.PagedKVCache.init(cfg.num_hidden_layers, nb, WIN_BS,
                                cfg.num_key_value_heads,
                                cfg.hidden_size // cfg.num_attention_heads,
                                1, nb, cfg.dtype, device=dev)
    pre, _ = P.llama_prefill_paged(
        model, torch.as_tensor([list(prompt)], device=dev),
        np.array([n], np.int32), cache, slot_ids=np.array([0], np.int32),
        table_rows=np.arange(nb, dtype=np.int32)[None])
    dec, _ = P.llama_decode_step_paged(
        model, torch.as_tensor([tok], device=dev), cache,
        torch.ones(1, dtype=torch.bool, device=dev))
    return pre.float(), dec.float()


def phase_window_check(torch, model, reqs):
    """The 4600-token served row through prefill and one decode step (its
    served first token): bf16 through the kernels, bf16 through the plain
    versions, float32 through the plain versions, under the check's rule
    with the limit CHECK_REL."""
    r = max(reqs, key=lambda q: len(q.prompt))
    with torch.no_grad():
        got = _window_logits(torch, model, r.prompt, r.tokens[0])
        with plain_kernels():
            ref = _window_logits(torch, model, r.prompt, r.tokens[0])
            m32 = fp32_copy(torch, model)
            ref32 = _window_logits(torch, m32, r.prompt, r.tokens[0])
            del m32
    torch.cuda.empty_cache()
    log(f"[window_check] one {len(r.prompt)}-token row, window "
        f"{model.cfg.sliding_window} ({card_line()})")
    _hold_logits("window_check", ("prefill", "decode"), got, ref, ref32,
                 CHECK_REL)


# ------------------------------------------------------------------ train
def train_config():
    """``bench.py`` ``main()``'s on-chip configuration, taken as it is."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5504, num_hidden_layers=12,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048, dtype=torch.bfloat16,
                       remat=False)


def train_batch(torch, dev, np, cfg, batch=4, seq=2048):
    """Ids from np.random.RandomState(0); labels shifted by one, -100 last."""
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq))
    labels = np.concatenate([ids[:, 1:], np.full((batch, 1), -100)], axis=1)
    return (torch.as_tensor(ids, device=dev),
            torch.as_tensor(labels, device=dev))


GRAD_NAMES = ("model.layers.0.self_attn.qkv_proj",
              "model.layers.11.mlp.down_proj", "lm_head")


def _loss_and_grads(model, ids, labels, names):
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    loss = model.loss(ids, labels)
    loss.backward()
    grads = {n: params[n].grad.float().clone() for n in names}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_train_check(torch, model, ids, labels, names=GRAD_NAMES,
                      rel=GRAD_REL, label="check"):
    """The loss and the gradients of three weights (``names``; the Llama
    step's: first layer's qkv, last layer's down projection, lm_head; the
    MoE step's: an expert up-projection stack, an expert down-projection
    stack and a router) on batch row 0 (1 x 2048): in
    bf16 through the kernels, in bf16 through the plain versions (autograd
    through plain PyTorch, the kernels' backward not involved) and in
    float32 through the plain versions. As in the serving check, the
    kernel path must be no further from float32 than twice the plain bf16
    path, RMS(kernel - fp32) <= 2 * RMS(plain - fp32), and each bf16 path
    within ``rel`` of the float32 gradient's RMS (LOSS_REL of the loss)."""
    ids, labels = ids[:1], labels[:1]
    got = _loss_and_grads(model, ids, labels, names)
    with plain_kernels():
        ref = _loss_and_grads(model, ids, labels, names)
        m32 = fp32_copy(torch, model)
        ref32 = _loss_and_grads(m32, ids, labels, names)
        del m32
    torch.cuda.empty_cache()
    card = card_line()
    (lk, gk), (lp, gp), (lf, gf) = got, ref, ref32
    log(f"[{label}] train loss on 1 x {ids.shape[1]}: kernel {lk:.6f}, plain "
        f"bf16 {lp:.6f}, fp32 {lf:.6f} (limit {LOSS_REL} of the fp32 loss; "
        f"{card})")
    for path, lx in (("kernel", lk), ("plain", lp)):
        if not (abs(lx - lf) <= LOSS_REL * abs(lf)):
            raise AssertionError(f"train loss: {path} bf16 path {lx} vs "
                                 f"fp32 {lf}")
    for n in names:
        a, r, f = gk[n], gp[n], gf[n]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"grad {n}: not finite")
        e_k, e_p, rms_f = _rms(a - f), _rms(r - f), _rms(f)
        log(f"[{label}] grad {n} {list(a.shape)} (RMS {rms_f:.4e}): RMS "
            f"kernel-fp32 {e_k:.4e} ({e_k / rms_f:.4f} of RMS), plain-fp32 "
            f"{e_p:.4e} ({e_p / rms_f:.4f} of RMS) (limit {rel})")
        for path, e in (("kernel", e_k), ("plain", e_p)):
            if not e <= rel * rms_f:
                raise AssertionError(f"grad {n}: {path} bf16 path is {e} "
                                     f"from fp32, over {rel} * {rms_f}")
        if not e_k <= 2 * e_p:
            raise AssertionError(f"grad {n}: kernel path {e_k} > 2 x the "
                                 f"plain bf16 path {e_p}")


def phase_train(torch, dev, np, check, anatomy=False):
    """The headline train step (``bench.py``'s Llama 0.74B at 4 x 2048):
    returns the launch counts."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               num_flops_per_token)
    cfg = train_config()
    tm = time.monotonic()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    ids, labels = train_batch(torch, dev, np, cfg)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"[train] {nparams / 1e9:.3f} B params, random weights in "
        f"{time.monotonic() - tm:.1f} s")
    return run_train(torch, np, "train", model, ids, labels, check, anatomy,
                     GRAD_NAMES, GRAD_REL,
                     num_flops_per_token(cfg, ids.shape[1]))


def qwen_moe_config(layers=24):
    """``Qwen/Qwen1.5-MoE-A2.7B``'s published ``config.json``, field by
    field: vocab 151 936, hidden 2048, 24 layers, 16 heads and 16 KV heads
    of 128, biased QKV, rope theta 1e6, eps 1e-6, 60 routed experts of 1408
    top-4 without renormalisation, a shared expert of 5632, every layer
    sparse (14.3 B parameters, 2.7 B activated). ``layers`` cuts depth only."""
    import torch
    from paddle_tpu_torch.models.qwen2_moe import Qwen2MoeConfig
    return Qwen2MoeConfig(
        vocab_size=151936, hidden_size=MOE_HIDDEN, intermediate_size=5632,
        num_hidden_layers=layers, num_attention_heads=MOE_HEADS,
        num_key_value_heads=MOE_HEADS, max_position_embeddings=8192,
        rms_norm_eps=1e-6, rope_theta=1e6, attention_bias=True,
        num_experts=MOE_EXPERTS, num_experts_per_tok=MOE_TOPK,
        moe_intermediate_size=MOE_INTER,
        shared_expert_intermediate_size=5632, norm_topk_prob=False,
        decoder_sparse_step=1, mlp_only_layers=(),
        router_aux_loss_coef=0.001, dtype=torch.bfloat16, remat=False)


def build_moe_model(torch, dev, layers, label):
    """Qwen1.5-MoE-A2.7B's widths at ``layers`` layers, random weights from
    seed 0 made on the card."""
    from paddle_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
    tm = time.monotonic()
    model = Qwen2MoeForCausalLM(qwen_moe_config(layers), device=dev, seed=0)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"[{label}] Qwen1.5-MoE-A2.7B width, {layers} layers, "
        f"{nparams / 1e9:.3f} B params, random weights in "
        f"{time.monotonic() - tm:.1f} s")
    return model


def phase_moe_train(torch, dev, np, check, anatomy=False):
    """The MoE train step: Qwen1.5-MoE-A2.7B's widths at MOE_TRAIN_LAYERS
    layers, batch 2 x 2048, the headline step's AdamW settings; with
    ``check`` the loss and three gradients (first layer's expert gate_up
    stack, last layer's expert down stack, the first router) on one row
    against the plain versions and float32. Returns the launch counts."""
    model = build_moe_model(torch, dev, MOE_TRAIN_LAYERS, "moe_train")
    cfg = model.cfg
    ids, labels = train_batch(torch, dev, np, cfg, batch=MOE_TRAIN_SHAPE[0],
                              seq=MOE_TRAIN_SHAPE[1])
    last = cfg.num_hidden_layers - 1
    names = ("layers.0.mlp.moe.experts.gate_up",
             f"layers.{last}.mlp.moe.experts.down", "layers.0.mlp.moe.gate_w")
    counts = run_train(torch, np, "moe_train", model, ids, labels, check,
                       anatomy, names, MOE_GRAD_REL)
    # per step: 2 products per layer forward, 2 dlhs and 2 drhs backward,
    # every drhs (bf16, aligned) on K6b's tensor-core kernel where the
    # tree counts its kernels apart
    steps, layers = 10, cfg.num_hidden_layers
    want = {"grouped_fwd": 4 * layers * steps,
            "grouped_dw": 2 * layers * steps}
    if "grouped_dw.wgmma" in counts:
        want["grouped_dw.wgmma"] = want["grouped_dw"]
    got = {k: counts.get(k) for k in want}
    if got != want:
        raise AssertionError(f"moe_train launches {got}, expected {want}")
    return counts


def run_train(torch, np, path, model, ids, labels, check, anatomy,
              grad_names, grad_rel, flops_per_token=None):
    """2 warm-up and 8 timed steps of ``model`` on one fixed batch through
    make_train_step + AdamW(3e-4, weight decay 0.1, global-norm clip 1.0,
    fp32 master weights); every loss finite, the last below the first, and
    every kernel of ``PATHS[path]`` launched. With ``check`` the train
    check first; ``anatomy``: then 2 more steps timed and 2 under
    torch.profiler. MFU only where ``flops_per_token`` is given (the
    model's own count). Returns the launch counts."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    if check:
        # "check" / "moe_check" as before, "<path>_check" for later paths
        label = {"train": "check", "moe_train": "moe_check"}.get(
            path, f"{path}_check")
        phase_train_check(torch, model, ids, labels, grad_names, grad_rel,
                          label)
    opt = O.AdamW(learning_rate=3e-4, weight_decay=0.1,
                  grad_clip=O.ClipGradByGlobalNorm(1.0), multi_precision=True)
    state = init_state(model, opt)
    step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses = []
    for _ in range(2):
        state, loss = step(state, ids, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    n_steps = 8
    t0 = time.monotonic()
    for _ in range(n_steps):
        state, loss = step(state, ids, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.monotonic() - t0) / n_steps
    counts = K.launches()
    # "<name>.<kernel>": launches of each kernel of a wrapper that counts
    # them apart (a tree without such counts has none)
    counts.update({f"{name}.{kernel}": n for name, per in
                   getattr(K, "route_launches", dict)().items()
                   for kernel, n in per.items()})
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    if path == "train":
        TRAIN_RECORD.update(losses=losses, ms=1e3 * step_s, counts=counts,
                            steps=len(losses))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path} losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{path} loss did not fall: {losses}")
    missing = _missing(path, counts)
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing} ({counts})")
    b, s = ids.shape
    tok_s = b * s / step_s
    mfu = ("" if flops_per_token is None else
           f"MFU {100 * flops_per_token * tok_s / PEAK_BF16_FLOPS:.2f}% of "
           f"989 TFLOP/s, ")
    card = card_line()
    log(f"[{path}] losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"[{path}] batch {b} x {s}: {1e3 * step_s:.1f} ms/step, "
        f"{tok_s:.0f} tokens/s, {mfu}peak "
        f"allocated {peak / 2**30:.2f} GiB ({card})")
    log(f"[{path}] launches over {len(losses)} steps: {counts}")
    if anatomy:
        def steps():
            nonlocal state
            for _ in range(2):
                state, _ = step(state, ids, labels)
        _anatomy(torch, f"{path} step, batch {b} x {s}", "step", steps, 2)
    del state, model
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------ the mesh train paths
@contextlib.contextmanager
def nccl_world(torch):
    """A world of this one rank on the card: ``init_parallel_env`` with
    NCCL, the rendezvous through a FileStore in a temporary directory (no
    TCP port); the group is destroyed on the way out."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed.mesh import forget_groups
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        if not init_parallel_env(init_method=f"file://{tmp}/store",
                                 world_size=1, rank=0):
            raise AssertionError("init_parallel_env joined no group")
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"the card's world runs {backend}, not nccl")
        one = torch.ones((), device="cuda")
        dist.all_reduce(one)
        if float(one) != 1.0:
            raise AssertionError(f"NCCL all_reduce of one rank gave {one}")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        forget_groups()
        shutil.rmtree(tmp, ignore_errors=True)


def _timed_steps(torch, n, run):
    """(results of ``run()`` n times, ms/step over all but the first)."""
    out, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out.append(run())
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    return out, 1e3 * sum(times[1:]) / max(len(times) - 1, 1)


def _per_step_same(path, counts, steps):
    """Each of the path's kernels launched as often a step as in the train
    phase's unsharded steps."""
    ref, n = TRAIN_RECORD["counts"], TRAIN_RECORD["steps"]
    diff = {k: (counts.get(k, 0), ref.get(k, 0) * steps / n)
            for k in PATHS[path]
            if counts.get(k, 0) * n != ref.get(k, 0) * steps}
    if diff:
        raise AssertionError(f"{path}: launches per step differ from the "
                             f"unsharded step's: {diff}")


def phase_dist_train(torch, dev, np):
    """make_train_step over a HybridMesh of one rank (NCCL): the train
    phase's model, seed, batch and AdamW; its losses equal the unsharded
    step's. Returns the launch counts of its steps."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg = train_config()
    ids, labels = train_batch(torch, dev, np, cfg)
    with nccl_world(torch):
        mesh = D.HybridMesh()
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        opt = _adamw(O)
        state = init_state(model, opt, mesh)
        step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt,
                               mesh=mesh)
        torch.cuda.synchronize()
        K.reset_launches()
        holder = [state]

        def one():
            holder[0], loss = step(holder[0], ids, labels)
            return loss
        losses, ms = _timed_steps(torch, DIST_STEPS, one)
        counts = K.launches()
        del holder, state, model, step
    torch.cuda.empty_cache()
    losses = [float(x) for x in losses]
    ref = TRAIN_RECORD["losses"][:DIST_STEPS]
    card = card_line()
    log(f"[dist_train] {mesh!r} over NCCL: losses "
        f"{' '.join(f'{x:.6f}' for x in losses)}; the train phase's first "
        f"{DIST_STEPS}: {' '.join(f'{x:.6f}' for x in ref)}; bit-identical: "
        f"{losses == ref}")
    log(f"[dist_train] batch {ids.shape[0]} x {ids.shape[1]}: {ms:.1f} "
        f"ms/step over steps 2-{DIST_STEPS} against train's "
        f"{TRAIN_RECORD['ms']:.1f} ({card})")
    log(f"[dist_train] launches over {DIST_STEPS} steps: {counts}")
    if losses != ref:
        raise AssertionError(f"dist_train losses {losses} differ from the "
                             f"unsharded step's {ref}")
    missing = _missing("dist_train", counts)
    if missing:
        raise AssertionError(f"kernels not launched on dist_train: {missing}")
    _per_step_same("dist_train", counts, DIST_STEPS)
    return counts


# ------------------------------------- sequence and expert parallelism
def _rel_rms(a, b):
    """RMS(a - b) / RMS(b)."""
    return _rms(a.float() - b.float()) / max(_rms(b), 1e-30)


def phase_sp_train(torch, dev, np):
    """ulysses_attention, ring_attention and zigzag_ring_attention over a
    one-rank sp group (NCCL) at the train phase's attention shape
    (TRAIN_SHAPE, bf16): output and dq / dk / dv of sum(o * dO) against
    the unsharded scaled_dot_product_attention (K2 forward, K5a / K5b
    backward). Ulysses's exchange is the identity at sp = 1, so its output
    and gradients must be the unsharded ones bit for bit; the ring's and
    the zigzag ring's block step is plain PyTorch (fp32 scores, bf16
    P @ V), held to them within SP_REL of their RMS. Returns the launch
    counts of the Ulysses run (K2, K5a and K5b once each)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import cuda as K
    q, k, v, do = _train_qkv(torch, dev, torch.bfloat16)

    def fwd_bwd(fn, grads=True):
        qs, ks, vs = (t.detach().clone().requires_grad_(grads)
                      for t in (q, k, v))
        o = fn(qs, ks, vs)
        if not grads:
            return (o,)
        o.backward(do)
        return o.detach(), qs.grad, ks.grad, vs.grad

    def sdpa(a, b, c):
        return A.scaled_dot_product_attention(a, b, c, is_causal=True)

    ref = fwd_bwd(sdpa)
    fns = {"ulysses": lambda a, b, c: D.ulysses_attention(a, b, c),
           "ring": lambda a, b, c: D.ring_attention(a, b, c),
           "zigzag": lambda a, b, c: D.zigzag_ring_attention(a, b, c)}
    card = card_line()
    with nccl_world(torch):
        with D.HybridMesh(sp=1) as mesh:
            torch.cuda.synchronize()
            K.reset_launches()
            got = {"ulysses": fwd_bwd(fns["ulysses"])}
            torch.cuda.synchronize()
            counts = K.launches()
            got["ring"] = fwd_bwd(fns["ring"])
            got["zigzag"] = fwd_bwd(fns["zigzag"])
            times = {"unsharded sdpa": sdpa, **fns}
            ms = {n: (time_ms(lambda f=f: fwd_bwd(f, False), iters=5,
                              warmup=1),
                      time_ms(lambda f=f: fwd_bwd(f), iters=5, warmup=1))
                  for n, f in times.items()}
    del mesh
    names = ("out", "dq", "dk", "dv")
    same = all(torch.equal(a, b) for a, b in zip(got["ulysses"], ref))
    log(f"[sp_train] ulysses at sp=1, q/k/v {list(TRAIN_SHAPE)} bf16: "
        f"output and dq/dk/dv bit-identical to the unsharded sdpa: {same}")
    if not same:
        raise AssertionError("sp_train: ulysses at sp = 1 differs from the "
                             "unsharded scaled_dot_product_attention")
    for mode in ("ring", "zigzag"):
        errs = {n: (_rel_rms(a, b), float((a.float() - b.float()).abs()
                                          .max()))
                for n, a, b in zip(names, got[mode], ref)}
        log(f"[sp_train] {mode} at sp=1 against the unsharded sdpa: "
            + ", ".join(f"{n} {r:.3e} of RMS (max abs {m:.3e})"
                        for n, (r, m) in errs.items())
            + f" (limit {SP_REL})")
        bad = {n: r for n, (r, _) in errs.items() if not r <= SP_REL}
        if bad:
            raise AssertionError(f"sp_train: {mode} off the unsharded "
                                 f"attention: {bad}")
    for n, (f_ms, fb_ms) in ms.items():
        log(f"[sp_train] {n}: forward {f_ms:.3f} ms, forward + backward "
            f"{fb_ms:.3f} ms ({card})")
    want = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    log(f"[sp_train] launches of the ulysses run: {counts}")
    if {n: counts.get(n, 0) for n in want} != want:
        raise AssertionError(f"sp_train launches {counts}, expected {want}")
    return counts


def _ep_k6_entries(torch, lhs, rhs, sizes):
    """K6a (forward) and K6b (drhs) at the shapes the ep path gives them —
    the compacted rows [m, k] of which the first sum(sizes) are live — held
    to their plain versions on the live rows and timed; the bounds count
    the live rows (this run's data), the weights of every expert."""
    from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
    m, k = lhs.shape
    e, _, n = rhs.shape
    es = lhs.element_size()
    live = int(sizes.sum())
    groups = int((sizes > 0).sum())
    err = _agree("grouped_fwd (ep_train compacted rows)", _hn(), _max_err(
        GM.grouped_fwd_cuda(lhs, rhs, sizes)[:live],
        GM.grouped_matmul_plain(lhs, rhs, sizes)[:live]))
    shape = (f"lhs [{m}, {k}] ({live} live rows) x rhs [{e}, {k}, {n}] "
             f"{_hn()}, {groups} of {e} groups live")
    b_ms, b_by = bound((live * k + live * n + groups * k * n) * es + 4 * e,
                       2 * live * k * n)
    fwd = dict(max_abs_err=err, variant=_k6_route(GM, m, e, k, n, lhs.dtype),
               ms=time_ms(lambda: GM.grouped_fwd_cuda(lhs, rhs, sizes),
                          iters=10),
               plain_ms=time_ms(lambda: GM.grouped_matmul_plain(
                   lhs, rhs, sizes), iters=3, warmup=1),
               library_ms=_library_grouped_mm(torch, lhs, rhs, sizes),
               bound_ms=b_ms, bound_by=b_by, shape=shape)
    g = torch.Generator(device=lhs.device).manual_seed(23)
    cot = torch.randn(m, n, generator=g, device=lhs.device).to(lhs.dtype)
    got, route = _k6b_ran(GM, lambda: GM.grouped_dw(lhs, cot, sizes))
    ref = GM.grouped_matmul_bwd_plain(lhs, rhs, sizes, cot)[1]
    err_w = _agree(f"grouped_dw (ep_train compacted rows, {route})", _hn(),
                   _max_err(got, ref))
    del got, ref
    dw = dict(max_abs_err=err_w, variant=route,
              ms=time_ms(lambda: GM.grouped_dw(lhs, cot, sizes), iters=10),
              plain_ms=time_ms(lambda: GM.grouped_matmul_bwd_plain(
                  lhs, rhs, sizes, cot), iters=3, warmup=1),
              library_ms=_library_grouped_mm(torch, lhs.t(), cot, sizes),
              bound_ms=b_ms, bound_by=b_by,
              shape=shape + " (plain: dlhs and drhs in one call)")
    return {"grouped_fwd": fwd, "grouped_dw": dw}


def phase_ep_train(torch, dev, np):
    """One MoE layer at moe_train's widths and tokens (Qwen1.5-MoE-A2.7B's
    2048 / 60 experts of 1408 / top-4, 2 x 2048 tokens, bf16, capacity
    factor EP_CAPACITY_FACTOR) through ``_forward_ep`` over a one-rank ep
    group (NCCL) against ``_forward_local``: output, aux, drop rate and
    every gradient of mean(y^2) + 0.01 aux (within EP_REL of the RMS; aux
    and drop rate equal). The compacted rows the ep path hands K6 are
    kept for the kernel entries. Returns (launch counts of the ep run,
    {kernel: entry})."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import moe as M
    from paddle_tpu_torch.models.llama import LlamaConfig, _Init
    from paddle_tpu_torch.ops import cuda as K
    cfg = LlamaConfig(hidden_size=MOE_HIDDEN, dtype=torch.bfloat16)
    layer = M.MoELayer(MOE_HIDDEN, MOE_INTER, MOE_EXPERTS, k=MOE_TOPK,
                       capacity_factor=EP_CAPACITY_FACTOR,
                       norm_topk_prob=False, init=_Init(cfg, dev, 0))
    b, s = MOE_TRAIN_SHAPE[:2]
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(b, s, MOE_HIDDEN, generator=g, device=dev).to(
        torch.bfloat16)

    def run(fn):
        layer.zero_grad(set_to_none=True)
        xs = x.detach().clone().requires_grad_()
        y, aux, drop = fn(xs)
        (y.float().square().mean() + 0.01 * aux).backward()
        grads = {n: p.grad.float() for n, p in layer.named_parameters()}
        grads["x"] = xs.grad.float()
        return y.detach(), float(aux.detach()), float(drop), grads

    ref = run(layer._forward_local)
    seen = {}
    orig = M.grouped_mlp_apply

    def spy(xs, gate_up, down, sizes):
        seen.setdefault("args", (xs.detach().clone(), gate_up.detach(),
                                 sizes.clone()))
        return orig(xs, gate_up, down, sizes)

    card = card_line()
    with nccl_world(torch):
        with D.HybridMesh(ep=1) as mesh:
            M.grouped_mlp_apply = spy
            try:
                torch.cuda.synchronize()
                K.reset_launches()
                got = run(lambda xs: layer._forward_ep(xs, mesh, 1))
                torch.cuda.synchronize()
                counts = K.launches()
            finally:
                M.grouped_mlp_apply = orig
            ms_ep = time_ms(lambda: run(lambda xs: layer._forward_ep(
                xs, mesh, 1)), iters=5, warmup=1)
    ms_local = time_ms(lambda: run(layer._forward_local), iters=5, warmup=1)
    (y_r, aux_r, drop_r, g_r), (y_g, aux_g, drop_g, g_g) = ref, got
    errs = {"y": _rel_rms(y_g, y_r),
            **{n: _rel_rms(g_g[n], g_r[n]) for n in g_r}}
    log(f"[ep_train] _forward_ep at ep=1 against _forward_local, tokens "
        f"{b} x {s}, {MOE_EXPERTS} experts top-{MOE_TOPK}, capacity factor "
        f"{EP_CAPACITY_FACTOR}: aux {aux_g:.6f} / {aux_r:.6f}, drop rate "
        f"{drop_g:.6f} / {drop_r:.6f}; RMS errors "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (limit {EP_REL})")
    log(f"[ep_train] forward + backward: ep {ms_ep:.3f} ms, local "
        f"{ms_local:.3f} ms ({card})")
    bad = {n: e for n, e in errs.items() if not e <= EP_REL}
    if bad or aux_g != aux_r or drop_g != drop_r:
        raise AssertionError(f"ep_train: _forward_ep off _forward_local: "
                             f"{bad}, aux {aux_g} / {aux_r}, drop {drop_g} "
                             f"/ {drop_r}")
    want = {"grouped_fwd": 4, "grouped_dw": 2}
    log(f"[ep_train] launches of the ep run: {counts}")
    if {n: counts.get(n, 0) for n in want} != want:
        raise AssertionError(f"ep_train launches {counts}, expected {want}")
    lhs, gate_up, sizes = seen["args"]
    del ref, got, layer
    torch.cuda.empty_cache()
    return counts, _ep_k6_entries(torch, lhs, gate_up, sizes)


def _pp_named(grads):
    """GRAD_NAMES' gradients out of a pipeline's PpParams."""
    last = train_config().num_hidden_layers - 1
    return {GRAD_NAMES[0]: grads["layers"]["self_attn.qkv_proj"][0],
            GRAD_NAMES[1]: grads["layers"]["mlp.down_proj"][last],
            GRAD_NAMES[2]: grads["lm_head"]}


# pp_train's timed arms, in order; with pp_anatomy also PP_ORDER_ARM:
# 1f1b again after zb1 shows whether a gap between the two schedules (the
# same work at pp = 1) is the order's
PP_ARMS = (("1f1b", "1f1b"), ("zb1", "zb1"))
PP_ORDER_ARM = ("1f1b again", "1f1b")


def phase_pp_train(torch, dev, np, anatomy=False):
    """make_llama_pp_train_step at pp = 1 (NCCL, one rank), 1f1b and zb1:
    loss and gradients against the unsharded step's, zb1 against 1f1b bit
    for bit, then PP_STEPS AdamW steps in each of PP_ARMS; ``anatomy``:
    PP_ORDER_ARM too, then 2 unsharded train steps and 2 1f1b steps
    profiled. Returns the launch counts of the timed arms' steps."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               init_llama_pp_state,
                                               llama_pipeline_train_step,
                                               make_llama_pp_train_step)
    from paddle_tpu_torch.ops import cuda as K
    cfg = train_config()
    ids, labels = train_batch(torch, dev, np, cfg)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    loss = model.loss(ids, labels)
    loss.backward()
    ref_loss = float(loss.detach())
    ref = {n: params[n].grad.float().clone() for n in GRAD_NAMES}
    model.zero_grad(set_to_none=True)
    del loss, params
    card = card_line()
    arms = PP_ARMS + ((PP_ORDER_ARM,) if anatomy else ())
    got, losses, ms = {}, {}, {}
    with nccl_world(torch):
        mesh = D.HybridMesh(pp=1)
        for sched in ("1f1b", "zb1"):
            lo, grads = llama_pipeline_train_step(
                model, mesh, ids, labels, PP_MICROBATCHES, schedule=sched)
            got[sched] = (float(lo), grads)
        torch.cuda.empty_cache()
        K.reset_launches()
        for arm, sched in arms:
            st = init_llama_pp_state(model, _adamw(O), mesh)
            step = make_llama_pp_train_step(model, mesh, _adamw(O),
                                            PP_MICROBATCHES, schedule=sched)
            holder = list(st)

            def one():
                holder[0], holder[1], lo = step(holder[0], holder[1], ids,
                                                labels)
                return lo
            run, ms[arm] = _timed_steps(torch, PP_STEPS, one)
            losses[arm] = [float(x) for x in run]
            del holder, st, step
            torch.cuda.empty_cache()
        counts = K.launches()
        if anatomy:
            _pp_anatomy(torch, O, model, mesh, ids, labels)
    (l1, g1), (lz, gz) = got["1f1b"], got["zb1"]
    log(f"[pp_train] pp=1, {PP_MICROBATCHES} microbatches of 1 x "
        f"{ids.shape[1]}: loss 1f1b {l1:.6f}, zb1 {lz:.6f}, unsharded "
        f"{ref_loss:.6f} (limit {LOSS_REL} of it; {card})")
    bad = []
    if not abs(l1 - ref_loss) <= LOSS_REL * abs(ref_loss):
        bad.append(f"loss {l1} vs {ref_loss}")
    for n, a in _pp_named(g1).items():
        e, rms = _rms(a.float() - ref[n]), _rms(ref[n])
        log(f"[pp_train] grad {n} {list(a.shape)}: RMS pipeline-unsharded "
            f"{e:.4e} ({e / rms:.4f} of RMS {rms:.4e}; limit {GRAD_REL})")
        if not (bool(torch.isfinite(a).all()) and e <= GRAD_REL * rms):
            bad.append(f"grad {n}")
    same = (l1 == lz and all(
        torch.equal(a, b) for a, b in zip(g1.flat().values(),
                                          gz.flat().values())))
    log(f"[pp_train] zb1 loss and every gradient bit-identical to 1f1b: "
        f"{same}")
    if not same:
        bad.append("zb1 differs from 1f1b")
    for arm, _ in arms:
        log(f"[pp_train] {arm}: losses "
            f"{' '.join(f'{x:.6f}' for x in losses[arm])}; {ms[arm]:.1f} "
            f"ms/step over steps 2-{PP_STEPS} against train's "
            f"{TRAIN_RECORD['ms']:.1f} ({card})")
    if any(losses[arm] != losses["1f1b"] for arm, _ in arms):
        bad.append("the arms' training losses differ")
    if not all(np.isfinite(losses["1f1b"])) or not (
            losses["1f1b"][-1] < losses["1f1b"][0]):
        bad.append(f"losses {losses['1f1b']} not finite and falling")
    log(f"[pp_train] launches over {len(arms)} x {PP_STEPS} steps: "
        f"{counts}")
    missing = _missing("pp_train", counts)
    if missing:
        bad.append(f"kernels not launched: {missing}")
    del model, got, g1, gz
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"pp_train: {bad}")
    return counts


def _pp_anatomy(torch, O, model, mesh, ids, labels):
    """2 unsharded train steps and 2 pp = 1 1f1b steps of the same model
    and batch under the anatomy's profilers, one after the other."""
    from paddle_tpu_torch.models.llama import (init_llama_pp_state,
                                               make_llama_pp_train_step)
    from paddle_tpu_torch.train import init_state, make_train_step
    b, s = ids.shape
    opt = _adamw(O)
    holder = [init_state(model, opt)]
    step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt)

    def train_steps():
        for _ in range(2):
            holder[0], _ = step(holder[0], ids, labels)
    _anatomy(torch, f"train step (unsharded), batch {b} x {s}", "step",
             train_steps, 2)
    del holder[:], step
    torch.cuda.empty_cache()
    pp = list(init_llama_pp_state(model, _adamw(O), mesh))
    pp_step = make_llama_pp_train_step(model, mesh, _adamw(O),
                                       PP_MICROBATCHES)

    def pp_steps():
        for _ in range(2):
            pp[0], pp[1], _ = pp_step(pp[0], pp[1], ids, labels)
    _anatomy(torch, f"pp_train 1f1b step, {PP_MICROBATCHES} microbatches "
             f"of 1 x {s}", "step", pp_steps, 2)
    del pp, pp_step
    torch.cuda.empty_cache()


# ------------------------------------------- BLOOM / Falcon (ALiBi, MQA)
def falcon_rw_1b_config(torch):
    """``tiiuae/falcon-rw-1b``'s ``config.json``, field by field: vocab
    50 304, hidden 2048, 24 layers, 32 heads of 64, one K/V head per
    head (``multi_query`` false), sequential block, biases, ALiBi, LayerNorm
    eps 1e-5 (1.31 B parameters)."""
    from paddle_tpu_torch.models.falcon import FalconConfig
    return FalconConfig(vocab_size=50304, hidden_size=2048,
                        num_hidden_layers=24, num_attention_heads=32,
                        multi_query=False, parallel_attn=False, bias=True,
                        alibi=True, new_decoder_architecture=False,
                        layer_norm_epsilon=1e-5, dtype=torch.bfloat16)


def gemma_2b_config(torch):
    """``google/gemma-2b``'s ``config.json``, field by field: vocab 256 000,
    hidden 2048, MLP 16 384, 18 layers, 8 query heads of 256 over one KV
    head, RMSNorm eps 1e-6, rope theta 10 000, max positions 8192, tied
    head (2.51 B parameters); remat as ``GemmaConfig`` defaults it (on)."""
    from paddle_tpu_torch.models.gemma import GemmaConfig
    return GemmaConfig(vocab_size=256000, hidden_size=2048,
                       intermediate_size=16384, num_hidden_layers=18,
                       num_attention_heads=8, num_key_value_heads=1,
                       head_dim=256, max_position_embeddings=8192,
                       rms_norm_eps=1e-6, rope_theta=10000.0,
                       dtype=torch.bfloat16)


def pythia_6p9b_config(torch):
    """``EleutherAI/pythia-6.9b``'s ``config.json``, field by field: vocab
    50 432, hidden 4096, 32 layers, 32 heads of 128, MLP 16 384, rotary on
    25% of each head (32 lanes), base 10 000, parallel residual,
    LayerNorm eps 1e-5, untied head (6.86 B parameters)."""
    from paddle_tpu_torch.models.gpt_neox import GPTNeoXConfig
    return GPTNeoXConfig(vocab_size=50432, hidden_size=4096,
                         num_hidden_layers=32, num_attention_heads=32,
                         intermediate_size=16384, rotary_pct=0.25,
                         rotary_emb_base=10000.0,
                         max_position_embeddings=2048,
                         use_parallel_residual=True, layer_norm_eps=1e-5,
                         dtype=torch.bfloat16)


def opt_6p7b_config(torch):
    """``facebook/opt-6.7b``'s ``config.json``, field by field: vocab
    50 272, hidden 4096, 32 layers, 32 heads of 128, ffn 16 384, 2048
    positions (a table of 2050 rows), pre-norm, no projections, tied head
    (6.66 B parameters)."""
    from paddle_tpu_torch.models.opt import OPTConfig
    return OPTConfig(vocab_size=50272, hidden_size=4096, ffn_dim=16384,
                     num_hidden_layers=32, num_attention_heads=32,
                     max_position_embeddings=2048, do_layer_norm_before=True,
                     word_embed_proj_dim=4096, dtype=torch.bfloat16)


def _layers(model):
    """The decoder blocks of a generate family's model."""
    return model.h if hasattr(model, "h") else model.layers


def build_generate_model(torch, dev, family, layers=None, **overrides):
    """BLOOM-560m (``BloomConfig()`` as it stands: ``bigscience/bloom-560m``),
    Falcon-RW-1B, Falcon-7B (``FalconConfig()`` as it stands:
    ``tiiuae/falcon-7b``), Gemma-2B (``gemma_2b_config``), Gemma-7B
    (``GemmaConfig()`` as it stands: ``google/gemma-7b``), GPT-J-6B
    (``GPTJConfig()`` as it stands: ``EleutherAI/gpt-j-6b``), Pythia-6.9B
    (``pythia_6p9b_config``), OPT-6.7B (``opt_6p7b_config``), Phi-2
    (``PhiConfig()`` as it stands: ``microsoft/phi-2``) or GLM-4-9B
    (``GlmConfig()`` as it stands: ``THUDM/glm-4-9b``) whole in bf16
    (``layers`` cuts depth only; ``overrides``: other config fields),
    random weights from seed 0 made on the card."""
    from paddle_tpu_torch.models.bloom import BloomConfig, BloomForCausalLM
    from paddle_tpu_torch.models.falcon import FalconConfig, FalconForCausalLM
    tm = time.monotonic()
    if family == "bloom":
        cfg, cls = BloomConfig(), BloomForCausalLM
    elif family == "falcon_rw":
        cfg, cls = falcon_rw_1b_config(torch), FalconForCausalLM
    elif family in ("gemma2b", "gemma7b"):
        from paddle_tpu_torch.models.gemma import (GemmaConfig,
                                                   GemmaForCausalLM)
        cfg = gemma_2b_config(torch) if family == "gemma2b" else GemmaConfig()
        cls = GemmaForCausalLM
    elif family == "gptj":
        from paddle_tpu_torch.models.gptj import GPTJConfig, GPTJForCausalLM
        cfg, cls = GPTJConfig(), GPTJForCausalLM
    elif family == "neox":
        from paddle_tpu_torch.models.gpt_neox import GPTNeoXForCausalLM
        cfg, cls = pythia_6p9b_config(torch), GPTNeoXForCausalLM
    elif family == "opt":
        from paddle_tpu_torch.models.opt import OPTForCausalLM
        cfg, cls = opt_6p7b_config(torch), OPTForCausalLM
    elif family == "phi":
        from paddle_tpu_torch.models.phi import PhiConfig, PhiForCausalLM
        cfg, cls = PhiConfig(), PhiForCausalLM
    elif family == "glm":
        from paddle_tpu_torch.models.glm import GlmConfig, GlmForCausalLM
        cfg, cls = GlmConfig(), GlmForCausalLM
    else:
        cfg, cls = FalconConfig(), FalconForCausalLM
    if layers is not None:
        overrides["n_layer" if family in ("bloom", "gptj")
                  else "num_hidden_layers"] = layers
    cfg = dataclasses.replace(cfg, **overrides)
    model = cls(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"[{family}] {cls.__name__}, hidden "
        f"{getattr(cfg, 'hidden_size', getattr(cfg, 'n_embd', 0))}, "
        f"{len(_layers(model))} layers, {nparams / 1e9:.3f} B params, "
        f"random weights in {time.monotonic() - tm:.1f} s")
    return model


def generate_prompts(np, vocab):
    """GEN_ROWS prompts of GEN_PROMPT tokens from np.random.RandomState(0)."""
    return np.random.RandomState(0).randint(3, vocab, (GEN_ROWS, GEN_PROMPT))


def phase_generate(torch, dev, model, np, path):
    """``generic_generate`` of the GEN_ROWS prompts, GEN_NEW new tokens each,
    greedy: every step re-forwards the fixed [8, 160] buffer, so K2 runs
    once a layer and step, in its ALiBi mode for BLOOM and falcon-rw (the
    mode without ALiBi must not run there, and the ALiBi mode not on
    Falcon-7B, Gemma-7B or GPT-J-6B). The prompt must come back unchanged
    and every new token be in the vocabulary, and neither
    ``eager_attention`` nor a plain version of K2 or K7 may run. Tokens/s
    of wall time (one warm-up call first). Returns (launch counts, the
    prompts)."""
    from paddle_tpu_torch.models.decoding import generic_generate
    from paddle_tpu_torch.ops import cuda as K
    vocab = model.cfg.vocab_size
    prompts = generate_prompts(np, vocab)
    generic_generate(model, prompts, max_new_tokens=2)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with count_plain_calls() as plain:
        t0 = time.monotonic()
        out = generic_generate(model, prompts, max_new_tokens=GEN_NEW)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    counts = K.launches()
    if plain.calls:
        raise AssertionError(f"{path}: plain attention or rope ran on the "
                             f"path: {plain.calls}")
    out = out.cpu().numpy()
    if out.shape != (GEN_ROWS, GEN_PROMPT + GEN_NEW) or not (
            (out[:, :GEN_PROMPT] == prompts).all()
            and ((out[:, GEN_PROMPT:] >= 0) & (out[:, GEN_PROMPT:] < vocab))
            .all()):
        raise AssertionError(f"{path}: generic_generate returned a wrong "
                             f"buffer {out.shape}")
    missing = _missing(path, counts)
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing} ({counts})")
    mine, other = (("flash_fwd_alibi", "flash_fwd")
                   if path in ("bloom_serve", "falcon_rw_serve")
                   else ("flash_fwd", "flash_fwd_alibi"))
    layers = len(_layers(model))
    want = GEN_NEW * layers
    if counts.get(other, 0) or counts[mine] != want:
        raise AssertionError(f"{path}: {mine} launched {counts[mine]} times "
                             f"(expected {want}: {GEN_NEW} forwards of "
                             f"{layers} layers), {other} {counts.get(other)}")
    ntok = GEN_ROWS * GEN_NEW
    card = card_line()
    log(f"[{path}] {GEN_ROWS} prompts of {GEN_PROMPT}, {GEN_NEW} new tokens "
        f"each (greedy, {GEN_NEW} forwards of [{GEN_ROWS}, "
        f"{GEN_PROMPT + GEN_NEW}]): {ntok} tokens in {wall:.3f} s, "
        f"{ntok / wall:.1f} tokens/s, {1e3 * wall / GEN_NEW:.1f} ms/step "
        f"({card})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{path}] peak allocated {peak:.2f} GiB ({card}); launches "
        f"{counts}")
    return counts, prompts


def phase_prompt_check(torch, model, prompts, label):
    """The prompt logits of the served prompts (one forward of [8, 128]):
    bf16 through the kernels, bf16 through the plain versions, float32
    through the plain versions, under the check's rule (limit CHECK_REL)."""
    ids = torch.as_tensor(prompts, device=model.device)
    with torch.no_grad():
        got = model(ids).float()
        with plain_kernels():
            ref = model(ids).float()
            m32 = fp32_copy(torch, model)
            ref32 = m32(ids).float()
            del m32
    torch.cuda.empty_cache()
    _hold_logits(label, ("prompt",), (got,), (ref,), (ref32,), CHECK_REL)


def phase_alibi_train(torch, dev, np, path, model, anatomy=False):
    """The train step of an ALiBi family whole (BLOOM-560m or Falcon-RW-1B,
    no remat, as the headline step) at batch 4 x 2048 through
    make_train_step with the headline's AdamW, after the train check (loss
    and three gradients on one row against the plain versions and
    float32): K2, K5a and K5b in their ALiBi mode, once a layer and step
    each, and the modes without ALiBi never. Returns the launch counts."""
    from paddle_tpu_torch.models import bloom, falcon
    model.cfg.remat = False
    cfg = model.cfg
    ids, labels = train_batch(torch, dev, np, cfg, batch=ALIBI_TRAIN_BATCH,
                              seq=ALIBI_TRAIN_SEQ)
    last = len(model.h) - 1
    if path == "bloom_train":
        names = ("h.0.qkv", f"h.{last}.four_h_to_h", "word_embeddings")
        flops = bloom.num_flops_per_token(cfg, ALIBI_TRAIN_SEQ)
    else:
        names = ("h.0.wq", f"h.{last}.four_h_to_h", "word_embeddings")
        flops = falcon.num_flops_per_token(cfg, ALIBI_TRAIN_SEQ)
    counts = run_train(torch, np, path, model, ids, labels, True, anatomy,
                       names, GRAD_REL, flops)
    want = 10 * len(model.h)
    got = {k: counts[k] for k in PATHS[path]}
    plain = {k: counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    if any(v != want for v in got.values()) or any(plain.values()):
        raise AssertionError(f"{path} launches {got} (expected {want} each), "
                             f"modes without ALiBi {plain}")
    return counts


def phase_hd256_train(torch, dev, np, path, anatomy=False):
    """The train step of a head dim 256 family through make_train_step with
    the headline's AdamW: ``gemma_train`` Gemma-2B whole
    (``gemma_2b_config``) at batch 2 x 2048 with remat on, as
    ``GemmaConfig`` defaults it (K2 twice a layer and step: the forward
    and its recompute); ``gptj_train`` GPT-J-6B's widths at
    GPTJ_TRAIN_LAYERS layers, 4 x 2048, remat off. First the train check
    (loss and three gradients on one row against the plain versions and
    float32), then 10 steps in which K2, K5a and K5b run at head dim 256 on
    the tensor cores (GQA 8:1 for Gemma; K5b's group of one for GPT-J) as
    many times as the model's layers say, the ALiBi modes never, and
    neither ``eager_attention`` nor a plain version of K2, K5 or K7 at all.
    Returns the launch counts."""
    from paddle_tpu_torch.models import gemma, gptj
    if path == "gemma_train":
        model = build_generate_model(torch, dev, "gemma2b")
        batch, mod = GEMMA_TRAIN_BATCH, gemma
        last = len(model.layers) - 1
        names = ("layers.0.qkv_proj", f"layers.{last}.down_proj",
                 "embed_tokens")
    else:
        model = build_generate_model(torch, dev, "gptj", GPTJ_TRAIN_LAYERS,
                                     remat=False)
        batch, mod = GPTJ_TRAIN_BATCH, gptj
        last = len(model.h) - 1
        names = ("h.0.q_proj", f"h.{last}.fc_out", "lm_head")
    cfg = model.cfg
    ids, labels = train_batch(torch, dev, np, cfg, batch=batch,
                              seq=HD256_TRAIN_SEQ)
    phase_train_check(torch, model, ids, labels, names, GRAD_REL,
                      f"{path}_check")
    with count_plain_calls() as plain:
        counts = run_train(torch, np, path, model, ids, labels, False,
                           anatomy, names, GRAD_REL,
                           mod.num_flops_per_token(cfg, HD256_TRAIN_SEQ))
    del model
    torch.cuda.empty_cache()
    if plain.calls:
        raise AssertionError(f"{path}: plain attention or rope ran on the "
                             f"path: {plain.calls}")
    layers = cfg.num_hidden_layers if path == "gemma_train" else cfg.n_layer
    steps = 10                       # run_train counts before its anatomy
    want = {"flash_fwd": steps * layers * (2 if cfg.remat else 1),
            "flash_bwd_dq": steps * layers, "flash_bwd_dkv": steps * layers,
            "flash_fwd_alibi": 0, "flash_bwd_dq_alibi": 0,
            "flash_bwd_dkv_alibi": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{path} launches {got}, expected {want}")
    return counts


# the launches of one generate forward of a layer on the decoder paths:
# K2 once; K7 on q and k (GPT-NeoX, Phi); K1 twice (GLM, plus the final
# norm once a forward)
DECODER_GEN_LAUNCHES = {"neox": {"rope": 2}, "opt": {}, "phi": {"rope": 2},
                        "glm": {"rms_norm": 2}}


def phase_decoder_serve(torch, dev, np, family, path):
    """``phase_generate`` of one of DECODER_SERVE's models whole (K2 once a
    layer and step; K7 twice a layer and step for Pythia and Phi-2, K1
    twice a layer and once at the end for GLM-4; none of these and no
    backward elsewhere: the launch counts must be exactly these), then
    the prompt logits of a DECODER_CHECK_LAYERS-layer cut held to float32
    (``phase_prompt_check``). Returns the launch counts."""
    model = build_generate_model(torch, dev, family)
    layers = len(_layers(model))
    counts, prompts = phase_generate(torch, dev, model, np, path)
    del model
    torch.cuda.empty_cache()
    per = DECODER_GEN_LAUNCHES[family]
    want = {"flash_fwd": GEN_NEW * layers,
            "rope": GEN_NEW * layers * per.get("rope", 0),
            "rms_norm": GEN_NEW * (layers * per.get("rms_norm", 0)
                                   + ("rms_norm" in per)),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_fwd_alibi": 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{path} launches {got}, expected {want}")
    model = build_generate_model(torch, dev, family, DECODER_CHECK_LAYERS)
    phase_prompt_check(torch, model, prompts, f"{path.split('_')[0]}_check")
    del model
    torch.cuda.empty_cache()
    return counts


def phase_gpt3_train(torch, dev, np, anatomy=False):
    """``bench.py``'s ``bench_gpt3_tp`` on the card: ``GPTConfig()`` whole
    (GPT-3 1.3B: 24 layers, hidden 2048, 16 heads of 128, remat on) through
    ``make_train_step(loss, AdamW(2e-4, weight_decay=0.1), mesh=
    HybridMesh(tp=1))`` over a one-rank NCCL world (``shard_module``'s
    pspec rule, tp = 1), at its batch 4 x 1024. First the train check
    (loss and three gradients on one row against the plain versions and
    float32), then 2 warm-up and 8 timed steps under
    ``count_plain_calls``: every loss finite and the last below the first,
    K2 exactly twice a layer and step (the forward and remat's recompute),
    K5a and K5b once, no other kernel and no plain version. Logs ms/step,
    tokens/s, MFU and peak memory. Returns the launch counts."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             num_flops_per_token)
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg = GPTConfig()
    tm = time.monotonic()
    model = GPTForCausalLM(cfg, device=dev, seed=0)
    ids, labels = train_batch(torch, dev, np, cfg, batch=GPT3_TRAIN_BATCH,
                              seq=GPT3_TRAIN_SEQ)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"[gpt3_train] GPTConfig(): {cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {nparams / 1e9:.3f} B params, random weights in "
        f"{time.monotonic() - tm:.1f} s")
    last = cfg.num_hidden_layers - 1
    phase_train_check(torch, model, ids, labels,
                      ("blocks.0.qkv", f"blocks.{last}.fc2", "wte"),
                      GRAD_REL, "gpt3_train_check")
    with nccl_world(torch):
        mesh = D.HybridMesh(tp=1)
        opt = O.AdamW(learning_rate=2e-4, weight_decay=0.1)
        state = init_state(model, opt, mesh)
        step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt,
                               mesh=mesh)
        del model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        holder = [state]
        del state

        def one():
            holder[0], loss = step(holder[0], ids, labels)
            return loss
        with count_plain_calls() as plain:
            warm = [one() for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            timed = [one() for _ in range(8)]
            torch.cuda.synchronize()
            step_s = (time.monotonic() - t0) / 8
        counts = K.launches()
        if anatomy:
            def steps():
                for _ in range(2):
                    one()
            _anatomy(torch, f"gpt3_train step, batch {GPT3_TRAIN_BATCH} x "
                     f"{GPT3_TRAIN_SEQ}", "step", steps, 2)
        del holder, step
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    losses = [float(x) for x in warm + timed]
    if plain.calls:
        raise AssertionError(f"gpt3_train: plain versions ran: {plain.calls}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt3_train losses: {losses}")
    layers, n = cfg.num_hidden_layers, len(losses)
    want = {"flash_fwd": 2 * layers * n, "flash_bwd_dq": layers * n,
            "flash_bwd_dkv": layers * n, "rope": 0, "rms_norm": 0,
            "flash_fwd_alibi": 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"gpt3_train launches {got}, expected {want}")
    tok_s = GPT3_TRAIN_BATCH * GPT3_TRAIN_SEQ / step_s
    mfu = num_flops_per_token(cfg, GPT3_TRAIN_SEQ) * tok_s / PEAK_BF16_FLOPS
    card = card_line()
    log(f"[gpt3_train] {mesh!r} over NCCL, AdamW(2e-4, weight_decay=0.1): "
        f"losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"[gpt3_train] batch {GPT3_TRAIN_BATCH} x {GPT3_TRAIN_SEQ}: "
        f"{1e3 * step_s:.1f} ms/step, {tok_s:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of 989 TFLOP/s, peak allocated "
        f"{peak / 2**30:.2f} GiB ({card})")
    log(f"[gpt3_train] launches over {n} steps: {counts}")
    return counts


def phase_phi_train(torch, dev, np, anatomy=False):
    """Phi-2's widths (hidden 2560, 32 heads of 80, MLP 10 240, vocab
    51 200) at PHI_TRAIN_LAYERS layers, remat off, batch 4 x 2048 through
    make_train_step with the headline's AdamW (``run_train``): the train
    check first, then 10 steps in which K2, K5a and K5b run at head dim 80
    once a layer and step and K7 four times (q and k, forward and
    backward), exactly, with no plain version. Returns the launch
    counts."""
    from paddle_tpu_torch.models import phi
    model = build_generate_model(torch, dev, "phi", PHI_TRAIN_LAYERS,
                                 remat=False)
    cfg = model.cfg
    ids, labels = train_batch(torch, dev, np, cfg, batch=PHI_TRAIN_BATCH,
                              seq=PHI_TRAIN_SEQ)
    last = PHI_TRAIN_LAYERS - 1
    names = ("layers.0.qkv_proj", f"layers.{last}.fc2", "lm_head")
    phase_train_check(torch, model, ids, labels, names, GRAD_REL,
                      "phi_train_check")
    with count_plain_calls() as plain:
        counts = run_train(torch, np, "phi_train", model, ids, labels, False,
                           anatomy, names, GRAD_REL,
                           phi.num_flops_per_token(cfg, PHI_TRAIN_SEQ))
    del model
    torch.cuda.empty_cache()
    if plain.calls:
        raise AssertionError(f"phi_train: plain versions ran: {plain.calls}")
    steps, layers = 10, PHI_TRAIN_LAYERS     # run_train's, before anatomy
    want = {"flash_fwd": steps * layers, "flash_bwd_dq": steps * layers,
            "flash_bwd_dkv": steps * layers, "rope": 4 * steps * layers,
            "rms_norm": 0, "flash_fwd_alibi": 0}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"phi_train launches {got}, expected {want}")
    return counts


# ------------------------------------------------------------- encoders
def _bert_pretrain_batch(torch, dev, np, vocab):
    """``bench_bert_dp``'s batch from np.random.RandomState(0): ids, MLM
    labels at 15% of the positions (-100 elsewhere), NSP labels."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (BERT_TRAIN_BATCH, BERT_SEQ))
    mlm = np.where(rs.rand(BERT_TRAIN_BATCH, BERT_SEQ) < 0.15, ids, -100)
    nsp = rs.randint(0, 2, (BERT_TRAIN_BATCH,))
    return tuple(torch.as_tensor(a, device=dev) for a in (ids, mlm, nsp))


def _timed_launches(torch, fn, n):
    """Run ``fn`` ``n`` times with the launch counters set to 0 just
    before, under ``count_plain_calls``: (the results, seconds a call over
    the last n - 1 — None for n = 1 —, the launch counts, the plain
    calls)."""
    from paddle_tpu_torch.ops import cuda as K
    torch.cuda.synchronize()
    K.reset_launches()
    with count_plain_calls() as plain:
        outs = [fn()]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs += [fn() for _ in range(n - 1)]
        torch.cuda.synchronize()
        sec = (time.monotonic() - t0) / (n - 1) if n > 1 else None
    return outs, sec, K.launches(), plain.calls


def _exact_launches(path, counts, want):
    """Every kernel of ``want`` launched exactly so often and every other
    kernel not at all."""
    got = {k: n for k, n in counts.items() if n or k in want}
    if got != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"{path} launches {got}, expected {want}")


def phase_bert_train(torch, dev, np):
    """``bench.py``'s ``bench_bert_dp`` on the card at dp = 1:
    ``BertForPretraining(BertConfig.base())`` in bf16 (hidden and
    attention dropout 0.1), batch 8 x 128, through ``make_train_step(loss,
    AdamW(1e-4, weight_decay=0.01), mesh=HybridMesh(dp=1),
    with_rng=True)`` over a one-rank NCCL world. First the train check on
    a copy with dropout 0 (the same seed: the same weights; its attention
    runs K2 / K5 without a causal mask): the MLM loss and three gradients
    on one row against the plain versions and float32 (GRAD_REL). Then 1
    warm-up and 9 counted steps (8 timed): every loss finite and the last
    below the first (means of three steps: dropout moves each step's loss);
    attention dropout sends every layer to ``eager_attention``
    (exactly 12 calls a step, as the reference's dropout goes to
    ``xla_attention``) and no kernel launches. Logs samples/s, ms/step,
    MFU (``models.bert.num_flops_per_token``) and peak memory. Returns the
    launch counts (all 0)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              num_flops_per_token)
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg0 = BertConfig.base(dtype=torch.bfloat16, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    ids, mlm, nsp = _bert_pretrain_batch(torch, dev, np, cfg0.vocab_size)
    model = BertForPretraining(cfg0, device=dev, seed=0)
    last = cfg0.num_hidden_layers - 1
    phase_train_check(torch, model, ids, mlm,
                      ("bert.layers.0.attention.q_proj.weight",
                       f"bert.layers.{last}.output.weight",
                       "bert.embeddings.word_embeddings.weight"),
                      GRAD_REL, "bert_train_check")
    del model
    cfg = BertConfig.base(dtype=torch.bfloat16)
    tm = time.monotonic()
    model = BertForPretraining(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    log(f"[bert_train] BertConfig.base(): {cfg.num_hidden_layers} layers, "
        f"hidden {cfg.hidden_size}, {nparams / 1e6:.1f} M params, dropout "
        f"{cfg.hidden_dropout_prob} / {cfg.attention_probs_dropout_prob}, "
        f"random weights in {time.monotonic() - tm:.1f} s")
    with nccl_world(torch):
        mesh = D.HybridMesh(dp=1)
        opt = O.AdamW(learning_rate=1e-4, weight_decay=0.01)
        state = init_state(model, opt, mesh)
        step = make_train_step(
            lambda m, i, lab, ns, g: m.loss(i, lab, ns, generator=g), opt,
            mesh=mesh, with_rng=True)
        del model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        holder = [state]
        del state

        def one():
            holder[0], loss = step(holder[0], ids, mlm, nsp)
            return loss
        warm = [one()]
        losses, step_s, counts, plain = _timed_launches(torch, one, 9)
        del holder, step
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    losses = [float(x) for x in warm + losses]
    n = len(losses) - 1                 # the steps counted
    # (dropout moves each step's loss: the means of three steps fall)
    if not all(np.isfinite(losses)) or not sum(losses[-3:]) < sum(
            losses[:3]):
        raise AssertionError(f"bert_train losses: {losses}")
    if any(counts.values()):
        raise AssertionError(f"bert_train launched kernels: "
                             f"{ {k: c for k, c in counts.items() if c} }")
    if plain != {"eager_attention": cfg.num_hidden_layers * n}:
        raise AssertionError(f"bert_train plain calls {plain}, expected "
                             f"{cfg.num_hidden_layers * n} eager_attention")
    tok_s = BERT_TRAIN_BATCH * BERT_SEQ / step_s
    mfu = num_flops_per_token(cfg, BERT_SEQ) * tok_s / PEAK_BF16_FLOPS
    card = card_line()
    log(f"[bert_train] {mesh!r} over NCCL, AdamW(1e-4, weight_decay=0.01), "
        f"with_rng: losses {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"[bert_train] batch {BERT_TRAIN_BATCH} x {BERT_SEQ}: "
        f"{1e3 * step_s:.2f} ms/step, {BERT_TRAIN_BATCH / step_s:.1f} "
        f"samples/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s (3 x (L (8 h^2 + "
        f"4 h I + 4 S h) + 2 h^2 + 2 h V) = "
        f"{num_flops_per_token(cfg, BERT_SEQ) / 1e6:.1f} MFLOP a token), "
        f"peak allocated {peak / 2**30:.2f} GiB ({card})")
    log(f"[bert_train] over {n} steps: no kernel launch, "
        f"{plain['eager_attention']} eager_attention calls (attention "
        f"dropout)")
    return counts


def phase_bert_finetune(torch, dev, np):
    """``BertForSequenceClassification`` at BERT-base in bf16 with
    ``varlen_attention`` (the right-padded batch's mask becomes kv_lens),
    attention dropout 0 and hidden dropout 0.1, batch 32 x 128 (lengths
    16-128), through ``make_train_step(cross entropy, AdamW(2e-5,
    weight_decay=0.01), with_rng=True)``: 1 warm-up and 8 counted steps,
    every loss finite; K2, K5a and K5b without a causal mask at head dim
    64 exactly 12 times a step each, no other kernel, no plain version.
    Returns the launch counts."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.bert import (BertConfig,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg = BertConfig.base(dtype=torch.bfloat16, varlen_attention=True,
                          attention_probs_dropout_prob=0.0)
    lens, ids, mask, labels = bert_batch(torch, dev, np, cfg.vocab_size)
    model = BertForSequenceClassification(cfg, device=dev, seed=0)
    opt = O.AdamW(learning_rate=2e-5, weight_decay=0.01)
    holder = [init_state(model, opt)]
    step = make_train_step(
        lambda m, i, am, lab, g: F.cross_entropy(
            m(i, attention_mask=am, generator=g), lab), opt, with_rng=True)
    del model

    def one():
        holder[0], loss = step(holder[0], ids, mask, labels)
        return loss
    warm = [one()]
    losses, step_s, counts, plain = _timed_launches(
        torch, one, BERT_FINETUNE_STEPS)
    del holder, step
    torch.cuda.empty_cache()
    losses = [float(x) for x in warm + losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bert_finetune losses: {losses}")
    if plain:
        raise AssertionError(f"bert_finetune: plain versions ran: {plain}")
    per = cfg.num_hidden_layers * BERT_FINETUNE_STEPS
    _exact_launches("bert_finetune", counts, {
        "flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per})
    log(f"[bert_finetune] batch {BERT_BATCH} x {BERT_SEQ}, kv_lens "
        f"{int(lens.min())}-{int(lens.max())} ({int(lens.sum())} of "
        f"{BERT_BATCH * BERT_SEQ} positions live): {1e3 * step_s:.2f} "
        f"ms/step, {BERT_BATCH / step_s:.1f} samples/s, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)} ({card_line()})")
    log(f"[bert_finetune] launches over {BERT_FINETUNE_STEPS} steps: "
        f"{ {k: c for k, c in counts.items() if c} }")
    return counts


def phase_bert_encode(torch, dev, np):
    """``BertModel`` at BERT-base in eval, bf16, ``varlen_attention``, the
    fine-tune batch: ENCODE_ITERS forwards, K2 exactly 12 times each and
    nothing else, sequences/s; the valid rows' hidden states held to a
    float32 copy through the plain versions (``_hold_logits``'s rule,
    CHECK_REL). Returns the launch counts."""
    from paddle_tpu_torch.models.bert import BertConfig, BertModel
    cfg = BertConfig.base(dtype=torch.bfloat16, varlen_attention=True)
    lens, ids, mask, _ = bert_batch(torch, dev, np, cfg.vocab_size)
    model = BertModel(cfg, device=dev, seed=0).eval()
    valid = mask.bool()
    with torch.no_grad():
        outs, sec, counts, plain = _timed_launches(
            torch, lambda: model(ids, attention_mask=mask)[0], ENCODE_ITERS)
        if plain:
            raise AssertionError(f"bert_encode: plain versions ran: {plain}")
        _exact_launches("bert_encode", counts, {
            "flash_fwd": cfg.num_hidden_layers * ENCODE_ITERS})
        got = outs[0][valid]
        del outs
        with plain_kernels():
            ref = model(ids, attention_mask=mask)[0][valid]
            m32 = fp32_copy(torch, model).eval()
            ref32 = m32(ids, attention_mask=mask)[0][valid]
            del m32
    del model
    torch.cuda.empty_cache()
    _hold_logits("bert_encode_check", ("hidden states (valid rows)",),
                 (got,), (ref,), (ref32,), CHECK_REL)
    log(f"[bert_encode] batch {BERT_BATCH} x {BERT_SEQ}, kv_lens "
        f"{int(lens.min())}-{int(lens.max())}: {1e3 * sec:.2f} ms a "
        f"forward, {BERT_BATCH / sec:.1f} sequences/s, K2 "
        f"{counts['flash_fwd']} launches over {ENCODE_ITERS} forwards "
        f"({card_line()})")
    return counts


def encoder_models(torch):
    """(name, model class, config, forward) of ``encoder_serve``: the auto
    registry's classes of RoBERTa, ERNIE, ELECTRA, LayoutLM, DistilBERT,
    ALBERT and ERNIE-M at their configs' published default widths, bf16;
    ``forward(model, ids, bbox)`` gives the output held to float32."""
    from paddle_tpu_torch.models import (albert, distilbert, electra, ernie,
                                         ernie_m, layoutlm, roberta)
    bf = dict(dtype=torch.bfloat16)

    def first(m, ids, bbox):
        out = m(ids)
        return out[0] if isinstance(out, tuple) else out
    return (
        ("roberta", roberta.RobertaForMaskedLM, roberta.RobertaConfig(**bf),
         first),
        ("ernie", ernie.ErnieForMaskedLM, ernie.ErnieConfig(**bf), first),
        ("electra", electra.ElectraForPreTraining,
         electra.ElectraConfig(**bf), first),
        ("layoutlm", layoutlm.LayoutLMForMaskedLM,
         layoutlm.LayoutLMConfig(**bf), lambda m, ids, bbox: m(ids, bbox)),
        ("distilbert", distilbert.DistilBertForMaskedLM,
         distilbert.DistilBertConfig(**bf), first),
        ("albert", albert.AlbertForMaskedLM, albert.AlbertConfig(**bf),
         first),
        ("ernie_m", ernie_m.ErnieMModel, ernie_m.ErnieMConfig(**bf), first))


def phase_encoder_serve(torch, dev, np):
    """One eval forward each of ``encoder_models`` on 32 full-length rows
    of 128 seeded ids (LayoutLM with seeded boxes) and no mask, so every
    layer's attention takes K2: exactly once a layer (DistilBERT's 6,
    ALBERT's 12 applications of its one layer), no other kernel, no plain
    version; sequences/s over 3 timed forwards; each output held to a
    float32 copy through the plain versions (CHECK_REL). Returns the
    launch counts summed over the seven counted forwards."""
    total = {}
    rs = np.random.RandomState(28)
    x0, y0 = (rs.randint(0, 500, (BERT_BATCH, BERT_SEQ)) for _ in range(2))
    bbox = torch.as_tensor(np.stack(
        [x0, y0, x0 + rs.randint(1, 500, x0.shape),
         y0 + rs.randint(1, 500, y0.shape)], -1), device=dev)
    for name, cls, cfg, fwd in encoder_models(torch):
        ids = torch.as_tensor(rs.randint(2, cfg.vocab_size,
                                         (BERT_BATCH, BERT_SEQ)), device=dev)
        model = cls(cfg, device=dev, seed=0).eval()
        layers = getattr(cfg, "num_hidden_layers", None) or cfg.n_layers
        with torch.no_grad():
            outs, _, counts, plain = _timed_launches(
                torch, lambda: fwd(model, ids, bbox), 1)
            got = outs[0]
            if plain:
                raise AssertionError(f"encoder_serve {name}: plain versions "
                                     f"ran: {plain}")
            _exact_launches(f"encoder_serve {name}", counts,
                            {"flash_fwd": layers})
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
            sec = time_ms(lambda: fwd(model, ids, bbox), iters=3,
                          warmup=1) / 1e3
            with plain_kernels():
                ref = fwd(model, ids, bbox)
                m32 = fp32_copy(torch, model).eval()
                ref32 = fwd(m32, ids, bbox)
                del m32
        nparams = sum(p.numel() for p in model.parameters())
        del model
        torch.cuda.empty_cache()
        _hold_logits(f"encoder_serve {name}", (f"{cls.__name__} output",),
                     (got,), (ref,), (ref32,), CHECK_REL)
        log(f"[encoder_serve] {name}: {cls.__name__}, {nparams / 1e6:.1f} M "
            f"params, {layers} layers: {1e3 * sec:.2f} ms a forward of "
            f"{BERT_BATCH} x {BERT_SEQ}, {BERT_BATCH / sec:.1f} "
            f"sequences/s, K2 {counts['flash_fwd']} launches")
        del got, ref, ref32
    log(f"[encoder_serve] launches over the seven forwards: {total} "
        f"({card_line()})")
    return total


def _anatomy(torch, label, unit, run, n):
    """Wall time per ``unit`` of ``run`` (which does n of them, timed three
    times plain, then once under torch.profiler and once under cProfile)
    against the device kernel time; the kernels that take the device time
    and the Python functions that take the host time."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) / n)
    wall = sorted(walls)[1]
    log(f"[anatomy] {label}: wall " + " / ".join(
        f"{1e3 * w:.2f}" for w in walls) + f" ms/{unit} over three runs")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side kernel entries only: an aten op's own "self device
        # time" is the time of the kernels it launched, counted again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3 / n, e.count // n, e.key))
    rows.sort(reverse=True)
    card = card_line()
    dev_ms = sum(r[0] for r in rows)
    if dev_ms <= 0:
        log(f"[anatomy] the profiler recorded no device time ({card}): "
            f"device share not measured; wall {1e3 * wall:.2f} ms/{unit}")
    else:
        log(f"[anatomy] {label}: wall {1e3 * wall:.2f} ms/{unit} (median), "
            f"device kernels {dev_ms:.2f} ms/{unit}, device idle "
            f"{100 * max(0.0, 1 - dev_ms / (1e3 * wall)):.1f}% ({card})")
    for ms, cnt, key in rows[:24]:
        log(f"[anatomy] {ms:8.3f} ms/{unit} {100 * ms / dev_ms:5.1f}% "
            f"{cnt:5d}x/{unit}  {key[:90]}")
    # the attention kernels one by one, wherever they rank
    for tag, fn in (("K2", "flash_fwd"), ("K5a", "flash_bwd_dq"),
                    ("K5b", "flash_bwd_dkv"), ("K6a", "grouped_fwd"),
                    ("K6a rows", "grouped_rows"),
                    ("K6a decode", "grouped_decode"), ("K6b", "grouped_dw"),
                    ("K6a LoRA shrink", "lora_shrink"),
                    ("K6a LoRA expand", "lora_expand")):
        mine = [r for r in rows if fn in r[2]]
        if mine and dev_ms > 0:
            ms = sum(r[0] for r in mine)
            log(f"[anatomy] {tag} ({fn}): {ms:8.3f} ms/{unit} "
                f"{100 * ms / dev_ms:5.1f}% {sum(r[1] for r in mine):5d}x/"
                f"{unit}  {mine[0][2][:60]}")
    # host: each Python function's own time (cProfile slows the run, so
    # the shares count, not the sum)
    prof_py = cProfile.Profile()
    prof_py.enable()
    run()
    torch.cuda.synchronize()
    prof_py.disable()
    fns = sorted(((tt, nc, f) for f, (_, nc, tt, _, _) in
                  pstats.Stats(prof_py).stats.items()), reverse=True)
    host_ms = 1e3 * sum(f[0] for f in fns) / n
    log(f"[anatomy] {label}: host {host_ms:.2f} ms/{unit} under cProfile")
    for tt, nc, (path, line, fn) in fns[:10]:
        ms = 1e3 * tt / n
        log(f"[anatomy] host {ms:8.3f} ms/{unit} {100 * ms / host_ms:5.1f}% "
            f"{nc // n:5d}x/{unit}  {os.path.basename(path)}:{line}({fn})")


def phase_anatomy(torch, dev, model, np, label="decode tick",
                  kv_dtype=None, async_depth=0, engine_kw=None,
                  adapter_ids=None):
    """Decode-tick anatomy (diagnostics, not in the default phases): 8
    active slots in steady decode, 16 ticks per run (six runs: every
    slot stays active through them); ``kv_dtype="int8"`` over an int8
    pool; ``async_depth``: the pipelined engine (every slot crosses a
    block boundary on the same tick, one step in 16, which drains the
    window); ``engine_kw``: further engine arguments (an adapter store),
    ``adapter_ids``: each slot's adapter."""
    from paddle_tpu_torch.serving import LLMEngine, Request
    extra = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
    if async_depth:
        extra["async_depth"] = async_depth
    eng = LLMEngine(model, num_slots=8, block_size=16, max_prompt_len=128,
                    max_seq_len=512, num_blocks=256, seed=0, device=dev,
                    **extra, **(engine_kw or {}))
    rs = np.random.RandomState(2)
    for i in range(8):
        eng.add_request(Request(rs.randint(3, model.cfg.vocab_size, size=100),
                                max_new_tokens=128,
                                adapter_id=(adapter_ids or [None] * 8)[i]))
    for _ in range(4):                     # admission + first decode ticks
        eng.step()

    def ticks():
        for _ in range(16):
            eng.step()
    _anatomy(torch, f"{label}, 8 active slots", "tick", ticks, 16)
    if hasattr(eng.exe, "tick_log"):
        eng.exe.tick_log = []
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ticks()
        torch.cuda.synchronize()
        wall = 1e3 * (time.monotonic() - t0) / 16
        for kind, (n, call, dev_ms) in _tick_stats(torch, eng.exe).items():
            log(f"[anatomy] {label}: {n} {kind} graph replays, step wall "
                f"{wall:.3f} ms, executor call {call:.3f} ms, device "
                f"{dev_ms:.3f} ms/tick (CUDA events around the replay), idle "
                f"{100 * max(0.0, 1 - dev_ms / wall):.1f}% of the step wall; "
                f"graph pools {eng.exe.graph_pool_bytes / 2**20:.1f} MiB "
                f"({card_line()})")
    for rid in list(eng.requests):
        eng.cancel(rid)


# ------------------------------------------- multi-LoRA and speculation
# lora_serve: three adapters of ranks 4, 8 and 16 on qkv_proj and o_proj
# (A ~ N(0, 1/in), B ~ N(0, 0.05^2) as the reference's test, alpha 2r), a
# store of capacity 4 padded to rank 16; requests i of the mix carry
# LORA_MIX[i % 4] (three each, three on the base)
LORA_RANKS = (4, 8, 16)
LORA_MIX = ("r4", "r8", "r16", None)
# the fp32 checks at reduced depth: Llama-2-7B's widths cut to 4 layers
CHECK_LAYERS = 4


def lora_sd(model, np, seed, r):
    """A visible adapter state dict (the reference's keys) for ``model``'s
    qkv and o projections, made with numpy from ``seed``."""
    from paddle_tpu_torch import peft
    rs = np.random.RandomState(seed)
    params = dict(model.named_parameters())
    sd = {}
    for name in peft.lora_targets(model, ("qkv_proj", "o_proj")):
        k, n = params[name].shape
        sd[name + ".lora_A"] = (rs.randn(k, r) / np.sqrt(k)).astype(
            np.float32)
        sd[name + ".lora_B"] = (rs.randn(r, n) * 0.05).astype(np.float32)
    sd["_scale"] = np.asarray(2.0, np.float32)
    return sd


def build_store(model, np, seed=100):
    """``AdapterStore(capacity=4, max_rank=16)`` over ``model`` holding
    the three adapters of LORA_RANKS; returns (store, {id: state dict})."""
    from paddle_tpu_torch.serving.adapters import AdapterStore
    store = AdapterStore(model, capacity=4, max_rank=16)
    sds = {f"r{r}": lora_sd(model, np, seed + i, r)
           for i, r in enumerate(LORA_RANKS)}
    for aid, sd in sds.items():
        store.register(aid, sd)
    return store, sds


def _adapter_counts():
    from paddle_tpu_torch.observability import METRICS
    out = {}
    for name in ("uploads", "evictions", "cache_hits", "cache_misses",
                 "admit_deferrals"):
        c = METRICS.get(f"serving_adapter_{name}_total")
        out[name] = 0 if c is None else c.value()
    return out


def phase_lora_serve(torch, dev, model, np, serve_stats):
    """The serve mix on Llama-2-7B with multi-LoRA: nine requests on three
    adapters (ranks 4, 8, 16), three on the base, the warm-up on a fourth
    adapter; after the fourth step a fifth adapter is registered and a
    request on it submitted, which must evict the warm-up adapter (LRU).
    Then the same mix with ``PT_MULTILORA_IMPL=gather`` (the dense per-row
    baseline, in a new engine: its LoRA graph captures the gather). Every
    request finishes, the serve kernels and (grouped) K6a's two LoRA
    kernels launch; the
    LoRA graph's device time a tick of the two is compared. Returns (the
    grouped run's launch counts, the store, the adapters' state dicts,
    the requests)."""
    from paddle_tpu_torch.serving import Request
    store, sds = build_store(model, np)
    store.register("warm", lora_sd(model, np, 99, 8))
    vocab = model.cfg.vocab_size
    ids = [LORA_MIX[i % 4] for i in range(12)]

    def late(eng):
        store.register("late", lora_sd(model, np, 98, 8))
        r = Request(np.random.RandomState(5).randint(3, vocab, size=60),
                    max_new_tokens=32, adapter_id="late")
        eng.add_request(r)
        return [r]

    runs = {}
    for impl in ("grouped", "gather"):
        os.environ["PT_MULTILORA_IMPL"] = impl
        try:
            a0 = _adapter_counts()
            counts, reqs, st = phase_serve(
                torch, dev, model, np, "lora_serve" if impl == "grouped"
                else "serve", label=f"lora_serve {impl}",
                engine_kw=dict(adapter_store=store), adapter_ids=ids,
                warm_adapter="warm", late=late)
            st["adapters"] = {k: v - a0[k] for k, v in
                              _adapter_counts().items()}
        finally:
            os.environ.pop("PT_MULTILORA_IMPL")
        runs[impl] = (counts, reqs, st)
        card = card_line()
        lt = st["ticks"].get("lora")
        log(f"[lora_serve {impl}] decode step: "
            + (f"{lt[0]} LoRA graph replays, wall {lt[1]:.3f} ms/tick "
               f"against {lt[2]:.3f} ms of device time (idle "
               f"{100 * (1 - lt[2] / lt[1]):.1f}%)" if lt else "none")
            + f"; LoRA kernel launches (shrink, expand) "
            f"{(counts.get('lora_shrink'), counts.get('lora_expand'))}, K6a "
            f"by route {st['routes'].get('grouped_fwd')}; "
            f"adapter uploads/hits/misses/evictions/deferrals "
            f"{st['adapters']}; graph pools {st['pool_mib']:.1f} MiB; "
            f"{st['tokens_s']:.1f} tokens/s against serve's "
            f"{serve_stats['tokens_s']:.1f} ({card})")
        if not st["adapters"]["evictions"] >= 1:
            raise AssertionError(f"lora_serve {impl}: the late adapter "
                                 f"evicted nothing: {st['adapters']}")
        if impl == "gather" and any(counts.get(name, 0) for name in (
                "grouped_fwd", "lora_shrink", "lora_expand")):
            raise AssertionError(f"the gather baseline launched K6a: "
                                 f"{counts}")
        if (impl == "grouped" and counts.get("grouped_fwd", 0)
                and "lora_shrink" not in ABSENT):
            raise AssertionError(f"the LoRA path launched the general K6a "
                                 f"routes: {counts}")
    store.assert_quiescent()
    g, d = runs["grouped"][2]["ticks"]["lora"], \
        runs["gather"][2]["ticks"]["lora"]
    same = sum(a.tokens == b.tokens for a, b in zip(runs["grouped"][1],
                                                    runs["gather"][1]))
    log(f"[lora_serve] grouped / gather LoRA graph device time a tick: "
        f"{g[2]:.3f} / {d[2]:.3f} ms = {g[2] / d[2]:.3f}; tokens/s "
        f"{runs['grouped'][2]['tokens_s']:.1f} / "
        f"{runs['gather'][2]['tokens_s']:.1f}; streams equal {same} of "
        f"{len(runs['grouped'][1])} (report: fp32 sums in another order, "
        f"cast to bf16) ({card_line()})")
    return runs["grouped"][0], store, sds, runs["grouped"][1]


def _lora_batch(store, aid, rows, width):
    """The engine's host description of ``rows`` rows all on adapter
    ``aid`` (pinned by the caller), ``width`` tokens a row."""
    import numpy as np
    idx = store.index_of(aid)
    gs = np.zeros(store.capacity, np.int32)
    gs[idx] = rows * width
    ar = np.arange(rows, dtype=np.int32)
    return {"perm": ar, "inv": ar, "gs": gs,
            "aidx": np.full(rows, idx, np.int32)}


def _prefill_logits(torch, model, prompts, lora=None, store=None):
    """Last-position prefill logits [rows, V] of ``prompts`` (flash) into
    a fresh pool, with the multi-LoRA batch ``lora`` over ``store``'s
    stacks."""
    import numpy as np
    from paddle_tpu_torch.models import paged as P
    cfg, dev = model.cfg, model.device
    bs, mb = 16, 8
    b = len(prompts)
    cache = P.PagedKVCache.init(cfg.num_hidden_layers, b * mb, bs,
                                cfg.num_key_value_heads,
                                cfg.hidden_size // cfg.num_attention_heads,
                                b, mb, cfg.dtype, device=dev)
    ids = np.zeros((b, 128), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    lk = None if lora is None else {
        **store.stacks(), **{k: torch.as_tensor(v, device=dev)
                             for k, v in lora.items()}}
    last, _ = P.llama_prefill_paged(
        model, torch.as_tensor(ids, device=dev),
        np.array([len(p) for p in prompts], np.int32), cache,
        np.arange(b, dtype=np.int32),
        np.arange(b * mb, dtype=np.int32).reshape(b, mb), lora=lk)
    return last.float()


def phase_lora_check(torch, dev, model, np, store, sds, reqs, m32):
    """Multi-LoRA correctness, in three parts.
    (a) Llama-2-7B bf16: each adapter's prompt logits (the six short
    prompts of the mix, every row on that adapter) through the kernels and
    through the plain versions, against the float32 copy ``m32`` with
    that adapter merged (``peft.lora_merge``), under the check's rule
    (limit CHECK_REL).
    (b) Llama-2-7B's widths cut to CHECK_LAYERS layers (the only cut), in
    float32: the mixed batch's every greedy stream equals a dedicated
    single-adapter engine's stream token for token, and the base rows
    equal a storeless engine's.
    (c) the LoRA graph's replay against the eager LoRA tick at 7B bf16 (8
    slots decoding, rows on the three adapters and the base):
    ``graph_against_eager``."""
    from paddle_tpu_torch import peft
    from paddle_tpu_torch.core.random import generator
    from paddle_tpu_torch.serving import LLMEngine, Request
    prompts = [list(r.prompt) for r in reqs[:6]]
    names, got, ref, ref32 = [], [], [], []
    with torch.no_grad():
        for aid, sd in sds.items():
            r = int(aid[1:])
            store.acquire(aid)
            lora = _lora_batch(store, aid, len(prompts), 128)
            got.append(_prefill_logits(torch, model, prompts, lora, store))
            with plain_kernels():
                ref.append(_prefill_logits(torch, model, prompts, lora,
                                           store))
                tree = peft.lora_load_state_dict(peft.lora_init(
                    m32, generator(0, dev), r=r, alpha=2 * r,
                    target_modules=("qkv_proj", "o_proj")), sd)
                merged = peft.lora_merge(m32, tree)
                ref32.append(_prefill_logits(torch, merged, prompts))
                del merged, tree
            store.release(aid)
            names.append(f"{aid} prefill")
    torch.cuda.empty_cache()
    _hold_logits("lora_check 7B bf16", names, got, ref, ref32, CHECK_REL)
    del got, ref, ref32
    # (b) reduced depth, fp32: mixed batch against dedicated engines
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    m4 = LlamaForCausalLM(LlamaConfig.llama2_7b(
        num_hidden_layers=CHECK_LAYERS, dtype=torch.float32), device=dev,
        seed=0)
    store4, _ = build_store(m4, np)
    kw = dict(num_slots=8, block_size=16, max_prompt_len=128,
              max_seq_len=512, num_blocks=256, device=dev)
    mix = [(list(r.prompt), LORA_MIX[i % 4]) for i, r in
           enumerate(reqs[:8])]

    def serve(with_store, pick):
        eng = LLMEngine(m4, adapter_store=store4 if with_store else None,
                        **kw)
        rids = {i: eng.add_request(Request(p, max_new_tokens=16,
                                           adapter_id=a))
                for i, (p, a) in enumerate(mix) if pick(a)}
        eng.run()
        eng.assert_quiescent()
        return {i: eng.requests[rid].tokens for i, rid in rids.items()}

    mixed = serve(True, lambda a: True)
    want = serve(False, lambda a: a is None)
    for aid in sds:
        want.update(serve(True, lambda a, aid=aid: a == aid))
    bad = [i for i in mixed if mixed[i] != want[i]]
    log(f"[lora_check] {CHECK_LAYERS}-layer fp32: {len(mixed)} mixed "
        f"streams ({sum(a is not None for _, a in mix)} on adapters) equal "
        f"to dedicated engines' token for token: {not bad} ({card_line()})")
    if bad:
        raise AssertionError(f"lora_check: mixed streams {bad} differ from "
                             f"their dedicated engines'")
    store4.assert_quiescent()
    del m4, store4
    torch.cuda.empty_cache()
    # (c) the LoRA graph against the eager LoRA tick, 7B bf16
    eng = LLMEngine(model, adapter_store=store, seed=0, **kw)
    rs = np.random.RandomState(3)
    for i, n in enumerate(rs.randint(20, 120, 8)):
        eng.add_request(Request(rs.randint(3, model.cfg.vocab_size,
                                           size=int(n)), max_new_tokens=64,
                                adapter_id=LORA_MIX[i % 4]))
    while not (eng.active.all() and eng.stats["ticks"] >= 2):
        eng.step()
    res = graph_against_eager(
        torch, eng, lora=eng._lora_arg(np.where(eng.active, eng.slot_aidx,
                                                -1), 1))
    log(f"[lora_check] LoRA graph vs eager LoRA tick, 7B bf16: {res}; "
        f"graph pools {eng.exe.graph_pool_bytes / 2**20:.1f} MiB "
        f"({card_line()})")
    for rid in list(eng.requests):
        eng.cancel(rid)
    eng.assert_quiescent()
    del eng
    torch.cuda.empty_cache()


def tinyllama_config(torch, layers=22, dtype=None):
    """``TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T``'s published
    ``config.json``: 22 layers, hidden 2048, intermediate 5632, 32 heads
    over 4 KV heads, vocab 32000, rope theta 10000, RMS eps 1e-5 (random
    weights here: a draft that nearly never agrees with the target)."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_hidden_layers=layers,
                       num_attention_heads=32, num_key_value_heads=4,
                       max_position_embeddings=2048, rms_norm_eps=1e-5,
                       rope_theta=10000.0, dtype=dtype or torch.bfloat16,
                       remat=False)


def _goodput_now():
    """(good, saved, {why: waste}) of the port's goodput ledger so far
    (None for a tree without it)."""
    if not _port_has("observability.goodput"):
        return None
    from paddle_tpu_torch.observability.goodput import GOODPUT
    return (GOODPUT.good_total(), GOODPUT.saved_total(),
            dict(GOODPUT.waste_by_why()))


def _log_goodput(label, before):
    """GOODPUT's document for one run: good, saved and wasted tokens by
    reason since ``before`` (``_goodput_now``), and the good share."""
    after = _goodput_now()
    if before is None or after is None:
        return
    good, saved = after[0] - before[0], after[1] - before[1]
    waste = {k: v - before[2].get(k, 0) for k, v in after[2].items()
             if v - before[2].get(k, 0)}
    total = good + sum(waste.values())
    log(f"[{label}] goodput: good {good:.0f}, saved {saved:.0f}, waste "
        f"{waste}, good share {good / total if total else 0.0:.4f}")


def _spec_tokens():
    from paddle_tpu_torch.serving.telemetry import _SPEC_TOKENS
    v = _SPEC_TOKENS.value()
    return v["sum"], v["count"]


def phase_spec_serve(torch, dev, model, np, serve_stats):
    """The serve mix on the Llama-2-7B bf16 target with ``spec_k=4``,
    adaptive, twice: the draft is the target itself (nearly every proposal
    accepted), then TinyLlama-1.1B's widths with random weights (nearly
    every proposal rejected: the rewind runs); then the TinyLlama run over
    an int8 KV pool (K3 and K4 in their int8 mode). The mix's greedy and
    temperature 0.8 rows all speculate. For each: tokens/s, the acceptance
    rate, tokens committed a slot and round, the draft's and the verify's
    wall ms a round, K3 launches and fallbacks. Returns the first run's
    launch counts."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    tiny = LlamaForCausalLM(tinyllama_config(torch), device=dev, seed=7)
    out = None
    for label, draft, kv, path in (
            ("spec_serve self-draft", model, None, "spec_serve"),
            ("spec_serve tinyllama draft", tiny, None, "spec_serve"),
            ("spec_serve tinyllama draft, int8 pool", tiny, "int8",
             "quant_serve")):
        t0 = _spec_tokens()
        g0 = _goodput_now()
        counts, reqs, st = phase_serve(
            torch, dev, model, np, path, kv_dtype=kv, label=label,
            engine_kw=dict(draft_model=draft, spec_k=4, spec_adaptive=True),
            roofline=True)
        t1 = _spec_tokens()
        _log_goodput(label, g0)
        e = st["engine"]
        n = max(e["spec_ticks"], 1)
        rate = e["spec_accepted"] / max(e["spec_proposed"], 1)
        k3 = counts["paged_chunk_i8" if kv else "paged_chunk"]
        log(f"[{label}] {st['tokens_s']:.1f} tokens/s (serve "
            f"{serve_stats['tokens_s']:.1f}); acceptance "
            f"{e['spec_accepted']} / {e['spec_proposed']} = {rate:.3f}; "
            f"{(t1[0] - t0[0]) / max(t1[1] - t0[1], 1):.3f} tokens a slot "
            f"and round over {e['spec_ticks']} rounds; draft "
            f"{1e3 * e['spec_draft_s'] / n:.2f} ms, verify "
            f"{1e3 * e['spec_verify_s'] / n:.2f} ms a round (wall); K3 "
            f"launches {k3}, fallbacks {e['spec_fallbacks']} ({card_line()})")
        if not e["spec_ticks"] or e["spec_fallbacks"]:
            raise AssertionError(f"{label}: {e}")
        if draft is model and rate < 0.5:
            raise AssertionError(f"{label}: the target as its own draft "
                                 f"accepted only {rate:.3f}")
        if out is None:
            out = counts
    del tiny
    torch.cuda.empty_cache()
    return out


def _verify_logits(torch, model, prompts, chunk):
    """Prefill ``prompts``, then one verify chunk of ``chunk`` [rows, 5]
    tokens at each prompt's end (crossing a block boundary where the
    prompt ends near one): the verify's logits [rows, 5, V]."""
    import numpy as np
    from paddle_tpu_torch.models import paged as P
    cfg, dev = model.cfg, model.device
    b, mb = len(prompts), 10
    cache = P.PagedKVCache.init(cfg.num_hidden_layers, b * mb, 16,
                                cfg.num_key_value_heads,
                                cfg.hidden_size // cfg.num_attention_heads,
                                b, mb, cfg.dtype, device=dev)
    ids = np.zeros((b, 128), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    tables = np.arange(b * mb, dtype=np.int32).reshape(b, mb)
    slots = np.arange(b, dtype=np.int32)
    P.llama_prefill_paged(model, torch.as_tensor(ids, device=dev), lens,
                          cache, slots, tables)
    logits, _ = P.llama_verify_chunk_paged(
        model, torch.as_tensor(chunk, device=dev),
        np.full(b, chunk.shape[1], np.int32), lens, cache, slots, tables)
    return logits.float()


def phase_spec_check(torch, dev, model, np, reqs, m32):
    """Speculative correctness, in two parts.
    (a) Llama-2-7B's widths cut to CHECK_LAYERS layers (the only cut), in
    float32: greedy speculative streams, with the target as its own draft
    and with TinyLlama's widths cut to CHECK_LAYERS layers, equal the
    non-speculative engine's streams token for token.
    (b) Llama-2-7B bf16: one verify chunk of 5 tokens a row after the six
    short prompts, through the kernels and through the plain versions,
    against the float32 copy ``m32`` under the check's rule (limit
    CHECK_REL)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import LLMEngine, Request
    prompts = [list(r.prompt) for r in reqs[:8]]
    m4 = LlamaForCausalLM(LlamaConfig.llama2_7b(
        num_hidden_layers=CHECK_LAYERS, dtype=torch.float32), device=dev,
        seed=0)
    t4 = LlamaForCausalLM(tinyllama_config(torch, CHECK_LAYERS,
                                           torch.float32), device=dev,
                          seed=7)
    kw = dict(num_slots=8, block_size=16, max_prompt_len=128,
              max_seq_len=512, num_blocks=256, device=dev)

    def serve(**ekw):
        eng = LLMEngine(m4, **kw, **ekw)
        rids = [eng.add_request(Request(p, max_new_tokens=24))
                for p in prompts]
        eng.run()
        eng.assert_quiescent()
        return [eng.requests[r].tokens for r in rids], eng.stats

    base, _ = serve()
    for label, draft in (("self-draft", m4), ("tinyllama draft", t4)):
        got, st = serve(draft_model=draft, spec_k=4)
        same = got == base
        log(f"[spec_check] {CHECK_LAYERS}-layer fp32, {label}: "
            f"{len(got)} greedy streams equal to the non-speculative "
            f"engine's token for token: {same}; acceptance "
            f"{st['spec_accepted']} / {st['spec_proposed']} "
            f"({card_line()})")
        if not same or not st["spec_ticks"]:
            raise AssertionError(f"spec_check {label}: streams differ "
                                 f"({st})")
    del m4, t4
    torch.cuda.empty_cache()
    p6 = prompts[:6]
    chunk = np.stack([[r.tokens[0], *np.random.RandomState(i).randint(
        3, model.cfg.vocab_size, 4)] for i, r in enumerate(reqs[:6])])
    with torch.no_grad():
        got = _verify_logits(torch, model, p6, chunk)
        with plain_kernels():
            ref = _verify_logits(torch, model, p6, chunk)
            ref32 = _verify_logits(torch, m32, p6, chunk)
    _hold_logits("spec_check 7B bf16", ("verify",), [got], [ref], [ref32],
                 CHECK_REL)
    torch.cuda.empty_cache()


# ------------------------------------------- beams and grammar (serving)
BEAM_K, BEAM_NEW = 4, 48
BEAM_ROWS = (1, 4)          # the serve mix's requests turned into beams
BEAM_CHECK_NEW = 24
BEAM_SCORE_REL = 1e-5       # engine vs paged_beam_search, same kernels
BEAM_PLAIN_REL = 1e-4       # kernels vs plain versions, best score
GRAMMAR_EOS = 2


def beam_requests(np, vocab=32000):
    """The serve mix with requests BEAM_ROWS turned into beam requests
    (``num_beams=4``, 48 new tokens, greedy), in their places."""
    from paddle_tpu_torch.serving import Request
    reqs = serve_requests(np.random.RandomState(0), vocab)
    for i in BEAM_ROWS:
        reqs[i] = Request(reqs[i].prompt, max_new_tokens=BEAM_NEW,
                          num_beams=BEAM_K)
    return reqs


def _beam_peaks(peak):
    """``on_step`` hook of phase_serve: the most pool blocks the live beam
    groups held at once, beside the blocks they would hold if each beam
    kept its own copy of the prompt and of the tokens so far."""
    def hook(eng):
        live = dense = 0
        for g in eng.groups.values():
            live += eng._group_live_blocks(g)
            dense += g.req.num_beams * eng.mgr.blocks_needed(g.s + g.i + 1)
        if live > peak["live"]:
            peak.update(live=live, dense=dense)
        peak["pool"] = max(peak["pool"],
                           eng.mgr.num_blocks - eng.mgr.free_blocks)
    return hook


def phase_beam_serve(torch, dev, model, np, serve_stats):
    """The serve mix on the Llama-2-7B bf16 model with two of its
    requests turned into beam requests (``num_beams=4``, 48 new tokens):
    the beams ride with the greedy rows and oversubscribe the 8 slots.
    Then one beam request over an int8 pool (``kv_dtype=torch.int8``) with
    the two long greedy prompts. Prints tokens/s, TTFT, the peak blocks
    the groups held beside the count if each beam held its own prompt
    blocks, the beam select's and the group update's ms a tick, and the
    launches. Returns ({path: launch counts}, the bf16 run's requests)."""
    out = {}
    peak = {"live": 0, "dense": 0, "pool": 0}
    counts, reqs, st = phase_serve(
        torch, dev, model, np, "beam_serve", mix=beam_requests(np),
        on_step=_beam_peaks(peak))
    out["beam_serve"] = counts
    e = st["engine"]
    n = max(e["beam_selects"], 1)
    beams = [reqs[i] for i in BEAM_ROWS]
    card = card_line()
    log(f"[beam_serve] {len(beams)} beam requests of {BEAM_K} beams, "
        f"{BEAM_NEW} new tokens each, finished: "
        f"{[r.finish_reason for r in beams]}, scores "
        f"{[round(r.beam_score, 4) for r in beams]}; {st['tokens_s']:.1f} "
        f"tokens/s (serve {serve_stats['tokens_s']:.1f}) ({card})")
    log(f"[beam_serve] peak blocks the groups held {peak['live']} (each "
        f"beam on its own copy: {peak['dense']}); peak pool blocks in use "
        f"{peak['pool']} of 256")
    log(f"[beam_serve] beam select {1e3 * e['beam_select_s'] / n:.3f} ms, "
        f"group update {1e3 * e['beam_update_s'] / n:.3f} ms a group and "
        f"tick (wall, {e['beam_selects']} selects); K1 "
        f"{counts['rms_norm']}, K2 {counts['flash_fwd']}, K4 "
        f"{counts['paged_decode']}, K7 {counts['rope']} + fold "
        f"{counts.get('rope_kv', 0)} launches ({card})")
    if peak["live"] <= 0 or peak["live"] >= peak["dense"]:
        raise AssertionError(f"beam groups did not share their prompt "
                             f"blocks: {peak}")
    # a third beam request, over an int8 pool, beside two long prompts
    from paddle_tpu_torch.serving import Request
    mix = serve_requests(np.random.RandomState(0))
    i8 = [Request(mix[2].prompt, max_new_tokens=BEAM_NEW, num_beams=BEAM_K),
          mix[6], mix[7]]
    counts8, r8, st8 = phase_serve(
        torch, dev, model, np, "beam_serve_i8", kv_dtype=torch.int8,
        label="beam_serve int8 pool", mix=i8, need_hits=False)
    out["beam_serve_i8"] = counts8
    log(f"[beam_serve int8 pool] beam finished {r8[0].finish_reason}, "
        f"score {r8[0].beam_score:.4f}; {st8['tokens_s']:.1f} tokens/s; "
        f"K4 int8 {counts8['paged_decode_i8']} launches ({card})")
    return out, reqs


def _beam_engine(torch, dev, model, reqs, eager=False, graph_check=False):
    """Serve ``reqs`` on a fresh engine of the serve geometry; ``eager``:
    every decode tick runs eagerly on the card (the executor's eager tick,
    the same kernels) instead of replaying the graph; ``graph_check``:
    once the groups decode, hold a replay against the eager tick
    (``graph_against_eager``) and the cache's tensors against the capture.
    Returns (the requests, the graph check's reading)."""
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.serving.executor import _cache_ptrs
    eng = LLMEngine(model, num_slots=8, block_size=16, max_prompt_len=128,
                    max_seq_len=512, num_blocks=256, seed=0, device=dev)
    exe = eng.exe
    if eager:
        def eager_tick(last_tok, run_mask, rows, cols, vals, temps, top_ps,
                       need_logp=False, lora=None, bias=None):
            return exe._eager_tick(last_tok, run_mask, rows, cols, vals,
                                   temps, top_ps, need_logp, lora, bias,
                                   time.perf_counter())
        exe.decode_tick = eager_tick
    ptrs = _cache_ptrs(exe.cache)
    for r in reqs:
        eng.add_request(r)
    res = None
    while eng.has_work():
        eng.step()
        if (graph_check and res is None and eng.groups
                and all(g.i >= 3 for g in eng.groups.values())):
            res = graph_against_eager(torch, eng)
    eng.assert_quiescent()
    if _cache_ptrs(exe.cache) != ptrs:
        raise AssertionError("the beam reorders moved the cache's tensors")
    return reqs, res


def phase_beam_check(torch, dev, np):
    """Beam correctness at Llama-2-7B's widths cut to CHECK_LAYERS layers,
    float32 (the model ``m32``):
    (a) the engine's beams (the beam mix's first 8 requests, both beam
    requests riding with the greedy rows) equal the port's own
    ``paged_beam_search`` of each prompt on the card token for token,
    scores within BEAM_SCORE_REL;
    (b) the best score within BEAM_PLAIN_REL of ``paged_beam_search``
    through the plain versions (``plain_kernels()``);
    (c) the same engine with every decode tick run eagerly gives the same
    beams bit for bit, a replay of the tick graph mid-group equals the
    eager tick (``graph_against_eager``), and the beam reorders left the
    captured tensors where the graph reads them."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.paged import paged_beam_search
    from paddle_tpu_torch.serving import Request
    m32 = LlamaForCausalLM(LlamaConfig.llama2_7b(
        num_hidden_layers=CHECK_LAYERS, dtype=torch.float32), device=dev,
        seed=0)

    def mix():
        reqs = beam_requests(np)[:8]
        return [Request(r.prompt, max_new_tokens=(BEAM_CHECK_NEW
                                                  if r.num_beams > 1
                                                  else 16),
                        num_beams=r.num_beams) for r in reqs]
    got, res = _beam_engine(torch, dev, m32, mix(), graph_check=True)
    eager, _ = _beam_engine(torch, dev, m32, mix(), eager=True)
    card = card_line()
    for i in BEAM_ROWS:
        g, e = got[i], eager[i]
        prompt = np.asarray(g.prompt)
        seq, score = paged_beam_search(m32, prompt, BEAM_CHECK_NEW, BEAM_K,
                                       block_size=16, num_blocks=64)
        with plain_kernels():
            pseq, pscore = paged_beam_search(m32, prompt, BEAM_CHECK_NEW,
                                             BEAM_K, block_size=16,
                                             num_blocks=64)
        want = seq.cpu().numpy()[len(prompt):].tolist()
        rel = abs(g.beam_score - float(score)) / abs(float(score))
        prel = abs(g.beam_score - float(pscore)) / abs(float(pscore))
        same_plain = pseq.cpu().numpy()[len(prompt):].tolist() == g.tokens
        log(f"[beam_check] {CHECK_LAYERS}-layer fp32 beam request {i}: "
            f"engine == paged_beam_search token for token: "
            f"{g.tokens == want}, score rel diff {rel:.2e} (limit "
            f"{BEAM_SCORE_REL}); plain versions' best score rel diff "
            f"{prel:.2e} (limit {BEAM_PLAIN_REL}), tokens equal "
            f"{same_plain}; eager ticks bit for bit: "
            f"{e.tokens == g.tokens and e.beam_score == g.beam_score} "
            f"({card})")
        if (g.tokens != want or rel > BEAM_SCORE_REL
                or prel > BEAM_PLAIN_REL or e.tokens != g.tokens
                or e.beam_score != g.beam_score):
            raise AssertionError(f"beam_check request {i}: {g.tokens} "
                                 f"{g.beam_score} vs {want} {score}, "
                                 f"eager {e.tokens} {e.beam_score}")
    for a, b in zip(got, eager):
        if a.tokens != b.tokens:
            raise AssertionError("beam_check: a greedy stream differs "
                                 "between graph and eager ticks")
    log(f"[beam_check] graph replay mid-group against the eager tick: "
        f"{res} ({card})")
    if res is None:
        raise AssertionError("beam_check: the groups never decoded three "
                             "ticks")
    del m32
    torch.cuda.empty_cache()


def grammar_vocab(np, seed, vocab=32000):
    """A synthetic vocabulary of ``vocab`` token strings from ``seed``:
    ids 0-2 empty (EOS is id 2), the 95 printable ASCII characters as
    single tokens (ids 3-97), then pieces of 2-6 printable characters
    (digits and punctuation over-represented, as in a real tokenizer's
    JSON-heavy merges)."""
    rs = np.random.RandomState(seed)
    printable = [chr(c) for c in range(32, 127)]
    heavy = list('0123456789{}":,-') + printable
    out = ["", "", ""] + printable
    while len(out) < vocab:
        n = int(rs.randint(2, 7))
        out.append("".join(heavy[int(j)] for j in
                           rs.randint(0, len(heavy), n)))
    return out


GRAMMAR_SCHEMA = {"type": "object",
                  "properties": {"color": {"enum": ["red", "green", "blue"]},
                                 "ok": {"type": "boolean"}}}
GRAMMAR_PHONE = "[0-9]{3}-[0-9]{4}"


def _automaton_build(TG, pattern, vocab):
    """A fresh automaton of ``pattern`` walked over every state it can
    reach: (the automaton, states, seconds) — the host cost the engine
    pays lazily, a state at a time, the first time a row reaches it."""
    import numpy as np
    t0 = time.perf_counter()
    aut = TG.TokenMaskAutomaton(pattern, vocab=vocab,
                                eos_token_id=GRAMMAR_EOS)
    seen, todo = {aut.start_state}, [aut.start_state]
    while todo:
        sid = todo.pop()
        for tok in np.nonzero(aut.mask(sid))[0]:
            if tok == GRAMMAR_EOS:
                continue
            nxt = aut.advance(sid, int(tok))
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
    return aut, len(seen), time.perf_counter() - t0


def grammar_requests(np, vocab, TG):
    """12 requests over the synthetic vocabulary (prompts of 20-120
    tokens, no shared prefix): 4 under the JSON schema's regex, 2 under
    GRAMMAR_PHONE, 6 free; greedy and at temperature 0.8. Returns (the
    requests, their patterns: None for a free one)."""
    from paddle_tpu_torch.serving import Request
    rs = np.random.RandomState(5)
    json_re = TG.json_schema_regex(GRAMMAR_SCHEMA)
    auts = {p: TG.TokenMaskAutomaton(p, vocab=vocab,
                                     eos_token_id=GRAMMAR_EOS)
            for p in (json_re, GRAMMAR_PHONE)}
    plan = [(json_re, 0.0), (None, 0.0), (GRAMMAR_PHONE, 0.0),
            (json_re, 0.8), (None, 0.0), (None, 0.8), (json_re, 0.0),
            (GRAMMAR_PHONE, 0.8), (None, 0.0), (json_re, 0.8),
            (None, 0.0), (None, 0.8)]
    reqs = [Request(rs.randint(3, len(vocab), size=int(rs.randint(20, 121))),
                    max_new_tokens=48, temperature=t,
                    grammar=None if p is None else auts[p])
            for p, t in plan]
    return reqs, [p for p, _ in plan]


def phase_grammar_serve(torch, dev, model, np, serve_stats, seed=0):
    """The 7B bf16 model over a synthetic vocabulary of 32000 token
    strings (``grammar_vocab``): 12 requests, 4 under a two-field JSON
    schema, 2 under GRAMMAR_PHONE, 6 free, greedy and at temperature 0.8.
    Prints tokens/s, the biased graph's device ms a tick against the
    unbiased graph's, the host ms a tick spent building bias rows (the
    automata's lazy per-state walks included) and each automaton's build
    time over all its states. Returns (launch counts, requests, patterns,
    vocab)."""
    from paddle_tpu_torch.serving import grammar as TG
    vocab = grammar_vocab(np, seed)
    card = card_line()
    for name, pat in (("json", TG.json_schema_regex(GRAMMAR_SCHEMA)),
                      ("phone", GRAMMAR_PHONE)):
        _, n, sec = _automaton_build(TG, pat, vocab)
        log(f"[grammar_serve] automaton {name} {pat!r}: {n} states over "
            f"{len(vocab)} token strings in {sec:.3f} s host "
            f"({1e3 * sec / n:.1f} ms a state) ({card})")
    reqs, pats = grammar_requests(np, vocab, TG)
    counts, reqs, st = phase_serve(
        torch, dev, model, np, "grammar_serve", mix=reqs, need_hits=False,
        engine_kw=dict(eos_token_id=GRAMMAR_EOS))
    e, ticks = st["engine"], st["ticks"]
    gt = max(e["grammar_ticks"], 1)
    b, u = ticks.get("biased", (0, 0.0, 0.0)), ticks.get("sync",
                                                           (0, 0.0, 0.0))
    log(f"[grammar_serve] {st['tokens_s']:.1f} tokens/s (serve "
        f"{serve_stats['tokens_s']:.1f}); biased graph {b[0]} replays, "
        f"device {b[2]:.3f} ms a tick against the unbiased graph's "
        f"{u[2]:.3f} ms ({u[0]} replays); bias rows "
        f"{1e3 * e['bias_s'] / gt:.3f} ms host a grammar tick over "
        f"{e['grammar_ticks']} ticks ({card})")
    log(f"[grammar_serve] finish reasons "
        f"{[(p is not None, r.finish_reason) for r, p in zip(reqs, pats)]}")
    if not b[0] or not e["grammar_ticks"]:
        raise AssertionError(f"grammar_serve: no biased tick ran ({ticks})")
    return counts, reqs, pats, vocab


def phase_grammar_check(torch, dev, model, np, reqs, pats, vocab):
    """(a) every grammar stream of grammar_serve that ended on EOS
    decodes to text that ``re.fullmatch``-es its pattern (and at least
    one did); (b) every free greedy stream equals its stream from a run
    with no grammar row present; (c) the biased graph's replay equals the
    eager biased tick (``graph_against_eager`` with the engine's bias
    rows, 8 slots decoding, 4 of them under a grammar)."""
    import re
    from paddle_tpu_torch.serving import LLMEngine, Request
    from paddle_tpu_torch.serving import grammar as TG
    card = card_line()
    ended = 0
    for r, p in zip(reqs, pats):
        if p is None or r.finish_reason != "eos":
            continue
        text = "".join(vocab[t] for t in r.tokens[:-1])
        ended += 1
        if not re.fullmatch(p, text):
            raise AssertionError(f"grammar_check: {text!r} !~ {p!r}")
    log(f"[grammar_check] {ended} grammar streams ended on EOS, each "
        f"matching its pattern ({card})")
    if not ended:
        raise AssertionError("grammar_check: no grammar stream ended")
    free = [i for i, (r, p) in enumerate(zip(reqs, pats))
            if p is None and r.temperature == 0.0]
    kw = dict(num_slots=8, block_size=16, max_prompt_len=128,
              max_seq_len=512, num_blocks=256, seed=0, device=dev,
              eos_token_id=GRAMMAR_EOS)
    eng = LLMEngine(model, **kw)
    ids = [eng.add_request(Request(reqs[i].prompt, max_new_tokens=48))
           for i in free]
    eng.run()
    eng.assert_quiescent()
    same = [eng.requests[j].tokens == reqs[i].tokens
            for i, j in zip(free, ids)]
    log(f"[grammar_check] {len(free)} free greedy streams equal to a run "
        f"without grammar rows: {same} ({card})")
    if not all(same):
        raise AssertionError("grammar_check: a free stream changed beside "
                             "grammar rows")
    del eng
    # (c) the biased graph against the eager biased tick
    eng = LLMEngine(model, **kw)
    rs = np.random.RandomState(3)
    json_re = TG.json_schema_regex(GRAMMAR_SCHEMA)
    aut = TG.TokenMaskAutomaton(json_re, vocab=vocab,
                                eos_token_id=GRAMMAR_EOS)
    for j, n in enumerate(rs.randint(20, 120, 8)):
        eng.add_request(Request(rs.randint(3, len(vocab), size=int(n)),
                                max_new_tokens=64,
                                grammar=aut if j % 2 else None))
    while not (eng.active.all() and eng.stats["ticks"] >= 2):
        eng.step()
    bias = eng._grammar_bias_rows([(s, s) for s in range(8)], 8)
    res = graph_against_eager(torch, eng, bias=bias)
    log(f"[grammar_check] biased graph against the eager biased tick: "
        f"{res} ({card})")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------- tenants and operations
# tenant_serve: the 12-request mix split into tenants — A (weight 2) the
# six short prompts, B (weight 1) the long and shared-prefix ones, C
# (best effort, a token bucket of 200 tokens/s and a burst of 50) the two
# sampled ones: each costs its prompt plus 32 tokens, so C's first
# admission overdraws the bucket and its second waits for the refill
TENANT_OF = ("A",) * 6 + ("B",) * 4 + ("C",) * 2
TENANT_WEIGHTS = {"A": 2.0, "B": 1.0}
TENANT_RATE_C = (200.0, 50.0)
TENANT_SERIES = ("serving_tenant_admissions_total",
                 "serving_tenant_finished_total",
                 "serving_tenant_throttled_total",
                 "serving_degrade_shed_total")
# endpoint_check: every route a scraper reads, every 50 ms
ENDPOINT_ROUTES = ("/metrics", "/metrics.json", "/healthz", "/flight",
                   "/requests", "/roofline", "/memory", "/slo", "/tenants")
SCRAPE_S = 0.05
PROFILE_S = 1.0


def _greedy_rows(reqs):
    return [list(r.tokens) for r in reqs if not r.temperature]


def _held_ctrl(level=0):
    """A degradation controller without signals whose down-patience never
    ends: it holds whatever rung it is forced to."""
    from paddle_tpu_torch.serving import DegradationController
    c = DegradationController(signals=[], down_patience=10 ** 9)
    c.force_level(level)
    return c


def _ops_kw():
    """Pass (a)'s engine arguments: a controller held at L0 and a tracker
    of the default objectives, new for each engine."""
    from paddle_tpu_torch.observability import SLOTracker, default_objectives
    return dict(degrade=_held_ctrl(), slo=SLOTracker(default_objectives()))


class _Timed:
    """A method wrapper adding up its calls' wall seconds."""

    def __init__(self, fn):
        self.fn, self.s, self.n = fn, 0.0, 0

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.s += time.perf_counter() - t
            self.n += 1


def _series_now(name):
    from paddle_tpu_torch.observability import METRICS
    inst = METRICS.get(name)
    return {} if inst is None else {k: c[0] for k, c in inst._series.items()}


def _hist_sum(name):
    from paddle_tpu_torch.observability import METRICS
    return sum(s.sum for s in METRICS.get(name)._series.values())


def _with_env(env, fn):
    """``fn()`` with the environment variables ``env`` set, restored
    after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_tenant_serve(torch, dev, model, np, serve_reqs, serve_stats):
    """Tenants, the degradation ladder and the SLO tracker on the serve
    phase's Llama-2-7B engine settings. (a) L0 bit identity: the mix with
    no tenants, a controller held at L0 and a tracker gives the serve
    phase's greedy rows, also under PT_DEGRADE=0 and PT_SLO=0. (b) The
    mix split into tenants A / B / C under the default signals: the
    admission order, per-tenant admissions, finishes, throttles and
    sheds, the rungs the ladder visited and which signal moved it; the
    host ms a step of the ladder's poll, the tracker's poll and its tick
    charge; tokens/s beside the serve phase's. (c) Forced rungs: L1
    launches no verify (K3) with the self-draft and L0 does; L2 chunks
    are at most max_prompt_len // chunk_shrink tokens; L3 keeps the
    best-effort tenant queued while the others finish; L4 rejects with
    OverloadError; back at L0 everything drains quiescent. (d) The
    tracker's device-seconds equal the sum of serving_tick_seconds over
    pass (b) within 1e-6 s, and its good tokens by tenant sum to the
    tokens emitted. Returns (pass (b)'s launch counts, pass (a)'s greedy
    rows)."""
    from paddle_tpu_torch.observability import (REQUESTS, SLOTracker,
                                                default_objectives)
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import (DegradationController, LLMEngine,
                                          OverloadError, Request)
    card = card_line()
    want = _greedy_rows(serve_reqs)
    sampled = [r.tokens for r in serve_reqs if r.temperature]
    # (a) L0 bit identity, then the same under both kill switches
    for label, env in (("tenant_serve L0", {}),
                       ("tenant_serve L0, PT_DEGRADE=0 PT_SLO=0",
                        {"PT_DEGRADE": "0", "PT_SLO": "0"})):
        _, reqs, st = _with_env(env, lambda: phase_serve(
            torch, dev, model, np, "tenant_serve", label=label,
            make_kw=_ops_kw))
        same = _greedy_rows(reqs) == want
        log(f"[{label}] greedy rows token for token the serve phase's: "
            f"{same}; sampled rows too: "
            f"{[r.tokens for r in reqs if r.temperature] == sampled}; "
            f"{st['tokens_s']:.1f} tokens/s ({card})")
        if not same:
            raise AssertionError(f"{label}: greedy rows differ from the "
                                 f"serve phase's")
    # (b) tenants under the default signals
    box = {"order": [], "levels": {}}

    def make_kw():
        box["ctrl"] = DegradationController()
        box["slo"] = SLOTracker(default_objectives())
        return dict(degrade=box["ctrl"], slo=box["slo"])

    def setup(eng):
        for t, w in TENANT_WEIGHTS.items():
            eng.sched.set_tenant_weight(t, w)
        eng.sched.set_tenant_priority("C", "best_effort")
        eng.sched.set_tenant_rate("C", *TENANT_RATE_C)
        for obj, name in ((box["ctrl"], "poll"), (box["slo"], "poll"),
                          (box["slo"], "charge_tick")):
            setattr(obj, name, _Timed(getattr(obj, name)))
        box["tick0"] = _hist_sum("serving_tick_seconds")
        box["m0"] = {n: _series_now(n) for n in TENANT_SERIES}
        charge = eng.sched._charge_tenant

        def admit(req, p):            # called at each admission, in order
            box["order"].append(req.req_id)
            return charge(req, p)
        eng.sched._charge_tenant = admit

    def on_step(eng):
        lvl = box["ctrl"].level
        box["levels"][lvl] = box["levels"].get(lvl, 0) + 1
        box["charged"] = dict(eng.sched.tenant_charged)

    mix = serve_requests(np.random.RandomState(0), model.cfg.vocab_size)
    for r, t in zip(mix, TENANT_OF):
        r.tenant_id = t
    counts, reqs, st = phase_serve(torch, dev, model, np, "tenant_serve",
                                   label="tenant_serve tenants", mix=mix,
                                   make_kw=make_kw, setup=setup,
                                   on_step=on_step)
    ctrl, slo = box["ctrl"], box["slo"]
    tenant = {r.req_id: r.tenant_id for r in reqs}
    delta = {}
    for n in TENANT_SERIES:
        now, was = _series_now(n), box["m0"][n]
        delta[n] = {k: v - was.get(k, 0) for k, v in now.items()
                    if v - was.get(k, 0)}
    steps = max(st["steps"], 1)
    poll_ms = 1e3 * ctrl.poll.s / steps
    spoll_ms = 1e3 * slo.poll.s / steps
    charge_ms = 1e3 * slo.charge_tick.s / steps
    dev_ms = sum(n * d for n, _, d in st["ticks"].values())
    log(f"[tenant_serve tenants] admission order "
        f"{[(rid, tenant[rid]) for rid in box['order']]}")
    log(f"[tenant_serve tenants] admitted {delta[TENANT_SERIES[0]]}, "
        f"finished {delta[TENANT_SERIES[1]]}, throttled "
        f"{delta[TENANT_SERIES[2]]}, shed {delta[TENANT_SERIES[3]]}; "
        f"tokens charged by tenant {box['charged']}")
    log(f"[tenant_serve tenants] ladder under the default signals: steps "
        f"by rung {dict(sorted(box['levels'].items()))}, peak "
        f"L{ctrl.peak_level}, transitions "
        f"{[(t['from'], t['to'], t['why']) for t in ctrl.transitions]}")
    log(f"[tenant_serve tenants] {st['tokens_s']:.1f} tokens/s against the "
        f"serve phase's {serve_stats['tokens_s']:.1f}; host a step: ladder "
        f"poll {poll_ms:.3f} ms, tracker poll {spoll_ms:.3f} ms, tick "
        f"charge {charge_ms:.3f} ms over {steps} steps; decode replays' "
        f"device time {dev_ms:.1f} ms of {1e3 * st['wall']:.1f} ms wall, "
        f"idle {100 * max(0.0, 1 - dev_ms / (1e3 * st['wall'])):.1f}% "
        f"(prefill's eager kernels counted as idle) ({card})")
    throttled = delta[TENANT_SERIES[2]].get(("C",), 0)
    if throttled < 1:
        raise AssertionError(f"tenant C was never throttled: {delta}")
    # (d) reconciliation
    led = slo.ledger
    ticks = _hist_sum("serving_tick_seconds") - box["tick0"]
    ntok = sum(len(r.tokens) for r in reqs)
    log(f"[tenant_serve reconcile] device seconds "
        f"{led.device_seconds_total:.9f} vs serving_tick_seconds "
        f"{ticks:.9f} over {led.ticks} ticks; by "
        f"tenant {led.device_seconds}; good tokens {led.good_tokens} "
        f"(emitted {ntok}); waste {led.waste_tokens}; block-seconds "
        f"{led.block_seconds}")
    if abs(led.device_seconds_total - ticks) > 1e-6 or \
            abs(sum(led.device_seconds.values())
                - led.device_seconds_total) > 1e-6:
        raise AssertionError("tenant_serve: the cost ledger's device "
                             "seconds do not reconcile")
    if sum(led.good_tokens.values()) != ntok or \
            set(led.good_tokens) != {"A", "B", "C"}:
        raise AssertionError(f"tenant_serve: good tokens {led.good_tokens} "
                             f"against {ntok} emitted")
    del box
    # (c) forced rungs on fresh engines of the same settings
    kw = dict(num_slots=8, block_size=16, max_prompt_len=128,
              max_seq_len=512, num_blocks=256, seed=0, device=dev)
    vocab = model.cfg.vocab_size
    rs = np.random.RandomState(5)
    ctrl = _held_ctrl(1)
    eng = LLMEngine(model, draft_model=model, spec_k=4, degrade=ctrl, **kw)
    k3, spec = [], []
    for level in (1, 0):
        ctrl.force_level(level)
        n0, s0 = K.launches()["paged_chunk"], eng.stats["spec_ticks"]
        for n in (24, 40):
            eng.add_request(Request(rs.randint(3, vocab, size=n),
                                    max_new_tokens=16))
        eng.run()
        k3.append(K.launches()["paged_chunk"] - n0)
        spec.append(eng.stats["spec_ticks"] - s0)
    eng.assert_quiescent()
    del eng
    log(f"[tenant_serve L1] self-draft, two requests of 16 new tokens: "
        f"K3 (verify) launches {k3[0]} at L1, {k3[1]} at L0; speculative "
        f"rounds {spec[0]} / {spec[1]} ({card})")
    if k3[0] or spec[0] or not k3[1] or not spec[1]:
        raise AssertionError(f"tenant_serve L1: verify launches {k3}, "
                             f"rounds {spec}")
    ctrl = _held_ctrl(2)
    eng = LLMEngine(model, degrade=ctrl, **kw)
    REQUESTS.enable()
    try:
        long_ = [Request(rs.randint(3, vocab, size=n), max_new_tokens=8)
                 for n in (300, 384)]
        for r in long_:
            eng.add_request(r)
        eng.run()
        chunks = [e["tokens"] for r in long_
                  for e in REQUESTS.timeline(r.trace_id)["events"]
                  if e["kind"] == "prefill_chunk"]
    finally:
        REQUESTS.disable()
        REQUESTS.clear()
    cap = kw["max_prompt_len"] // ctrl.chunk_shrink
    log(f"[tenant_serve L2] chunks of the 300- and 384-token prompts "
        f"{chunks} (at most {cap}) ({card})")
    if not chunks or max(chunks) > cap:
        raise AssertionError(f"tenant_serve L2: chunks {chunks} > {cap}")
    ctrl.force_level(3)
    eng.sched.set_tenant_priority("C", "best_effort")
    shed0 = _series_now("serving_degrade_shed_total").get(("C",), 0)
    rung = [Request(rs.randint(3, vocab, size=n), max_new_tokens=16,
                    tenant_id=t)
            for n, t in zip((30, 60, 45, 90, 20, 50), "AABBCC")]
    for r in rung:
        eng.add_request(r)
    for _ in range(10000):
        if all(r.done for r in rung if r.tenant_id != "C"):
            break
        eng.step()
    queued = {q.req_id for q in eng.queue}
    c_waiting = all(r.req_id in queued and not r.tokens
                    for r in rung if r.tenant_id == "C")
    shed = _series_now("serving_degrade_shed_total").get(("C",), 0) - shed0
    log(f"[tenant_serve L3] A and B finished "
        f"{all(r.done for r in rung if r.tenant_id != 'C')}, C still "
        f"queued {c_waiting}, shed passes {shed} ({card})")
    if not c_waiting or shed <= 0 or \
            not all(r.done for r in rung if r.tenant_id != "C"):
        raise AssertionError("tenant_serve L3: the best-effort tenant was "
                             "not shed while the others finished")
    ctrl.force_level(4)
    try:
        eng.add_request(Request(rs.randint(3, vocab, size=16),
                                max_new_tokens=4))
    except OverloadError as e:
        log(f"[tenant_serve L4] add_request raised OverloadError: {e}")
    else:
        raise AssertionError("tenant_serve L4: a new session was admitted")
    ctrl.force_level(0)
    eng.run()
    eng.assert_quiescent()
    eng.kv.assert_quiescent()
    if not all(r.done and len(r.tokens) == 16 for r in rung):
        raise AssertionError("tenant_serve L0: the shed requests did not "
                             "drain")
    log(f"[tenant_serve L0] back at L0 every request drained, the pool "
        f"quiescent ({card})")
    del eng
    torch.cuda.empty_cache()
    return counts, want


def _http_get(url, timeout=30):
    """(status, body bytes) of one GET; error statuses included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_endpoint_check(torch, dev, model, np, want):
    """The metrics server on a free port and a shipper into a temporary
    file, while pass (a)'s configuration of tenant_serve serves the mix
    again: a client thread scrapes every route every 50 ms from before the
    engines are built (their CUDA graph captures run under it) to the
    end. The greedy rows must equal pass (a)'s (``want``); every route
    answers 200 (``/healthz`` may answer 503, with its JSON). Then 8 rows
    in steady decode under one ``/profile?seconds=1``: its trace must
    name the decode kernels (``paged_decode``, ``rope_kv``). The
    shipper's lines carry deltas and the CUDA memory gauges."""
    import shutil
    import tempfile
    import threading
    from paddle_tpu_torch.observability import (MetricsShipper,
                                                start_metrics_server,
                                                stop_metrics_server)
    from paddle_tpu_torch.serving import LLMEngine, Request
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="pt_endpoint_check_")
    srv = start_metrics_server(port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{srv.port}"
    ship = MetricsShipper(os.path.join(tmp, "metrics.jsonl"),
                          interval_s=0.2).start()
    seen = {r: {} for r in ENDPOINT_ROUTES}
    bad, rounds = [], [0]
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            for route in ENDPOINT_ROUTES:
                code, body = _http_get(base + route)
                seen[route][code] = seen[route].get(code, 0) + 1
                ok = code == 200 or (route == "/healthz" and code == 503)
                try:
                    if ok and route != "/metrics":
                        json.loads(body)
                except ValueError:
                    ok = False
                if not ok:
                    bad.append((route, code, body[:200]))
            rounds[0] += 1
            stop.wait(SCRAPE_S)

    scraper = threading.Thread(target=scrape, name="pt-endpoint-scraper",
                               daemon=True)
    scraper.start()
    old_dir = os.environ.get("PT_PROFILE_DIR")
    os.environ["PT_PROFILE_DIR"] = os.path.join(tmp, "profile")
    try:
        _, reqs, st = phase_serve(torch, dev, model, np, "tenant_serve",
                                  label="endpoint_check", make_kw=_ops_kw)
        same = _greedy_rows(reqs) == want
        log(f"[endpoint_check] greedy rows under scraping token for token "
            f"tenant_serve's pass (a): {same}; {st['tokens_s']:.1f} "
            f"tokens/s ({card})")
        if not same:
            raise AssertionError("endpoint_check: greedy rows changed "
                                 "under scraping")
        # steady decode under one profiler capture; the first capture of a
        # process starts Kineto and CUPTI (seconds), so the rows are topped
        # up until the capture returns
        eng = LLMEngine(model, num_slots=8, block_size=16,
                        max_prompt_len=128, max_seq_len=512, num_blocks=256,
                        seed=0, device=dev, **_ops_kw())
        rs = np.random.RandomState(2)

        def top_up():
            while len(eng.queue) + len(eng.prefilling) \
                    + int(eng.active.sum()) < 8:
                eng.add_request(Request(rs.randint(
                    3, model.cfg.vocab_size, size=100), max_new_tokens=256))
        top_up()
        while eng.queue or eng.prefilling or eng.stats["ticks"] < 2:
            eng.step()
        got = {}
        prof = threading.Thread(target=lambda: got.update(resp=_http_get(
            f"{base}/profile?seconds={PROFILE_S}", timeout=300)),
            name="pt-endpoint-profile")
        t0 = time.monotonic()
        prof.start()
        ticks0 = eng.stats["ticks"]
        while prof.is_alive():
            top_up()
            eng.step()
        ticks = eng.stats["ticks"] - ticks0
        prof.join()
        eng.run()
        eng.assert_quiescent()
        del eng
        code, body = got["resp"]
        if code != 200:
            raise AssertionError(f"endpoint_check: /profile answered {code}: "
                                 f"{body[:300]}")
        doc = json.loads(body)
        with open(doc["trace"]) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events if e.get("ph") == "X"]
        kern = {k: sum(k in n for n in names)
                for k in ("paged_decode", "rope_kv", "rms_norm")}
        main_tid = threading.main_thread().native_id
        cpu_tids = {}
        for e in events:
            if e.get("cat") == "cpu_op":
                cpu_tids[e.get("tid")] = cpu_tids.get(e.get("tid"), 0) + 1
        log(f"[endpoint_check] /profile?seconds={PROFILE_S}: profiler "
            f"start {doc['start_s']:.3f} s, wall {doc['wall_s']:.3f} s "
            f"(request {time.monotonic() - t0:.3f} s), trace "
            f"{doc['bytes']} bytes, {len(events)} events over "
            f"{ticks} decode ticks; kernel events {kern}; CUDA activity "
            f"{doc['cuda']}, all threads {doc['all_threads']}; CPU "
            f"operators by thread {cpu_tids} (the engine thread "
            f"{main_tid}) ({card})")
        if not doc["cuda"] or not kern["paged_decode"] or \
                not kern["rope_kv"]:
            raise AssertionError(f"endpoint_check: the capture names no "
                                 f"decode kernel: {kern}")
    finally:
        if old_dir is None:
            os.environ.pop("PT_PROFILE_DIR", None)
        else:
            os.environ["PT_PROFILE_DIR"] = old_dir
        stop.set()
        scraper.join()
        ship.stop()
        stop_metrics_server()
    with open(ship.path) as f:
        lines = [json.loads(ln) for ln in f]
    deltas = sum(bool(r["deltas"]) for r in lines)
    mem = {k: v for k, v in lines[-1]["snapshot"]["gauges"].items()
           if k.startswith("device_bytes")}
    log(f"[endpoint_check] {rounds[0]} scrape rounds, answers by route "
        f"{seen}; failures {bad[:5]}")
    log(f"[endpoint_check] shipper: {len(lines)} lines, {deltas} with "
        f"deltas, {ship.errors} errors; last line's device gauges {mem} "
        f"({card})")
    shutil.rmtree(tmp, ignore_errors=True)
    if bad or not rounds[0] or any(not seen[r] for r in ENDPOINT_ROUTES):
        raise AssertionError(f"endpoint_check: failed scrapes {bad[:5]}")
    if not deltas or ship.errors or \
            mem.get('device_bytes_in_use{device="cuda:0"}', 0) <= 0:
        raise AssertionError(f"endpoint_check: shipper lines without "
                             f"deltas or the CUDA memory gauges: {mem}")


# --------------------------------------------- HF checkpoints and router
HF_SHARD_BYTES = 5 * 10 ** 9        # shards of at most 5 GB, as HF writes
HF_CUT_LAYERS = 8                   # the depth cut when temp space is short
# meta-llama/Llama-2-7b-hf's config.json, field by field (its shards are
# float16; these hold the served model's bf16 weights, so the dtype field
# says bfloat16)
LLAMA2_7B_HF = {
    "architectures": ["LlamaForCausalLM"], "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 11008,
    "max_position_embeddings": 4096, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 32, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000}
# Qwen/Qwen1.5-MoE-A2.7B's config.json (qwen_moe_config's source), cut to
# HF_MOE_LAYERS layers
QWEN_MOE_HF = {
    "architectures": ["Qwen2MoeForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "decoder_sparse_step": 1,
    "eos_token_id": 151643, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 5632,
    "max_position_embeddings": 8192, "max_window_layers": 21,
    "model_type": "qwen2_moe", "moe_intermediate_size": 1408,
    "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts": 60, "num_experts_per_tok": 4, "num_hidden_layers": 24,
    "num_key_value_heads": 16, "output_router_logits": False,
    "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.001, "shared_expert_intermediate_size": 5632,
    "sliding_window": 32768, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936}
HF_MOE_LAYERS = 2
# the router arms' engines: the serve phase's geometry
ROUTER_ENGINE = dict(num_slots=8, block_size=16, max_prompt_len=128,
                     max_seq_len=512, num_blocks=256, seed=0)
# the serve mix's requests 5, 8 and 9 share a 64-token prefix: one session
# id, so that affinity keeps them on the replica holding the prefix
ROUTER_SESSION = (5, 8, 9)
# router_check's requests: the serve mix's 0, 1, 2 (whole-prompt) and 6
# (300 tokens, chunked); the death case takes 0-5
CHECK_ROWS = (0, 1, 2, 6)
DEATH_ROWS = (0, 1, 2, 3, 4, 5)


def _hf_attention(p, att, nh, nkv, d):
    """A Llama-family attention's HF tensors ([out, in]) from the port's
    fused ``qkv_proj`` [h, (nh + 2 nkv) d] (and ``qkv_bias``)."""
    sizes = [nh * d, nkv * d, nkv * d]
    q, k, v = att.qkv_proj.split(sizes, dim=1)
    out = [(p + "self_attn.q_proj.weight", q.T),
           (p + "self_attn.k_proj.weight", k.T),
           (p + "self_attn.v_proj.weight", v.T),
           (p + "self_attn.o_proj.weight", att.o_proj.T)]
    if att.qkv_bias is not None:
        qb, kb, vb = att.qkv_bias.split(sizes)
        out += [(p + "self_attn.q_proj.bias", qb),
                (p + "self_attn.k_proj.bias", kb),
                (p + "self_attn.v_proj.bias", vb)]
    return out


def _hf_norms(p, lyr):
    return [(p + "input_layernorm.weight", lyr.input_layernorm.weight),
            (p + "post_attention_layernorm.weight",
             lyr.post_attention_layernorm.weight)]


def _hf_gated(p, gate_up, down):
    g, u = gate_up.chunk(2, dim=-1)
    return [(p + "gate_proj.weight", g.T), (p + "up_proj.weight", u.T),
            (p + "down_proj.weight", down.T)]


def hf_llama_tensors(model, layers=None):
    """(HF name, device tensor in HF's layout) of a port
    ``LlamaForCausalLM``'s first ``layers`` layers (all by default)."""
    cfg, m = model.cfg, model.model
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    out = [("model.embed_tokens.weight", m.embed_tokens),
           ("model.norm.weight", m.norm.weight),
           ("lm_head.weight", model.lm_head.T)]
    for i, lyr in enumerate(m.layers[:layers]):
        p = f"model.layers.{i}."
        out += _hf_attention(p, lyr.self_attn, nh, nkv, d)
        out += _hf_gated(p + "mlp.", lyr.mlp.gate_up_proj, lyr.mlp.down_proj)
        out += _hf_norms(p, lyr)
    return out


def hf_qwen_moe_tensors(model):
    """The same for a port ``Qwen2MoeForCausalLM``: the expert stacks
    split into HF's per-expert linears, the router ``gate`` kept in fp32
    (the port's ``gate_w``; HF writes it in the model's type, which would
    not reload bit for bit)."""
    cfg = model.cfg
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    out = [("model.embed_tokens.weight", model.embed_tokens),
           ("model.norm.weight", model.norm.weight),
           ("lm_head.weight", model.lm_head.T)]
    for i, lyr in enumerate(model.layers):
        p = f"model.layers.{i}."
        out += _hf_attention(p, lyr.self_attn, nh, nkv, d) + _hf_norms(p, lyr)
        blk = lyr.mlp
        out.append((p + "mlp.gate.weight", blk.moe.gate_w.T))
        ex = blk.moe.experts
        for e in range(cfg.num_experts):
            out += _hf_gated(p + f"mlp.experts.{e}.", ex.gate_up[e],
                             ex.down[e])
        out += _hf_gated(p + "mlp.shared_expert.", blk.shared_gate_up,
                         blk.shared_down)
        out.append((p + "mlp.shared_expert_gate.weight", blk.shared_gate.T))
    return out


def write_hf_checkpoint(torch, path, tensors, config):
    """An HF checkpoint directory: ``config.json`` and safetensors shards
    of at most HF_SHARD_BYTES (an 8-byte little-endian header length, the
    JSON header padded to 8 bytes, then each tensor's raw little-endian
    bytes). Returns the bytes written."""
    tags = {torch.bfloat16: "BF16", torch.float32: "F32"}
    shards, size = [[]], 0
    for name, t in tensors:
        nb = t.numel() * t.element_size()
        if shards[-1] and size + nb > HF_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append((name, t))
        size += nb
    total = 0
    for i, items in enumerate(shards, 1):
        fn = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        header, off = {"__metadata__": {"format": "pt"}}, 0
        for name, t in items:
            nb = t.numel() * t.element_size()
            header[name] = {"dtype": tags[t.dtype], "shape": list(t.shape),
                            "data_offsets": [off, off + nb]}
            off += nb
        hb = json.dumps(header).encode()
        hb += b" " * (-len(hb) % 8)
        with open(os.path.join(path, fn), "wb") as f:
            f.write(struct.pack("<Q", len(hb)))
            f.write(hb)
            for _, t in items:
                host = t.detach().contiguous().cpu().reshape(-1)
                f.write(host.view(torch.uint8).numpy())
        total += 8 + len(hb) + off
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return total


def _rss():
    """{VmRSS, RssAnon, RssFile: bytes} of this process (the keys the
    kernel's /proc/self/status reports)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            k, _, v = line.partition(":")
            if k in ("VmRSS", "RssAnon", "RssFile"):
                out[k] = int(v.split()[0]) * 1024
    return out


class _RssPeak:
    """The peaks of ``_rss()`` while the block runs, sampled every 10 ms
    on a thread of its own (joined on exit)."""

    def __enter__(self):
        import threading
        self.start = _rss()
        self.peak = dict(self.start)
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                for k, v in _rss().items():
                    self.peak[k] = max(self.peak.get(k, 0), v)
        self._t = threading.Thread(target=sample, name="pt-rss", daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        for k, v in _rss().items():
            self.peak[k] = max(self.peak.get(k, 0), v)


def _gib(n):
    return f"{n / 2**30:.2f} GiB"


def _rss_text(peak):
    return ", ".join(f"{k} {_gib(v)}" for k, v in sorted(peak.items())) \
        or "not reported"


def _hf_round_trip(torch, label, tensors, config, want, load_fn):
    """Write ``tensors`` as an HF checkpoint, load it with ``load_fn(dir)``
    and hold every parameter of the result to ``want`` ({name: tensor})
    bit for bit. Logs the seconds to write and to load, the host's peak
    RSS in each and the device bytes the load added; deletes the
    directory (under TMPDIR). Returns the loaded model."""
    import shutil
    import tempfile
    need = sum(t.numel() * t.element_size() for _, t in tensors)
    path = tempfile.mkdtemp(prefix="hf_load_")
    try:
        torch.cuda.synchronize()
        with _RssPeak() as wpk:
            t0 = time.monotonic()
            nbytes = write_hf_checkpoint(torch, path, tensors, config)
            t_write = time.monotonic() - t0
        shards = sorted(fn for fn in os.listdir(path)
                        if fn.endswith(".safetensors"))
        dev0 = torch.cuda.memory_allocated()
        with _RssPeak() as lpk:
            t0 = time.monotonic()
            loaded = load_fn(path)
            torch.cuda.synchronize()
            t_load = time.monotonic() - t0
        dev_bytes = torch.cuda.memory_allocated() - dev0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    got = dict(loaded.named_parameters())
    if set(got) != set(want):
        raise AssertionError(f"[{label}] parameters differ: "
                             f"{sorted(set(got) ^ set(want))[:8]}")
    bad = [n for n, p in want.items()
           if got[n].dtype != p.dtype or not torch.equal(got[n], p)]
    if bad:
        raise AssertionError(f"[{label}] reloaded parameters not bit-equal: "
                             f"{bad[:8]}")
    card = card_line()
    log(f"[{label}] {len(shards)} shards, {_gib(nbytes)} written in "
        f"{t_write:.2f} s ({nbytes / t_write / 2**30:.2f} GiB/s; host peak "
        f"{_rss_text(wpk.peak)}; before {_rss_text(wpk.start)}); "
        f"auto_from_pretrained in {t_load:.2f} s ({need / t_load / 2**30:.2f}"
        f" GiB/s; host peak {_rss_text(lpk.peak)}); device bytes "
        f"{_gib(dev_bytes)}; {len(want)} parameters bit-equal ({card})")
    return loaded


def phase_hf_load(torch, dev, model):
    """The serve phase's Llama-2-7B as an HF checkpoint directory (bf16
    shards of at most 5 GB, HF names and [out, in] layouts,
    meta-llama/Llama-2-7b-hf's config.json) read back by
    ``auto_from_pretrained(dir, dtype=torch.bfloat16)`` onto the card,
    every parameter bit-equal to the served model's; then Qwen1.5-MoE-
    A2.7B's widths at HF_MOE_LAYERS layers (the expert stacks, the fp32
    router). Returns the reloaded Llama (None when the temp space forced
    the HF_CUT_LAYERS cut: the router phases then serve the served
    model)."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models.auto import auto_from_pretrained
    need = sum(p.numel() * p.element_size() for p in model.parameters())
    room = shutil.disk_usage(tempfile.gettempdir()).free
    log(f"[hf_load] {tempfile.gettempdir()}: {_gib(room)} free, "
        f"{_gib(need)} needed")
    layers, cfg = None, dict(LLAMA2_7B_HF)
    if room < 1.05 * need:
        layers = HF_CUT_LAYERS
        cfg["num_hidden_layers"] = layers
        log(f"[hf_load] {_gib(room)} of temp space cannot hold "
            f"{_gib(need)}: the first {layers} layers at full width")
    tensors = hf_llama_tensors(model, layers)
    want = {n: p for n, p in model.named_parameters()
            if not n.startswith("model.layers.")
            or int(n.split(".")[2]) < (layers or 10 ** 9)}
    loaded = _hf_round_trip(
        torch, "hf_load", tensors, cfg, want,
        lambda d: auto_from_pretrained(d, dtype=torch.bfloat16, device=dev))
    del tensors
    from paddle_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
    moe = Qwen2MoeForCausalLM(qwen_moe_config(HF_MOE_LAYERS), device=dev,
                              seed=0)
    mwant = dict(moe.named_parameters())
    if mwant["layers.0.mlp.moe.gate_w"].dtype != torch.float32:
        raise AssertionError("the MoE router's gate_w is not fp32")
    mloaded = _hf_round_trip(
        torch, "hf_load qwen1.5-moe", hf_qwen_moe_tensors(moe),
        {**QWEN_MOE_HF, "num_hidden_layers": HF_MOE_LAYERS}, mwant,
        lambda d: auto_from_pretrained(d, dtype=torch.bfloat16, device=dev))
    if mloaded.cfg.sliding_window is not None:
        raise AssertionError("use_sliding_window=false was not honoured")
    del moe, mloaded, mwant
    torch.cuda.empty_cache()
    if layers is not None:
        del loaded
        torch.cuda.empty_cache()
        return None
    return loaded


def _free_cycles(torch):
    """Collect the reference cycles the wrappers close (an engine's
    counted ``step`` holds the engine), then return the freed blocks to
    the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _router_engine(torch, dev, model, **kw):
    from paddle_tpu_torch.serving import LLMEngine
    eng = LLMEngine(model, **ROUTER_ENGINE, device=dev, **kw)
    eng.exe.tick_log = []
    return eng


def _count_steps(eng):
    """Wrap ``eng.step`` so that the launches each of its steps adds are
    summed into the returned dict (the router steps its replicas one after
    another, so each replica's launches are told apart)."""
    from paddle_tpu_torch.ops import cuda as K
    acc, step = {}, eng.step

    def counted():
        before = K.launches()
        try:
            return step()
        finally:
            for k, v in K.launches().items():
                if v != before.get(k, 0):
                    acc[k] = acc.get(k, 0) + v - before.get(k, 0)
    eng.step = counted
    return acc


def _time_handoffs(torch, router):
    """Wrap the replicas' ``extract_sequence`` / ``install_sequence`` and
    the router's ``_deliver`` (ship + validation): seconds of each by
    request id, each timed from a synchronised card (so that the seal's
    fetch does not wait for a replica's queued tick) to its own
    synchronised end, and the payloads' bytes and blocks."""
    rec = {"extract": {}, "deliver": {}, "install": {}, "bytes": 0,
           "blocks": 0, "payloads": 0}

    def add(kind, rid, dt):
        rec[kind][rid] = rec[kind].get(rid, 0.0) + dt

    for rep in router.replicas:
        eng = rep.engine

        def extract(rid, _f=eng.extract_sequence):
            torch.cuda.synchronize()
            t = time.perf_counter()
            p = _f(rid)
            torch.cuda.synchronize()
            add("extract", rid, time.perf_counter() - t)
            rec["bytes"] += p.tokens_bytes
            rec["blocks"] += p.n_blocks
            rec["payloads"] += 1
            return p

        def install(payload, _f=eng.install_sequence):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = _f(payload)
            torch.cuda.synchronize()
            if ok:
                add("install", payload.req.req_id, time.perf_counter() - t)
            return ok
        eng.extract_sequence, eng.install_sequence = extract, install
    deliver = router._deliver

    def timed_deliver(payload, rep):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return deliver(payload, rep)
        finally:
            torch.cuda.synchronize()
            add("deliver", payload.req.req_id, time.perf_counter() - t)
    router._deliver = timed_deliver
    return rec


def _router_mix(np, vocab, rows=None):
    """The serve mix (or its ``rows``), the prefix-sharing requests in one
    session."""
    reqs = serve_requests(np.random.RandomState(0), vocab)
    for i in ROUTER_SESSION:
        reqs[i].session_id = "shared-prefix"
    return reqs if rows is None else [reqs[i] for i in rows]


def _router_run(torch, np, router, reqs, label, path, parallel=False):
    """Serve ``reqs`` through ``router``: every request must finish and
    every replica end quiescent; with ``path``, every kernel of
    ``PATHS[path]`` must have launched in this run. Returns (launch
    counts, {metric: value})."""
    from paddle_tpu_torch.ops import cuda as K
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.monotonic()
    for r in reqs:
        router.add_request(r)
    router.run(parallel=parallel)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = K.launches()
    for r in reqs:
        if not r.done or r.finish_reason not in ("length", "eos"):
            raise AssertionError(f"[{label}] request {r.req_id} did not "
                                 f"finish: {r.finish_reason}")
    router.assert_quiescent()
    for rep in router.replicas:
        rep.engine.assert_quiescent()
    if path is not None:
        missing = _missing(path, counts)
        if missing:
            raise AssertionError(f"[{label}] kernels not launched: "
                                 f"{missing} ({counts})")
    ntok = sum(len(r.tokens) for r in reqs)
    ttft = [r._first_tok_t - r._submit_t for r in reqs]
    stats = dict(tokens_s=ntok / wall, wall=wall,
                 ttft_mean_ms=1e3 * sum(ttft) / len(ttft),
                 ttft_max_ms=1e3 * max(ttft), stats=dict(router.stats))
    log(f"[{label}] {len(reqs)} requests, {ntok} tokens in {wall:.3f} s: "
        f"{stats['tokens_s']:.1f} tokens/s; mean TTFT "
        f"{stats['ttft_mean_ms']:.1f} ms, max {stats['ttft_max_ms']:.1f} ms;"
        f" router {router.stats} ({card_line()})")
    return counts, stats


def _log_replicas(torch, label, router, per):
    """Each replica's launches in the run (graph replays counted) and its
    decode-tick replays."""
    card = card_line()
    for rep in router.replicas:
        ticks = _tick_stats(torch, rep.engine.exe)
        replays = sum(n for n, _, _ in ticks.values())
        log(f"[{label}] replica {rep.name} ({rep.role}): launches "
            f"{dict(sorted(per[rep.name].items()))}; {replays} decode-tick "
            f"graph replays ({card})")


def _handoff_stats(label, rec, np):
    rids = sorted(rec["install"])
    ms = np.array([1e3 * (rec["extract"].get(r, 0.0)
                          + rec["deliver"].get(r, 0.0) + rec["install"][r])
                   for r in rids])
    out = dict(transfers=len(rids), blocks=rec["blocks"],
               bytes=rec["bytes"], payloads=rec["payloads"],
               p50_ms=float(np.percentile(ms, 50)),
               p95_ms=float(np.percentile(ms, 95)),
               extract_ms=1e3 * float(np.mean(list(rec["extract"].values()))),
               deliver_ms=1e3 * float(np.mean(list(rec["deliver"].values()))),
               install_ms=1e3 * float(np.mean(list(rec["install"].values()))))
    log(f"[{label}] handoffs: {out['transfers']} installed, "
        f"{out['blocks']} blocks, {out['bytes'] / 2**20:.1f} MiB moved "
        f"({out['bytes'] / max(out['blocks'], 1) / 2**20:.2f} MiB a block); "
        f"extract + ship/validate + install p50 {out['p50_ms']:.2f} ms, "
        f"p95 {out['p95_ms']:.2f} ms (means: extract {out['extract_ms']:.2f}"
        f", ship/validate {out['deliver_ms']:.2f}, install "
        f"{out['install_ms']:.2f} ms) ({card_line()})")
    return out


def _disagg_arm(torch, dev, np, model, label, path, want, kv_dtype=None):
    """Arm (b) / (c): one prefill-role and one decode-role replica; 12
    transfers, the prefill replica never decodes and the decode replica
    never prefills, greedy rows equal to ``want``."""
    from paddle_tpu_torch.serving import Replica, Router
    kw = {} if kv_dtype is None else dict(kv_dtype=kv_dtype)
    chunk, decode = (("paged_chunk_i8", "paged_decode_i8") if kv_dtype
                     else ("paged_chunk", "paged_decode"))
    router = Router([Replica(_router_engine(torch, dev, model, **kw),
                             name="p0", role="prefill"),
                     Replica(_router_engine(torch, dev, model, **kw),
                             name="d0", role="decode")])
    per = {rep.name: _count_steps(rep.engine) for rep in router.replicas}
    rec = _time_handoffs(torch, router)
    reqs = _router_mix(np, model.cfg.vocab_size)
    counts, stats = _router_run(torch, np, router, reqs, label, path)
    _log_replicas(torch, label, router, per)
    stats["handoff"] = _handoff_stats(label, rec, np)
    if router.stats["transfers"] != 12 or stats["handoff"]["transfers"] != 12:
        raise AssertionError(f"[{label}] {router.stats['transfers']} "
                             f"transfers, not 12")
    p, d = per["p0"], per["d0"]
    if p.get(decode, 0) or p.get("rope_kv", 0) or \
            router.replicas[0].engine.exe.tick_log:
        raise AssertionError(f"[{label}] the prefill replica decoded: {p}")
    if d.get("flash_fwd", 0) or d.get(chunk, 0):
        raise AssertionError(f"[{label}] the decode replica prefilled: {d}")
    same = _greedy_rows(reqs) == want
    log(f"[{label}] greedy rows token for token the single engine's: "
        f"{same}")
    if not same:
        raise AssertionError(f"[{label}] greedy streams differ from the "
                             f"single engine's")
    stats["per_replica"] = per
    del router
    _free_cycles(torch)
    return counts, stats


def phase_router_serve(torch, dev, model, np, serve_reqs, serve_stats):
    """The 12-request serve mix through ``Router`` at the serve phase's
    engine arguments, on ``model`` (hf_load's reload). (a) Two "both"
    replicas sharing the model: sequential rounds (each replica's
    launches counted apart), then ``run(parallel=True)`` (one
    thread per replica; every tick graph was captured when its engine was
    built); (b) disaggregated: a prefill-role and a decode-role replica,
    every sequence handed over sealed (12 transfers). Greedy rows equal the
    serve phase's in each. Logs tokens/s and TTFT beside serve's, the
    handoffs' blocks, bytes and ms, each replica's launches. Returns
    {path: launch counts}."""
    from paddle_tpu_torch.serving import Replica, Router
    want = _greedy_rows(serve_reqs)
    vocab = model.cfg.vocab_size
    out = {}
    for parallel in (False, True):
        label = "router_serve" + (" parallel" if parallel else "")
        router = Router([Replica(_router_engine(torch, dev, model)),
                         Replica(_router_engine(torch, dev, model))])
        per = ({} if parallel else
               {rep.name: _count_steps(rep.engine) for rep in router.replicas})
        reqs = _router_mix(np, vocab)
        counts, stats = _router_run(torch, np, router, reqs, label,
                                    None if parallel else "router_serve",
                                    parallel=parallel)
        if not parallel:
            out["router_serve"] = counts
            _log_replicas(torch, label, router, per)
        hits = sum(rep.engine.mgr.cache_stats.get("token_hits", 0)
                   for rep in router.replicas)
        spread = [rep.engine.stats["ticks"] for rep in router.replicas]
        same = _greedy_rows(reqs) == want
        log(f"[{label}] greedy rows token for token serve's: {same}; "
            f"prefix token hits {hits}; decode ticks per replica {spread}; "
            f"{stats['tokens_s']:.1f} tokens/s against serve's "
            f"{serve_stats['tokens_s']:.1f} ({card_line()})")
        if not same:
            raise AssertionError(f"[{label}] greedy streams differ from the "
                                 f"serve phase's")
        if hits <= 0 or min(spread) <= 0:
            raise AssertionError(f"[{label}] no prefix hit ({hits}) or an "
                                 f"idle replica ({spread})")
        del router
        _free_cycles(torch)
    out["router_serve_disagg"], _ = _disagg_arm(
        torch, dev, np, model, "router_serve disagg", "router_serve_disagg",
        want)
    return out


def phase_router_serve_i8(torch, dev, model, np, quant_reqs):
    """Arm (c): arm (b) over int8 pools on quant_serve's weight-only int8
    model; its greedy rows equal quant_serve's."""
    counts, _ = _disagg_arm(torch, dev, np, model, "router_serve i8",
                            "router_serve_i8", _greedy_rows(quant_reqs),
                            kv_dtype="int8")
    return counts


def _corrupt(ctx):
    """A zeroed COPY of the shipped payload (the source stays pristine for
    the retry)."""
    import torch
    p = ctx["payload"]
    return dataclasses.replace(p, k=torch.zeros_like(p.k))


def phase_router_check(torch, dev, model, np, serve_reqs):
    """The router's failure paths at Llama-2-7B width on the card, over
    three engines of the serve geometry (p0, d0, d1) reused across the
    cases: (1) ``router.kv_partial`` corrupts the first shipment:
    validation rejects it, one retry installs the pristine payload, the
    greedy rows equal serve's; (2) ``router.kv_transfer`` faults one
    extraction: the request is requeued once, no block leaks; (3) three
    "both" replicas with ``snapshot_every=1``: r0 dies, its requests are
    requeued once each, then r1 dies and the request that lost both is
    restored from its snapshot, none fails; (4) ``drain_replica`` on the
    prefill replica with a 300-token prompt mid-chunk flushes its
    handoffs; (5) a bf16 replica refuses an int8 payload by name
    (validation and install); every engine ends quiescent. Returns the
    launch counts."""
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import (KVTransferError, Replica, Request,
                                          Router, validate_payload)
    from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
    card = card_line()
    p0, d0, d1 = (_router_engine(torch, dev, model) for _ in range(3))
    engines = [p0, d0, d1]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.monotonic()

    def mix(rows):
        return [Request(serve_reqs[i].prompt, max_new_tokens=32)
                for i in rows]

    def quiescent():
        for e in engines:
            e.assert_quiescent()

    def series(name):
        return {k: v for k, v in _series_now(name).items() if v}

    def pd(a, b):
        return Router([Replica(a, name="p0", role="prefill"),
                       Replica(b, name="d0", role="decode")])
    # (1) a partial shipment, retried once from the pristine payload
    retries0 = series("router_transfer_retries_total")
    r = pd(p0, d0)
    reqs = mix(CHECK_ROWS)
    with FAULTS.scope("router.kv_partial", on={0}, action=_corrupt):
        for q in reqs:
            r.add_request(q)
        r.run()
    r.assert_quiescent()
    quiescent()
    retries = {k: v - retries0.get(k, 0) for k, v in
               series("router_transfer_retries_total").items()
               if v != retries0.get(k, 0)}
    want = [list(serve_reqs[i].tokens) for i in CHECK_ROWS]
    same = [list(q.tokens) for q in reqs] == want
    log(f"[router_check] kv_partial: retries {retries}, transfers "
        f"{r.stats['transfers']}, streams equal serve's: {same} ({card})")
    if retries != {("d0", "partial"): 1} or r.stats["transfers"] != 4 \
            or not same:
        raise AssertionError("router.kv_partial was not caught and retried "
                             "exactly once")
    # (2) a failed extraction: requeued, re-prefilled, nothing leaks
    r = pd(p0, d0)
    with FAULTS.scope("router.kv_transfer", exc=InjectedFault, on={1}):
        reqs = mix(CHECK_ROWS)
        for q in reqs:
            r.add_request(q)
        r.run()
    r.assert_quiescent()
    quiescent()
    log(f"[router_check] kv_transfer: requeues {r.stats['requeues']}, "
        f"transfers {r.stats['transfers']}, all finished "
        f"{all(q.done for q in reqs)}, streams equal serve's: "
        f"{[list(q.tokens) for q in reqs] == want} ({card})")
    if r.stats["requeues"] != 1 or not all(len(q.tokens) == 32
                                           for q in reqs):
        raise AssertionError("router.kv_transfer did not requeue once")
    # (3) two replica deaths; the second restores from a snapshot
    restores0 = _series_now("router_session_restores_total").get((), 0)
    r = Router([Replica(e, name=f"r{i}") for i, e in enumerate(engines)],
               snapshot_every=1)
    seen = {"r0": 0, "r1": 0}

    def kill(ctx):
        name = ctx["replica"]
        if name in seen:
            seen[name] += 1
            if (name, seen[name]) in (("r0", 2), ("r1", 5)):
                raise InjectedFault(f"induced {name} death")
    with FAULTS.scope("router.replica_death", action=kill):
        reqs = mix(DEATH_ROWS)
        for q in reqs:
            r.add_request(q)
        r.run()
    r.assert_quiescent()
    quiescent()
    restores = _series_now("router_session_restores_total").get(
        (), 0) - restores0
    failed = [q.req_id for q in reqs if q.finish_reason == "replica_death"]
    log(f"[router_check] replica deaths {r.stats['deaths']}: requeued once "
        f"each {sorted(r._requeued)}, restored from snapshots {restores}, "
        f"failed {failed}, tokens {[len(q.tokens) for q in reqs]} ({card})")
    if (r.stats["deaths"] != 2 or restores < 1 or failed
            or not all(len(q.tokens) == 32 for q in reqs)
            or r.stats["requeues"] != len(r._requeued) + restores):
        raise AssertionError("replica death did not requeue exactly once "
                             "and restore after the second death")
    # (4) draining the prefill replica mid-chunk flushes its handoffs
    r = pd(p0, d1)
    reqs = [Request(np.random.RandomState(7).randint(3, model.cfg.vocab_size,
                                                     size=300),
                    max_new_tokens=32), *mix((0, 1))]
    for q in reqs:
        r.add_request(q)
    r.step()
    if not p0.prefilling:
        raise AssertionError("the 300-token prompt is not mid-chunk")
    r.drain_replica("p0")
    flushed = not p0.has_work() and not r._pending
    r.run()
    r.assert_quiescent()
    quiescent()
    p0._draining = False
    log(f"[router_check] drain_replica(p0) mid-chunk: flushed {flushed}, "
        f"transfers {r.stats['transfers']}, tokens "
        f"{[len(q.tokens) for q in reqs]} ({card})")
    if not flushed or r.stats["transfers"] != 3:
        raise AssertionError("drain_replica on the prefill replica did not "
                             "flush its handoffs")
    # (5) a bf16 replica refuses an int8 payload by name
    q8 = _router_engine(torch, dev, model, kv_dtype="int8",
                        prefill_only=True)
    q8.add_request(Request(serve_reqs[0].prompt, max_new_tokens=32,
                           req_id=0))
    while not q8.active.any():
        q8.step()
    payload = q8.extract_sequence(0)
    refused = []
    try:
        validate_payload(payload, d0)
    except KVTransferError as e:
        refused.append(f"validate: {e}")
    try:
        d0.install_sequence(payload)
    except ValueError as e:
        refused.append(f"install: {e}")
    q8.assert_quiescent()
    quiescent()
    log(f"[router_check] int8 payload into a bf16 replica: {refused}")
    if len(refused) != 2 or "dtype mismatch" not in refused[0] \
            or "quantization" not in refused[1]:
        raise AssertionError("a bf16 replica did not refuse an int8 payload")
    torch.cuda.synchronize()
    counts = K.launches()
    missing = _missing("router_check", counts)
    if missing:
        raise AssertionError(f"[router_check] kernels not launched: "
                             f"{missing} ({counts})")
    log(f"[router_check] every replica quiescent; {time.monotonic() - t0:.1f}"
        f" s; launches {counts} ({card})")
    del q8, engines, p0, d0, d1
    _free_cycles(torch)
    return counts


# ------------------------------------- GPTQ, smoothing, speculative, remat
GPTQ_CALIB = (2, 512)       # calibration ids [B, S] from RandomState(19)
GPTQ_HELD = (4, 128)        # the held-out quality batch, same generator
GPTQ_CHECK_COLS = 32        # output channels gptq_check runs on the CPU
GPTQ_CODE_SHARE = 0.999     # codes the card and the CPU must agree on
# smoothed vs unsmoothed bf16 logits, as a share of their RMS: the fold
# rescales every norm weight and qkv / gate_up row in fp32 and rounds them
# to bf16 again, which moves the logits by bf16 rounding alone, so the
# whole-path bf16 limit (CHECK_REL) holds it; gptq_check holds the fold
# exact in float32
SMOOTH_REL = CHECK_REL
SMOOTH_FP32_REL = 1e-4      # float32 logits, smoothed vs not (4 layers)
SMOOTH_CHECK_RTOL = 1e-4    # folded weights, card vs CPU (fp32, 4 layers)
SMOOTH_CHECK_TOKENS = 128   # calibration tokens a row of that check
GPTQ_PROJ = (("self_attn", "qkv_proj", "qkv"), ("self_attn", "o_proj", "o"),
             ("mlp", "gate_up_proj", "gate_up"), ("mlp", "down_proj", "down"))


def gptq_inputs(torch, dev, np, vocab):
    """(calibration ids [2, 512], held-out ids [4, 128]) on the card."""
    rs = np.random.RandomState(19)
    calib = torch.as_tensor(rs.randint(3, vocab, GPTQ_CALIB), device=dev)
    held = torch.as_tensor(rs.randint(3, vocab, GPTQ_HELD), device=dev)
    return calib, held


def _first_layer_mse(torch, model, qmodel, rec0):
    """{projection: mean squared error of X @ dequant(Wq) against X @ W}
    over the first layer's captured calibration activations X."""
    out = {}
    l0, q0 = model.model.layers[0], qmodel.model.layers[0]
    with torch.no_grad():
        for owner, name, key in GPTQ_PROJ:
            w = getattr(getattr(l0, owner), name).float()
            wq = getattr(getattr(q0, owner), name).dequantize(torch.float32)
            x = rec0[key]
            out[name] = float(((x @ wq - x @ w) ** 2).mean())
    return out


def phase_gptq_serve(torch, dev, model, np, rec0):
    """Three quantized copies of the served Llama-2-7B, each served with
    the serve mix over a bf16 pool (module docstring). ``rec0``: the first
    layer's calibration records of the unquantized model. Returns the GPTQ
    arm's launch counts."""
    import copy

    from paddle_tpu_torch.serving.quant import (quant_quality,
                                                quantize_for_serving,
                                                smooth_for_serving)
    card = card_line()
    calib, held = gptq_inputs(torch, dev, np, model.cfg.vocab_size)
    with torch.no_grad():
        ref = model(held).float()
    m = copy.deepcopy(model)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    smooth_for_serving(m, calib_ids=calib)
    torch.cuda.synchronize()
    t_smooth = time.monotonic() - t0
    with torch.no_grad():
        err = _rms(m(held).float() - ref) / _rms(ref)
    del m
    torch.cuda.empty_cache()
    log(f"[gptq_serve] calibrated smoothing in {t_smooth:.2f} s: smoothed "
        f"bf16 logits on the held-out {list(held.shape)} batch "
        f"{err:.5f} of the unsmoothed logits' RMS from them (limit "
        f"{SMOOTH_REL}; {card})")
    if not err <= SMOOTH_REL:
        raise AssertionError(f"calibrated smoothing moved the bf16 logits "
                             f"by {err} of their RMS")
    arms = (("gptq_int4", "gptq_int4", dict(calib_ids=calib)),
            ("smoothed weight_only_int8", "weight_only_int8",
             dict(smooth=True, calib_ids=calib)),
            ("rtn weight_only_int4", "weight_only_int4", {}))
    out, mse = None, {}
    for label, algo, kw in arms:
        m = copy.deepcopy(model)
        timings = {}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        quantize_for_serving(m, algo, timings=timings, **kw)
        torch.cuda.synchronize()
        q_s = time.monotonic() - t0
        with torch.no_grad():
            qual = quant_quality(ref, m(held).float())
        # the smoothed arm's weights read X / s, not the captured X
        mse[label] = ({} if kw.get("smooth") else
                      _first_layer_mse(torch, model, m, rec0))
        counts, reqs, st = phase_serve(torch, dev, m, np, "gptq_serve",
                                       label=f"gptq_serve {label}")
        short = [r.req_id for r in reqs if len(r.tokens) != r.max_new_tokens]
        if short:
            raise AssertionError(f"gptq_serve {label}: requests {short} "
                                 f"ended short")
        split = ", ".join(f"{k} {v:.2f} s" for k, v in sorted(
            timings.items()))
        log(f"[gptq_serve] {label}: quantized in {q_s:.2f} s"
            f"{f' ({split})' if split else ''}; weights "
            f"{st['weight_bytes'] / 2**30:.3f} GiB; held-out logit MSE "
            f"{qual['logit_mse']:.6f}, greedy match "
            f"{qual['greedy_match_rate']:.4f}; first layer's calibration "
            f"MSE {', '.join(f'{k} {v:.4e}' for k, v in mse[label].items())}"
            f"; {st['tokens_s']:.1f} tokens/s; launches {counts} ({card})")
        if out is None:
            out = counts
        del m
        torch.cuda.empty_cache()
    worse = [n for n, v in mse["gptq_int4"].items()
             if not v < mse["rtn weight_only_int4"][n]]
    if worse:
        raise AssertionError(f"GPTQ int4 not below RTN int4 on the "
                             f"calibration activations: {worse} {mse}")
    return out


def phase_gptq_check(torch, dev, model, np, rec0):
    """GPTQ and calibrated smoothing on the card against the CPU path
    (module docstring)."""
    import copy

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import gptq_quantize
    from paddle_tpu_torch.serving.quant import smooth_for_serving
    card = card_line()
    lyr = model.model.layers[0]
    for owner, name, key in GPTQ_PROJ:
        w = getattr(getattr(lyr, owner), name)[:, :GPTQ_CHECK_COLS].float()
        x = rec0[key]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = gptq_quantize(w, x, bits=4)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        want = gptq_quantize(w.cpu(), x.cpu(), bits=4)
        t2 = time.monotonic()
        differ = int((got.unpack().cpu() != want.unpack()).sum())
        share = 1.0 - differ / want.unpack().numel()
        same_scale = torch.equal(got.scale.cpu(), want.scale)
        log(f"[gptq_check] layer 0 {name} [{w.shape[0]}, "
            f"{GPTQ_CHECK_COLS}] over X {list(x.shape)}: scales bit-equal "
            f"{same_scale}; {differ} of {want.unpack().numel()} codes differ "
            f"(share equal {share:.6f}, limit {GPTQ_CODE_SHARE}); card "
            f"{t1 - t0:.2f} s, CPU loop {t2 - t1:.2f} s ({card})")
        if not same_scale or share < GPTQ_CODE_SHARE:
            raise AssertionError(f"gptq_check {name}: card and CPU disagree")
    m = LlamaForCausalLM(LlamaConfig.llama2_7b(
        num_hidden_layers=CHECK_LAYERS, dtype=torch.float32), device=dev,
        seed=0)
    cpu = copy.deepcopy(m).to("cpu")
    calib = gptq_inputs(torch, dev, np, m.cfg.vocab_size)[0][
        :, :SMOOTH_CHECK_TOKENS]
    with torch.no_grad():
        before = m(calib).float()
    t0 = time.monotonic()
    smooth_for_serving(m, calib_ids=calib)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    with torch.no_grad():
        kept = _rms(m(calib).float() - before) / _rms(before)
    del before
    log(f"[gptq_check] the {CHECK_LAYERS}-layer fp32 model's logits after "
        f"calibrated smoothing: {kept:.3e} of their RMS from the unsmoothed "
        f"ones (limit {SMOOTH_FP32_REL}; {card})")
    if not kept <= SMOOTH_FP32_REL:
        raise AssertionError(f"calibrated smoothing changed the fp32 "
                             f"function by {kept} of the logits' RMS")
    t_card, t1 = t1 - t0, time.monotonic()
    smooth_for_serving(cpu, calib_ids=calib.cpu())
    t2 = time.monotonic()
    want = dict(cpu.named_parameters())
    worst = (0.0, "")
    for name, p in m.named_parameters():
        a, b = p.detach().cpu(), want[name].detach()
        rel = float(((a - b).abs() / (b.abs() + 1e-30)).max())
        worst = max(worst, (rel, name))
        if not torch.allclose(a, b, rtol=SMOOTH_CHECK_RTOL, atol=1e-7):
            raise AssertionError(f"smoothing {name}: card and CPU folds "
                                 f"differ by {rel}")
    log(f"[gptq_check] calibrated smoothing of a {CHECK_LAYERS}-layer fp32 "
        f"copy at 7B width over {list(calib.shape)} ids: every folded "
        f"weight within rtol {SMOOTH_CHECK_RTOL} of the CPU's (largest "
        f"relative difference {worst[0]:.3e} in {worst[1]}); card "
        f"{t_card:.2f} s, CPU {t2 - t1:.2f} s ({card})")
    del m, cpu
    torch.cuda.empty_cache()


SPEC_PROMPTS = (64, 85, 107, 128)
SPEC_NEW, SPEC_GAMMA = 64, 4
# the float32 exactness checks run the target's first 8 of its 32 layers
# (the default run's time limit)
SPEC_FP32_LAYERS = 8


def _shared_prefix(got, ref, start):
    """Leading tokens from ``start`` on where ``got`` equals ``ref``."""
    same = (got[0, start:] == ref[0, start:]).cpu().tolist()
    return same.index(False) if False in same else len(same)


def phase_spec_generate(torch, dev, model, np):
    """The standalone speculative API (module docstring): (1) on the served
    bf16 model, the speed, rounds and acceptance of ``speculative_generate``
    with both drafts beside ``generate``, and how many leading tokens of
    each bf16 stream equal ``generate``'s (a 5-token verify rounds
    differently from one-token decode in bf16); (2) on float32 copies of
    the target (its first SPEC_FP32_LAYERS layers) and the TinyLlama
    draft (whole): every stream equal
    to ``generate``'s, the batched rows to their solo runs,
    ``speculative_sample`` repeating itself at one seed and equal to
    ``generate`` at temperature 0. Returns the bf16 run's launch counts."""
    from paddle_tpu_torch.models.decoding import generate
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.models.speculative import (
        speculative_generate, speculative_generate_batched,
        speculative_sample)
    from paddle_tpu_torch.ops import cuda as K
    card = card_line()
    tiny = LlamaForCausalLM(tinyllama_config(torch), device=dev, seed=7)
    rs = np.random.RandomState(19)
    prompts = [rs.randint(3, model.cfg.vocab_size, n) for n in SPEC_PROMPTS]
    padded = np.zeros((len(prompts), max(SPEC_PROMPTS)), np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lens = np.asarray(SPEC_PROMPTS)
    ntok = SPEC_NEW * len(prompts)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = fn()
        torch.cuda.synchronize()
        return got, time.monotonic() - t0

    def greedy(target):
        refs, wall = [], 0.0
        for p in prompts:
            r, s = timed(lambda: generate(target, p[None], SPEC_NEW))
            refs.append(r)
            wall += s
        return refs, wall

    torch.cuda.synchronize()
    K.reset_launches()
    refs, gen_s = greedy(model)
    log(f"[spec_generate] bf16 generate (greedy, no draft): "
        f"{ntok / gen_s:.1f} tokens/s over {len(prompts)} prompts of "
        f"{list(SPEC_PROMPTS)} tokens, {SPEC_NEW} new each ({card})")
    for label, draft in (("self-draft", model), ("tinyllama draft", tiny)):
        agg = dict(rounds=0, proposed=0, accepted=0, draft_s=0.0,
                   verify_s=0.0)
        wall, agree = 0.0, []
        for i, p in enumerate(prompts):
            (got, st), s = timed(lambda: speculative_generate(
                model, draft, p[None], SPEC_NEW, SPEC_GAMMA))
            wall += s
            agree.append(_shared_prefix(got, refs[i], len(p)))
            for k in agg:
                agg[k] += st[k]
        n = max(agg["rounds"], 1)
        log(f"[spec_generate] bf16 {label}: {ntok / wall:.1f} tokens/s, "
            f"{agg['rounds']} rounds, acceptance {agg['accepted']} / "
            f"{agg['proposed']} = "
            f"{agg['accepted'] / max(agg['proposed'], 1):.3f}, draft "
            f"{1e3 * agg['draft_s'] / n:.2f} ms and verify "
            f"{1e3 * agg['verify_s'] / n:.2f} ms a round (wall); leading "
            f"tokens equal to bf16 generate's {agree} of {SPEC_NEW} "
            f"({card})")
    counts = K.launches()
    missing = _missing("spec_generate", counts)
    if missing:
        raise AssertionError(f"kernels not launched on spec_generate: "
                             f"{missing} ({counts})")
    m32 = fp32_copy(torch, model, SPEC_FP32_LAYERS)
    t32 = fp32_copy(torch, tiny)
    del tiny
    refs, gen_s = greedy(m32)
    bad = []
    for label, draft in (("self-draft", m32), ("tinyllama draft", t32)):
        same = []
        for i, p in enumerate(prompts):
            got, st = speculative_generate(m32, draft, p[None], SPEC_NEW,
                                           SPEC_GAMMA)
            same.append(bool(torch.equal(got, refs[i])))
        (got_b, stb), s_b = timed(lambda: speculative_generate_batched(
            m32, draft, padded, prompt_lens=lens, max_new_tokens=SPEC_NEW,
            gamma=SPEC_GAMMA))
        rows = [bool(torch.equal(got_b[i, :lens[i] + SPEC_NEW], refs[i][0]))
                for i in range(len(prompts))]
        log(f"[spec_generate] fp32 {label}: streams equal to generate's "
            f"{same}; batched over the ragged {len(prompts)} "
            f"({ntok / s_b:.1f} tokens/s, {stb['rounds']} rounds, acceptance "
            f"{stb['acceptance_rate']:.3f}): rows equal to their solo runs "
            f"{rows} ({card})")
        if not all(same) or not all(rows):
            bad.append(label)
        if draft is m32 and stb["accepted"] != stb["proposed"]:
            bad.append(f"{label} rejected a proposal")
    (s1, st1), t1 = timed(lambda: speculative_sample(
        m32, t32, prompts[0][None], SPEC_NEW, SPEC_GAMMA, temperature=1.0,
        seed=5))
    s2, _ = speculative_sample(m32, t32, prompts[0][None], SPEC_NEW,
                               SPEC_GAMMA, temperature=1.0, seed=5)
    s0, _ = speculative_sample(m32, m32, prompts[0][None], SPEC_NEW,
                               SPEC_GAMMA, temperature=0.0, seed=5)
    log(f"[spec_generate] fp32 speculative_sample (tinyllama draft, "
        f"temperature 1.0, seed 5): {SPEC_NEW / t1:.1f} tokens/s, "
        f"{st1['rounds']} rounds, acceptance {st1['acceptance_rate']:.3f}; "
        f"the same tokens twice: {bool(torch.equal(s1, s2))}; temperature 0 "
        f"equal to generate: {bool(torch.equal(s0, refs[0]))} ({card})")
    if not torch.equal(s1, s2):
        bad.append("speculative_sample repeat")
    if not torch.equal(s0, refs[0]):
        bad.append("speculative_sample at temperature 0")
    del m32, t32
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"spec_generate: {bad}")
    return counts


REMAT_RUNS = ((None, False), ("hidden", False), ("no_ffn", False),
              ("dots", False), (None, True))
REMAT_TIMED = 4             # steps timed after the two that are compared


def _step_grads(model, scanned, layers):
    """{name: gradient} with a stacked gradient split into the loop's
    per-layer names."""
    out = {}
    for n, p in model.named_parameters():
        if scanned and ".layers_stacked." in n:
            for i in range(layers):
                out[n.replace("layers_stacked", f"layers.{i}")] = p.grad[i]
        else:
            out[n] = p.grad
    return out


def phase_remat_train(torch, dev, np):
    """The headline train step under every remat policy and with scanned
    layers (module docstring). Returns the phase's launch counts."""
    import contextlib

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    card = card_line()
    cfg0 = train_config()
    ids, labels = train_batch(torch, dev, np, cfg0)
    L = cfg0.num_hidden_layers
    K.reset_launches()
    ref, rows, diffs = None, {}, []
    for pol, scan in REMAT_RUNS:
        label = f"{pol}{' scanned' if scan else ''}"
        cfg = dataclasses.replace(cfg0, remat=True, remat_policy=pol,
                                  scan_layers=scan)
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        opt = O.AdamW(learning_rate=3e-4, weight_decay=0.1,
                      grad_clip=O.ClipGradByGlobalNorm(1.0),
                      multi_precision=True)
        state = init_state(model, opt)
        fwd = {}

        def loss_fn(m, i, lab, fwd=fwd):
            loss = m.loss(i, lab)
            fwd.update(K.launches())
            return loss

        step = make_train_step(loss_fn, opt)
        packed = {}

        def pack(t, packed=packed):
            st = t.untyped_storage()
            packed[st.data_ptr()] = st.nbytes()
            return t

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        losses, grads, ms = [], [], []
        for s in range(2):
            hooks = (torch.autograd.graph.saved_tensors_hooks(
                pack, lambda t: t) if s == 0 else contextlib.nullcontext())
            before = K.launches()
            t0 = time.monotonic()
            with hooks:
                state, loss = step(state, ids, labels)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.monotonic() - t0))
            after = K.launches()
            if s == 0:
                bwd = {k: after[k] - fwd[k] for k in after}
                fw = {k: fwd[k] - before[k] for k in after}
            losses.append(loss)
            # set_to_none: the next step's backward writes new tensors,
            # so these stay this step's gradients
            grads.append(_step_grads(model, scan, L))
        # then REMAT_TIMED more steps for the step time
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(REMAT_TIMED):
            state, _ = step(state, ids, labels)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.monotonic() - t0) / REMAT_TIMED
        peak = torch.cuda.max_memory_allocated()
        retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                                0) - retries0
        rows[label] = dict(saved=sum(packed.values()), bwd=bwd, fwd=fw)
        log(f"[remat_train] {label}: losses "
            f"{' '.join(f'{float(x):.6f}' for x in losses)}; "
            f"{step_ms:.1f} ms/step over {REMAT_TIMED} more steps (steps 1, "
            f"2: {ms[0]:.1f}, {ms[1]:.1f} ms); peak allocated "
            f"{peak / 2**30:.2f} GiB ({retries} allocator retries, each a "
            f"cache flush); saved for the backward "
            f"{rows[label]['saved'] / 2**30:.4f} GiB; K2 launches forward "
            f"{fw['flash_fwd']}, backward {bwd['flash_fwd']}; K7 forward "
            f"{fw['rope']}, backward {bwd['rope']}; K1 backward "
            f"{bwd['rms_norm']}; K5a/K5b backward {bwd['flash_bwd_dq']}/"
            f"{bwd['flash_bwd_dkv']} ({card})")
        if ref is None:
            ref = (losses, grads)
        else:
            for s in range(2):
                if not torch.equal(losses[s], ref[0][s]):
                    diffs.append((label, s, "loss",
                                  float((losses[s] - ref[0][s]).abs())))
                for n, g in grads[s].items():
                    if not torch.equal(g, ref[1][s][n]):
                        diffs.append((label, s, n, float(
                            (g.float() - ref[1][s][n].float()).abs().max())))
        del state, model, grads, opt, step
        torch.cuda.empty_cache()
    counts = K.launches()
    runs = [f"{p}{' scanned' if s else ''}" for p, s in REMAT_RUNS]
    log(f"[remat_train] loss and every gradient of both steps bit-identical "
        f"across {runs}: {not diffs}"
        f"{f' (largest differences {diffs[:8]})' if diffs else ''}; "
        f"launches {counts} ({card})")
    saved = [rows[str(p)]["saved"] for p in (None, "hidden", "no_ffn",
                                             "dots")]
    if diffs:
        raise AssertionError(f"remat_train: policies differ: {diffs[:8]}")
    if not saved[0] < saved[1] < saved[2] < saved[3]:
        raise AssertionError(f"remat_train: saved bytes not growing "
                             f"None < hidden < no_ffn < dots: {saved}")
    if not rows["dots"]["bwd"]["flash_fwd"] <= \
            rows["hidden"]["bwd"]["flash_fwd"]:
        raise AssertionError(f"remat_train: dots launched K2 more often in "
                             f"the backward than hidden: {rows}")
    missing = _missing("remat_train", counts)
    if missing:
        raise AssertionError(f"kernels not launched on remat_train: "
                             f"{missing} ({counts})")
    return counts


# ------------------------------------------------------ the trainer stack
TRAINER_STEPS = 8           # steps of each trainer_fit arm (logged at 4, 8)
TOKEN_FILE_TOKENS = 1 << 26  # the seeded uint16 token file (~64 M tokens)
CKPT_LAYERS = 4             # ckpt_resume: the train width at 4 layers
CKPT_STEPS = 4              # saves every 2 steps; the crash at the 4th step
LORA_TRAIN_SHAPE = (1, 2048, 32, 128)   # Llama-2-7B's q/k/v at 1 x 2048
LORA_STEPS = 4
FP8_STEPS = 6
FP8_BOUND = (0.15, 0.05)    # tests/test_fp8.py: |a - b| < 0.15 |a| + 0.05
# fp8_matmul on the card against its plain version, norm-wise: max |card -
# plain| over max |plain| of each product. Both multiply the same fp8
# codes; the plain version sums them exactly in fp32, the card's fp8
# tensor cores with a shorter accumulator: over dw's 8192-term sums an
# element is off by up to ~4% of its own (small) value, ~0.5% of the
# product's largest (first card reading; the elementwise bf16 rule failed
# on dw at 0.036)
FP8_CHECK_REL = 1e-2
# the fp8 model's loss on the card against the same run with plain
# products (the same fp8 codes, exact fp32 sums), relative, every step
FP8_PATH_REL = 0.05
# the accumulated (2 x 2048, twice) loss and gradients against one
# 4 x 2048 batch's: both sum the same bf16 per-token terms, in fp32
# (accumulation) or bf16 (the single batch's gradients are bf16), so they
# differ by bf16 rounding, ~2^-8 of a value
ACCUM_LOSS_REL = 1e-3
ACCUM_GRAD_REL = 0.02


def token_file(np, tmp):
    """A seeded uint16 token file of TOKEN_FILE_TOKENS ids < 32000 under
    ``tmp`` (written once a run)."""
    path = os.path.join(tmp, "tokens.bin")
    if not os.path.exists(path):
        t0 = time.monotonic()
        np.random.RandomState(0).randint(
            0, 32000, TOKEN_FILE_TOKENS, dtype=np.uint16).tofile(path)
        log(f"[token_file] {TOKEN_FILE_TOKENS} uint16 tokens "
            f"({os.path.getsize(path) / 2**20:.0f} MiB) in "
            f"{time.monotonic() - t0:.1f} s")
    return path


def _adamw(O):
    return O.AdamW(learning_rate=3e-4, weight_decay=0.1,
                   grad_clip=O.ClipGradByGlobalNorm(1.0), multi_precision=True)


def _lm_loss(m, i, lab):
    return m.loss(i.long(), lab.long())


def _flight_losses():
    from paddle_tpu_torch.observability.flight import FLIGHT
    return [e["loss"] for e in FLIGHT.events() if e["kind"] == "train.step"]


def phase_trainer_fit(torch, dev, np, tmp):
    """``Trainer.fit`` on the headline model (``train_config()``: bench.py's
    0.738 B Llama), AdamW with fp32 masters, batch 4 x 2048 from
    ``TokenBinDataset`` (one reader thread: a deterministic stream) over
    the seeded token file through ``prefetch_to_device`` (depth 2), in
    three arms from seed 0: pipeline_depth 0, 2, and 2 with
    device_double_buffer. Every step's loss bit-identical across the arms;
    then the accumulation check (module docstring). Returns the launch
    counts of the three arms."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.io import TokenBinDataset, prefetch_to_device
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               num_flops_per_token)
    from paddle_tpu_torch.observability import METRICS
    from paddle_tpu_torch.observability.flight import FLIGHT
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import Trainer, TrainerArgs
    card = card_line()
    cfg = train_config()
    path = token_file(np, tmp)
    b, s = TRAIN_SHAPE[:2]
    fpt = num_flops_per_token(cfg, s)
    arms = (("depth 0", 0, False), ("depth 2", 2, False),
            ("depth 2, double buffer", 2, True))
    traces, finals = [], []
    K.reset_launches()
    for label, depth, dbuf in arms:
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        tr = Trainer(model, _adamw(O), _lm_loss, TrainerArgs(
            max_steps=TRAINER_STEPS, log_every=TRAINER_STEPS // 2,
            flops_per_token=fpt, pipeline_depth=depth,
            device_double_buffer=dbuf), device=dev)
        data = TokenBinDataset(path, b, s, seed=0, num_workers=1,
                               num_batches=TRAINER_STEPS)
        FLIGHT.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with prefetch_to_device(iter(data), depth=2, device=dev) as p:
            tr.fit(p)
        torch.cuda.synchronize()
        losses = _flight_losses()
        rec = tr.history[-1]
        g = METRICS.snapshot()["gauges"]
        log(f"[trainer_fit] {label}: losses "
            f"{' '.join(f'{x:.6f}' for x in losses)}; steps "
            f"{TRAINER_STEPS // 2 + 1}-{TRAINER_STEPS}: "
            f"{1e3 / rec['steps_per_sec']:.1f} ms/step, "
            f"{rec['tokens_per_sec']:.0f} tokens/s, train_mfu "
            f"{100 * g['train_mfu']:.2f}% (overlap-aware "
            f"{100 * g['train_mfu_overlap']:.2f}%) of the card's row "
            f"{tr.peak_flops / 1e12:.0f} TFLOP/s; host idle (blocked on "
            f"loss fetches) {tr.host_wait_s:.3f} of {tr.fit_s:.3f} s = "
            f"{100 * tr.host_wait_s / tr.fit_s:.1f}% of the fit; peak "
            f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({card})")
        if len(losses) != TRAINER_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"trainer_fit {label}: losses {losses}")
        if not rec.get("mfu", 0) > 0:
            raise AssertionError(f"trainer_fit {label}: no MFU: {rec}")
        traces.append(losses)
        finals.append(model.lm_head.detach()[:64].clone())
        del tr, model
        torch.cuda.empty_cache()
    counts = K.launches()
    same = all(t == traces[0] for t in traces) and all(
        torch.equal(f, finals[0]) for f in finals)
    log(f"[trainer_fit] every loss and the final lm_head bit-identical "
        f"across the three arms: {same}; launches over the arms {counts}")
    if not same:
        raise AssertionError(f"trainer_fit arms differ: {traces}")
    missing = _missing("trainer_fit", counts)
    if missing:
        raise AssertionError(f"kernels not launched on trainer_fit: "
                             f"{missing} ({counts})")
    # grad_accum_steps=2 over 2 x 2048 halves against one 4 x 2048 batch,
    # through the Trainer's own accumulation
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    ids, labels = train_batch(torch, dev, np, cfg)
    tr = Trainer(model, _adamw(O), _lm_loss, TrainerArgs(
        grad_accum_steps=2), device=dev)
    la, ga = tr._grads([(ids[:2], labels[:2]), (ids[2:], labels[2:])])
    ga = {n: ga[n] for n in GRAD_NAMES}
    lf, _ = tr._grads([(ids, labels)])
    params = dict(model.named_parameters())
    worst = 0.0
    for n in GRAD_NAMES:
        full = params[n].grad.float()
        worst = max(worst, _rms(ga[n] - full) / _rms(full))
    rel = abs(float(la) - float(lf)) / abs(float(lf))
    log(f"[trainer_fit] grad_accum 2 x (2 x 2048) against 1 x (4 x 2048): "
        f"loss {float(la):.6f} vs {float(lf):.6f} (rel {rel:.2e}, limit "
        f"{ACCUM_LOSS_REL}); gradients {list(GRAD_NAMES)}: worst RMS(diff) "
        f"{worst:.4f} of the RMS (limit {ACCUM_GRAD_REL})")
    if not (rel <= ACCUM_LOSS_REL and worst <= ACCUM_GRAD_REL):
        raise AssertionError(f"grad accumulation: loss rel {rel}, grads "
                             f"{worst}")
    del tr, model, ga
    torch.cuda.empty_cache()
    return counts


def phase_ckpt_resume(torch, dev, np, tmp):
    """The train width at CKPT_LAYERS layers under ``ElasticRunner``:
    ``CheckpointManager(async_save=True)`` every 2 steps; a clean run, then
    a run whose 4th step raises through the ``train.step`` fault site: one
    restart from the step-2 checkpoint, the fresh token stream fast-
    forwarded; the final parameters must be bit-identical to the clean
    run's. The writer's seconds and GB/s a save, a timed verified restore
    of the latest checkpoint, and a truncated latest checkpoint falling
    back to the one before."""
    import shutil
    import warnings

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.io import TokenBinDataset
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.observability import METRICS
    from paddle_tpu_torch.train import Trainer, TrainerArgs
    from paddle_tpu_torch.train.checkpoint import CheckpointManager
    from paddle_tpu_torch.train.elastic import ElasticRunner
    from paddle_tpu_torch.utils.faults import FAULTS, InjectedCrash
    card = card_line()
    cfg = dataclasses.replace(train_config(), num_hidden_layers=CKPT_LAYERS)
    path = token_file(np, tmp)
    b, s = TRAIN_SHAPE[:2]
    log(f"[ckpt_resume] {shutil.disk_usage(tmp).free / 2**30:.1f} GiB free "
        f"under {tmp}")

    def make(d):
        def make_trainer():
            return Trainer(LlamaForCausalLM(cfg, device=dev, seed=0),
                           _adamw(O), _lm_loss, TrainerArgs(
                               max_steps=CKPT_STEPS, log_every=0,
                               ckpt_every=2, ckpt_dir=d, async_ckpt=True),
                           device=dev)
        return make_trainer

    def data_fn():
        return iter(TokenBinDataset(path, b, s, seed=1, num_workers=1))

    def run(d, crash):
        METRICS.reset()
        FAULTS.clear()
        if crash:
            FAULTS.install("train.step", on={CKPT_STEPS - 1},
                           exc=InjectedCrash)
        runner = ElasticRunner(make(d), max_restarts=1, backoff_s=0.0)
        t0 = time.monotonic()
        state = runner.run(data_fn)
        wall = time.monotonic() - t0
        FAULTS.clear()
        snap = METRICS.snapshot()
        h = snap["histograms"]["ckpt_save_seconds"]
        nbytes = snap["counters"]["ckpt_saved_bytes_total"]
        log(f"[ckpt_resume] {'crashed at the 4th step' if crash else 'clean'}"
            f": {runner.restarts} restart(s) {runner.failures}, step "
            f"{int(state.step)} in {wall:.1f} s; {h['count']} async saves "
            f"of {nbytes / h['count'] / 1e9:.3f} GB, writer "
            f"{h['sum'] / h['count']:.2f} s each "
            f"({nbytes / h['sum'] / 1e9:.2f} GB/s)")
        return state, runner

    da, db = os.path.join(tmp, "ckpt_a"), os.path.join(tmp, "ckpt_b")
    clean, _ = run(db, False)
    want = {n: p.detach().clone() for n, p in clean.model.named_parameters()}
    del clean
    shutil.rmtree(db)
    torch.cuda.empty_cache()
    state, runner = run(da, True)
    diff = [n for n, p in state.model.named_parameters()
            if not torch.equal(p, want[n])]
    log(f"[ckpt_resume] restarts {runner.restarts}; final parameters "
        f"bit-identical to the clean run's: {not diff} ({len(want)} "
        f"tensors) ({card})")
    if runner.restarts != 1 or int(state.step) != CKPT_STEPS or diff:
        raise AssertionError(f"ckpt_resume: restarts {runner.restarts}, "
                             f"step {int(state.step)}, differing {diff[:8]}")
    del want
    # a timed verified restore of the latest checkpoint into the live state
    mgr = CheckpointManager(da)
    latest = mgr.latest_step()
    nbytes = mgr._step_path(latest).stat().st_size
    torch.cuda.synchronize()
    t0 = time.monotonic()
    mgr.restore(state, step=latest)
    torch.cuda.synchronize()
    t_load = time.monotonic() - t0
    rate = nbytes / t_load / 1e9
    log(f"[ckpt_resume] verified restore of step {latest} "
        f"({nbytes / 1e9:.3f} GB) into the live state in {t_load:.2f} s "
        f"({rate:.2f} GB/s, CRCs and the host-to-card copies included) "
        f"({card})")
    # a truncated latest checkpoint falls back to the previous one
    p = mgr._step_path(latest)
    p.write_bytes(p.read_bytes()[:4096])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mgr.restore(state)
    log(f"[ckpt_resume] latest step {latest} truncated: restored step "
        f"{mgr.last_restored_step} ({[str(x.message)[:90] for x in w
                                      if 'fell back' in str(x.message)]})")
    if mgr.last_restored_step != latest - 2:
        raise AssertionError(f"corrupt latest: restored "
                             f"{mgr.last_restored_step}, not {latest - 2}")
    del state
    shutil.rmtree(da)
    torch.cuda.empty_cache()


def phase_lora_train(torch, dev, np):
    """Adapter-only LoRA training at Llama-2-7B width in bf16 (random
    weights from seed 0, frozen), rank 8 on qkv_proj and o_proj (fp32
    adapters, B drawn nonzero so the step moves the loss from the start),
    ``make_lora_train_step`` with AdamW, batch 1 x 2048, remat on; every
    base parameter bit-identical after the steps. Returns the launch
    counts."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.peft import (lora_init, lora_num_parameters,
                                       make_lora_train_step)
    card = card_line()
    cfg = LlamaConfig.llama2_7b(remat=True)
    tm = time.monotonic()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    lora = lora_init(model, torch.Generator(device=dev).manual_seed(1), r=8,
                     target_modules=("qkv_proj", "o_proj"))
    g = torch.Generator(device=dev).manual_seed(2)
    for k, ab in lora.items():
        if k != "_scale":
            ab["b"].normal_(0.0, 0.01, generator=g)
    ids, labels = train_batch(torch, dev, np, cfg, batch=1)
    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    log(f"[lora_train] llama2_7b width, {cfg.num_hidden_layers} layers bf16 "
        f"frozen, {lora_num_parameters(lora) / 1e6:.2f} M adapter "
        f"parameters (rank 8, qkv_proj / o_proj) in "
        f"{time.monotonic() - tm:.1f} s")
    step, ad, st = make_lora_train_step(
        model, lora, O.AdamW(learning_rate=1e-3), lambda m, i, lab:
        m.loss(i, lab), device=dev)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses, ms = [], []
    for _ in range(LORA_STEPS):
        t0 = time.monotonic()
        ad, st, loss = step(ad, st, ids, labels)
        losses.append(float(loss))
        ms.append(1e3 * (time.monotonic() - t0))
    counts = K.launches()
    peak = torch.cuda.max_memory_allocated()
    same = all(torch.equal(p, base[n]) and p.grad is None
               for n, p in model.named_parameters())
    log(f"[lora_train] losses {' '.join(f'{x:.5f}' for x in losses)}; "
        f"{sum(ms[1:]) / (LORA_STEPS - 1):.1f} ms/step over steps 2-"
        f"{LORA_STEPS} (step 1 {ms[0]:.1f} ms); peak allocated "
        f"{peak / 2**30:.2f} GiB (the base's copy for the check "
        f"{sum(t.numel() * t.element_size() for t in base.values()) / 2**30:.2f}"
        f" GiB of it); base bit-identical, no .grad: {same}; launches "
        f"{counts} ({card})")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and same):
        raise AssertionError(f"lora_train: losses {losses}, base same {same}")
    missing = _missing("lora_train", counts)
    if missing:
        raise AssertionError(f"kernels not launched on lora_train: "
                             f"{missing} ({counts})")
    del model, base, ad, st, step, lora
    torch.cuda.empty_cache()
    return counts


def _fp8_check(torch, dev):
    """fp8_matmul on the card (torch._scaled_mm) against its plain version
    (the CPU's bf16 upcasts, run on the card) at the headline's qkv shape,
    forward, dx and dw, under a calibrated history; the rolled histories
    must agree exactly."""
    from paddle_tpu_torch.amp import fp8
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(8192, 2048, generator=g, device=dev).bfloat16()
    w = (0.02 * torch.randn(2048, 6144, generator=g, device=dev)).bfloat16()
    gy = torch.randn(8192, 6144, generator=g, device=dev).bfloat16()
    out = []
    for plain in (False, True):
        meta = fp8.new_fp8_meta(device=dev)
        meta.amax_x[0], meta.amax_w[0], meta.amax_g[0] = (
            float(x.abs().max()), float(w.abs().max()), float(gy.abs().max()))
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fp8.fp8_matmul(xr, wr, meta, plain=plain)
        y.backward(gy)
        out.append((y.detach(), xr.grad, wr.grad, torch.cat(
            meta.histories())))
    for name, a, r in zip(("y", "dx", "dw"), out[0][:3], out[1][:3]):
        err, scaled = _max_err(a, r)
        rel = err / float(r.float().abs().max())
        log(f"[fp8_train] fp8_matmul {name} {list(a.shape)} scaled_mm vs "
            f"plain: max_abs_err {err:.3e}, {rel:.3e} of max |plain| (limit "
            f"{FP8_CHECK_REL}); elementwise {scaled:.3e} of (1 + |plain|)")
        if not rel <= FP8_CHECK_REL:
            raise AssertionError(f"fp8_matmul {name}: card {rel} of max "
                                 f"|plain| from its plain version")
    if not torch.equal(out[0][3], out[1][3]):
        raise AssertionError("fp8_matmul: rolled histories differ")
    del out
    torch.cuda.empty_cache()


def phase_fp8_train(torch, dev, np, tmp):
    """The headline model with ``fp8=True`` beside its bf16 run from the
    same seed (4 x 2048, the headline's AdamW), fp8_matmul against its
    plain version first. On fresh batches of the seeded token file (one
    a step, as training runs) every step's fp8 loss within the
    reference's bound 0.15 |a| + 0.05 of the bf16 loss. On the headline's
    one fixed batch (memorised: the bf16 loss halves in 6 steps) the
    card's fp8 run within FP8_PATH_REL of the same model with plain
    products at every step, and the bf16 / fp8 gap reported. Returns the
    fp8 runs' launch counts."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.amp import fp8 as F8
    from paddle_tpu_torch.io import TokenBinDataset
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    card = card_line()
    _fp8_check(torch, dev)
    cfg0 = train_config()
    b, s = TRAIN_SHAPE[:2]
    fixed = [train_batch(torch, dev, np, cfg0)] * FP8_STEPS
    stream = [(torch.as_tensor(x, device=dev).long(),
               torch.as_tensor(y, device=dev).long()) for x, y in TokenBinDataset(
        token_file(np, tmp), b, s, seed=2, num_workers=1,
        num_batches=FP8_STEPS)]

    def run(label, fp8, batches, plain=False):
        model = LlamaForCausalLM(dataclasses.replace(cfg0, fp8=fp8),
                                 device=dev, seed=0)
        opt = _adamw(O)
        state = init_state(model, opt)
        step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt)
        losses = []
        torch.cuda.synchronize()
        with F8.plain_products() if plain else contextlib.nullcontext():
            for k, (ids, labels) in enumerate(batches):
                if k == 2:
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                state, loss = step(state, ids, labels)
                losses.append(loss)
                if k == 0 and fp8:
                    g1 = float(model.model.layers[0].self_attn
                               .fp8_meta["qkv"].amax_g[0])
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0) / (FP8_STEPS - 2)
        losses = [float(x) for x in losses]
        rolled = (int((model.model.layers[0].self_attn.fp8_meta["qkv"]
                       .amax_x > 0).sum()) if fp8 else None)
        log(f"[fp8_train] {label}: losses "
            f"{' '.join(f'{x:.5f}' for x in losses)}; {ms:.1f} ms/step over "
            f"steps 3-{FP8_STEPS}"
            + (f"; layer 0 qkv's first gradient amax {g1:.3e} (read at "
               f"scale 1: e5m2's smallest subnormal is 1.526e-05), "
               f"histories rolled {rolled} times" if fp8 else "")
            + f" ({card})")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]) or \
                rolled not in (None, FP8_STEPS):
            raise AssertionError(f"fp8_train {label}: {losses}, rolled "
                                 f"{rolled}")
        del state, model, opt, step
        torch.cuda.empty_cache()
        return losses

    def gap(a_s, b_s):
        return [(a, b) for a, b in zip(a_s, b_s)
                if not abs(a - b) < FP8_BOUND[0] * abs(a) + FP8_BOUND[1]]

    t_bf16 = run("bf16, token stream", False, stream)
    K.reset_launches()
    t_fp8 = run("fp8, token stream", True, stream)
    counts = K.launches()
    bad = gap(t_bf16, t_fp8)
    log(f"[fp8_train] token stream: fp8 within {FP8_BOUND[0]} |a| + "
        f"{FP8_BOUND[1]} of bf16 at every step: {not bad}")
    f_bf16 = run("bf16, fixed batch", False, fixed)
    f_fp8 = run("fp8, fixed batch", True, fixed)
    f_plain = run("fp8 with plain products, fixed batch", True, fixed, True)
    off = max(abs(a - b) / abs(b) for a, b in zip(f_fp8, f_plain))
    log(f"[fp8_train] fixed batch: the card's fp8 run within {off:.4f} of "
        f"the plain-product run at every step (limit {FP8_PATH_REL}); "
        f"steps outside the reference's bound against bf16: "
        f"{gap(f_bf16, f_fp8)}; launches of the fp8 stream run {counts}")
    if bad or not off <= FP8_PATH_REL:
        raise AssertionError(f"fp8_train: stream outside the bound {bad}, "
                             f"card vs plain {off}")
    missing = _missing("fp8_train", counts)
    if missing:
        raise AssertionError(f"kernels not launched on fp8_train: "
                             f"{missing} ({counts})")
    return counts


def phase_amp_check(torch, dev, np):
    """(a) ``amp.decorate(level="O2")`` of a float32 2-layer model at the
    headline width, trained 3 steps in bf16 with fp32 masters; (b) an
    enabled ``GradScaler`` on the float32 model with one injected inf
    gradient: the scale halves, the step is skipped, and no host sync
    happens inside the scaler (counted under
    ``torch.cuda.set_sync_debug_mode("warn")``); (c) a float16 model runs
    on the card's float16 kernels (a finite loss) and
    ``amp.is_float16_supported`` says so."""
    import warnings

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.train import init_state, make_train_step
    card = card_line()
    cfg = dataclasses.replace(train_config(), num_hidden_layers=2,
                              dtype=torch.float32)
    ids, labels = train_batch(torch, dev, np, cfg, batch=1)
    m32 = LlamaForCausalLM(cfg, device=dev, seed=0)
    m16 = amp.decorate(m32, level="O2", dtype=torch.bfloat16)
    opt = _adamw(O)
    state = init_state(m16, opt)
    step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt)
    losses = []
    for _ in range(3):
        state, loss = step(state, ids, labels)
        losses.append(float(loss))
    masters = sum(v is not None for v in state.opt_state["master"].values())
    log(f"[amp_check] O2 bf16 (multi_precision, {masters} fp32 masters): "
        f"losses {' '.join(f'{x:.5f}' for x in losses)}; the float32 "
        f"model's parameters stay float32: "
        f"{next(m32.parameters()).dtype}")
    if not (losses[-1] < losses[0] and masters and
            next(m32.parameters()).dtype == torch.float32):
        raise AssertionError(f"amp_check O2: {losses}, masters {masters}")
    del state, m16, opt, step
    sc = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    st = sc.init(dev)
    m32.zero_grad(set_to_none=True)
    sc.scale(m32.loss(ids, labels), st).backward()
    params = dict(m32.named_parameters())
    old = {n: p.detach().clone() for n, p in params.items()}
    # the injected overflow (a Python scalar written into a card tensor
    # copies from host memory: outside the counted window)
    params["lm_head"].grad[0, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            grads = sc.unscale({n: p.grad for n, p in params.items()}, st)
            found = sc.found_inf(grads)
            new = {n: p.detach() - 3e-4 * grads[n] for n, p in params.items()}
            kept = sc.step_or_skip(old, new, found)
            st2 = sc.update(st, found)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message)[:80] for w in caught
             if "synchroniz" in str(w.message)]
    halved = float(st2["scale"]) == float(st["scale"]) / 2
    skipped = all(torch.equal(kept[n], old[n]) for n in old)
    log(f"[amp_check] GradScaler on the float32 model, one inf gradient: "
        f"scale {float(st['scale']):.0f} -> {float(st2['scale']):.0f} "
        f"(halved: {halved}), step skipped: {skipped}; host syncs inside "
        f"the scaler: {len(syncs)} {syncs} ({card})")
    if not (halved and skipped and not syncs):
        raise AssertionError(f"amp_check scaler: halved {halved}, skipped "
                             f"{skipped}, syncs {syncs}")
    del m32, grads, new, kept, old
    torch.cuda.empty_cache()
    m_h = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=1,
                                               dtype=torch.float16),
                           device=dev, seed=0)
    loss = float(m_h.loss(ids, labels))
    log(f"[amp_check] a float16 model on the card: loss {loss:.4f}; "
        f"amp.is_float16_supported(card) = "
        f"{amp.is_float16_supported(dev)}")
    if not (np.isfinite(loss) and amp.is_float16_supported(dev)):
        raise AssertionError(f"amp_check float16: loss {loss}")
    del m_h
    torch.cuda.empty_cache()


# ------------------------------------------------------------- float16
# f16_check: the float16 kernel path's logits against float32 (RMS of the
# difference over the float32 RMS; float16 keeps three more mantissa bits
# than bf16, whose sound readings are ~0.06 under CHECK_REL 0.15), and the
# floor of each f16_train loss's distance from the float32 run's after as
# many updates (relative; the bound is twice the bf16 run's distance)
F16_CHECK_REL = 0.03
F16_LOSS_REL = 0.02
F16_MOE_LAYERS = 4          # f16_moe: Qwen1.5-MoE-A2.7B's widths, cut
F16_TRAIN_TAKEN = 8         # f16_train: steps after the first one taken
F16_INIT_SCALE = 2.0 ** 24  # overflows the first float16 gradients


def f16_kernel_entries(torch, dev):
    """Each kernel's float16 instantiation against its plain version at
    the shapes of its bf16 rows (``half_rows("f16")``: the same checks and
    times at float16, tolerance TOL["f16"] = 2e-2 * (1 + |plain|), the
    float32 checks left out): K1 (also under an fp32 weight), K2 with
    kv_lens and its LSE, K3 and K4 over f16 and int8 pools (partials too),
    K7 and its fold at every path's shapes, K5a and K5b at the train
    shapes; K6a's tensor-core and decode routes and K6b at the MoE shapes;
    the ALiBi mode, head dim 256, the sliding window, K2 at head dim 64
    (GQA 71:1) and the multi-LoRA kernels at their paths' shapes
    (logged). Returns {path: {name_f16:
    entry}} for the float16 paths."""
    def f16(rows):
        return {f"{k}_f16": v for k, v in rows.items()}
    with half_rows("f16"):
        serve = serve_kernel_entries(torch, dev, fp32=False)
        k1_fp32_weight(torch, dev)
        train = {"rms_norm": k1_train(torch, dev),
                 "flash_fwd": k2_train(torch, dev), **k5(torch, dev)}
        k6e = k6(torch, dev)
        k6d = k6_decode(torch, dev)
        b, s, _, _ = MOE_TRAIN_SHAPE
        moe_serve = {**serve_kernel_entries(torch, dev, MOE_HIDDEN,
                                            MOE_HEADS, fp32=False),
                     "grouped_fwd": [*k6d["moe_serve"],
                                     {**k6e["prefill_fwd"],
                                      "variant": "wgmma prefill gate_up"}]}
        moe_train = {"rms_norm": k1_train(torch, dev, b * s, MOE_HIDDEN),
                     "flash_fwd": k2_train(torch, dev, MOE_TRAIN_SHAPE),
                     **k5(torch, dev, MOE_TRAIN_SHAPE),
                     "grouped_fwd": k6e["train_fwd"],
                     "grouped_dw": k6e["train_dw"]}
        rope = k7(torch, dev)
        fold = k7_fold(torch, dev)
        i8 = int8_kernel_entries(torch, dev)
        # the modes no float16 path runs: checked and timed, logged
        alibi_kernel_entries(torch, dev)          # (logs its rows)
        for path, rs in hd256_kernel_entries(torch, dev).items():
            for name, r in rs.items():
                _log_entry(f"f16 (at {path}'s shape) {name}", r)
        for name, r in window_kernel_entries(torch, dev).items():
            _log_entry(f"f16 (at window_serve's shape) {name}", r)
        # K2 at head dim 64 without ALiBi (GQA 71:1)
        _log_entry("f16 (at falcon7b_serve's shape) flash_fwd",
                   falcon7b_kernel_entries(torch, dev)["flash_fwd"])
        lora_kernel_entries(torch, dev)
    out = {"f16_serve": f16({**serve, "rope": rope["serve"],
                             "rope_kv": fold["serve"]}),
           "f16_train": f16({**train, "rope": rope["train"]}),
           "f16_moe_serve": f16({**moe_serve, "rope": rope["moe_serve"],
                                 "rope_kv": fold["moe_serve"]}),
           "f16_moe_train": f16({**moe_train, "rope": rope["moe_train"]})}
    out["f16_serve_i8"] = f16({
        **{k: serve[k] for k in ("rms_norm", "flash_fwd")},
        "rope": rope["serve decode"], **i8})
    return out


def build_f16_model(torch, dev):
    """``LlamaConfig.llama2_7b()`` at full width in float16, random weights
    from seed 0 made on the card (the serve model's values, rounded to
    float16)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    tm = time.monotonic()
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(dtype=torch.float16),
                             device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[f16_serve] llama2_7b width in float16, "
        f"{model.cfg.num_hidden_layers} layers, random weights in "
        f"{time.monotonic() - tm:.1f} s")
    return model


def _all_f16(path, counts):
    """Every launch of ``path``'s kernels on their float16 instantiation:
    each kernel's total equals its float16 count (nothing cast to bf16,
    nothing on another type)."""
    off = {k: (counts[k[:-4]], counts[k]) for k in PATHS[path]
           if k not in ABSENT and counts[k[:-4]] != counts[k]}
    if off:
        raise AssertionError(f"{path}: launches not all float16 "
                             f"(total, f16): {off}")


def phase_f16_serve(torch, dev, model, np, bf16_stats):
    """The 12-request mix at Llama-2-7B width in float16 through
    ``LLMEngine`` (the CUDA-graph decode tick, chunked prefill), then again
    over an int8 KV pool; every kernel on its float16 instantiation.
    Returns ({path: counts}, the first run's requests, its stats)."""
    counts = {}
    counts["f16_serve"], reqs, stats = phase_serve(torch, dev, model, np,
                                                   "f16_serve")
    _all_f16("f16_serve", counts["f16_serve"])
    counts["f16_serve_i8"], _, st8 = phase_serve(torch, dev, model, np,
                                                 "f16_serve_i8",
                                                 kv_dtype="int8")
    _all_f16("f16_serve_i8", counts["f16_serve_i8"])
    log(f"[f16_serve] {stats['tokens_s']:.1f} tokens/s (int8 pool "
        f"{st8['tokens_s']:.1f}) against serve's bf16 "
        f"{bf16_stats['tokens_s']:.1f} tokens/s in this run; decode tick "
        f"device ms f16 {stats['ticks'].get('sync', (0, 0, 0))[2]:.3f}, "
        f"bf16 {bf16_stats['ticks'].get('sync', (0, 0, 0))[2]:.3f} "
        f"({card_line()})")
    return counts, reqs, stats


def phase_f16_check(torch, model, reqs):
    """(a) The served prompts' prefill, chunk and first-decode-tick logits
    through the float16 kernels, the float16 plain versions and float32
    (the check's rule, limit F16_CHECK_REL). (b) Each greedy stream of
    the six short requests against the float16 plain path's (dense-cache
    ``generate`` of the same prompt with every wrapper on its plain
    version), token for token up to the first step whose float32 top-2
    margin (teacher-forced along the engine's stream) is below 2 *
    F16_CHECK_REL of that step's logit RMS: past it a float16 rounding may
    choose either token."""
    from paddle_tpu_torch.models.decoding import generate
    phase_check(torch, model, reqs, "f16_check", F16_CHECK_REL)
    rows = [r for r in reqs[:6] if not r.temperature]      # greedy
    dev = model.device
    with torch.no_grad(), plain_kernels():
        m32 = fp32_copy(torch, model)
        held = 0
        for r in rows:
            new = len(r.tokens)
            prompt = torch.as_tensor(list(r.prompt), device=dev)[None]
            plain = generate(model, prompt, max_new_tokens=new)[
                0, prompt.shape[1]:].tolist()
            full = torch.as_tensor(list(r.prompt) + list(r.tokens[:-1]),
                                   device=dev)[None]
            lg = m32(full)[0, prompt.shape[1] - 1:].float()
            top2 = lg.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).tolist()
            limit = (2 * F16_CHECK_REL
                     * lg.square().mean(-1).sqrt()).tolist()
            upto = next((t for t in range(new) if margin[t] < limit[t]),
                        new)
            same = list(r.tokens[:upto]) == plain[:upto]
            log(f"[f16_check] request {r.req_id}: engine and plain float16 "
                f"streams equal over the first {upto} of {new} tokens (the "
                f"fp32 margin holds that far): {same}; first difference at "
                f"{next((t for t in range(new) if r.tokens[t] != plain[t]), None)}")
            if not same:
                raise AssertionError(f"f16_check: request {r.req_id}'s "
                                     f"stream leaves the plain path's before "
                                     f"step {upto}")
            held += upto
        del m32
    torch.cuda.empty_cache()
    log(f"[f16_check] {len(rows)} greedy streams, {held} tokens held to the "
        f"float16 plain path")


def _scaled_steps(torch, model, ids, labels, scaler, n, taken_after):
    """Train steps of ``model`` on one batch through ``scaler``: scale,
    backward, unscale, found_inf, the AdamW update masked by the overflow
    (``Optimizer.step(ok=~found_inf)``: every parameter, fp32 master and
    moment keeps its bits on a skipped step, as ``step_or_skip`` keeps a
    dict's), update. Stops ``taken_after`` steps after the first one
    taken, or at ``n``. Returns ([(loss, scale, taken)], ms of each taken
    step after the first)."""
    from paddle_tpu_torch import optimizer as O
    opt = O.AdamW(learning_rate=3e-4, weight_decay=0.1,
                  grad_clip=O.ClipGradByGlobalNorm(1.0), multi_precision=True)
    state = opt.init(model)
    st = scaler.init(ids.device)
    t_dev = torch.zeros((), dtype=torch.int64, device=ids.device)
    lr = torch.tensor(3e-4, dtype=torch.float64, device=ids.device)
    rec, times, first = [], [], None
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model.zero_grad(set_to_none=True)
        loss = model.loss(ids, labels)
        scaler.scale(loss, st).backward()
        grads = scaler.unscale({k: p.grad for k, p in
                                model.named_parameters()}, st)
        found = scaler.found_inf(grads)
        ok = ~found
        _, state = opt.step(model, grads, state, ok=ok, lr=lr, t=t_dev + 1)
        t_dev += ok
        scale = st["scale"]
        st = scaler.update(st, found)
        torch.cuda.synchronize()
        taken = bool(ok)
        rec.append((float(loss.detach()), float(scale), taken))
        if taken and first is None:
            first = i
        elif taken:
            times.append(1e3 * (time.monotonic() - t0))
        if first is not None and i - first >= taken_after:
            break
    del state, grads
    return rec, times


def k5_loss_scaling(torch, dev):
    """K5 at float16 under loss scaling: the train shape's q/k/v with a
    cotangent of the size a 8192-token mean loss gives (N(0, 1) * 1e-5),
    multiplied by each scale; dq, dk and dv divided by the scale against
    the float32 plain backward of the same values. Logs, per scale, the
    RMS error over the fp32 RMS, the share of outputs flushed to 0 where
    the fp32 result is not, and the non-finite outputs: small dS values
    underflow float16 at scale 1, large scales overflow it (what the
    scaler's skip is for)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    q, k, v, do = _train_qkv(torch, dev, torch.float16)
    do = (do.float() * 1e-5)
    d = q.shape[-1]
    args = (True, d ** -0.5, None, None)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    o32, lse32 = FA.flash_attention_fwd_plain(q32, k32, v32, True)
    ref = FA.flash_attention_bwd_plain(q32, k32, v32, o32, lse32, do, *args)
    o, lse = FA.flash_fwd_cuda(q, k, v, *args)
    for scale in (1.0, 2.0 ** 12, 2.0 ** 24, 2.0 ** 28):
        got = FA.flash_bwd_cuda(q, k, v, o, lse, (do * scale).half(), *args)
        parts = []
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            a = a.float() / scale
            fin = torch.isfinite(a)
            zero = float(((a == 0) & (r != 0)).float().mean())
            err = (_rms(torch.where(fin, a - r, 0.0)) / _rms(r))
            parts.append(f"{name} {err:.4f} of RMS, {zero:.4f} flushed, "
                         f"{int((~fin).sum())} non-finite")
        log(f"[f16_train] K5 at float16, cotangent x {scale:.0f}: "
            + "; ".join(parts) + f" ({card_line()})")
    del q, k, v, do, o, lse, q32, k32, v32, o32, lse32, ref, got
    torch.cuda.empty_cache()


def phase_f16_train(torch, dev, np):
    """The train phase's model (``train_config()``, 0.74 B) in float16
    parameters with fp32 masters, driven through the port's GradScaler
    from a scale of F16_INIT_SCALE: the first float16 gradients overflow,
    those steps are skipped (parameters, masters and moments unchanged)
    and the scale halves each time until steps are taken; then the losses
    fall. The same loop runs the model in float32 and in bf16 (the same
    seed and batch, the scaler disabled); before each update j the f16
    loss must be within max(2 * |bf16_j - f32_j|, F16_LOSS_REL * f32_j)
    of the float32 loss: no further from float32 than twice the bf16
    run, the rule the logit checks use (on this memorised batch the loss
    falls by ~1 a step, so each run's rounding moves its trajectory by
    more than any per-step rounding). ms/step of f16 and bf16. Returns the
    float16 run's launch counts."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    card = card_line()
    k5_loss_scaling(torch, dev)
    runs = {}
    for name, dt, scaler in (
            ("f32", torch.float32, amp.GradScaler(enable=False)),
            ("bf16", torch.bfloat16, amp.GradScaler(enable=False)),
            ("f16", torch.float16,
             amp.GradScaler(init_loss_scaling=F16_INIT_SCALE))):
        cfg = dataclasses.replace(train_config(), dtype=dt)
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        ids, labels = train_batch(torch, dev, np, cfg)
        K.reset_launches()
        rec, times = _scaled_steps(torch, model, ids, labels, scaler, 40,
                                   F16_TRAIN_TAKEN)
        batch = list(ids.shape)
        counts = K.launches()
        runs[name] = (rec, times, counts)
        log(f"[f16_train] {name}: " + " ".join(
            f"{loss:.4f}{'' if taken else ' (skipped, scale %.0f)' % sc}"
            for loss, sc, taken in rec))
        del model
        torch.cuda.empty_cache()
    rec16, t16, counts = runs["f16"]
    tbf = runs["bf16"][1]
    skipped = [sc for _, sc, taken in rec16 if not taken]
    taken16 = [loss for loss, _, taken in rec16 if taken]
    if not skipped or not taken16:
        raise AssertionError(f"f16_train: no overflow skipped ({skipped}) "
                             f"or no step taken ({rec16})")
    halved = all(b == a / 2 for a, b in zip(skipped, skipped[1:]))
    # each run's loss before its j-th update
    f32, bf = ([loss for loss, _, _ in runs[n][0]] for n in ("f32", "bf16"))
    d16 = [abs(a - r) for a, r in zip(taken16, f32)]
    dbf = [abs(a - r) for a, r in zip(bf, f32)]
    limit = [max(2 * e, F16_LOSS_REL * r) for e, r in zip(dbf, f32)]
    log(f"[f16_train] {len(skipped)} overflowed steps skipped at scales "
        f"{skipped} (halving each time: {halved}), then {len(taken16)} taken;"
        f" loss {taken16[0]:.4f} -> {taken16[-1]:.4f}; |f16 - f32| "
        f"{' '.join(f'{x:.4f}' for x in d16)}, |bf16 - f32| "
        f"{' '.join(f'{x:.4f}' for x in dbf)} before each update (limit "
        f"max(2 |bf16 - f32|, {F16_LOSS_REL} f32)); {np.mean(t16):.1f} "
        f"ms/step f16 against {np.mean(tbf):.1f} bf16, batch {batch} "
        f"({card})")
    if not (halved and taken16[-1] < taken16[0]
            and all(e <= lim for e, lim in zip(d16, limit))):
        raise AssertionError(f"f16_train: halved {halved}, losses "
                             f"{taken16}, |f16 - f32| {d16} (limits "
                             f"{limit})")
    missing = _missing("f16_train", counts)
    if missing:
        raise AssertionError(f"kernels not launched on f16_train: {missing}")
    _all_f16("f16_train", counts)
    return counts


def _f16_moe_routes(path, routes):
    """K6a's float16 launches on their routes: the serve path's tick on
    the decode route and its prefill on the tensor cores; the train path's
    products and K6b all on the tensor cores."""
    fwd, dw = routes["grouped_fwd"], routes.get("grouped_dw", {})
    ok = (fwd["decode"] and fwd["wgmma"] and not fwd["fma"]
          if path == "f16_moe_serve"
          else fwd["wgmma"] and dw["wgmma"] and not fwd["fma"] + dw["fma"])
    if not ok:
        raise AssertionError(f"{path}: K6a / K6b routes {routes}")


def phase_f16_moe(torch, dev, np):
    """Qwen1.5-MoE-A2.7B's widths at F16_MOE_LAYERS layers in float16:
    the 12-request mix through ``LLMEngine`` (K6a's decode route in the
    tick, its tensor-core route at prefill), then two train steps at batch
    2 x 2048 (K6a forward and dlhs, K6b on the tensor cores), every
    launch on a float16 instantiation. Returns ({path: counts}, the serve
    run's K6a launches by route under the f16 counter's name)."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg = dataclasses.replace(qwen_moe_config(F16_MOE_LAYERS),
                              dtype=torch.float16)
    model = Qwen2MoeForCausalLM(cfg, device=dev, seed=0)
    out = {}
    out["f16_moe_serve"], _, st = phase_serve(torch, dev, model, np,
                                              "f16_moe_serve")
    _all_f16("f16_moe_serve", out["f16_moe_serve"])
    _f16_moe_routes("f16_moe_serve", st["routes"])
    # (every K6a launch of the run is float16: its routes are the f16
    # counter's)
    serve_routes = {"grouped_fwd_f16": st["routes"]["grouped_fwd"]}
    ids, labels = train_batch(torch, dev, np, cfg, batch=MOE_TRAIN_SHAPE[0],
                              seq=MOE_TRAIN_SHAPE[1])
    opt = O.AdamW(learning_rate=3e-4, weight_decay=0.1,
                  grad_clip=O.ClipGradByGlobalNorm(1.0), multi_precision=True)
    state = init_state(model, opt)
    step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses = []
    for _ in range(2):
        state, loss = step(state, ids, labels)
        losses.append(float(loss))
    wall = time.monotonic() - t0
    counts = K.launches()
    routes = K.route_launches()
    out["f16_moe_train"] = counts
    log(f"[f16_moe_train] losses {losses}, {1e3 * wall / 2:.1f} ms/step "
        f"(the first with its warm-up), K6a routes {routes['grouped_fwd']}, "
        f"K6b {routes['grouped_dw']} ({card_line()})")
    missing = _missing("f16_moe_train", counts)
    if missing or not all(np.isfinite(losses)):
        raise AssertionError(f"f16_moe_train: missing {missing}, losses "
                             f"{losses}")
    _f16_moe_routes("f16_moe_train", routes)
    _all_f16("f16_moe_train", counts)
    del state, model
    torch.cuda.empty_cache()
    return out, serve_routes


PAGED_GEN_LENS = (17, 40, 64, 77, 96, 110, 120, 128)
PAGED_GEN_NEW = 64


def phase_paged_generate(torch, dev, model, np):
    """``models.paged.paged_generate`` at Llama-2-7B width in bf16: eight
    ragged prompts, greedy, PAGED_GEN_NEW new tokens. A first call without
    EOS picks row 0's ninth token as the EOS of the timed call, which has
    the same shapes: row 0 must stop at its first EOS and be padded with
    it, every row equal the first call's tokens up to its own EOS (a row's
    arithmetic does not depend on the others finishing). Tokens/s of the
    timed call (tokens generated, padding excluded); the pool sized to the
    ragged bound. Returns the timed call's launch counts."""
    from paddle_tpu_torch.models.paged import paged_generate
    from paddle_tpu_torch.ops import cuda as K
    rs = np.random.RandomState(7)
    ids = np.zeros((len(PAGED_GEN_LENS), max(PAGED_GEN_LENS)), np.int64)
    for i, n in enumerate(PAGED_GEN_LENS):
        ids[i, :n] = rs.randint(3, model.cfg.vocab_size, n)
    lens = np.asarray(PAGED_GEN_LENS)
    first, _ = paged_generate(model, ids, lens, max_new_tokens=PAGED_GEN_NEW)
    first = first.cpu().numpy()
    eos = int(first[0, lens[0] + 8])
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.monotonic()
    got, cache = paged_generate(model, ids, lens,
                                max_new_tokens=PAGED_GEN_NEW,
                                eos_token_id=eos)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = K.launches()
    got = got.cpu().numpy()
    made, keeps = 0, []
    for i, n in enumerate(PAGED_GEN_LENS):
        gen = got[i, n:n + PAGED_GEN_NEW]
        stop = np.nonzero(gen == eos)[0]
        keep = int(stop[0]) + 1 if len(stop) else PAGED_GEN_NEW
        made += keep
        keeps.append(keep)
        if not (np.array_equal(gen[:keep], first[i, n:n + keep])
                and (gen[keep:] == eos).all()):
            raise AssertionError(f"paged_generate row {i}: {gen.tolist()}")
    if keeps[0] > 9:
        raise AssertionError("paged_generate: row 0 did not stop at its EOS")
    bound = sum(-(-(n + PAGED_GEN_NEW) // 16) for n in PAGED_GEN_LENS)
    if cache.num_blocks != bound:
        raise AssertionError(f"paged_generate pool {cache.num_blocks} blocks"
                             f", ragged bound {bound}")
    missing = _missing("paged_generate", counts)
    if missing:
        raise AssertionError(f"kernels not launched on paged_generate: "
                             f"{missing} ({counts})")
    log(f"[paged_generate] 8 ragged prompts ({list(PAGED_GEN_LENS)}), "
        f"{made} tokens in {wall:.3f} s: {made / wall:.1f} tokens/s, pool "
        f"{bound} blocks (the ragged bound); EOS {eos}: tokens a row "
        f"{keeps}; launches {counts} ({card_line()})")
    return counts


# ------------------------------------------- sharded checkpoints and cp
SHARDED_STEPS = 2           # steps before the save, and after it
CP_ROWS = 8                 # the serve mix's greedy rows 0-7
CP_CHUNK = 128              # whole-prompt prefill / chunk width
CP_BLOCKS = 32              # blocks of 16 a row: 512 positions
CP_TICKS = 16               # decode ticks compared
CP_VERIFY = 5               # the verify chunk's width (spec_k 4 + 1)
CP_TIMED = 20               # decode ticks timed in each arm


def cp_kernel_entries(torch, dev):
    """K3 and K4 in their partials mode, the cp_serve path's, at the serve
    path's 7B shapes (``kernel_cases``) over the whole table (a one-rank
    cp group owns every block), bf16: the triple against the plain
    partials, the kernel's time eager and from a CUDA graph, the plain
    partials' time and the bound (q and K/V read, the fp32 triple of the
    live rows written)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as PA
    cases = kernel_cases(torch, dev)
    dt, dtype = _hdt(torch), _hn()
    out = {}
    c = cases["paged_chunk"]
    q, kp, vp = c["q"].to(dt), c["kp"].to(dt), c["vp"].to(dt)
    tb, offs, cls = c["tables"], c["offsets"], c["chunk_lens"]

    def k3():
        return PA.paged_chunk_attention(q, kp, vp, tb, offs, cls,
                                        partials=True)

    def p3():
        return PA.paged_chunk_attention_plain(q, kp, vp, tb, offs, cls,
                                              partials=True)
    err = _triple_agree("cp_serve paged_chunk", dtype, k3(), p3())
    a, cc, nh, d = q.shape
    es = q.element_size()
    rows = int(cls.sum())
    keys = sum(int(offs[i]) * int(cls[i]) + int(cls[i]) * (int(cls[i]) + 1)
               // 2 for i in range(a))
    nbytes = (rows * nh * d * es + 2 * int((offs + cls).long().sum()) * nh
              * d * es + tb.numel() * 4 + rows * nh * (d + 2) * 4)
    b_ms, b_by = bound(nbytes, 4 * d * nh * keys)
    out["paged_chunk_partials"] = dict(
        max_abs_err=err, variant=_k3_variant(PA, q), ms=time_ms(k3),
        graph_ms=graph_ms(k3), plain_ms=time_ms(p3), library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q [{a}, {cc}, {nh}, {d}] {dtype}, pool {list(kp.shape)}, "
              f"MB {tb.shape[1]}, partials")
    c = cases["paged_decode"]
    q, lens = c["q"].to(dt), c["lens"]

    def k4():
        return PA.paged_decode_attention(q, kp, vp, tb, lens, partials=True)

    def p4():
        return PA.paged_decode_attention_plain(q, kp, vp, tb, lens,
                                               partials=True)
    err = _triple_agree("cp_serve paged_decode", dtype, k4(), p4())
    nsplit = _k4_nsplit(PA)
    bq, nh, d = q.shape
    nbytes = (bq * nh * d * es + 2 * int(lens.sum()) * nh * d * es
              + tb.numel() * 4 + bq * nh * (d + 2) * 4)
    b_ms, b_by = bound(nbytes, 4 * d * nh * int(lens.sum()))
    out["paged_decode_partials"] = dict(
        max_abs_err=err, nsplit=nsplit, ms=time_ms(k4), graph_ms=graph_ms(k4),
        plain_ms=time_ms(p4), library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"q [{bq}, {nh}, {d}] {dtype}, pool {list(kp.shape)}, lens sum "
              f"{int(lens.sum())}, partials")
    return out


def _clone_cache(cache):
    from paddle_tpu_torch.models.paged import PagedKVCache
    return PagedKVCache([t.clone() for t in cache.k_store],
                        [t.clone() for t in cache.v_store],
                        cache.block_tables.clone(), cache.lens.clone(),
                        [t.clone() for t in cache.k_scale_store],
                        [t.clone() for t in cache.v_scale_store])


def phase_cp_serve(torch, dev, model, np):
    """The cp path's forwards on the served 7B model over a one-rank NCCL
    cp group, each against the same forward without cp from the same cache
    state (see the module docstring). Returns the launch counts of the cp
    forwards."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.core.random import generator
    from paddle_tpu_torch.models import paged as P
    from paddle_tpu_torch.ops import cuda as K
    cfg = model.cfg
    card = card_line()
    reqs = serve_requests(np.random.RandomState(0), cfg.vocab_size)[:CP_ROWS]
    prompts = [np.asarray(r.prompt, np.int64) for r in reqs]
    b, bs, mb = len(prompts), 16, CP_BLOCKS
    d = cfg.hidden_size // cfg.num_attention_heads
    cache = P.PagedKVCache.init(cfg.num_hidden_layers, b * mb, bs,
                                cfg.num_key_value_heads, d, b, mb, cfg.dtype,
                                device=dev)
    tables = np.arange(b * mb, dtype=np.int32).reshape(b, mb)
    slots = np.arange(b, dtype=np.int32)
    gens = {None: generator(0, dev), "cp": generator(0, dev)}
    counts = {k: 0 for k in K.launches()}
    worst = {}

    with nccl_world(torch):
        mesh = D.HybridMesh(cp=1)

        def both(label, fn):
            """fn(cache, cp_axis) without cp on the cache and with cp on a
            copy of its state before; the outputs, logits compared."""
            snap = _clone_cache(cache)
            ref = fn(cache, None)
            torch.cuda.synchronize()
            before = K.launches()
            with mesh:
                got = fn(snap, "cp")
            torch.cuda.synchronize()
            for k, v in K.launches().items():
                counts[k] += v - before[k]
            del snap
            err = _max_err(got[0], ref[0])
            worst[label] = max(worst.get(label, (0.0, 0.0)), err,
                               key=lambda e: e[1])
            tok_ref = ref[0].float().argmax(-1)
            tok_got = got[0].float().argmax(-1)
            if not torch.equal(tok_ref, tok_got):
                raise AssertionError(f"cp_serve {label}: greedy tokens "
                                     f"differ from the forward without cp")
            return ref, tok_ref

        # whole-prompt prefill of each row's first CP_CHUNK tokens
        ids = np.zeros((b, CP_CHUNK), np.int64)
        lens = np.array([min(len(p), CP_CHUNK) for p in prompts], np.int32)
        for i, p in enumerate(prompts):
            ids[i, :lens[i]] = p[:lens[i]]
        ids_t = torch.as_tensor(ids, device=dev)
        ref, tok = both("prefill", lambda c, ax: (P.llama_prefill_paged(
            model, ids_t, lens, c, slots, tables, cp_axis=ax)[0],))
        last = tok.clone()
        # the long rows chunked on, CP_CHUNK tokens a call
        long_rows = [i for i, p in enumerate(prompts) if len(p) > CP_CHUNK]
        done = {i: CP_CHUNK for i in long_rows}
        chunks = 0
        while any(done[i] < len(prompts[i]) for i in long_rows):
            cids = np.zeros((len(long_rows), CP_CHUNK), np.int64)
            cl = np.zeros(len(long_rows), np.int32)
            off = np.array([done[i] for i in long_rows], np.int32)
            for j, i in enumerate(long_rows):
                piece = prompts[i][done[i]:done[i] + CP_CHUNK]
                cids[j, :len(piece)] = piece
                cl[j] = len(piece)
            cids_t = torch.as_tensor(cids, device=dev)
            rows = slots[long_rows]
            trows = tables[long_rows]
            _, tok = both("chunk", lambda c, ax: (P.llama_prefill_chunk_paged(
                model, cids_t, cl, off, c, rows, trows, cp_axis=ax)[0],))
            for j, i in enumerate(long_rows):
                if cl[j]:
                    last[i] = tok[j]
                done[i] += int(cl[j])
            chunks += 1
        cur = np.array([len(p) for p in prompts], np.int32)
        # greedy decode ticks (every row; no table growth: tables whole)
        no_upd = np.full(b, b, np.int64)
        zeros = np.zeros(b, np.int64)
        temps, top_ps = np.zeros(b, np.float32), np.ones(b, np.float32)
        active = np.ones(b, bool)
        streams = [last.clone()]
        for _ in range(CP_TICKS):
            toks = streams[-1]

            def tick(c, ax, toks=toks):
                nxt, logp, _ = P.llama_decode_tick(
                    model, toks, c, active, no_upd, zeros, zeros, gens[ax],
                    temps, top_ps, want_logp=True, cp_axis=ax)
                return (logp, nxt)
            ref, tok = both("decode", tick)
            if not torch.equal(ref[1], tok):
                raise AssertionError("cp_serve: the tick's sampled tokens "
                                     "are not its logits' argmax")
            streams.append(tok)
        cur += CP_TICKS
        # one verify chunk at every row's end: the last token and 4 more
        vids = np.random.RandomState(3).randint(3, cfg.vocab_size,
                                                (b, CP_VERIFY))
        vids[:, 0] = streams[-1].cpu().numpy()
        vids_t = torch.as_tensor(vids, device=dev)
        vl = np.full(b, CP_VERIFY, np.int32)
        both("verify", lambda c, ax: (P.llama_verify_chunk_paged(
            model, vids_t, vl, cur, c, slots, tables, cp_axis=ax)[0],))
        # the decode tick timed eagerly, with and without partials + merge
        times = {None: [], "cp": []}
        toks = streams[-1]
        for i in range(2 * CP_TIMED):
            ax = None if i % 2 == 0 else "cp"
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with (mesh if ax else contextlib.nullcontext()):
                e0.record()
                P.llama_decode_tick(model, toks, cache, active, no_upd, zeros,
                                    zeros, gens[ax], temps, top_ps,
                                    cp_axis=ax)
                e1.record()
            torch.cuda.synchronize()
            times[ax].append(e0.elapsed_time(e1))
    for label, (err, scaled) in worst.items():
        _agree(f"cp_serve {label} logits (cp against no cp)", "bf16",
               (err, scaled))
    tick_ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f"[cp_serve] {b} rows ({', '.join(str(len(p)) for p in prompts)} "
        f"tokens), {chunks} chunk calls, {CP_TICKS} decode ticks, one "
        f"{CP_VERIFY}-token verify: greedy tokens identical with and "
        f"without cp; K3 partials launches {counts['paged_chunk_partials']}, "
        f"K4 partials launches {counts['paged_decode_partials']} ({card})")
    log(f"[cp_serve] decode tick (8 rows, eager, median of {CP_TIMED}): "
        f"{tick_ms[None]:.3f} ms without cp, {tick_ms['cp']:.3f} ms with K4's "
        f"partials + merge + finalize ({card})")
    if counts["paged_chunk"] or counts["paged_decode"]:
        raise AssertionError(f"cp_serve: the cp forwards launched K3 / K4 "
                             f"outside their partials mode: "
                             f"{counts['paged_chunk']}, "
                             f"{counts['paged_decode']}")
    missing = _missing("cp_serve", counts)
    if missing:
        raise AssertionError(f"kernels not launched on cp_serve: {missing}")
    del cache
    torch.cuda.empty_cache()
    return counts


def _dir_bytes(path):
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def phase_sharded_ckpt(torch, dev, np, tmp):
    """The headline Trainer over a one-rank NCCL HybridMesh(fsdp=1) saved
    and restored in both formats (see the module docstring); the resumed
    runs' losses must equal the uninterrupted run's bit for bit. Returns
    the launch counts of the phase's steps."""
    import shutil

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import Trainer, TrainerArgs
    from paddle_tpu_torch.train.checkpoint import CheckpointManager
    card = card_line()
    cfg = train_config()
    ids, labels = train_batch(torch, dev, np, cfg)
    data = [(ids, labels)] * (2 * SHARDED_STEPS)
    end = 2 * SHARDED_STEPS
    dirs = {"global": os.path.join(tmp, "sharded_ckpt_global"),
            "sharded": os.path.join(tmp, "sharded_ckpt_sharded")}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    with nccl_world(torch):
        mesh = D.HybridMesh(fsdp=1)

        def trainer(seed, steps):
            return Trainer(LlamaForCausalLM(cfg, device=dev, seed=seed),
                           O.AdamW(learning_rate=1e-4, weight_decay=0.01),
                           _lm_loss, TrainerArgs(max_steps=steps,
                                                 log_every=1),
                           mesh=mesh, device=dev)

        K.reset_launches()
        tr = trainer(0, SHARDED_STEPS)
        tr.fit(iter(data))
        writes, reads = {}, {}
        _, writes["global"] = timed(lambda: CheckpointManager(
            dirs["global"]).save(SHARDED_STEPS, tr.state))
        nbytes = {"global": _dir_bytes(dirs["global"])}
        tr.args.max_steps = end
        tr.fit(iter(data))
        want = [h["loss"] for h in tr.history[SHARDED_STEPS:end]]
        del tr
        torch.cuda.empty_cache()
        got = {}
        for seed, fmt in ((1, "global"), (2, "sharded")):
            fresh = trainer(seed, end)
            mgr = CheckpointManager(dirs[fmt], use_orbax=fmt == "sharded")
            fresh.state, reads[fmt] = timed(lambda: mgr.restore(fresh.state))
            if int(fresh.state.step) != SHARDED_STEPS:
                raise AssertionError(f"sharded_ckpt {fmt}: restored step "
                                     f"{int(fresh.state.step)}")
            if fmt == "global":
                # the restored step-2 state, saved in the sharded format
                shutil.rmtree(dirs["global"])
                _, writes["sharded"] = timed(lambda: CheckpointManager(
                    dirs["sharded"], use_orbax=True).save(SHARDED_STEPS,
                                                          fresh.state))
                nbytes["sharded"] = _dir_bytes(dirs["sharded"])
            fresh.fit(iter(data))
            got[fmt] = [h["loss"] for h in fresh.history]
            del fresh
            torch.cuda.empty_cache()
        shutil.rmtree(dirs["sharded"])
        counts = K.launches()
    for fmt in ("global", "sharded"):
        gb = nbytes[fmt] / 1e9
        log(f"[sharded_ckpt] {fmt} format: {gb:.3f} GB; write "
            f"{writes[fmt]:.2f} s ({gb / writes[fmt]:.2f} GB/s), restore into "
            f"a fresh Trainer {reads[fmt]:.2f} s ({gb / reads[fmt]:.2f} GB/s, "
            f"CRCs and the host-to-card copies included) ({card})")
        log(f"[sharded_ckpt] {fmt}: resumed losses "
            f"{' '.join(f'{x:.6f}' for x in got[fmt])}, uninterrupted "
            f"{' '.join(f'{x:.6f}' for x in want)}; bit-identical: "
            f"{got[fmt] == want}")
        if got[fmt] != want:
            raise AssertionError(f"sharded_ckpt {fmt}: resumed losses "
                                 f"{got[fmt]} differ from {want}")
    missing = _missing("sharded_ckpt", counts)
    if missing:
        raise AssertionError(f"kernels not launched on sharded_ckpt: "
                             f"{missing}")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,serve,check,"
                    "graph_check,async_serve,lora_serve,lora_check,"
                    "spec_serve,spec_check,beam_serve,beam_check,"
                    "grammar_serve,grammar_check,tenant_serve,"
                    "endpoint_check,hf_load,router_serve,router_check,"
                    "gptq_serve,gptq_check,spec_generate,cp_serve,train,"
                    "dist_train,pp_train,sp_train,ep_train,remat_train,"
                    "trainer_fit,ckpt_resume,sharded_ckpt,lora_train,"
                    "fp8_train,amp_check,"
                    "moe_serve,moe_check,moe_train,window_serve,window_check,"
                    "quant_serve,quant_check,bloom_serve,bloom_train,"
                    "falcon_rw_serve,falcon_rw_train,falcon7b_serve,"
                    "gemma_train,gemma7b_serve,gptj_serve,gptj_train,"
                    "gpt3_train,neox_serve,opt_serve,phi_serve,phi_train,"
                    "glm_serve,bert_train,bert_finetune,bert_encode,"
                    "encoder_serve,"
                    "paged_generate,f16_serve,f16_check,f16_train,f16_moe")
    ap.add_argument("--root", help="import paddle_tpu_torch from the "
                    "checkout at ROOT instead of this one: an earlier "
                    "tree's package under this script's measurement")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import paddle_tpu_torch  # noqa: F401  (fails without the checkout)
    from paddle_tpu_torch.ops import cuda as K
    ABSENT.update(k for names in PATHS.values() for k in names
                  if k not in K.kernels())
    if ABSENT and not args.root:
        raise AssertionError(f"kernels of PATHS missing from ops.cuda: "
                             f"{sorted(ABSENT)}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    t0 = time.monotonic()
    log(f"[env] {card_line()}")
    if "build" in phases:
        phase_build()
    results = phase_kernels(torch, dev) if "kernels" in phases else {}
    if "k6_tiles" in phases:
        phase_k6_tiles(torch, dev)
    if "k6_decode_strips" in phases:
        phase_k6_decode_strips(torch, dev)
    if "k4_splits" in phases:
        phase_k4_splits(torch, dev)
    if "k3_tiles" in phases:
        phase_k3_tiles(torch, dev)
    counts = {}                # path -> {kernel: launches in its own run}
    routes = {}                # path -> {kernel: {route: launches}} alike
    # router_serve's arm (c) serves quant_serve's quantized model and holds
    # its streams to quant_serve's
    quant = {"quant_serve", "quant_check", "quant_anatomy",
             "router_serve"} & set(phases)
    router = {"hf_load", "router_serve", "router_check"} & set(phases)
    gptq = {"gptq_serve", "gptq_check"} & set(phases)
    lora_spec = {"lora_serve", "lora_check", "lora_anatomy", "spec_serve",
                 "spec_check", "beam_serve", "beam_check", "grammar_serve",
                 "grammar_check", "tenant_serve",
                 "endpoint_check"} & set(phases)
    serve_stats = None
    if {"serve", "check", "anatomy", "graph_check", "async_serve",
            "spec_generate", "paged_generate", "cp_serve"} & set(phases) \
            or quant or \
            lora_spec or router or gptq:
        tm = time.monotonic()
        model = build_model(dev)
        torch.cuda.synchronize()
        log(f"[serve] llama2_7b width, {model.cfg.num_hidden_layers} layers, "
            f"random weights in {time.monotonic() - tm:.1f} s")
        counts["serve"], reqs, serve_stats = phase_serve(
            torch, dev, model, np, roofline=True)
        if {"check", "quant_check"} & set(phases):
            got, ref32 = phase_check(torch, model, reqs)
        if "graph_check" in phases:
            phase_graph_check(torch, dev, model, np)
            phase_graph_check(torch, dev, model, np, kv_dtype="int8")
        if "async_serve" in phases:
            counts["async_serve"], areqs, astats = phase_serve(
                torch, dev, model, np, "async_serve", async_depth=2)
            same = [r.tokens for r in areqs] == [r.tokens for r in reqs]
            log(f"[async_serve] 12 streams token for token the serve "
                f"phase's: {same}; {astats['tokens_s']:.1f} tokens/s "
                f"against {serve_stats['tokens_s']:.1f} synchronous "
                f"({card_line()})")
            if not same:
                raise AssertionError("async_serve streams differ from the "
                                     "synchronous serve phase's")
            if not astats["drains"] or "async" not in astats["ticks"]:
                raise AssertionError(f"the async pipeline never cruised: "
                                     f"{astats}")
        if "anatomy" in phases:
            phase_anatomy(torch, dev, model, np)
            if "async_serve" in phases:
                phase_anatomy(torch, dev, model, np,
                              "decode tick, async_depth 2", async_depth=2)
        # multi-LoRA and speculative decoding on the same model (before the
        # quant phases quantize it in place); the checks share one float32
        # copy of it
        m32 = None
        if {"lora_check", "spec_check"} & set(phases):
            m32 = fp32_copy(torch, model)
        if {"lora_serve", "lora_check", "lora_anatomy"} & set(phases):
            tp = time.monotonic()
            counts["lora_serve"], store, sds, _ = phase_lora_serve(
                torch, dev, model, np, serve_stats)
            log(f"[lora_serve] phase {time.monotonic() - tp:.1f} s")
            if "lora_check" in phases:
                tp = time.monotonic()
                phase_lora_check(torch, dev, model, np, store, sds, reqs,
                                 m32)
                log(f"[lora_check] phase {time.monotonic() - tp:.1f} s")
            if "lora_anatomy" in phases:
                phase_anatomy(torch, dev, model, np, "multi-LoRA decode tick",
                              engine_kw=dict(adapter_store=store),
                              adapter_ids=[LORA_MIX[i % 4]
                                           for i in range(8)])
            del store
        if "spec_serve" in phases:
            tp = time.monotonic()
            counts["spec_serve"] = phase_spec_serve(torch, dev, model, np,
                                                    serve_stats)
            log(f"[spec_serve] phase {time.monotonic() - tp:.1f} s")
        if "spec_check" in phases:
            tp = time.monotonic()
            phase_spec_check(torch, dev, model, np, reqs, m32)
            log(f"[spec_check] phase {time.monotonic() - tp:.1f} s")
        del m32
        torch.cuda.empty_cache()
        if "beam_serve" in phases:
            tp = time.monotonic()
            bc, _ = phase_beam_serve(torch, dev, model, np, serve_stats)
            counts.update(bc)
            log(f"[beam_serve] phase {time.monotonic() - tp:.1f} s")
        if "beam_check" in phases:
            tp = time.monotonic()
            phase_beam_check(torch, dev, np)
            log(f"[beam_check] phase {time.monotonic() - tp:.1f} s")
        if {"grammar_serve", "grammar_check"} & set(phases):
            tp = time.monotonic()
            counts["grammar_serve"], greqs, gpats, gvocab = \
                phase_grammar_serve(torch, dev, model, np, serve_stats)
            log(f"[grammar_serve] phase {time.monotonic() - tp:.1f} s")
            if "grammar_check" in phases:
                tp = time.monotonic()
                phase_grammar_check(torch, dev, model, np, greqs, gpats,
                                    gvocab)
                log(f"[grammar_check] phase {time.monotonic() - tp:.1f} s")
        if {"tenant_serve", "endpoint_check"} & set(phases):
            tp = time.monotonic()
            counts["tenant_serve"], greedy = phase_tenant_serve(
                torch, dev, model, np, reqs, serve_stats)
            log(f"[tenant_serve] phase {time.monotonic() - tp:.1f} s")
            if "endpoint_check" in phases:
                tp = time.monotonic()
                phase_endpoint_check(torch, dev, model, np, greedy)
                log(f"[endpoint_check] phase {time.monotonic() - tp:.1f} s")
        # the HF round trip, then the router on the reloaded model (the
        # served model's bits), before the quant phases quantize it
        if router:
            tp = time.monotonic()
            served = (phase_hf_load(torch, dev, model)
                      if "hf_load" in phases else None)
            served = model if served is None else served
            log(f"[hf_load] phase {time.monotonic() - tp:.1f} s")
            if "router_serve" in phases:
                tp = time.monotonic()
                counts.update(phase_router_serve(torch, dev, served, np,
                                                 reqs, serve_stats))
                log(f"[router_serve] phase {time.monotonic() - tp:.1f} s")
            if "router_check" in phases:
                tp = time.monotonic()
                counts["router_check"] = phase_router_check(
                    torch, dev, served, np, reqs)
                log(f"[router_check] phase {time.monotonic() - tp:.1f} s")
            del served
            _free_cycles(torch)
        # GPTQ, calibrated smoothing and the speculative API on copies of
        # the served model / the served model itself, before the quant
        # phases quantize it in place
        if gptq:
            from paddle_tpu_torch.quantization import _capture_calib
            tp = time.monotonic()
            rec0 = _capture_calib(model, gptq_inputs(
                torch, dev, np, model.cfg.vocab_size)[0])[0]
            torch.cuda.empty_cache()
            if "gptq_serve" in phases:
                counts["gptq_serve"] = phase_gptq_serve(torch, dev, model,
                                                        np, rec0)
                log(f"[gptq_serve] phase {time.monotonic() - tp:.1f} s")
            if "gptq_check" in phases:
                tp = time.monotonic()
                phase_gptq_check(torch, dev, model, np, rec0)
                log(f"[gptq_check] phase {time.monotonic() - tp:.1f} s")
            del rec0
            torch.cuda.empty_cache()
        if "spec_generate" in phases:
            tp = time.monotonic()
            counts["spec_generate"] = phase_spec_generate(torch, dev, model,
                                                          np)
            log(f"[spec_generate] phase {time.monotonic() - tp:.1f} s")
        if "paged_generate" in phases:
            tp = time.monotonic()
            counts["paged_generate"] = phase_paged_generate(torch, dev,
                                                            model, np)
            log(f"[paged_generate] phase {time.monotonic() - tp:.1f} s")
        if "cp_serve" in phases:
            tp = time.monotonic()
            counts["cp_serve"] = phase_cp_serve(torch, dev, model, np)
            log(f"[cp_serve] phase {time.monotonic() - tp:.1f} s")
        if "quant_check" in phases:
            phase_quant_check(torch, model, reqs, got, ref32, "bf16")
        if quant:
            # the same model, quantized in place (saves building another)
            from paddle_tpu_torch.serving.quant import quantize_for_serving
            tm = time.monotonic()
            quantize_for_serving(model, "weight_only_int8")
            torch.cuda.synchronize()
            log(f"[quant_serve] weight_only_int8 in place in "
                f"{time.monotonic() - tm:.1f} s")
        if {"quant_serve", "router_serve"} & set(phases):
            counts["quant_serve"], quant_reqs = phase_quant_serve(
                torch, dev, model, np, serve_stats)
        if "router_serve" in phases:
            tp = time.monotonic()
            counts["router_serve_i8"] = phase_router_serve_i8(
                torch, dev, model, np, quant_reqs)
            log(f"[router_serve i8] phase {time.monotonic() - tp:.1f} s")
        if "quant_check" in phases:
            phase_quant_check(torch, model, reqs, got, ref32, "int8")
        if "quant_anatomy" in phases:
            phase_anatomy(torch, dev, model, np,
                          "quant decode tick (int8 weights, int8 KV)",
                          kv_dtype="int8")
        del model
        torch.cuda.empty_cache()
    # float16: Llama-2-7B served (bf16 pool and int8 pool) and checked
    if {"f16_serve", "f16_check"} & set(phases):
        tp = time.monotonic()
        model = build_f16_model(torch, dev)
        f16c, f16_reqs, _ = phase_f16_serve(
            torch, dev, model, np, serve_stats or {"tokens_s": 0.0,
                                                   "ticks": {}})
        counts.update(f16c)
        log(f"[f16_serve] phase {time.monotonic() - tp:.1f} s")
        if "f16_check" in phases:
            tp = time.monotonic()
            phase_f16_check(torch, model, f16_reqs)
            log(f"[f16_check] phase {time.monotonic() - tp:.1f} s")
        del model
        torch.cuda.empty_cache()
    if "train" in phases:
        counts["train"] = phase_train(torch, dev, np, "check" in phases,
                                      "anatomy" in phases)
    # the mesh paths are held to the train phase's unsharded steps
    if {"dist_train", "pp_train"} & set(phases) and "train" not in phases:
        counts["train"] = phase_train(torch, dev, np, False)
    for name in ("dist_train", "pp_train"):
        if name in phases:
            tp = time.monotonic()
            counts[name] = (phase_pp_train(torch, dev, np,
                                           "pp_anatomy" in phases)
                            if name == "pp_train"
                            else phase_dist_train(torch, dev, np))
            log(f"[{name}] phase {time.monotonic() - tp:.1f} s")
    if "sp_train" in phases:
        tp = time.monotonic()
        counts["sp_train"] = phase_sp_train(torch, dev, np)
        log(f"[sp_train] phase {time.monotonic() - tp:.1f} s")
    if "ep_train" in phases:
        tp = time.monotonic()
        counts["ep_train"], entries = phase_ep_train(torch, dev, np)
        results.setdefault("ep_train", {}).update(entries)
        for name, r in entries.items():
            _log_entry(f"ep_train {name}", r)
        log(f"[ep_train] phase {time.monotonic() - tp:.1f} s")
    if "f16_train" in phases:
        tp = time.monotonic()
        counts["f16_train"] = phase_f16_train(torch, dev, np)
        log(f"[f16_train] phase {time.monotonic() - tp:.1f} s")
    if "remat_train" in phases:
        tp = time.monotonic()
        counts["remat_train"] = phase_remat_train(torch, dev, np)
        log(f"[remat_train] phase {time.monotonic() - tp:.1f} s")
    trainer = ("trainer_fit", "ckpt_resume", "sharded_ckpt", "lora_train",
               "fp8_train", "amp_check")
    if set(trainer) & set(phases):
        import shutil
        import tempfile
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            for name in trainer:
                if name not in phases:
                    continue
                tp = time.monotonic()
                fn = globals()[f"phase_{name}"]
                got = (fn(torch, dev, np, tmp)
                       if name in ("trainer_fit", "ckpt_resume",
                                   "sharded_ckpt", "fp8_train")
                       else fn(torch, dev, np))
                if name in PATHS:
                    counts[name] = got
                log(f"[{name}] phase {time.monotonic() - tp:.1f} s")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if {"moe_serve", "moe_check", "moe_anatomy"} & set(phases):
        model = build_moe_model(torch, dev, 24, "moe_serve")
        counts["moe_serve"], moe_reqs, moe_stats = phase_serve(
            torch, dev, model, np, "moe_serve")
        routes["moe_serve"] = moe_stats["routes"]
        per_forward = 2 * model.cfg.num_hidden_layers
        if counts["moe_serve"]["grouped_fwd"] % per_forward:
            raise AssertionError(
                f"grouped_fwd launches {counts['moe_serve']['grouped_fwd']} "
                f"are no multiple of {per_forward} (2 per layer and forward)")
        if "moe_anatomy" in phases:
            phase_anatomy(torch, dev, model, np, "moe decode tick")
        del model
        torch.cuda.empty_cache()
        if "moe_check" in phases:
            model = build_moe_model(torch, dev, MOE_CHECK_LAYERS, "moe_check")
            phase_check(torch, model, moe_reqs, "moe_check", MOE_CHECK_REL,
                        twice=True)
            del model
            torch.cuda.empty_cache()
    if "moe_train" in phases:
        counts["moe_train"] = phase_moe_train(
            torch, dev, np, "moe_check" in phases, "moe_anatomy" in phases)
    if "f16_moe" in phases:
        tp = time.monotonic()
        f16m, routes["f16_moe_serve"] = phase_f16_moe(torch, dev, np)
        counts.update(f16m)
        log(f"[f16_moe] phase {time.monotonic() - tp:.1f} s")
    if {"window_serve", "window_check"} & set(phases):
        model = build_mistral(torch, dev)
        counts["window_serve"], win_reqs = phase_window_serve(torch, dev,
                                                              model, np)
        if "window_check" in phases:
            phase_window_check(torch, model, win_reqs)
        del model
        torch.cuda.empty_cache()
    # BLOOM-560m and Falcon-RW-1B: generate (+ prompt-logit check), then
    # the train step on the same model
    for fam in ("bloom", "falcon_rw"):
        if not {f"{fam}_serve", f"{fam}_train"} & set(phases):
            continue
        model = build_generate_model(torch, dev, fam)
        if f"{fam}_serve" in phases:
            counts[f"{fam}_serve"], prompts = phase_generate(
                torch, dev, model, np, f"{fam}_serve")
            phase_prompt_check(torch, model, prompts, f"{fam}_check")
        if f"{fam}_train" in phases:
            counts[f"{fam}_train"] = phase_alibi_train(
                torch, dev, np, f"{fam}_train", model, "anatomy" in phases)
        del model
        torch.cuda.empty_cache()
    if "falcon7b_serve" in phases:
        model = build_generate_model(torch, dev, "falcon7b")
        counts["falcon7b_serve"], prompts = phase_generate(
            torch, dev, model, np, "falcon7b_serve")
        del model
        torch.cuda.empty_cache()
        model = build_generate_model(torch, dev, "falcon7b",
                                     FALCON7B_CHECK_LAYERS)
        phase_prompt_check(torch, model, prompts, "falcon7b_check")
        del model
        torch.cuda.empty_cache()
    # head dim 256: Gemma-2B's train step, Gemma-7B and GPT-J-6B generating
    # whole (their prompt logits checked at HD256_CHECK_LAYERS layers),
    # GPT-J-6B's widths trained at GPTJ_TRAIN_LAYERS layers
    if "gemma_train" in phases:
        counts["gemma_train"] = phase_hd256_train(
            torch, dev, np, "gemma_train", "anatomy" in phases)
    for fam in ("gemma7b", "gptj"):
        if f"{fam}_serve" not in phases:
            continue
        model = build_generate_model(torch, dev, fam)
        counts[f"{fam}_serve"], prompts = phase_generate(
            torch, dev, model, np, f"{fam}_serve")
        del model
        torch.cuda.empty_cache()
        model = build_generate_model(torch, dev, fam, HD256_CHECK_LAYERS)
        phase_prompt_check(torch, model, prompts, f"{fam}_check")
        del model
        torch.cuda.empty_cache()
    if "gptj_train" in phases:
        counts["gptj_train"] = phase_hd256_train(
            torch, dev, np, "gptj_train", "anatomy" in phases)
    # GPT-3 1.3B trained as bench_gpt3_tp; Pythia-6.9B, OPT-6.7B, Phi-2 and
    # GLM-4-9B generating whole (prompt logits checked at
    # DECODER_CHECK_LAYERS layers); Phi-2's widths trained at head dim 80
    if "gpt3_train" in phases:
        tp = time.monotonic()
        counts["gpt3_train"] = phase_gpt3_train(torch, dev, np,
                                                "anatomy" in phases)
        log(f"[gpt3_train] phase {time.monotonic() - tp:.1f} s")
    for fam, path in DECODER_SERVE:
        if path in phases:
            tp = time.monotonic()
            counts[path] = phase_decoder_serve(torch, dev, np, fam, path)
            log(f"[{path}] phase {time.monotonic() - tp:.1f} s")
        if path == "phi_serve" and "phi_train" in phases:
            tp = time.monotonic()
            counts["phi_train"] = phase_phi_train(torch, dev, np,
                                                  "anatomy" in phases)
            log(f"[phi_train] phase {time.monotonic() - tp:.1f} s")
    # the BERT-family encoders: bench_bert_dp's pretraining step, a
    # varlen fine-tune step and encoding, the other encoders' forwards
    for name in ("bert_train", "bert_finetune", "bert_encode",
                 "encoder_serve"):
        if name in phases:
            tp = time.monotonic()
            got = globals()[f"phase_{name}"](torch, dev, np)
            if name in PATHS:
                counts[name] = got
            log(f"[{name}] phase {time.monotonic() - tp:.1f} s")
    kern = []
    for path, names in PATHS.items():
        for name in names:
            src, rep = SOURCES[name]
            rs = results.get(path, {}).get(name, {})
            # K6a at moe_serve: one entry for each product on a route (the
            # variant's first word), each taking its half of that route's
            # launches in the path's run (a forward launches gate_up and
            # down on the same route)
            for r in (rs if isinstance(rs, list) else [rs]):
                n = counts.get(path, {}).get(name, 0)
                if isinstance(rs, list):
                    n = routes.get(path, {}).get(name, {}).get(
                        r["variant"].split()[0], 0) // 2
                kern.append({"name": name, "path": path, "route": "cuda",
                             "variant": r.get("variant"),
                             **({"nsplit": r["nsplit"]} if "nsplit" in r
                                else {}),
                             **({"graph_ms": r["graph_ms"]}
                                if "graph_ms" in r else {}),
                             "source": src, "replaces": rep,
                             "launches": n,
                             "max_abs_err": r.get("max_abs_err"),
                             "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                             "bound_ms": r.get("bound_ms"),
                             "bound_by": r.get("bound_by"),
                             "library_ms": r.get("library_ms")})
    log(f"[done] {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
