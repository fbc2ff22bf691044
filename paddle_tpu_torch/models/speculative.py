"""Speculative decoding with a draft model — counterpart of
``paddle_tpu/models/speculative.py`` (ref capability: the PaddleNLP
``llm`` predictor's speculative / draft-model decoding).

The standalone API over the dense :class:`~paddle_tpu_torch.models.
decoding.KVCache`: :func:`speculative_generate` (greedy, one sequence),
:func:`speculative_generate_batched` (greedy, ragged rows advancing at
their own acceptance) and :func:`speculative_sample` (the stochastic
accept-reject rule, drawn on the host with ``np.random.RandomState(seed)``
as the reference draws). The draft proposes ``gamma`` tokens; the target
verifies them in ONE chunk forward and commits the longest matching
prefix plus its own next token, so the greedy output is exactly the
target's own greedy decode. "Rollback" is free: chunk writes are
positional overwrites and causal masking never reads past a row's
frontier. The loops are eager and read the argmaxes on the host every
round, as the reference's are.

The serving engine (``serving/engine.py``) drafts through
:func:`_forward_rows` too, verifies in one target chunk through the
paged pool (``models/paged.py`` ``llama_verify_chunk_paged``, K3 on the
card) and rolls rejected positions back by lengths alone
(``spec_rewind_lens``). The accept rules are ``models/paged.py``'s
``greedy_accept_length`` and ``stochastic_accept_row``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from paddle_tpu_torch.models.decoding import (KVCache, _new_cache,
                                              llama_forward_with_cache)
from paddle_tpu_torch.models.paged import (_apply_rope_rows, _backbone,
                                           _mlp_out, _model_logits, _qkv,
                                           greedy_accept_length,
                                           model_config,
                                           spec_advance_frontiers,
                                           stochastic_accept_row)
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.quantization import wo_matmul as _wo


@torch.no_grad()
def _forward_rows(model, input_ids, cache: KVCache, row_pos, chunk_lens=None,
                  chunk_end_len=None):
    """Chunk forward with PER-ROW positions: row b's tokens occupy cache
    positions ``row_pos[b] .. row_pos[b]+C-1`` (rope, cache writes and
    causal visibility all per row). After the first speculative round
    every row sits at a different position (different acceptance
    counts), so this is what makes the draft batchable. Stale cache
    entries beyond a row's frontier are never visible (key j attends iff
    j <= row_pos[b]+i) and are overwritten by the row's next chunk.

    ``chunk_lens`` ([B]): per-row WRITE mask — row b commits only its
    first chunk_lens[b] positions to the cache (a row at 0 writes nothing
    at all): slots propose different k, so padding columns and whole
    padding rows must not clobber cache entries. Masked writes go to the
    cache's sink position, the counterpart of the reference's
    out-of-bounds dropped scatter (NOT a clamp, which would corrupt
    position cap-1). The cache is written in place; returns the logits
    [B, C, V].

    ``chunk_end_len`` ([B], dynamic-NTK only): rotate the WHOLE chunk of
    row b with the base of its chunk-end length ``chunk_end_len[b]`` —
    what ``generate()``'s prefill does. Without it each position takes
    the base of its own length ``pos + 1``, the one-token-per-step decode
    that verify chunks must reproduce; a prefill must pass it.

    Attention here is plain PyTorch (``ops.attention.eager_attention``)
    over the dense cache: the reference computes it with
    ``xla_attention``, outside any Pallas kernel. The norms run K1 and
    the ropes K7 on the card."""
    cfg = model_config(model)
    if cfg.sliding_window:
        raise NotImplementedError("speculative rows-forward: no window")
    dev = cache.k[0].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, c = input_ids.shape
    row_pos = torch.as_tensor(row_pos, device=dev).long()
    x = _backbone(model).embed_tokens[input_ids]
    d = cfg.hidden_size // cfg.num_attention_heads
    positions = row_pos[:, None] + torch.arange(c, device=dev)   # [B, C]
    cur_len = None
    if (cfg.rope_scaling or {}).get("type") == "dynamic":
        cur_len = (positions + 1 if chunk_end_len is None else
                   torch.as_tensor(chunk_end_len, device=dev).long()[:, None])
    base, pos_div = A.resolve_rope_scaling(
        cfg.rope_theta, d, cfg.rope_scaling, allow_dynamic=False,
        max_position_embeddings=cfg.max_position_embeddings, cur_len=cur_len)
    base = torch.as_tensor(base, dtype=torch.float32, device=dev)
    base = base.reshape((1, 1) if base.ndim == 0 else base.shape)  # [B|1,C|1]
    inv = 1.0 / (base[:, :, None]
                 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                  device=dev) / d))
    f = (positions.float() / pos_div)[:, :, None] * inv
    cos, sin = torch.cos(f), torch.sin(f)                     # [B, C, D/2]
    cap = cache.capacity
    vis = (torch.arange(cap, device=dev)[None, None, :]
           <= positions[:, :, None])[:, None]                 # [B,1,C,L]
    wpos = positions
    if chunk_lens is not None:
        cl = torch.as_tensor(chunk_lens, device=dev).long()
        wpos = torch.where(torch.arange(c, device=dev)[None, :]
                           < cl[:, None], positions, cap)
    wpos = torch.clamp(wpos, max=cap)          # past the cache: the sink
    row = torch.arange(b, device=dev)[:, None]
    for li, lyr in enumerate(_backbone(model).layers):
        h = lyr.input_layernorm(x)
        att = lyr.self_attn
        q, k, v = _qkv(att, h, (b, c), (b, c))
        q = _apply_rope_rows(q, cos, sin)
        k = _apply_rope_rows(k, cos, sin)
        cache.k[li][row, wpos] = k.to(cache.k[li].dtype)
        cache.v[li][row, wpos] = v.to(cache.v[li].dtype)
        out = A.eager_attention(q, cache.view_k(li), cache.view_v(li),
                                attn_mask=vis)
        x = x + _wo(out.reshape(b, c, att.num_heads * att.head_dim),
                    att.o_proj)
        x = x + _mlp_out(lyr, lyr.post_attention_layernorm(x))
    x = _backbone(model).norm(x)
    return _model_logits(model, x)


def _greedy(logits):
    return int(torch.argmax(logits.float(), dim=-1).reshape(-1)[0])


def _stats(rounds, proposed, accepted, draft_s, verify_s):
    """The reference's stats dict, plus the host seconds spent drafting
    and verifying (each round reads its argmaxes on the host, so the
    clock sees the device work)."""
    return {"rounds": rounds, "proposed": proposed, "accepted": accepted,
            "acceptance_rate": accepted / max(proposed, 1),
            "draft_s": draft_s, "verify_s": verify_s}


def _buffer(ids, committed, max_new_tokens, eos_token_id):
    """[1, S + max_new_tokens]: the prompt, the committed tokens cut at
    the first EOS, zeros after — ``generate()``'s single-sequence
    buffer."""
    committed = committed[:max_new_tokens]
    if eos_token_id is not None and eos_token_id in committed:
        committed = committed[: committed.index(eos_token_id) + 1]
    out = torch.zeros(1, ids.shape[1] + max_new_tokens, dtype=torch.long,
                      device=ids.device)
    out[0, :ids.shape[1]] = ids[0]
    out[0, ids.shape[1]: ids.shape[1] + len(committed)] = torch.tensor(
        committed, dtype=torch.long)
    return out


def _no_window(*cfgs):
    if any(c.sliding_window for c in cfgs):
        raise NotImplementedError(
            "speculative decoding over a windowed ring cache is not "
            "supported (positional overwrite-rollback needs the full cache)")


@torch.no_grad()
def speculative_generate(target, draft, input_ids, max_new_tokens: int = 32,
                         gamma: int = 4, eos_token_id=None):
    """Greedy speculative decode of ONE sequence. ``input_ids``: [1, S].
    Returns (tokens [1, S + max_new_tokens] int64 on the target's device,
    stats). The tokens equal ``generate()``'s greedy buffer exactly,
    zeros after the first EOS included."""
    t_cfg, d_cfg = model_config(target), model_config(draft)
    dev = next(target.parameters()).device
    ids = torch.as_tensor(input_ids, device=dev).long()
    if ids.shape[0] != 1:
        raise ValueError("speculative_generate is single-sequence (B == 1)")
    _no_window(t_cfg, d_cfg)
    prompt_len = ids.shape[1]
    max_len = prompt_len + max_new_tokens + gamma + 2
    dynamic = any((c.rope_scaling or {}).get("type") == "dynamic"
                  for c in (t_cfg, d_cfg))

    def fwd(model, chunk, cache, pos, chunk_end=None):
        chunk = torch.as_tensor(chunk, device=dev).long()
        if not dynamic:
            # llama_forward_with_cache is natively chunk-end based
            return llama_forward_with_cache(model, chunk, cache, pos)[0]
        # verify chunks rotate every position with its own length, the
        # prefill with the chunk-end length (generate()'s prefill)
        rows = chunk.shape[0]
        ce = None if chunk_end is None else torch.full((rows,), chunk_end)
        return _forward_rows(model, chunk, cache, torch.full((rows,), pos),
                             chunk_end_len=ce)

    cache_t = _new_cache(target, 1, max_len)
    cache_d = _new_cache(draft, 1, max_len)
    logits_t = fwd(target, ids, cache_t, 0, chunk_end=prompt_len)
    fwd(draft, ids, cache_d, 0, chunk_end=prompt_len)

    committed = [_greedy(logits_t[:, -1])]   # tokens at prompt_len + i
    c = committed[0]
    pos = draft_pos = prompt_len        # caches valid through pos - 1
    rounds = accepted_total = 0
    draft_s = verify_s = 0.0

    def done():
        return (len(committed) >= max_new_tokens
                or (eos_token_id is not None and eos_token_id in committed))

    while not done():
        rounds += 1
        t0 = time.perf_counter()
        # the draft first takes the committed tokens it has not seen; its
        # last logit starts the proposals
        pending = committed[draft_pos - prompt_len:]
        dl = fwd(draft, [pending], cache_d, draft_pos)
        draft_pos += len(pending)
        props = [_greedy(dl[:, -1])]
        for _ in range(gamma - 1):
            dl = fwd(draft, [[props[-1]]], cache_d, draft_pos)
            draft_pos += 1
            props.append(_greedy(dl[:, -1]))
        t1 = time.perf_counter()
        # the target verifies the chunk at positions pos .. pos + gamma
        tl = fwd(target, [[c] + props], cache_t, pos)
        vs = torch.argmax(tl.float(), dim=-1)[0].cpu().numpy()
        n_acc = int(greedy_accept_length(vs[:gamma], props))
        # the accepted prefix and the target's own next token (the
        # correction, or the bonus token when every proposal matched)
        new = props[:n_acc] + [int(vs[n_acc])]
        committed.extend(new)
        accepted_total += n_acc
        pos, draft_pos = spec_advance_frontiers(pos, draft_pos, len(new))
        pos, draft_pos = int(pos), int(draft_pos)
        c = committed[-1]
        draft_s += t1 - t0
        verify_s += time.perf_counter() - t1

    return (_buffer(ids, committed, max_new_tokens, eos_token_id),
            _stats(rounds, rounds * gamma, accepted_total, draft_s,
                   verify_s))


def _last_argmax(logits, lens):
    """[B] argmax of each row's logits at position ``lens - 1``."""
    idx = torch.as_tensor(lens - 1, device=logits.device).long()
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.argmax(logits[rows, idx].float(), dim=-1).cpu().numpy()


@torch.no_grad()
def speculative_generate_batched(target, draft, input_ids, prompt_lens=None,
                                 max_new_tokens: int = 32, gamma: int = 4,
                                 eos_token_id=None):
    """BATCHED greedy speculative decoding. ``input_ids``: [B, S]
    right-padded ragged prompts with ``prompt_lens`` [B] (default S
    everywhere). Rows advance at their own acceptance, so every chunk runs
    through :func:`_forward_rows` (per-row rope, writes and visibility);
    each row's output is exactly its solo greedy decode, and finished rows
    are frozen (their re-verifications rewrite identical K/V). Returns
    (tokens [B, S + max_new_tokens] int64 on the target's device, stats);
    positions past a row's first EOS stay zero."""
    dev = next(target.parameters()).device
    ids_np = torch.as_tensor(input_ids).cpu().numpy()
    b, s = ids_np.shape
    lens_np = (np.full((b,), s, np.int64) if prompt_lens is None
               else np.asarray(torch.as_tensor(prompt_lens).cpu(), np.int64))
    max_len = int(lens_np.max()) + max_new_tokens + gamma + 2
    _no_window(model_config(target), model_config(draft))

    cache_t, cache_d = _new_cache(target, b, max_len), _new_cache(
        draft, b, max_len)
    zero = np.zeros((b,), np.int64)
    ids = torch.as_tensor(ids_np, device=dev).long()
    # ragged prefill with every row at position 0, each row's last valid
    # logit; under dynamic NTK each row's prompt rotates with the base of
    # its own length (generate()'s prefill); padding past a row's length
    # is stale and overwritten later
    logits_t = _forward_rows(target, ids, cache_t, zero,
                             chunk_end_len=lens_np)
    _forward_rows(draft, ids, cache_d, zero, chunk_end_len=lens_np)
    last = _last_argmax(logits_t, lens_np)

    committed = [[int(last[r])] for r in range(b)]
    c = last.astype(np.int64)                 # last committed token per row
    pos = lens_np.copy()                      # target frontier per row
    draft_pos = lens_np.copy()
    done = np.zeros((b,), bool)
    rounds = accepted_total = proposed_total = 0
    draft_s = verify_s = 0.0

    def row_done(r):
        return (len(committed[r]) >= max_new_tokens
                or (eos_token_id is not None
                    and eos_token_id in committed[r]))

    while not all(row_done(r) for r in range(b)):
        rounds += 1
        proposed_total += gamma * int((~done).sum())
        t0 = time.perf_counter()
        # the draft catches up on each row's pending committed suffix
        pend = [committed[r][int(draft_pos[r] - lens_np[r]):] if not done[r]
                else [int(c[r])] for r in range(b)]
        pmax = max(len(p) for p in pend)
        chunk = np.zeros((b, pmax), np.int64)
        for r in range(b):
            chunk[r, :len(pend[r])] = pend[r]
        dl = _forward_rows(draft, chunk, cache_d, draft_pos)
        plen = np.asarray([len(p) for p in pend], np.int64)
        draft_pos = np.where(done, draft_pos, draft_pos + plen)
        props = [_last_argmax(dl, plen)]
        for _ in range(gamma - 1):
            dl = _forward_rows(draft, props[-1][:, None], cache_d, draft_pos)
            draft_pos = np.where(done, draft_pos, draft_pos + 1)
            props.append(torch.argmax(dl[:, 0].float(), -1).cpu().numpy())
        props = np.stack(props, axis=1)                    # [B, gamma]
        t1 = time.perf_counter()

        # the target verifies every row's chunk in one forward
        chunk_t = np.concatenate([c[:, None], props], axis=1)
        tl = _forward_rows(target, chunk_t, cache_t, pos)
        vs = torch.argmax(tl.float(), dim=-1).cpu().numpy()
        n_acc = greedy_accept_length(vs[:, :gamma], props)     # [B]
        for r in range(b):
            if done[r]:
                continue
            na = int(n_acc[r])
            new = list(props[r, :na]) + [int(vs[r, na])]
            committed[r].extend(int(t) for t in new)
            accepted_total += na
            pos[r], draft_pos[r] = spec_advance_frontiers(
                int(pos[r]), int(draft_pos[r]), len(new))
            c[r] = committed[r][-1]
            done[r] = row_done(r)
        draft_s += t1 - t0
        verify_s += time.perf_counter() - t1

    out = np.zeros((b, s + max_new_tokens), np.int64)
    for r in range(b):
        toks = committed[r][:max_new_tokens]
        if eos_token_id is not None and eos_token_id in toks:
            toks = toks[: toks.index(eos_token_id) + 1]
        out[r, : lens_np[r]] = ids_np[r, : lens_np[r]]
        out[r, lens_np[r]: lens_np[r] + len(toks)] = toks
    return (torch.as_tensor(out, device=dev),
            _stats(rounds, proposed_total, accepted_total, draft_s,
                   verify_s))


@torch.no_grad()
def speculative_sample(target, draft, input_ids, max_new_tokens: int = 32,
                       gamma: int = 4, temperature: float = 1.0,
                       eos_token_id=None, seed: int = 0):
    """STOCHASTIC speculative decoding (the speculative-sampling accept
    rule, Leviathan et al. / Chen et al.): the draft proposes ``gamma``
    tokens by sampling its own distribution q, the target verifies the
    chunk once and accepts x_i with probability min(1, p_i(x_i) /
    q_i(x_i)); the first rejection resamples from norm(max(0, p_i - q_i)).
    The stream is distributed exactly as sampling the target alone. The
    draws come from ``np.random.RandomState(seed)`` on the host over the
    float32 softmax of both models' logits / ``temperature``, as in the
    reference, so the same seed gives the reference's tokens where the
    probabilities agree. ``input_ids``: [1, S]; temperature 0 is the
    lossless greedy :func:`speculative_generate`. Returns (tokens [1, S +
    max_new_tokens], stats)."""
    if temperature == 0.0:
        return speculative_generate(target, draft, input_ids,
                                    max_new_tokens=max_new_tokens,
                                    gamma=gamma, eos_token_id=eos_token_id)
    dev = next(target.parameters()).device
    ids = torch.as_tensor(input_ids, device=dev).long()
    if ids.shape[0] != 1:
        raise ValueError("speculative_sample is single-sequence (B == 1)")
    rs = np.random.RandomState(seed)
    prompt_len = ids.shape[1]
    max_len = prompt_len + max_new_tokens + gamma + 2

    def fwd(model, chunk, cache, pos):
        chunk = torch.as_tensor(chunk, device=dev).long()
        return llama_forward_with_cache(model, chunk, cache, pos)[0]

    def probs(logits):
        return torch.softmax(logits.float() / temperature, dim=-1) \
            .cpu().numpy().reshape(-1)

    cache_t = _new_cache(target, 1, max_len)
    cache_d = _new_cache(draft, 1, max_len)
    logits_t = fwd(target, ids, cache_t, 0)
    fwd(draft, ids, cache_d, 0)

    p0 = probs(logits_t[:, -1])
    committed = [int(rs.choice(p0.size, p=p0))]
    c = committed[0]
    pos = draft_pos = prompt_len
    rounds = accepted_total = 0
    draft_s = verify_s = 0.0

    def done():
        return (len(committed) >= max_new_tokens
                or (eos_token_id is not None and eos_token_id in committed))

    while not done():
        rounds += 1
        t0 = time.perf_counter()
        pending = committed[draft_pos - prompt_len:]
        dl = fwd(draft, [pending], cache_d, draft_pos)
        draft_pos += len(pending)
        props, qs = [], []
        q = probs(dl[:, -1])
        for _ in range(gamma):
            x = int(rs.choice(q.size, p=q))
            props.append(x)
            qs.append(q)
            dl = fwd(draft, [[x]], cache_d, draft_pos)
            draft_pos += 1
            q = probs(dl[:, -1])
        t1 = time.perf_counter()
        tl = fwd(target, [[c] + props], cache_t, pos)
        ps = [probs(tl[:, i]) for i in range(gamma + 1)]
        new, n_acc = stochastic_accept_row(props, qs, ps, rs)
        committed.extend(new)
        accepted_total += n_acc
        pos, draft_pos = spec_advance_frontiers(pos, draft_pos, len(new))
        pos, draft_pos = int(pos), int(draft_pos)
        c = committed[-1]
        draft_s += t1 - t0
        verify_s += time.perf_counter() - t1

    return (_buffer(ids, committed, max_new_tokens, eos_token_id),
            _stats(rounds, rounds * gamma, accepted_total, draft_s,
                   verify_s))
