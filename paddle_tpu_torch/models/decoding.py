"""Sampling and decoding — counterpart of ``paddle_tpu/models/decoding.py``:
the engine's per-row sampling (``_sample_rows``), the scalar-parameter
``_sample`` with the CTRL repetition penalty, the dense :class:`KVCache`
(the serving engine's draft model decodes into it, ``models/speculative.py``
``_forward_rows``), the Llama family's cached generation API
(:func:`llama_forward_with_cache`, :func:`generate`, :func:`beam_search`
and the beam step :func:`beam_select` the paged and serving beams share),
and the family-agnostic :func:`generic_generate`.

The cached forward attends over the dense cache in plain PyTorch, as the
reference computes it in XLA outside any Pallas kernel; its norms run K1
and its ropes K7 on the card. A sliding-window model masks keys below
the window over the dense cache where the reference keeps a ring of
``window`` slots: the same keys are attended, the ring only saves
memory.

``jax.random.categorical`` bits cannot be reproduced with a
``torch.Generator``, so parity with the reference is checked on the
filtered, scaled logits (:func:`filter_rows`, :func:`filter_logits`) and
on greedy rows; the draw itself is a Gumbel-max over those logits with
noise from an explicit generator on the logits' device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from paddle_tpu_torch.core.device import resolve_device

_NEG = -1e30


@dataclass
class KVCache:
    """Per-layer dense [B, cap + 1, H_kv, D] k/v buffers, written in place.
    Positions 0..cap-1 are the cache; position ``cap`` is a write sink
    for masked rows (the reference's out-of-bounds ``mode="drop"``
    scatter), never read (:attr:`view_k` / :attr:`view_v` stop before
    it). The reference's sliding-window ring (``slot_pos``) is not
    ported: the engine refuses speculation under a window."""
    k: list
    v: list

    @staticmethod
    def init(num_layers, batch, max_len, num_kv_heads, head_dim, dtype,
             device=None):
        dev = resolve_device(device)
        shape = (batch, max_len + 1, num_kv_heads, head_dim)
        return KVCache(
            [torch.zeros(shape, dtype=dtype, device=dev)
             for _ in range(num_layers)],
            [torch.zeros(shape, dtype=dtype, device=dev)
             for _ in range(num_layers)])

    @property
    def capacity(self) -> int:
        return self.k[0].shape[1] - 1

    def view_k(self, li):
        return self.k[li][:, :self.capacity]

    def view_v(self, li):
        return self.v[li][:, :self.capacity]


def filter_rows(logits, temps, top_ps, top_k=None, bias=None):
    """The distribution ``_sample_rows`` draws from, as logits: grammar
    ``bias`` added, temperature scale (rows with temperature 0 scale by
    1), the static ``top_k`` cut, then the per-row nucleus (``top_ps``)
    cut; cut entries hold -1e30."""
    if bias is not None:
        logits = logits + bias
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    scaled = logits / safe_t
    if top_k is not None and top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[..., -top_k][..., None]
        scaled = torch.where(scaled < kth, _NEG, scaled)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_ps[:, None], dim=-1, keepdim=True)
    cutoff_idx = torch.clamp(cutoff_idx, max=scaled.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(scaled < cutoff, _NEG, scaled)


def _gumbel_max(logits, gen):
    """A draw from softmax(logits) per row: argmax of logits + Gumbel
    noise from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(1e-20))),
                        dim=-1)


def _sample_rows(logits, gen, temps, top_ps, top_k=None, bias=None):
    """Per-ROW temperature/top-p sampling (the serving engine's
    per-request params). ``temps``/``top_ps``: [B] tensors — temperature
    0 means greedy FOR THAT ROW; top_p 1.0 disables the nucleus cut.
    ``gen``: a ``torch.Generator`` on the logits' device. Returns [B]
    int64 on the logits' device."""
    sampled = _gumbel_max(filter_rows(logits, temps, top_ps, top_k, bias),
                          gen)
    if bias is not None:
        logits = logits + bias
    return torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1))


def _apply_repetition_penalty(logits, appeared, penalty):
    """CTRL-style penalty (PaddleNLP GenerationMixin): divide positive
    scores / multiply negative scores of the tokens in ``appeared``."""
    if penalty == 1.0:
        return logits
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(appeared, penalised, logits)


def filter_logits(logits, temperature, top_k=None, top_p=None):
    """The distribution the reference's ``_sample`` draws from, as logits
    (``temperature`` > 0): scaled by the temperature, the ``top_k`` cut,
    then the nucleus (``top_p`` < 1) cut; cut entries hold -1e30."""
    logits = logits / temperature
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, _NEG, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff_idx = torch.clamp(cutoff_idx, max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, _NEG, logits)
    return logits


def _sample(logits, gen, temperature, top_k, top_p):
    """One token a row under one set of parameters: argmax at temperature
    0, else a draw from :func:`filter_logits`."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return _gumbel_max(filter_logits(logits, temperature, top_k, top_p), gen)


@torch.no_grad()
def generic_generate(model, input_ids, max_new_tokens=32, temperature=0.0,
                     top_k=None, top_p=None, eos_token_id=None,
                     generator=None, repetition_penalty=1.0,
                     min_new_tokens=0):
    """Family-agnostic decoding (PaddleNLP GenerationMixin over every
    causal architecture) for any model whose ``forward(ids [B, S]) ->
    logits [B, S, V]`` — BLOOM, Falcon, ... — with the reference's
    sampling, penalty and EOS semantics. Returns the token buffer
    [B, prompt + max_new_tokens] (int64, on the model's device).

    As in the reference, the whole fixed-shape buffer (prompt, then zeros)
    is re-forwarded at every step, with no KV cache: position p's logits
    depend only on tokens <= p under causal masking, so the zero-padded
    future is inert. After a row emits ``eos_token_id`` it repeats it;
    the loop stops once every row has, leaving the rest of the buffer 0.
    EOS is masked until ``min_new_tokens`` tokens were generated. Sampling
    draws from ``generator`` (a ``torch.Generator`` on the model's device;
    default: seed 0)."""
    dev = next(model.parameters()).device
    ids = torch.as_tensor(input_ids, device=dev).long()
    b, prompt_len = ids.shape
    vocab = model.cfg.vocab_size
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))
    rows = torch.arange(b, device=dev)
    eos_col = None
    if eos_token_id is not None and min_new_tokens > 0:
        eos_col = torch.arange(vocab, device=dev) == eos_token_id

    def next_token(tokens, pos, appeared, gen_len):
        logits = model(tokens)[:, pos].float()
        logits = _apply_repetition_penalty(logits, appeared,
                                           repetition_penalty)
        if eos_col is not None and gen_len < min_new_tokens:
            logits = torch.where(eos_col[None, :], _NEG, logits)
        return _sample(logits, gen, temperature, top_k, top_p)

    tokens = torch.cat([ids, ids.new_zeros(b, max_new_tokens)], dim=1)
    appeared = torch.zeros(b, vocab, dtype=torch.bool, device=dev)
    appeared[rows[:, None], ids] = True
    nxt = next_token(tokens, prompt_len - 1, appeared, 0)
    appeared[rows, nxt] = True
    tokens[:, prompt_len] = nxt
    done = (torch.zeros(b, dtype=torch.bool, device=dev)
            if eos_token_id is None else nxt == eos_token_id)
    i = 0
    while i < max_new_tokens - 1 and not bool(done.all()):
        nxt = next_token(tokens, prompt_len + i, appeared, i + 1)
        if eos_token_id is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        appeared[rows, nxt] = True
        tokens[:, prompt_len + i + 1] = nxt
        i += 1
    return tokens


# ---------------------------------------------- cached generation (Llama)
def _model_device(model):
    return next(model.parameters()).device


@torch.no_grad()
def llama_forward_with_cache(model, input_ids, cache: KVCache, pos: int):
    """One forward over ``input_ids`` [B, S] (a prompt or one token a row)
    at cache positions ``pos .. pos+S-1``: K/V written into ``cache`` in
    place, each query attending every cached position up to its own (and
    inside the model's sliding window). Returns (logits [B, S, V],
    cache). Dynamic-NTK rope takes its base from the length ``pos + S``,
    as the reference's does."""
    from paddle_tpu_torch.models.paged import (_backbone, _layer_tail,
                                               _model_logits, _qkv,
                                               model_config)
    from paddle_tpu_torch.ops import attention as A
    cfg = model_config(model)
    dev = cache.k[0].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, s = input_ids.shape
    d = cfg.hidden_size // cfg.num_attention_heads
    positions = pos + torch.arange(s, device=dev)
    cos, sin = A.rope_cos_sin(
        s, d, base=cfg.rope_theta, position_ids=positions,
        scaling=cfg.rope_scaling,
        max_position_embeddings=cfg.max_position_embeddings,
        cur_len=pos + s, allow_dynamic=False, device=dev)
    cap = cache.capacity
    if pos + s > cap:
        raise ValueError(f"positions {pos}..{pos + s - 1} exceed the "
                         f"cache's {cap}")
    key_idx = torch.arange(cap, device=dev)[None, :]
    keep = key_idx <= positions[:, None]                       # [S, cap]
    if cfg.sliding_window is not None:
        keep = keep & (positions[:, None] - key_idx < cfg.sliding_window)
    x = _backbone(model).embed_tokens[input_ids]
    for li, lyr in enumerate(_backbone(model).layers):
        h = lyr.input_layernorm(x)
        q, k, v = _qkv(lyr.self_attn, h, (b, s), (b, s))
        q = A.apply_rope(q, cos, sin)
        k = A.apply_rope(k, cos, sin)
        cache.k[li][:, pos:pos + s] = k.to(cache.k[li].dtype)
        cache.v[li][:, pos:pos + s] = v.to(cache.v[li].dtype)
        out = A.eager_attention(q, cache.view_k(li), cache.view_v(li),
                                attn_mask=keep[None, None])
        x = _layer_tail(lyr, x, out, (b, s))
    x = _backbone(model).norm(x)
    return _model_logits(model, x), cache


def _new_cache(model, batch, max_len):
    from paddle_tpu_torch.models.paged import model_config
    cfg = model_config(model)
    return KVCache.init(cfg.num_hidden_layers, batch, max_len,
                        cfg.num_key_value_heads,
                        cfg.hidden_size // cfg.num_attention_heads,
                        cfg.dtype, device=_model_device(model))


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, temperature=0.0,
             top_k=None, top_p=None, eos_token_id=None, generator=None,
             repetition_penalty=1.0, min_new_tokens=0):
    """Greedy/temperature/top-k/top-p decoding over the dense cache (the
    reference's ``generate``, PaddleNLP GenerationMixin) with the CTRL
    repetition penalty and a minimum length (EOS masked until
    ``min_new_tokens`` tokens were generated). After a row emits
    ``eos_token_id`` it repeats it; the loop stops once every row has.
    Sampling draws from ``generator`` (a ``torch.Generator`` on the
    model's device; default: seed 0). Returns [B, prompt +
    max_new_tokens] int64 tokens on the model's device."""
    dev = _model_device(model)
    ids = torch.as_tensor(input_ids, device=dev).long()
    b, prompt_len = ids.shape
    vocab = model.cfg.vocab_size
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))
    cache = _new_cache(model, b, prompt_len + max_new_tokens)
    rows = torch.arange(b, device=dev)
    eos_col = None
    if eos_token_id is not None and min_new_tokens > 0:
        eos_col = torch.arange(vocab, device=dev) == eos_token_id

    def pick(logits, appeared, gen_len):
        logits = _apply_repetition_penalty(logits.float(), appeared,
                                           repetition_penalty)
        if eos_col is not None and gen_len < min_new_tokens:
            logits = torch.where(eos_col[None, :], _NEG, logits)
        return _sample(logits, gen, temperature, top_k, top_p)

    appeared = torch.zeros(b, vocab, dtype=torch.bool, device=dev)
    appeared[rows[:, None], ids] = True
    logits, cache = llama_forward_with_cache(model, ids, cache, 0)
    nxt = pick(logits[:, -1], appeared, 0)
    appeared[rows, nxt] = True
    tokens = torch.cat([ids, ids.new_zeros(b, max_new_tokens)], dim=1)
    tokens[:, prompt_len] = nxt
    done = (torch.zeros(b, dtype=torch.bool, device=dev)
            if eos_token_id is None else nxt == eos_token_id)
    i = 0
    while i < max_new_tokens - 1 and not bool(done.all()):
        cur = tokens[:, prompt_len + i: prompt_len + i + 1]
        logits, cache = llama_forward_with_cache(model, cur, cache,
                                                 prompt_len + i)
        nxt = pick(logits[:, -1], appeared, i + 1)
        if eos_token_id is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        appeared[rows, nxt] = True
        tokens[:, prompt_len + i + 1] = nxt
        i += 1
    return tokens


def _top_k(x, k):
    """The ``k`` largest entries of the last axis, largest first; ties
    keep the lower index first, as ``lax.top_k`` does (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x, idx):
    """``take_along_axis(x, idx, axis=1)`` for [B, N, ...] x and [B, M]
    idx."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (x.ndim - 2))
                        .expand(*idx.shape, *x.shape[2:]))


_BEAM_NEG = -1e9


def beam_select(running_lp, seqs, fin_seqs, fin_scores, logp, i,
                prompt_len, eos_token_id, length_penalty):
    """One beam expansion: place token ``i``, split the 2K best
    candidates into a finished (EOS) pool and a running pool. Shapes:
    running_lp / fin_scores [B, K] fp32, seqs / fin_seqs [B, K, L] int64,
    logp [B, K, V] fp32. Shared by :func:`beam_search`, the paged beam
    (``models/paged.py``) and the serving engine's beam groups, so their
    selection math can never drift apart. Returns (running_lp, seqs,
    fin_seqs, fin_scores, new_beam [B, K] parent beams, new_tok [B, K])."""
    b, k = running_lp.shape
    v = logp.shape[-1]
    total = running_lp[:, :, None] + logp                      # [B, K, V]
    cand_lp, cand_idx = _top_k(total.reshape(b, k * v), 2 * k)
    beam = cand_idx // v                                        # [B, 2K]
    tok = cand_idx % v
    cand_seqs = _take(seqs, beam).clone()
    cand_seqs[:, :, prompt_len + i] = tok
    if eos_token_id is not None:
        is_eos = tok == eos_token_id
    else:
        is_eos = torch.zeros_like(tok, dtype=torch.bool)
    # the length penalty in fp32, as the reference's traced arithmetic
    denom = torch.tensor(i + 1.0, dtype=torch.float32,
                         device=cand_lp.device) ** float(length_penalty)
    cand_score = cand_lp / denom
    neg = torch.full_like(cand_lp, _BEAM_NEG)
    all_scores = torch.cat([fin_scores, torch.where(is_eos, cand_score, neg)],
                           dim=1)
    all_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
    fin_scores, fin_idx = _top_k(all_scores, k)
    fin_seqs = _take(all_seqs, fin_idx)
    running_lp, run_idx = _top_k(torch.where(is_eos, neg, cand_lp), k)
    seqs = _take(cand_seqs, run_idx)
    return (running_lp, seqs, fin_seqs, fin_scores,
            torch.gather(beam, 1, run_idx), torch.gather(tok, 1, run_idx))


def beam_finalize(running_lp, seqs, fin_seqs, fin_scores, prompt_len,
                  max_new_tokens, eos_token_id, length_penalty):
    """The best hypothesis per batch row among the finished pool and the
    still-running beams (scored at full length), EOS-filled past its
    first EOS. Returns (best_seqs [B, L], best_scores [B])."""
    denom = torch.tensor(float(max_new_tokens), dtype=torch.float32,
                         device=running_lp.device) ** float(length_penalty)
    all_scores = torch.cat([fin_scores, running_lp / denom], dim=1)
    all_seqs = torch.cat([fin_seqs, seqs], dim=1)
    best = torch.argmax(all_scores, dim=1)
    rows = torch.arange(all_scores.shape[0], device=best.device)
    best_seqs = all_seqs[rows, best].clone()
    best_scores = all_scores[rows, best]
    if eos_token_id is not None:
        gen = best_seqs[:, prompt_len:]
        seen = torch.cumsum(gen == eos_token_id, dim=1)
        after = torch.cat([torch.zeros_like(seen[:, :1], dtype=torch.bool),
                           (seen > 0)[:, :-1]], dim=1)
        best_seqs[:, prompt_len:] = torch.where(
            after, torch.full_like(gen, eos_token_id), gen)
    return best_seqs, best_scores


def beam_init(logits_last, prompt, num_beams, max_new_tokens):
    """Selection state before the first :func:`beam_select`: logp of the
    prompt's last logits broadcast over the beams, beam 0 live and the
    others at -1e9 (so the first select picks K distinct tokens), the
    sequences holding the prompt. ``logits_last`` [B, V]; ``prompt``
    [B, S] int64. Returns (running_lp, seqs, fin_seqs, fin_scores,
    logp)."""
    b, s = prompt.shape
    k, dev = num_beams, logits_last.device
    logp = torch.log_softmax(logits_last.float(), dim=-1)
    logp = logp[:, None, :].expand(b, k, logp.shape[-1])
    running_lp = torch.full((b, k), _BEAM_NEG, dtype=torch.float32,
                            device=dev)
    running_lp[:, 0] = 0.0
    seqs = torch.zeros(b, k, s + max_new_tokens, dtype=torch.int64,
                       device=dev)
    seqs[:, :, :s] = prompt.to(dev)[:, None, :]
    fin_scores = torch.full((b, k), _BEAM_NEG, dtype=torch.float32,
                            device=dev)
    return running_lp, seqs, torch.zeros_like(seqs), fin_scores, logp


@torch.no_grad()
def beam_search(model, input_ids, max_new_tokens=32, num_beams=4,
                length_penalty=1.0, eos_token_id=None):
    """Beam search over the dense cache (PaddleNLP
    ``GenerationMixin.beam_search`` / ``BeamSearchScorer``): the prompt is
    prefilled once at batch B, the cache tiled over a beam axis [B*K],
    and every step is one batched forward after the cache rows are
    gathered along the chosen parents. Returns (sequences [B, prompt +
    max_new_tokens], scores [B]) — the best finished hypothesis per row
    (length-penalised log prob, ``sum logp / len**alpha``), EOS-filled
    after its first EOS."""
    dev = _model_device(model)
    ids = torch.as_tensor(input_ids, device=dev).long()
    b, prompt_len = ids.shape
    k = num_beams
    cache = _new_cache(model, b, prompt_len + max_new_tokens)
    logits, cache = llama_forward_with_cache(model, ids, cache, 0)
    cache = KVCache([t.repeat_interleave(k, dim=0) for t in cache.k],
                    [t.repeat_interleave(k, dim=0) for t in cache.v])
    running_lp, seqs, fin_seqs, fin_scores, logp = beam_init(
        logits[:, -1], ids, k, max_new_tokens)
    base = (torch.arange(b, device=dev) * k)[:, None]
    for i in range(max_new_tokens):
        running_lp, seqs, fin_seqs, fin_scores, new_beam, new_tok = \
            beam_select(running_lp, seqs, fin_seqs, fin_scores, logp, i,
                        prompt_len, eos_token_id, length_penalty)
        if i == max_new_tokens - 1:
            break                   # the last token: selection only
        order = (base + new_beam).reshape(-1)
        cache = KVCache([t[order] for t in cache.k],
                        [t[order] for t in cache.v])
        logits, cache = llama_forward_with_cache(
            model, new_tok.reshape(b * k, 1), cache, prompt_len + i)
        logp = torch.log_softmax(logits[:, -1].float(),
                                 dim=-1).reshape(b, k, -1)
    return beam_finalize(running_lp, seqs, fin_seqs, fin_scores, prompt_len,
                         max_new_tokens, eos_token_id, length_penalty)
