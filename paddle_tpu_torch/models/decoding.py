"""Sampling and family-agnostic decoding — counterpart of
``paddle_tpu/models/decoding.py``: the engine's per-row sampling
(``_sample_rows``), the scalar-parameter ``_sample`` with the CTRL
repetition penalty, :func:`generic_generate`, and the dense
:class:`KVCache` the serving engine's draft model decodes into
(``models/speculative.py`` ``_forward_rows``).

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
