"""LLaMA-2 family — counterpart of ``paddle_tpu/models/llama.py``.

Same parameter names and the reference's ``[in, out]`` weight layout:
the fused ``self_attn.qkv_proj`` is ``[h, (nh + 2*nkv)*d]`` and the fused
``mlp.gate_up_proj`` ``[h, 2*m]``, both applied as ``x @ W``, so
:func:`paddle_tpu_torch.models.convert.load_jax_state_dict` loads a
reference model's ``state_dict()`` with no per-model table. Norms go
through ``ops.fused_rms_norm`` (K1 on the card) and attention through
``ops.attention.scaled_dot_product_attention`` (K2 forward and K5
backward on the card).

The parameters are trainable: :meth:`LlamaForCausalLM.loss` is what the
train step differentiates (``train.step.make_train_step``). ``remat``
recomputes each decoder layer in the backward pass (non-reentrant
``torch.utils.checkpoint``, the counterpart of the per-layer
``jax.checkpoint``). ``remat_policy`` names the layer's activations the
backward keeps (:meth:`LlamaConfig.save_names`, the reference's
``checkpoint_name`` tags ``qkv``, ``attn_ctx``, ``ffn_gu``, ``ffn_out``).
Torch's selective-checkpoint policies decide per dispatcher op, and the
port's kernels are ctypes launches inside ``autograd.Function``s that no
such policy sees; so the layer is cut into segments whose boundaries are
exactly the saved names (:func:`_segments`), each segment checkpointed on
its own: a saved tensor is a segment's input, kept for the backward, and
the segment that produced it stops its recompute before the product that
made it (a product saves its inputs before it runs, and the checkpoint's
recompute stops once every saved tensor it needs is back).

``scan_layers=True`` holds the decoder layers as ONE stacked parameter set
``model.layers_stacked`` (leading dim L, the reference's ``lax.scan``
pytree) and loops over its slices; ``model.layers`` is then empty, and
every walker of it refuses such a model by name (:func:`refuse_scanned`).

``fp8=True`` runs the four projections of each layer (qkv, o, gate_up,
down) through :func:`paddle_tpu_torch.amp.fp8.fp8_matmul` under delayed
scaling, as the reference does; each layer's amax histories are buffers
of its ``self_attn.fp8_meta`` / ``mlp.fp8_meta`` (``nn.ModuleDict`` of
:class:`~paddle_tpu_torch.amp.fp8.Fp8Meta`), which the optimizer never
sees. Sequence parallelism is a later slice.

Tensor parallelism (``distributed.shard_module`` over a mesh with tp > 1)
follows the reference's specs: qkv and gate_up column-sharded, o and down
row-sharded, the embedding and lm_head sharded over the vocabulary. A tp
rank holds the interleaved slices ``[q_i|k_i|v_i]`` and ``[g_i|u_i]``
(:func:`_tp_interleave_perm`, applied when sharding and undone by
``state_dict()``), so its attention runs ``nh/tp`` query heads over
``nkv/tp`` KV heads through the same kernels; the Megatron collectives
sit around the local products (``distributed.collective``
``copy_to_group`` / ``reduce_from_group``), and the loss is the
vocab-parallel cross-entropy. The pipeline functions at the end
(``make_llama_pp_train_step`` and its helpers) run the decoder layers as
the stages of ``distributed.pipeline``'s 1F1B / zero-bubble schedules.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.sharded import set_pspec
from paddle_tpu_torch.distributed.tensor_parallel import (
    _vocab_parallel_ce, vocab_parallel_lookup)
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.nn.functional import (masked_mean,
                                             parallel_cross_entropy)
from paddle_tpu_torch.ops import fused_rms_norm
from paddle_tpu_torch.quantization import wo_matmul

# remat_policy mode -> the named activations the per-layer checkpoint
# SAVES (empty: classic full remat, save nothing named)
_REMAT_SAVE_NAMES = {
    None: (), "full": (),
    "hidden": ("attn_ctx", "ffn_out"),
    "no_ffn": ("qkv", "attn_ctx", "ffn_out"),
    "dots": ("qkv", "attn_ctx", "ffn_gu", "ffn_out"),
}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # what the per-layer checkpoint SAVES instead of recomputing:
    #   None/"full"  nothing (classic full remat, most recompute)
    #   "hidden"     the attention context and the ffn output
    #   "no_ffn"     every named activation but the [B, S, 2m] gate/up
    #   "dots"       every named activation (least recompute, most memory)
    remat_policy: str | None = None
    scan_layers: bool = False          # one stacked [L, ...] layer set
    sliding_window: int | None = None  # Mistral-style causal window
    attention_bias: bool = False       # Qwen2: bias on fused qkv only
    rope_scaling: dict | None = None   # linear | ntk | dynamic
    fp8: bool = False  # e4m3/e5m2 projections with delayed scaling (amp.fp8)

    def __post_init__(self):
        self.save_names()

    def save_names(self) -> tuple:
        """The named activations ``remat_policy`` SAVES; everything else
        is recomputed in backward."""
        try:
            return _REMAT_SAVE_NAMES[self.remat_policy]
        except KeyError:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected one "
                f"of {sorted(k for k in _REMAT_SAVE_NAMES if k)} or None"
            ) from None

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**{**dict(hidden_size=4096, intermediate_size=11008,
                                     num_hidden_layers=32,
                                     num_attention_heads=32), **kw})

    @staticmethod
    def tiny(**kw):
        return LlamaConfig(**{**dict(vocab_size=256, hidden_size=64,
                                     intermediate_size=128,
                                     num_hidden_layers=2,
                                     num_attention_heads=4,
                                     num_key_value_heads=2,
                                     max_position_embeddings=128,
                                     dtype=torch.float32, remat=False),
                              **kw})


class _Init:
    """Normal(0, std) parameters drawn on the target device from one
    seeded generator (random weights; a real checkpoint goes through
    ``models.convert``)."""

    def __init__(self, cfg, device, seed):
        self.cfg, self.device = cfg, device
        self.gen = generator(seed, device)

    def normal(self, *shape, dtype=None):
        w = torch.empty(shape, dtype=dtype or self.cfg.dtype,
                        device=self.device)
        w.normal_(0.0, self.cfg.initializer_range, generator=self.gen)
        return nn.Parameter(w)

    def fill(self, value, *shape):
        return nn.Parameter(torch.full(shape, value, dtype=self.cfg.dtype,
                                       device=self.device))


class LlamaRMSNorm(nn.Module):
    def __init__(self, size, eps, init: _Init):
        super().__init__()
        self.weight = init.fill(1.0, size)
        self.eps = eps

    def forward(self, x):
        return fused_rms_norm(x, self.weight, self.eps)


def _fp8_metas(cfg, init, names):
    """The layer's fp8 scaling state (None unless ``cfg.fp8``)."""
    if not getattr(cfg, "fp8", False):
        return None
    from paddle_tpu_torch.amp.fp8 import Fp8Meta
    return nn.ModuleDict({n: Fp8Meta(device=init.device) for n in names})


def _proj(x, w, metas, name):
    """``x @ w`` through fp8_matmul when the layer trains in fp8."""
    if metas is not None:
        from paddle_tpu_torch.amp.fp8 import fp8_matmul
        return fp8_matmul(x, w, metas[name])
    return wo_matmul(x, w)


def _tp_interleave_perm(n_blocks_per_group, block: int, tp: int):
    """Column permutation turning globally grouped fused projections
    ([Q|K|V] or [gate|up]) into per-tp-shard groups ([q0|k0|v0 | q1|k1|v1]):
    each group's ``n`` blocks of ``block`` columns are dealt to the shards
    in contiguous runs of ``n // tp``."""
    import numpy as np
    offs = np.cumsum([0] + [n * block for n in n_blocks_per_group])
    perm = []
    for i in range(tp):
        for g, n in enumerate(n_blocks_per_group):
            per = n // tp
            start = offs[g] + i * per * block
            perm.extend(range(start, start + per * block))
    return np.asarray(perm)


def _refuse_tp(what, n, tp):
    if n % tp:
        raise ValueError(f"tp={tp} must divide {what}={n}: a tp rank holds "
                         f"whole slices of it")


class LlamaAttention(nn.Module):
    _pt_tp = None   # distributed.sharded.TpInfo once tp-sharded

    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        h, nh, nkv = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads)
        self.head_dim = h // nh
        self.qkv_proj = init.normal(h, (nh + 2 * nkv) * self.head_dim)
        self.o_proj = init.normal(nh * self.head_dim, h)
        self.qkv_bias = (init.fill(0.0, (nh + 2 * nkv) * self.head_dim)
                         if cfg.attention_bias else None)
        self.num_heads, self.num_kv_heads = nh, nkv
        self.window = cfg.sliding_window
        self.fp8_meta = _fp8_metas(cfg, init, ("qkv", "o"))
        set_pspec(self, "qkv_proj", (None, "tp"))
        set_pspec(self, "o_proj", ("tp", None))
        if cfg.attention_bias:
            set_pspec(self, "qkv_bias", ("tp",))

    def shard_check(self, mesh):
        tp = mesh.size("tp")
        _refuse_tp("num_key_value_heads", self.num_kv_heads, tp)
        _refuse_tp("num_attention_heads", self.num_heads, tp)
        if tp > 1 and self.fp8_meta is not None:
            raise ValueError("fp8 delayed scaling under tp > 1: the amax "
                             "histories would need a max over tp; train fp8 "
                             "with dp / fsdp")

    def tp_perm(self, name, tp):
        if name in ("qkv_proj", "qkv_bias"):
            return _tp_interleave_perm(
                [self.num_heads, self.num_kv_heads, self.num_kv_heads],
                self.head_dim, tp)
        return None

    def qkv(self, x):
        """The fused projection (tag ``qkv``)."""
        if self._pt_tp is not None:
            x = C.copy_to_group(x, self._pt_tp.group)
        qkv = _proj(x, self.qkv_proj, self.fp8_meta, "qkv")
        return qkv if self.qkv_bias is None else qkv + self.qkv_bias

    def context(self, qkv, cos, sin, attn_mask=None):
        """Rope (K7) and attention (K2) of the fused projection: the
        context [B, S, H, D] (tag ``attn_ctx``); under tp this rank's
        ``nh/tp`` query and ``nkv/tp`` KV heads."""
        b, s, _ = qkv.shape
        tp = 1 if self._pt_tp is None else self._pt_tp.size
        nh, nkv, d = (self.num_heads // tp, self.num_kv_heads // tp,
                      self.head_dim)
        q, k, v = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
        q = A.apply_rope(q.reshape(b, s, nh, d), cos, sin)
        k = A.apply_rope(k.reshape(b, s, nkv, d), cos, sin)
        v = v.reshape(b, s, nkv, d)
        return A.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                              is_causal=True,
                                              window=self.window)

    def out(self, ctx):
        b, s = ctx.shape[:2]
        y = _proj(ctx.reshape(b, s, -1), self.o_proj, self.fp8_meta, "o")
        return (y if self._pt_tp is None
                else C.reduce_from_group(y, self._pt_tp.group))

    def forward(self, x, cos, sin, attn_mask=None):
        return self.out(self.context(self.qkv(x), cos, sin, attn_mask))


class LlamaMLP(nn.Module):
    _pt_tp = None

    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_up_proj = init.normal(h, 2 * m)   # fused gate+up (SwiGLU)
        self.down_proj = init.normal(m, h)
        self.intermediate_size = m
        self.fp8_meta = _fp8_metas(cfg, init, ("gate_up", "down"))
        set_pspec(self, "gate_up_proj", (None, "tp"))
        set_pspec(self, "down_proj", ("tp", None))

    def shard_check(self, mesh):
        _refuse_tp("intermediate_size", self.intermediate_size,
                   mesh.size("tp"))

    def tp_perm(self, name, tp):
        if name == "gate_up_proj":
            m = self.intermediate_size
            return _tp_interleave_perm([m, m], 1, tp)
        return None

    def gate_up(self, x):
        """The fused gate/up product (tag ``ffn_gu``)."""
        if self._pt_tp is not None:
            x = C.copy_to_group(x, self._pt_tp.group)
        return _proj(x, self.gate_up_proj, self.fp8_meta, "gate_up")

    def down(self, gu):
        """SwiGLU and the down projection (tag ``ffn_out``)."""
        gate, up = torch.chunk(gu, 2, dim=-1)
        y = _proj(torch.nn.functional.silu(gate) * up, self.down_proj,
                  self.fp8_meta, "down")
        return (y if self._pt_tp is None
                else C.reduce_from_group(y, self._pt_tp.group))

    def forward(self, x):
        return self.down(self.gate_up(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                            init)
        self.self_attn = LlamaAttention(cfg, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, init)
        self.mlp = LlamaMLP(cfg, init)

    # the layer as five stages over named values; a stage's outputs that
    # a policy saves end a remat segment (:func:`_segments`)
    STAGES = (("qkv", ("x",), ("qkv",)),
              ("attn_ctx", ("qkv",), ("ctx",)),
              ("ffn_gu", ("x", "ctx"), ("x2", "gu")),
              ("ffn_out", ("gu",), ("out",)),
              (None, ("x2", "out"), ("y",)))

    def stage(self, i, *args, cos=None, sin=None, attn_mask=None):
        att, mlp = self.self_attn, self.mlp
        if i == 0:
            return att.qkv(self.input_layernorm(args[0]))
        if i == 1:
            return att.context(args[0], cos, sin, attn_mask)
        if i == 2:
            x, ctx = args
            x2 = x + att.out(ctx)
            return x2, mlp.gate_up(self.post_attention_layernorm(x2))
        if i == 3:
            return mlp.down(args[0])
        return args[0] + args[1]

    def forward(self, x, cos, sin, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


def _segments(names):
    """The layer's stages grouped into remat segments: a segment ends
    after each stage whose tag ``names`` saves. Returns [(stage indices,
    input value names, output value names)]; the outputs are what later
    segments read. A last segment that needs no saved tensor of its own
    (the residual add) runs outside any checkpoint (inputs ())."""
    stages = LlamaDecoderLayer.STAGES
    groups, cur = [], []
    for i, (tag, _, _) in enumerate(stages):
        cur.append(i)
        if tag in names or i == len(stages) - 1:
            groups.append(cur)
            cur = []
    out = []
    for gi, g in enumerate(groups):
        made = {v for i in g for v in stages[i][2]}
        ins = []
        for i in g:
            ins += [v for v in stages[i][1] if v not in made and v not in ins]
        later = {v for h in groups[gi + 1:] for i in h for v in stages[i][1]}
        outs = [v for i in g for v in stages[i][2] if v in later] or ["y"]
        out.append((tuple(g), tuple(ins), tuple(outs)))
    return out


def _run_layer(call, x, names, remat):
    """One decoder layer through ``call(stage, *values)``: whole under
    full remat or no remat, else segment by segment (each checkpointed
    unless it is the bare residual add)."""
    if not remat:
        return call(None, x)
    if not names:
        return checkpoint(call, None, x, use_reentrant=False)
    env = {"x": x}
    for idx, ins, outs in _segments(names):
        def seg(*vals, idx=idx, ins=ins, outs=outs):
            local = dict(zip(ins, vals))
            for i in idx:
                _, reads, writes = LlamaDecoderLayer.STAGES[i]
                got = call(i, *(local[v] for v in reads))
                local.update(zip(writes, got if len(writes) > 1 else (got,)))
            return tuple(local[v] for v in outs)
        vals = [env[v] for v in ins]
        if idx == (len(LlamaDecoderLayer.STAGES) - 1,):
            got = seg(*vals)
        else:
            got = checkpoint(seg, *vals, use_reentrant=False)
        env.update(zip(outs, got))
    return env["y"]


def _stack_layers(layers):
    """The scanned layout: the first layer, each of its parameters replaced
    by the stack of all L layers' (leading dim L), so that its names are
    the reference's ``layers_stacked.<name>``. It runs only through
    :class:`_StageOf` with one layer's slices swapped in."""
    st = layers[0]
    for name, _ in list(st.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        stacked = torch.stack([lyr.get_parameter(name).detach()
                               for lyr in layers])
        setattr(st.get_submodule(owner), leaf, nn.Parameter(stacked))
    return st


class _StageOf(nn.Module):
    """``forward(i, *values)`` = stage ``i`` of ``layer`` (the whole layer
    for None): what ``functional_call`` runs with one layer's parameter
    slices of the stacked set swapped in."""

    def __init__(self, layer, cos, sin, attn_mask):
        super().__init__()
        self.layer = layer
        self.rope, self.attn_mask = (cos, sin), attn_mask

    def forward(self, i, *vals):
        (cos, sin), mask = self.rope, self.attn_mask
        if i is None:
            return self.layer(vals[0], cos, sin, mask)
        return self.layer.stage(i, *vals, cos=cos, sin=sin, attn_mask=mask)


def refuse_scanned(model, what: str):
    """Raise for a ``scan_layers=True`` model: ``what`` walks
    ``model.model.layers``, which such a model leaves empty."""
    bb = getattr(model, "model", model)
    if getattr(bb, "layers_stacked", None) is not None:
        raise NotImplementedError(
            f"{what} walks model.model.layers; a scan_layers=True model "
            f"holds its layers stacked in model.model.layers_stacked: "
            f"build it with scan_layers=False")


class LlamaModel(nn.Module):
    _pt_tp = None

    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
        set_pspec(self, "embed_tokens", ("tp", None))
        layers = [LlamaDecoderLayer(cfg, init)
                  for _ in range(cfg.num_hidden_layers)]
        if cfg.scan_layers:
            if getattr(cfg, "fp8", False):
                raise NotImplementedError(
                    "fp8 with scan_layers=True: the stacked layer set holds "
                    "parameters only, not each layer's fp8 amax buffers; "
                    "build the fp8 model with scan_layers=False")
            self.layers_stacked = _stack_layers(layers)
            self.layers = nn.ModuleList()
        else:
            self.layers = nn.ModuleList(layers)
            self.layers_stacked = None
        del layers
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, init)

    def shard_check(self, mesh):
        _refuse_tp("vocab_size", self.cfg.vocab_size, mesh.size("tp"))
        if self.layers_stacked is not None and (mesh.size("tp") > 1
                                                or mesh.size("fsdp") > 1):
            raise NotImplementedError(
                "sharding a scan_layers=True model: its stacked parameters "
                "run through functional_call by name; build it with "
                "scan_layers=False")

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        cfg = self.cfg
        x = vocab_parallel_lookup(self.embed_tokens, input_ids, self._pt_tp)
        cos, sin = A.rope_cos_sin(
            input_ids.shape[1], cfg.hidden_size // cfg.num_attention_heads,
            base=cfg.rope_theta, position_ids=position_ids,
            scaling=cfg.rope_scaling,
            max_position_embeddings=cfg.max_position_embeddings,
            device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        names = cfg.save_names()
        if self.layers_stacked is not None:
            # one unbind a parameter: its backward stacks the L slices'
            # gradients into the stacked gradient
            slices = {f"layer.{n}": p.unbind(0)
                      for n, p in self.layers_stacked.named_parameters()}
            run = _StageOf(self.layers_stacked, cos, sin, attn_mask)
            for i in range(cfg.num_hidden_layers):
                params = {n: t[i] for n, t in slices.items()}

                def call(stage, *vals, params=params):
                    return functional_call(run, params, (stage, *vals))
                x = _run_layer(call, x, names, remat)
            return self.norm(x)
        for lyr in self.layers:
            x = _run_layer(_layer_call(lyr, cos, sin, attn_mask), x, names,
                           remat)
        return self.norm(x)


def _layer_call(lyr, cos, sin, attn_mask):
    def call(i, *vals):
        if i is None:
            return lyr(vals[0], cos, sin, attn_mask)
        return lyr.stage(i, *vals, cos=cos, sin=sin, attn_mask=attn_mask)
    return call


class LlamaForCausalLM(nn.Module):
    """Decoder LM. ``device``: ``None`` means the card (raises without
    one); tests pass ``"cpu"``. ``seed`` draws the random weights."""

    _pt_tp = None

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        init = _Init(cfg, dev, seed)
        self.cfg = cfg
        self.model = LlamaModel(cfg, init)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else init.normal(cfg.hidden_size, cfg.vocab_size))
        if self.lm_head is not None:
            set_pspec(self, "lm_head", (None, "tp"))

    def shard_check(self, mesh):
        _refuse_tp("vocab_size", self.cfg.vocab_size, mesh.size("tp"))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _vocab_tp(self):
        """The tp of the vocab-sharded head (the embedding's when tied)."""
        return self._pt_tp or self.model._pt_tp

    def _local_logits(self, hidden):
        """This rank's vocab shard of the logits (all of them without tp)."""
        w = (self.model.embed_tokens.T if self.lm_head is None
             else self.lm_head)
        tp = self._vocab_tp()
        if tp is not None:
            hidden = C.copy_to_group(hidden, tp.group)
        return wo_matmul(hidden, w)

    def logits(self, hidden):
        tp = self._vocab_tp()
        out = self._local_logits(hidden)
        return (out if tp is None
                else C.gather_last(out, tp.group, tp.size, tp.index))

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        return self.logits(self.model(input_ids, attn_mask, position_ids))

    def loss(self, input_ids, labels, attn_mask=None):
        """Causal LM loss; labels = input shifted, ignore_index=-100."""
        logits = self._local_logits(self.model(input_ids, attn_mask))
        tp, lab = self._vocab_tp(), torch.clamp(labels, min=0)
        per_tok = (parallel_cross_entropy(logits, lab) if tp is None
                   else _vocab_parallel_ce(logits.float(), lab, tp, 0.0))
        return masked_mean(per_tok, (labels >= 0).float())


# ------------------------------------------------ pipeline parallelism

class PpParams(dict):
    """The pipeline's parameter tree ``{layers: {name: [L_stage, ...]},
    embed_tokens, norm_weight, lm_head}`` with its layout tag:
    ``tp_layout`` is the tp degree the fused projections are interleaved
    for (1: the reference's [Q|K|V] / [gate|up] order), so the tp pipeline
    refuses weights in another layout instead of splitting wrong
    columns. On a rank, ``layers`` holds that rank's stage (and tp slice)."""

    tp_layout: int = 1

    @staticmethod
    def make(d: dict, tp_layout: int = 1) -> "PpParams":
        p = PpParams(d)
        p.tp_layout = tp_layout
        return p

    def flat(self) -> dict:
        """{dotted name: tensor}, the optimizer's view of the same tensors."""
        out = {f"layers.{k}": v for k, v in self["layers"].items()}
        out.update((k, v) for k, v in self.items() if k != "layers")
        return out


def _check_pp_model(model):
    if model.lm_head is None:
        raise ValueError("the pipeline head needs untied embeddings "
                         "(tie_word_embeddings=False)")
    refuse_scanned(model, "the pipeline")
    if not model.model.layers:
        raise ValueError("the pipeline stages need the decoder layers")


def _pp_params(model, copy: bool) -> PpParams:
    """The canonical (global) pp tree; ``copy`` clones every leaf so the
    in-place optimizer never writes the module's own weights."""
    from paddle_tpu_torch.distributed.pipeline import stack_layers
    cp = (lambda t: t.detach().clone()) if copy else (lambda t: t.detach())
    return PpParams.make(dict(
        layers=stack_layers(model.model.layers),
        embed_tokens=cp(model.model.embed_tokens),
        norm_weight=cp(model.model.norm.weight),
        lm_head=cp(model.lm_head)), 1)


def llama_tp_stage_specs(stacked: dict, tp_axis: str = "tp") -> dict:
    """Specs of the STACKED [L, ...] layer tree: ("pp", *tp_spec) — fused
    projections column-sharded, o / down row-sharded over tp, the rest
    replicated over tp."""
    specs = {}
    for name, leaf in stacked.items():
        if name.endswith(("qkv_proj", "gate_up_proj")):
            dims = (None, tp_axis)
        elif name.endswith("qkv_bias"):
            dims = (tp_axis,)
        elif name.endswith(("o_proj", "down_proj")):
            dims = (tp_axis, None)
        else:
            dims = (None,) * (leaf.dim() - 1)
        specs[name] = ("pp",) + dims
    return specs


def _pp_local(params: PpParams, mesh) -> PpParams:
    """This rank's stage of a global pp tree (and its tp slice)."""
    specs = llama_tp_stage_specs(params["layers"])
    layers = {k: mesh.local(v, specs[k]) for k, v in params["layers"].items()}
    return PpParams.make({**params, "layers": layers}, params.tp_layout)


def gather_llama_pp_params(params: PpParams, mesh) -> PpParams:
    """The global pp tree of every rank's local one (parameters or
    gradients; the layout tag kept)."""
    specs = llama_tp_stage_specs(params["layers"])
    layers = {k: mesh.gather(v, specs[k]) for k, v in params["layers"].items()}
    return PpParams.make({**params, "layers": layers}, params.tp_layout)


def tp_shuffle_llama_params(params: PpParams, cfg: LlamaConfig, tp: int,
                            inverse: bool = False) -> PpParams:
    """(Un)permute the stacked layers of a global pp tree for manual tp:
    qkv_proj / qkv_bias columns to per-shard [q_i|k_i|v_i], gate_up_proj
    columns to per-shard [g_i|u_i] (o / down rows already match)."""
    cur = getattr(params, "tp_layout", 1) or 1
    want_cur = tp if inverse else 1
    if cur != want_cur:
        raise ValueError(
            f"tp_shuffle_llama_params: params are in tp_layout={cur}, "
            f"expected {want_cur} for {'inverse ' if inverse else ''}"
            f"shuffle to tp={tp} — double-(un)shuffling would scramble "
            "the fused projection columns")
    import numpy as np
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd, m = cfg.hidden_size // nh, cfg.intermediate_size
    qkv_perm = _tp_interleave_perm([nh, nkv, nkv], hd, tp)
    gu_perm = _tp_interleave_perm([m, m], 1, tp)
    if inverse:
        qkv_perm, gu_perm = np.argsort(qkv_perm), np.argsort(gu_perm)
    layers = {}
    for name, leaf in params["layers"].items():
        perm = (qkv_perm if name.endswith(("qkv_proj", "qkv_bias"))
                else gu_perm if name.endswith("gate_up_proj") else None)
        layers[name] = (leaf if perm is None else leaf.index_select(
            -1, torch.as_tensor(perm, device=leaf.device)))
    return PpParams.make({**params, "layers": layers},
                         1 if inverse else tp)


def _template_layer(cfg):
    """A decoder layer on the meta device for ``functional_call``."""

    class _Meta(_Init):
        def __init__(self, cfg):
            self.cfg, self.device = cfg, torch.device("meta")

        def normal(self, *shape, dtype=None):
            return nn.Parameter(torch.empty(shape, dtype=dtype or
                                            self.cfg.dtype, device="meta"))

    return LlamaDecoderLayer(cfg, _Meta(cfg))


def make_tp_layer_call(cos, sin, tp_axis: str = "tp", mesh=None):
    """Decoder-layer call for manual tensor parallelism inside the
    pipeline: the layer (a pipeline ``LayerView`` or a decoder layer) runs
    its local q/k/v heads and all-reduces the row-parallel o / down
    products over ``tp_axis`` of ``mesh`` (the active mesh by default).
    Expects weights permuted by ``tp_shuffle_llama_params``."""
    from paddle_tpu_torch.distributed.mesh import current_mesh
    from paddle_tpu_torch.distributed.sharded import TpInfo
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("make_tp_layer_call needs a mesh: pass mesh= or "
                         "call it inside `with mesh:`")
    n = mesh.size(tp_axis)
    tp = (None if n == 1
          else TpInfo(mesh.group(tp_axis), n, mesh.index(tp_axis)))

    def call(lyr, h):
        layer = getattr(lyr, "template", lyr)
        layer.self_attn._pt_tp = layer.mlp._pt_tp = tp
        return lyr(h, cos, sin, None)
    return call


def _pp_loss_and_grads(cfg, n_layers, mesh, params, input_ids, labels,
                       num_microbatches, batch_axes, schedule="1f1b"):
    """The one pipeline-Llama forward/backward over this rank's local
    ``params``: decoder layers are the stages, the embedding runs at stage
    0 and the final norm + lm_head + masked CE at the last."""
    from paddle_tpu_torch.distributed.pipeline import (PipelineLayer,
                                                       pipeline_train_step)
    if cfg.fp8:
        raise NotImplementedError(
            "fp8 delayed scaling is not supported inside the 1F1B pipeline "
            "(amax histories need max/last-write combining across "
            "microbatches, not the schedule's mean); train fp8 with "
            "dp/tp/fsdp instead")
    tp = mesh.size("tp")
    layout = getattr(params, "tp_layout", 1)
    if tp > 1:
        for what, n in (("num_attention_heads", cfg.num_attention_heads),
                        ("num_key_value_heads", cfg.num_key_value_heads),
                        ("intermediate_size", cfg.intermediate_size)):
            _refuse_tp(what, n, tp)
        if layout != tp:
            raise ValueError(
                f"params are in tp_layout={layout!r} but the mesh has "
                f"tp={tp}; build them with init_llama_pp_state(model, opt, "
                "mesh) / tp_shuffle_llama_params so the fused projections "
                "are interleaved for this tp degree (wrong-layout weights "
                "would silently split the wrong q/k/v columns)")
    elif layout not in (None, 1):
        raise ValueError(
            f"params are tp-interleaved for tp={layout} but the mesh has "
            "tp=1; convert back with tp_shuffle_llama_params(..., "
            "inverse=True) first (the plain layer path would split the "
            "wrong q/k/v columns)")
    dev = params["embed_tokens"].device
    cos, sin = A.rope_cos_sin(
        input_ids.shape[1], cfg.hidden_size // cfg.num_attention_heads,
        base=cfg.rope_theta, scaling=cfg.rope_scaling,
        max_position_embeddings=cfg.max_position_embeddings, device=dev)
    eps = cfg.rms_norm_eps
    pipe = PipelineLayer.from_stacked(
        params["layers"], n_layers=n_layers, num_stages=mesh.size("pp"),
        num_microbatches=num_microbatches, remat=cfg.remat,
        template=_template_layer(cfg), stage_local=True)

    def embed_fn(emb_w, ids):
        return emb_w[ids]

    def head_loss(hp, hidden, lbl):
        norm_w, head_w = hp
        h = fused_rms_norm(hidden, norm_w, eps)
        logp = torch.log_softmax(wo_matmul(h, head_w).float(), dim=-1)
        per_tok = -torch.gather(logp, -1,
                                torch.clamp(lbl, min=0)[..., None])[..., 0]
        mask = (lbl >= 0).float()
        return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    loss, dstage, dembed, dhead = pipeline_train_step(
        pipe, mesh, input_ids, labels,
        layer_call=make_tp_layer_call(cos, sin, mesh=mesh),
        head_loss_fn=head_loss,
        head_params=(params["norm_weight"], params["lm_head"]),
        embed_fn=embed_fn, embed_params=params["embed_tokens"],
        batch_axes=batch_axes, schedule=schedule)
    grads = PpParams.make(dict(layers=dstage, embed_tokens=dembed,
                               norm_weight=dhead[0], lm_head=dhead[1]),
                          layout)
    return loss, grads


def llama_pipeline_train_step(model: LlamaForCausalLM, mesh, input_ids,
                              labels, num_microbatches: int, batch_axes=(),
                              schedule: str = "1f1b"):
    """1F1B (or zb1) pipeline loss and gradients of the model's weights
    over the mesh's pp axis: ``(loss, grads)``, ``grads`` a PpParams of
    this rank's stage (fp32), in the tp-interleaved layout on a tp > 1
    mesh (``gather_llama_pp_params`` then ``tp_shuffle_llama_params(...,
    inverse=True)`` give the global canonical tree). The mean of the
    microbatch losses equals ``model.loss`` when every microbatch masks
    the same number of labels (the shifted -100 tail does)."""
    _check_pp_model(model)
    params = _pp_params(model, copy=False)
    if mesh.size("tp") > 1:
        params = tp_shuffle_llama_params(params, model.cfg, mesh.size("tp"))
    return _pp_loss_and_grads(model.cfg, len(model.model.layers), mesh,
                              _pp_local(params, mesh), input_ids, labels,
                              num_microbatches, batch_axes, schedule)


def init_llama_pp_state(model: LlamaForCausalLM, optimizer, mesh=None):
    """(params, opt_state) for ``make_llama_pp_train_step``: this rank's
    stage of fresh copies of the weights (tp-interleaved and tp-sliced on a
    tp > 1 mesh; ``gather_llama_pp_params`` and an inverse shuffle give
    them back for export) and the optimizer's state on them."""
    _check_pp_model(model)
    params = _pp_params(model, copy=True)
    if mesh is not None:
        if mesh.size("tp") > 1:
            params = tp_shuffle_llama_params(params, model.cfg,
                                             mesh.size("tp"))
        params = _pp_local(params, mesh)
    params["layers"] = {k: v.clone() for k, v in params["layers"].items()}
    return params, optimizer.init(params.flat())


def make_llama_pp_train_step(model: LlamaForCausalLM, mesh, optimizer,
                             num_microbatches: int, batch_axes=(),
                             schedule: str = "1f1b"):
    """Pipeline training: ``step(params, opt_state, ids, labels) ->
    (params, opt_state, loss)`` over the state of ``init_llama_pp_state``;
    the optimizer updates the rank's tensors in place from the schedule's
    gradients. ``batch_axes`` composes pp with dp."""
    _check_pp_model(model)
    cfg, n_layers = model.cfg, len(model.model.layers)

    def step(params, opt_state, input_ids, labels):
        loss, grads = _pp_loss_and_grads(
            cfg, n_layers, mesh, params, input_ids, labels,
            num_microbatches, batch_axes, schedule)
        _, opt_state = optimizer.step(params.flat(), grads.flat(), opt_state)
        return params, opt_state, loss

    return step


def num_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token ~ 6*N_params + attention term (for MFU)."""
    h, m = cfg.hidden_size, cfg.intermediate_size
    L, v = cfg.num_hidden_layers, cfg.vocab_size
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = h // nh
    per_layer = (2 * h * (nh + 2 * nkv) * d + 2 * nh * d * h + 2 * h * 2 * m
                 + 2 * m * h)
    n_matmul = L * per_layer + 2 * h * v  # fwd matmul FLOPs per token
    attn = L * 2 * 2 * seq_len * nh * d   # qk^T and pv per token
    return 3.0 * (n_matmul + attn)        # fwd + 2x bwd
