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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.nn.functional import parallel_cross_entropy
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


class LlamaAttention(nn.Module):
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

    def qkv(self, x):
        """The fused projection (tag ``qkv``)."""
        qkv = _proj(x, self.qkv_proj, self.fp8_meta, "qkv")
        return qkv if self.qkv_bias is None else qkv + self.qkv_bias

    def context(self, qkv, cos, sin, attn_mask=None):
        """Rope (K7) and attention (K2) of the fused projection: the
        context [B, S, H, D] (tag ``attn_ctx``)."""
        b, s, _ = qkv.shape
        nh, nkv, d = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
        q = A.apply_rope(q.reshape(b, s, nh, d), cos, sin)
        k = A.apply_rope(k.reshape(b, s, nkv, d), cos, sin)
        v = v.reshape(b, s, nkv, d)
        return A.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                              is_causal=True,
                                              window=self.window)

    def out(self, ctx):
        b, s = ctx.shape[:2]
        return _proj(ctx.reshape(b, s, -1), self.o_proj, self.fp8_meta, "o")

    def forward(self, x, cos, sin, attn_mask=None):
        return self.out(self.context(self.qkv(x), cos, sin, attn_mask))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_up_proj = init.normal(h, 2 * m)   # fused gate+up (SwiGLU)
        self.down_proj = init.normal(m, h)
        self.intermediate_size = m
        self.fp8_meta = _fp8_metas(cfg, init, ("gate_up", "down"))

    def gate_up(self, x):
        """The fused gate/up product (tag ``ffn_gu``)."""
        return _proj(x, self.gate_up_proj, self.fp8_meta, "gate_up")

    def down(self, gu):
        """SwiGLU and the down projection (tag ``ffn_out``)."""
        gate, up = torch.chunk(gu, 2, dim=-1)
        return _proj(torch.nn.functional.silu(gate) * up, self.down_proj,
                     self.fp8_meta, "down")

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
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
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

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        cfg = self.cfg
        x = self.embed_tokens[input_ids]
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

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        init = _Init(cfg, dev, seed)
        self.cfg = cfg
        self.model = LlamaModel(cfg, init)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else init.normal(cfg.hidden_size, cfg.vocab_size))

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.device

    def logits(self, hidden):
        w = (self.model.embed_tokens.T if self.lm_head is None
             else self.lm_head)
        return wo_matmul(hidden, w)

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        return self.logits(self.model(input_ids, attn_mask, position_ids))

    def loss(self, input_ids, labels, attn_mask=None):
        """Causal LM loss; labels = input shifted, ignore_index=-100."""
        logits = self(input_ids, attn_mask)
        per_tok = parallel_cross_entropy(logits, torch.clamp(labels, min=0))
        mask = (labels >= 0).float()
        return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)


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
