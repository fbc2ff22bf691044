"""Weight loading: the JAX package's state dicts and HuggingFace
checkpoints — counterpart of ``paddle_tpu/models/convert.py``.

``paddle_tpu`` ``Module.state_dict()`` returns ``{dotted path: numpy
array}`` (``core/module.py``), with the same dotted paths and ``[in,
out]`` layouts as the port's parameters — ``model.layers.0.self_attn.
qkv_proj``, ``lm_head`` — so that bridge (:func:`load_jax_state_dict`) is
a name-for-name copy. bf16 arrays arrive as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` cannot take: they cross as their ``uint16``
bit pattern.

The HF loaders (``load_<family>_state_dict``) take an HF-named state
dict — torch tensors or numpy arrays, e.g. a ``transformers`` model's
``state_dict()`` or :func:`load_safetensors`'s memory-mapped tensors —
and fill the port's model IN PLACE: each HF tensor is moved to the
parameter's device and written, transposed from HF's ``[out, in]``, into
its slice of the fused parameter (q|k|v into ``qkv_proj``, gate|up into
``gate_up_proj``, expert e into row e of the ``[E, h, 2I]`` / ``[E, I,
h]`` stacks). Nothing is concatenated on the host, so a 7B checkpoint
costs no second host copy. The re-layouts of the fused QKV tensors
(BLOOM's and GPT-NeoX's head-interleaved ``[nh, 3, d]``, Falcon's three
layouts, CodeGen's ``mp_num = 4`` column groups) are the reference's
reshapes; GPT-2's Conv1D weights are ``[in, out]`` already.
Every parameter of the model must be written, and every piece must have
its slice's exact shape: a missing or mis-shaped tensor raises. The one
exception is an encoder's heads and pooler (BERT's MLM / NSP heads, a
classifier, ...): a checkpoint of the bare encoder or of another head
lacks them, and they keep their random init, as the reference's loaders
leave them.

``dtype`` (default: the model's) is the type the parameters end up in;
the MoE routers' ``gate_w`` stay float32, as the reference keeps them.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch


def to_tensor(arr) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) or a tensor -> CPU tensor,
    bit-exact."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu()
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


@torch.no_grad()
def load_jax_state_dict(model: torch.nn.Module, state: dict):
    """Copy every entry of ``state`` into the parameter of the same dotted
    name (cast to the parameter's dtype, moved to its device). Unknown,
    missing or mis-shaped entries raise."""
    params = dict(model.named_parameters())
    unknown = sorted(set(state) - set(params))
    missing = sorted(set(params) - set(state))
    if unknown or missing:
        raise KeyError(f"state_dict mismatch: unknown {unknown[:8]}, "
                       f"missing {missing[:8]}")
    for name, arr in state.items():
        p = params[name]
        t = to_tensor(arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(t.shape)} "
                             f"vs {tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model


def load_jax_checkpoint(model: torch.nn.Module, path):
    """Load the model leaves of a checkpoint the JAX package wrote
    (``paddle_tpu.train.checkpoint.save`` of a model, or of a
    ``TrainState``, whose model leaves sit under ``[<flat index 0>].``)
    into ``model``'s parameters of the same dotted names, CRCs verified
    (:func:`paddle_tpu_torch.train.checkpoint.load`). Leaves of other
    parts of a TrainState (optimizer slots, the JAX PRNG key) are left
    out."""
    from paddle_tpu_torch.train.checkpoint import load
    prefix = "[<flat index 0>]."
    flat = load(path)
    names = {n for n, _ in model.named_parameters()}
    state = {}
    for k, v in flat.items():
        k = k[len(prefix):] if k.startswith(prefix) else k
        if k in names:
            state[k] = v
    return load_jax_state_dict(model, state)


# ------------------------------------------------------------ safetensors
# safetensors dtype tag -> (numpy view of the raw bytes, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def load_safetensors(path) -> dict:
    """Read a ``.safetensors`` file (an 8-byte little-endian header length,
    a JSON header, then raw little-endian buffers) into ``{name: CPU
    tensor}``. The tensors are views of a copy-on-write memory map of the
    file: nothing is read until a tensor is used, and the file is never
    written. BF16 is read as its ``uint16`` bit pattern viewed as
    ``torch.bfloat16``. Neither the ``safetensors`` nor the ``ml_dtypes``
    package is used, even where installed."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    base = 8 + hlen
    data = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{meta['dtype']!r}, which the reader does not "
                             f"take ({sorted(_ST_DTYPES)})")
        np_dt, t_dt = _ST_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        buf = data[base + lo:base + hi]
        if (base + lo) % np.dtype(np_dt).itemsize:
            buf = np.array(buf)              # unaligned: copy to align
        t = torch.from_numpy(buf.view(np_dt))
        if t_dt == torch.bfloat16:
            t = t.view(torch.bfloat16)
        out[name] = t.reshape(meta["shape"])
    return out


# ------------------------------------------------------------- HF loaders
def _src_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


class _Fill:
    """Writes HF tensors into a model's parameters in place. ``strip``:
    a key prefix HF uses that the parameter names lack
    (``transformer.``)."""

    def __init__(self, model, state_dict, dtype=None, strip=None):
        cfg = model.cfg
        self.params = dict(model.named_parameters())
        self.sd = ({k.removeprefix(strip): v for k, v in state_dict.items()}
                   if strip else state_dict)
        if dtype is not None and dtype != cfg.dtype:
            for name, p in self.params.items():
                if not name.endswith("gate_w"):
                    p.data = p.data.to(dtype)
            cfg.dtype = dtype
        self.device = next(iter(self.params.values())).device
        self.model = model
        self.written = set()

    def __contains__(self, key):
        return key in self.sd

    def __call__(self, key) -> torch.Tensor:
        """The HF tensor ``key`` on the parameters' device."""
        return _src_tensor(self.sd[key]).to(self.device)

    def put(self, name, *pieces, at=None):
        """Write ``pieces`` side by side along the last axis into parameter
        ``name`` (row ``at`` of a stacked parameter). Their widths must add
        up to the parameter's, and each piece must match its slice."""
        p = self.params[name]
        dst = p if at is None else p[at]
        off = 0
        for t in pieces:
            n = t.shape[-1] if t.dim() else 1
            view = dst.narrow(-1, off, n) if dst.dim() else dst
            if tuple(view.shape) != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for {name}"
                    f"{'' if at is None else f'[{at}]'}: piece "
                    f"{tuple(t.shape)} at column {off} of "
                    f"{tuple(dst.shape)}")
            view.copy_(t)
            off += n
        if dst.dim() and off != dst.shape[-1]:
            raise ValueError(f"shape mismatch for {name}: pieces fill {off} "
                             f"of {dst.shape[-1]} columns")
        self.written.add(name)

    def done(self, keep=()):
        """Raise unless every parameter was written; those under a prefix
        of ``keep`` (heads a checkpoint of the bare encoder lacks) may keep
        their random init."""
        missing = sorted(n for n in set(self.params) - self.written
                         if not n.startswith(tuple(keep)))
        if missing:
            raise KeyError(f"the checkpoint left parameters unwritten: "
                           f"{missing[:8]}")
        return self.model

    def norm(self, name, key):
        self.put(name + ".weight", self(key + ".weight"))
        if name + ".bias" in self.params:
            self.put(name + ".bias", self(key + ".bias"))

    def linear(self, name, key):
        """HF's ``nn.Linear`` ``key`` ([out, in] weight) into the port's
        ``[in, out]`` ``Linear`` ``name``, with its bias."""
        self.put(name + ".weight", self(key + ".weight").T)
        if name + ".bias" in self.params:
            self.put(name + ".bias", self(key + ".bias"))

    def head(self, name, key, norm=False):
        """A head or pooler the checkpoint may lack: loaded when both the
        model and the checkpoint have it."""
        if name + ".weight" in self.params and key + ".weight" in self:
            (self.norm if norm else self.linear)(name, key)


def _llama_attention(f, pre, key):
    """q/k/v -> ``{pre}qkv_proj`` (and the Qwen2 ``qkv_bias``), o_proj."""
    f.put(pre + "qkv_proj", f(key + "q_proj.weight").T,
          f(key + "k_proj.weight").T, f(key + "v_proj.weight").T)
    f.put(pre + "o_proj", f(key + "o_proj.weight").T)
    if pre + "qkv_bias" in f.params:
        f.put(pre + "qkv_bias", f(key + "q_proj.bias"),
              f(key + "k_proj.bias"), f(key + "v_proj.bias"))
    elif key + "q_proj.bias" in f:
        raise ValueError(f"the checkpoint biases {key}q/k/v but the config "
                         f"has attention_bias=False")


def _gated_mlp(f, pre, key):
    f.put(pre + "gate_up_proj", f(key + "gate_proj.weight").T,
          f(key + "up_proj.weight").T)
    f.put(pre + "down_proj", f(key + "down_proj.weight").T)


def _lm_head(f, name="lm_head"):
    """The untied head: HF's ``lm_head.weight``, or the embedding of a
    tied checkpoint loaded into an untied config."""
    if name in f.params:
        key = ("lm_head.weight" if "lm_head.weight" in f
               else "model.embed_tokens.weight")
        f.put(name, f(key).T)


@torch.no_grad()
def load_llama_state_dict(model, state_dict, dtype=None):
    """``LlamaForCausalLM`` (and Mistral, Qwen2 — Qwen2 adds the q/k/v
    biases) from an HF state dict. A tied config has no ``lm_head``; a
    ``scan_layers=True`` model raises by name."""
    from paddle_tpu_torch.models.llama import refuse_scanned
    refuse_scanned(model, "loading an HF checkpoint")
    f = _Fill(model, state_dict, dtype)
    f.put("model.embed_tokens", f("model.embed_tokens.weight"))
    f.put("model.norm.weight", f("model.norm.weight"))
    _lm_head(f)
    for i in range(model.cfg.num_hidden_layers):
        p, k = f"model.layers.{i}.", f"model.layers.{i}."
        _llama_attention(f, p + "self_attn.", k + "self_attn.")
        _gated_mlp(f, p + "mlp.", k + "mlp.")
        f.norm(p + "input_layernorm", k + "input_layernorm")
        f.norm(p + "post_attention_layernorm", k + "post_attention_layernorm")
    return f.done()


def _experts(f, pre, keys, num_experts):
    """Per-expert (gate, up, down) HF linears -> rows of the stacked
    ``{pre}gate_up`` [E, h, 2I] and ``{pre}down`` [E, I, h]."""
    for e in range(num_experts):
        g, u, d = (f(k.format(e=e)) for k in keys)
        f.put(pre + "gate_up", g.T, u.T, at=e)
        f.put(pre + "down", d.T, at=e)


@torch.no_grad()
def load_mixtral_state_dict(model, state_dict, dtype=None):
    """``MixtralForCausalLM``: Llama attention packing, the expert stacks
    (HF w1 = gate, w3 = up, w2 = down) and the fp32 router."""
    cfg = model.cfg
    f = _Fill(model, state_dict, dtype)
    f.put("embed_tokens", f("model.embed_tokens.weight"))
    f.put("norm.weight", f("model.norm.weight"))
    _lm_head(f)
    for i in range(cfg.num_hidden_layers):
        p, k = f"layers.{i}.", f"model.layers.{i}."
        _llama_attention(f, p + "self_attn.", k + "self_attn.")
        f.norm(p + "input_layernorm", k + "input_layernorm")
        f.norm(p + "post_attention_layernorm", k + "post_attention_layernorm")
        ek = k + "block_sparse_moe."
        f.put(p + "moe.gate_w", f(ek + "gate.weight").T)
        _experts(f, p + "moe.experts.",
                 [ek + "experts.{e}.w1.weight", ek + "experts.{e}.w3.weight",
                  ek + "experts.{e}.w2.weight"], cfg.num_local_experts)
    return f.done()


@torch.no_grad()
def load_qwen2_moe_state_dict(model, state_dict, dtype=None):
    """``Qwen2MoeForCausalLM``: Qwen2 attention (fused biased QKV), the
    expert stacks, the shared expert and its sigmoid gate, the fp32
    router; ``mlp_only_layers`` carry a dense MLP."""
    cfg = model.cfg
    f = _Fill(model, state_dict, dtype)
    f.put("embed_tokens", f("model.embed_tokens.weight"))
    f.put("norm.weight", f("model.norm.weight"))
    _lm_head(f)
    for i, lyr in enumerate(model.layers):
        p, k = f"layers.{i}.", f"model.layers.{i}."
        _llama_attention(f, p + "self_attn.", k + "self_attn.")
        f.norm(p + "input_layernorm", k + "input_layernorm")
        f.norm(p + "post_attention_layernorm", k + "post_attention_layernorm")
        if not lyr.sparse:
            _gated_mlp(f, p + "mlp.", k + "mlp.")
            continue
        mk = k + "mlp."
        f.put(p + "mlp.moe.gate_w", f(mk + "gate.weight").T)
        _experts(f, p + "mlp.moe.experts.",
                 [mk + "experts.{e}.gate_proj.weight",
                  mk + "experts.{e}.up_proj.weight",
                  mk + "experts.{e}.down_proj.weight"], cfg.num_experts)
        f.put(p + "mlp.shared_gate_up",
              f(mk + "shared_expert.gate_proj.weight").T,
              f(mk + "shared_expert.up_proj.weight").T)
        f.put(p + "mlp.shared_down",
              f(mk + "shared_expert.down_proj.weight").T)
        f.put(p + "mlp.shared_gate", f(mk + "shared_expert_gate.weight").T)
    return f.done()


@torch.no_grad()
def load_gemma_state_dict(model, state_dict, dtype=None):
    """``GemmaForCausalLM``: zero-centred norm weights stored as they are;
    the head is the (tied) embedding."""
    f = _Fill(model, state_dict, dtype)
    f.put("embed_tokens", f("model.embed_tokens.weight"))
    f.put("norm.weight", f("model.norm.weight"))
    for i in range(model.cfg.num_hidden_layers):
        p, k = f"layers.{i}.", f"model.layers.{i}."
        f.put(p + "qkv_proj", f(k + "self_attn.q_proj.weight").T,
              f(k + "self_attn.k_proj.weight").T,
              f(k + "self_attn.v_proj.weight").T)
        f.put(p + "o_proj", f(k + "self_attn.o_proj.weight").T)
        _gated_mlp(f, p, k + "mlp.")
        f.norm(p + "input_layernorm", k + "input_layernorm")
        f.norm(p + "post_attention_layernorm", k + "post_attention_layernorm")
    return f.done()


@torch.no_grad()
def load_bloom_state_dict(model, state_dict, dtype=None):
    """``BloomForCausalLM``: HF fuses QKV head-interleaved (``[nh, 3, d]``
    on the out axis); the port's ``qkv`` is ``[q | k | v]`` blocks."""
    cfg = model.cfg
    nh, h = cfg.n_head, cfg.hidden_size
    d = h // nh
    f = _Fill(model, state_dict, dtype, strip="transformer.")
    f.put("word_embeddings", f("word_embeddings.weight"))
    f.norm("word_embeddings_layernorm", "word_embeddings_layernorm")
    f.norm("ln_f", "ln_f")
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        f.norm(p + "input_layernorm", p + "input_layernorm")
        f.norm(p + "post_attention_layernorm", p + "post_attention_layernorm")
        w = f(p + "self_attention.query_key_value.weight").reshape(
            nh, 3, d, h)
        f.put(p + "qkv", *(w[:, j].reshape(nh * d, h).T for j in range(3)))
        b = f(p + "self_attention.query_key_value.bias").reshape(nh, 3, d)
        f.put(p + "qkv_bias", *(b[:, j].reshape(-1) for j in range(3)))
        f.put(p + "dense", f(p + "self_attention.dense.weight").T)
        f.put(p + "dense_bias", f(p + "self_attention.dense.bias"))
        f.put(p + "h_to_4h", f(p + "mlp.dense_h_to_4h.weight").T)
        f.put(p + "h_to_4h_bias", f(p + "mlp.dense_h_to_4h.bias"))
        f.put(p + "four_h_to_h", f(p + "mlp.dense_4h_to_h.weight").T)
        f.put(p + "four_h_to_h_bias", f(p + "mlp.dense_4h_to_h.bias"))
    return f.done()


@torch.no_grad()
def load_falcon_state_dict(model, state_dict, dtype=None):
    """``FalconForCausalLM``. The fused QKV's layout differs per variant:
    ``[q * g | k | v]`` per KV head (the new decoder architecture),
    ``[all q | k | v]`` (multi-query 7b) or head-interleaved (rw); each
    is split into the port's ``wq``/``wk``/``wv``."""
    cfg = model.cfg
    nh, nkv = cfg.num_attention_heads, cfg.kv_heads
    d = cfg.hidden_size // nh

    def split_qkv(w):
        """[out, h] (or [out] bias) -> (q, k, v) along the out axis."""
        tail = tuple(w.shape[1:])
        if cfg.new_decoder_architecture:
            g = nh // nkv
            w = w.reshape((nkv, g + 2, d) + tail)
            return (w[:, :g].reshape((nh * d,) + tail),
                    w[:, g].reshape((nkv * d,) + tail),
                    w[:, g + 1].reshape((nkv * d,) + tail))
        if cfg.multi_query:
            return w[:nh * d], w[nh * d:(nh + 1) * d], w[(nh + 1) * d:]
        w = w.reshape((nh, 3, d) + tail)
        return tuple(w[:, j].reshape((nh * d,) + tail) for j in range(3))

    f = _Fill(model, state_dict, dtype, strip="transformer.")
    f.put("word_embeddings", f("word_embeddings.weight"))
    f.norm("ln_f", "ln_f")
    for i in range(cfg.num_hidden_layers):
        p = f"h.{i}."
        if cfg.new_decoder_architecture:
            f.norm(p + "ln_attn", p + "ln_attn")
            f.norm(p + "ln_mlp", p + "ln_mlp")
        else:
            f.norm(p + "input_layernorm", p + "input_layernorm")
            if p + "post_attention_layernorm.weight" in f.params:
                f.norm(p + "post_attention_layernorm",
                       p + "post_attention_layernorm")
        q, k, v = split_qkv(f(p + "self_attention.query_key_value.weight"))
        f.put(p + "wq", q.T)
        f.put(p + "wk", k.T)
        f.put(p + "wv", v.T)
        f.put(p + "dense", f(p + "self_attention.dense.weight").T)
        f.put(p + "h_to_4h", f(p + "mlp.dense_h_to_4h.weight").T)
        f.put(p + "four_h_to_h", f(p + "mlp.dense_4h_to_h.weight").T)
        if cfg.bias:
            qb, kb, vb = split_qkv(
                f(p + "self_attention.query_key_value.bias"))
            f.put(p + "wq_bias", qb)
            f.put(p + "wk_bias", kb)
            f.put(p + "wv_bias", vb)
            f.put(p + "dense_bias", f(p + "self_attention.dense.bias"))
            f.put(p + "h_to_4h_bias", f(p + "mlp.dense_h_to_4h.bias"))
            f.put(p + "four_h_to_h_bias", f(p + "mlp.dense_4h_to_h.bias"))
    return f.done()


def _gptj_common(f, p):
    """The GPT-J block's parts outside attention, and the model's ends."""
    f.norm(p + "ln_1", p + "ln_1")
    f.put(p + "fc_in", f(p + "mlp.fc_in.weight").T)
    f.put(p + "fc_in_bias", f(p + "mlp.fc_in.bias"))
    f.put(p + "fc_out", f(p + "mlp.fc_out.weight").T)
    f.put(p + "fc_out_bias", f(p + "mlp.fc_out.bias"))


def _gptj_ends(f):
    f.put("wte", f("wte.weight"))
    f.norm("ln_f", "ln_f")
    f.put("lm_head", f("lm_head.weight").T)
    f.put("lm_head_bias", f("lm_head.bias"))


@torch.no_grad()
def load_gptj_state_dict(model, state_dict, dtype=None):
    """``GPTJForCausalLM`` (``transformer.*`` names; a separate biased
    head, untied)."""
    f = _Fill(model, state_dict, dtype, strip="transformer.")
    _gptj_ends(f)
    for i in range(model.cfg.n_layer):
        p = f"h.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            f.put(p + name, f(p + f"attn.{name}.weight").T)
        _gptj_common(f, p)
    return f.done()


@torch.no_grad()
def load_codegen_state_dict(model, state_dict, dtype=None):
    """``CodeGenForCausalLM``. The fused ``qkv_proj`` is laid out in
    ``mp_num = 4`` groups of (q | v | k) columns with the heads
    group-major; it is unpacked into separate q/k/v keeping that head
    order everywhere (``out_proj`` consumes the same order)."""
    cfg = model.cfg
    mp, n = 4, cfg.n_embd
    local = n // mp
    f = _Fill(model, state_dict, dtype, strip="transformer.")
    _gptj_ends(f)
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        w = f(p + "attn.qkv_proj.weight").reshape(mp, 3, local, n)
        f.put(p + "q_proj", w[:, 0].reshape(-1, n).T)
        f.put(p + "v_proj", w[:, 1].reshape(-1, n).T)
        f.put(p + "k_proj", w[:, 2].reshape(-1, n).T)
        f.put(p + "out_proj", f(p + "attn.out_proj.weight").T)
        _gptj_common(f, p)
    return f.done()


@torch.no_grad()
def load_gpt2_state_dict(model, state_dict, dtype=None):
    """``GPTForCausalLM`` from an HF GPT-2 state dict (``transformer.*``
    names or none). HF's Conv1D layers store ``[in, out]`` already, so the
    fused ``c_attn`` ([q | k | v] blocks) and the MLP map without a
    transpose; the head is the (tied) word embedding."""
    f = _Fill(model, state_dict, dtype, strip="transformer.")
    f.put("wte", f("wte.weight"))
    f.put("wpe", f("wpe.weight"))
    f.norm("ln_f", "ln_f")
    for i in range(model.cfg.num_hidden_layers):
        p, k = f"blocks.{i}.", f"h.{i}."
        f.norm(p + "ln1", k + "ln_1")
        f.norm(p + "ln2", k + "ln_2")
        for ours, theirs in (("qkv", "attn.c_attn"), ("proj", "attn.c_proj"),
                             ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
            f.put(p + ours, f(k + theirs + ".weight"))
            f.put(p + ours + "_bias", f(k + theirs + ".bias"))
    return f.done()


@torch.no_grad()
def load_opt_state_dict(model, state_dict, dtype=None):
    """``OPTForCausalLM`` from an HF state dict (``model.decoder.*``
    names; the head tied to ``embed_tokens``), the 350m shape too
    (``project_in`` / ``project_out``, post-norm blocks, no final
    LayerNorm)."""
    f = _Fill(model, state_dict, dtype, strip="model.decoder.")
    f.put("embed_tokens", f("embed_tokens.weight"))
    f.put("embed_positions", f("embed_positions.weight"))
    for name in ("project_in", "project_out"):
        if name in f.params:
            f.put(name, f(name + ".weight").T)
    if "final_layer_norm.weight" in f.params:
        f.norm("final_layer_norm", "final_layer_norm")
    for i in range(model.cfg.num_hidden_layers):
        p = f"layers.{i}."
        f.norm(p + "self_attn_layer_norm", p + "self_attn_layer_norm")
        f.norm(p + "final_layer_norm", p + "final_layer_norm")
        for ours, bias in (("q_proj", "q_bias"), ("k_proj", "k_bias"),
                           ("v_proj", "v_bias"), ("out_proj", "out_bias")):
            f.put(p + ours, f(p + f"self_attn.{ours}.weight").T)
            f.put(p + bias, f(p + f"self_attn.{ours}.bias"))
        for name in ("fc1", "fc2"):
            f.put(p + name, f(p + name + ".weight").T)
            f.put(p + name + "_bias", f(p + name + ".bias"))
    return f.done()


@torch.no_grad()
def load_gpt_neox_state_dict(model, state_dict, dtype=None):
    """``GPTNeoXForCausalLM`` from an HF state dict (``gpt_neox.*``
    names). HF fuses QKV head-interleaved (``[nh, 3, d]`` on the out
    axis, as BLOOM); the port's ``qkv`` is ``[q | k | v]`` blocks. The
    untied ``embed_out`` is HF's ``[vocab, h]`` transposed."""
    cfg = model.cfg
    nh, h = cfg.num_attention_heads, cfg.hidden_size
    d = h // nh
    f = _Fill(model, state_dict, dtype, strip="gpt_neox.")
    f.put("embed_in", f("embed_in.weight"))
    f.put("embed_out", f("embed_out.weight").T)
    f.norm("final_layer_norm", "final_layer_norm")
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        f.norm(p + "input_layernorm", p + "input_layernorm")
        f.norm(p + "post_attention_layernorm", p + "post_attention_layernorm")
        w = f(p + "attention.query_key_value.weight").reshape(nh, 3, d, h)
        f.put(p + "qkv", *(w[:, j].reshape(nh * d, h).T for j in range(3)))
        b = f(p + "attention.query_key_value.bias").reshape(nh, 3, d)
        f.put(p + "qkv_bias", *(b[:, j].reshape(-1) for j in range(3)))
        f.put(p + "dense", f(p + "attention.dense.weight").T)
        f.put(p + "dense_bias", f(p + "attention.dense.bias"))
        f.put(p + "h_to_4h", f(p + "mlp.dense_h_to_4h.weight").T)
        f.put(p + "h_to_4h_bias", f(p + "mlp.dense_h_to_4h.bias"))
        f.put(p + "four_h_to_h", f(p + "mlp.dense_4h_to_h.weight").T)
        f.put(p + "four_h_to_h_bias", f(p + "mlp.dense_4h_to_h.bias"))
    return f.done()


@torch.no_grad()
def load_glm_state_dict(model, state_dict, dtype=None):
    """``GlmForCausalLM`` from an HF state dict: Llama's q/k/v packing
    (with the biases of an ``attention_bias`` config), HF's fused
    ``gate_up_proj`` as it is ([gate | up]), and ``lm_head`` falling back
    to the embeddings of a checkpoint that ties them."""
    f = _Fill(model, state_dict, dtype)
    f.put("embed_tokens", f("model.embed_tokens.weight"))
    f.put("norm.weight", f("model.norm.weight"))
    _lm_head(f)
    for i in range(model.cfg.num_hidden_layers):
        p, k = f"layers.{i}.", f"model.layers.{i}."
        _llama_attention(f, p, k + "self_attn.")
        f.put(p + "gate_up_proj", f(k + "mlp.gate_up_proj.weight").T)
        f.put(p + "down_proj", f(k + "mlp.down_proj.weight").T)
        f.norm(p + "input_layernorm", k + "input_layernorm")
        f.norm(p + "post_attention_layernorm", k + "post_attention_layernorm")
    return f.done()


@torch.no_grad()
def load_phi_state_dict(model, state_dict, dtype=None):
    """``PhiForCausalLM`` from an HF state dict (``model.*`` names): the
    biased q/k/v packed into the fused ``qkv_proj`` / ``qkv_bias``, the
    untied biased head."""
    f = _Fill(model, state_dict, dtype, strip="model.")
    f.put("embed_tokens", f("embed_tokens.weight"))
    f.norm("final_layernorm", "final_layernorm")
    f.put("lm_head", f("lm_head.weight").T)
    f.put("lm_head_bias", f("lm_head.bias"))
    for i in range(model.cfg.num_hidden_layers):
        p = f"layers.{i}."
        f.norm(p + "input_layernorm", p + "input_layernorm")
        f.put(p + "qkv_proj", *(f(p + f"self_attn.{n}_proj.weight").T
                                for n in "qkv"))
        f.put(p + "qkv_bias", *(f(p + f"self_attn.{n}_proj.bias")
                                for n in "qkv"))
        f.put(p + "dense", f(p + "self_attn.dense.weight").T)
        f.put(p + "dense_bias", f(p + "self_attn.dense.bias"))
        for name in ("fc1", "fc2"):
            f.put(p + name, f(p + f"mlp.{name}.weight").T)
            f.put(p + name + "_bias", f(p + f"mlp.{name}.bias"))
    return f.done()



# ---------------------------------------------------------------- encoders
# Heads and poolers of the encoders: a checkpoint of the bare encoder (or
# of another head) lacks them, and the port then keeps their random init,
# as the reference's loaders do.
_ENCODER_HEADS = ("mlm_", "nsp_head", "classifier", "lm_", "dense",
                  "out_proj", "vocab_", "disc_")


def _prefix(model, attr):
    """``attr + "."`` when ``model`` is a head model around the encoder
    ``attr``, else "" (the encoder itself)."""
    return attr + "." if hasattr(model, attr) else ""


def _hf_prefix(f, prefix, key="embeddings.word_embeddings.weight"):
    """``prefix`` when the checkpoint's names carry it (a head model's
    checkpoint), else "" (a bare encoder's)."""
    return prefix if prefix + key in f else ""


def _bert_layers(f, p, k, n):
    """``n`` BERT blocks (HF ``{k}encoder.layer.i``) into the port's
    ``{p}layers.i``, and the pooler the checkpoint may hold."""
    for i in range(n):
        ours, theirs = f"{p}layers.{i}.", f"{k}encoder.layer.{i}."
        for a, b in (("attention.q_proj", "attention.self.query"),
                     ("attention.k_proj", "attention.self.key"),
                     ("attention.v_proj", "attention.self.value"),
                     ("attention.out_proj", "attention.output.dense"),
                     ("intermediate", "intermediate.dense"),
                     ("output", "output.dense")):
            f.linear(ours + a, theirs + b)
        f.norm(ours + "attn_norm", theirs + "attention.output.LayerNorm")
        f.norm(ours + "out_norm", theirs + "output.LayerNorm")
    f.head(p + "pooler", k + "pooler.dense")


def _embeddings(f, p, k, names, norm):
    """The tables ``names`` (HF's ``{k}embeddings.<name>``, the port's
    ``{p}<name>``) and the embedding LayerNorm (the port's ``{p}{norm}``)."""
    for n in names:
        f.put(f"{p}{n}.weight", f(f"{k}embeddings.{n}.weight"))
    f.norm(p + norm, k + "embeddings.LayerNorm")


_BERT_TABLES = ("word_embeddings", "position_embeddings",
                "token_type_embeddings")


def _mlm_head(f, key="cls.predictions."):
    """BERT's MLM head: transform, its LayerNorm and the decoder bias (the
    decoder weight is the tied word table), where model and checkpoint
    both have it."""
    f.head("mlm_transform", key + "transform.dense")
    f.head("mlm_norm", key + "transform.LayerNorm", norm=True)
    if "mlm_bias" in f.params and key + "bias" in f:
        f.put("mlm_bias", f(key + "bias"))


def _done(f, p):
    return f.done(_ENCODER_HEADS + (p + "pooler",))


@torch.no_grad()
def load_bert_state_dict(model, state_dict, dtype=None):
    """``BertModel``, ``BertForPretraining`` or
    ``BertForSequenceClassification`` from an HF BERT state dict (``bert.*``
    names, or a bare ``BertModel``'s). The heads the checkpoint holds
    (``cls.predictions``, ``cls.seq_relationship``, ``classifier``) are
    loaded; those it lacks keep their random init."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "bert"), _hf_prefix(f, "bert.")
    _embeddings(f, p + "embeddings.", k, _BERT_TABLES, "layer_norm")
    _bert_layers(f, p, k, model.cfg.num_hidden_layers)
    _mlm_head(f)
    f.head("nsp_head", "cls.seq_relationship")
    f.head("classifier", "classifier")
    return _done(f, p)


@torch.no_grad()
def load_roberta_state_dict(model, state_dict, dtype=None):
    """``RobertaModel``, ``RobertaForMaskedLM`` or
    ``RobertaForSequenceClassification`` from an HF state dict
    (``roberta.*`` names): BERT's layout, plus the ``lm_head`` (dense, its
    LayerNorm, the bias; the decoder tied) or the ``classifier`` (dense,
    out_proj)."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "roberta") + "bert.", _hf_prefix(f, "roberta.")
    _embeddings(f, p + "embeddings.", k, _BERT_TABLES, "layer_norm")
    _bert_layers(f, p, k, model.cfg.num_hidden_layers)
    f.head("lm_dense", "lm_head.dense")
    f.head("lm_norm", "lm_head.layer_norm", norm=True)
    if "lm_bias" in f.params and "lm_head.bias" in f:
        f.put("lm_bias", f("lm_head.bias"))
    f.head("dense", "classifier.dense")
    f.head("out_proj", "classifier.out_proj")
    return _done(f, p)


@torch.no_grad()
def load_ernie_state_dict(model, state_dict, dtype=None):
    """``ErnieModel``, ``ErnieForMaskedLM`` or
    ``ErnieForSequenceClassification`` from an HF state dict (``ernie.*``
    names): BERT's layout, ERNIE's task-type table (``use_task_id``) and
    the MLM head or classifier the checkpoint holds."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "ernie"), _hf_prefix(f, "ernie.")
    tables = _BERT_TABLES + (("task_type_embeddings",)
                             if model.cfg.use_task_id else ())
    _embeddings(f, p + "embeddings.", k, tables, "layer_norm")
    _bert_layers(f, p, k, model.cfg.num_hidden_layers)
    _mlm_head(f)
    f.head("classifier", "classifier")
    return _done(f, p)


@torch.no_grad()
def load_electra_state_dict(model, state_dict, dtype=None):
    """``ElectraModel`` or ``ElectraForPreTraining`` from an HF state dict
    (``electra.*`` names): the factorised tables, the projection up to the
    hidden size (when the config has one) and the discriminator head."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "electra"), _hf_prefix(f, "electra.")
    _embeddings(f, p, k, _BERT_TABLES, "emb_norm")
    if p + "embeddings_project.weight" in f.params:
        f.linear(p + "embeddings_project", k + "embeddings_project")
    _bert_layers(f, p, k, model.cfg.num_hidden_layers)
    f.head("disc_dense", "discriminator_predictions.dense")
    f.head("disc_out", "discriminator_predictions.dense_prediction")
    return _done(f, p)


@torch.no_grad()
def load_layoutlm_state_dict(model, state_dict, dtype=None):
    """``LayoutLMModel`` or ``LayoutLMForMaskedLM`` from an HF state dict
    (``layoutlm.*`` names): BERT's encoder, the six 2-D layout tables and
    the MLM head."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "layoutlm"), _hf_prefix(f, "layoutlm.")
    _embeddings(f, p, k, _BERT_TABLES + tuple(
        f"{a}_position_embeddings" for a in "xyhw"), "emb_norm")
    _bert_layers(f, p, k, model.cfg.num_hidden_layers)
    _mlm_head(f)
    return _done(f, p)


@torch.no_grad()
def load_distilbert_state_dict(model, state_dict, dtype=None):
    """``DistilBertModel`` or ``DistilBertForMaskedLM`` from an HF state
    dict (``distilbert.*`` names; the projector tied to the word table)."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "distilbert"), _hf_prefix(f, "distilbert.")
    _embeddings(f, p, k, ("word_embeddings", "position_embeddings"),
                "emb_norm")
    for i in range(model.cfg.n_layers):
        ours, theirs = f"{p}layers.{i}.", f"{k}transformer.layer.{i}."
        for a in "qkv":
            f.linear(f"{ours}attention.{a}_proj",
                     f"{theirs}attention.{a}_lin")
        f.linear(ours + "attention.out_proj", theirs + "attention.out_lin")
        f.linear(ours + "lin1", theirs + "ffn.lin1")
        f.linear(ours + "lin2", theirs + "ffn.lin2")
        f.norm(ours + "sa_layer_norm", theirs + "sa_layer_norm")
        f.norm(ours + "output_layer_norm", theirs + "output_layer_norm")
    f.head("vocab_transform", "vocab_transform")
    f.head("vocab_norm", "vocab_layer_norm", norm=True)
    if "vocab_bias" in f.params and "vocab_projector.bias" in f:
        f.put("vocab_bias", f("vocab_projector.bias"))
    return _done(f, p)


@torch.no_grad()
def load_albert_state_dict(model, state_dict, dtype=None):
    """``AlbertModel`` or ``AlbertForMaskedLM`` from an HF state dict
    (``albert.*`` names): the factorised tables, the projection
    (``encoder.embedding_hidden_mapping_in``), the ONE shared layer
    (``albert_layer_groups.0.albert_layers.0``) and the MLM head
    (``predictions``)."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "albert"), _hf_prefix(f, "albert.")
    _embeddings(f, p, k, _BERT_TABLES, "emb_norm")
    f.linear(p + "embedding_project",
             k + "encoder.embedding_hidden_mapping_in")
    ours = p + "shared."
    theirs = k + "encoder.albert_layer_groups.0.albert_layers.0."
    for a, b in (("attention.q_proj", "attention.query"),
                 ("attention.k_proj", "attention.key"),
                 ("attention.v_proj", "attention.value"),
                 ("attention.out_proj", "attention.dense"),
                 ("ffn", "ffn"), ("ffn_output", "ffn_output")):
        f.linear(ours + a, theirs + b)
    f.norm(ours + "attn_norm", theirs + "attention.LayerNorm")
    f.norm(ours + "full_norm", theirs + "full_layer_layer_norm")
    f.head(p + "pooler", k + "pooler")
    f.head("lm_dense", "predictions.dense")
    f.head("lm_norm", "predictions.LayerNorm", norm=True)
    if "lm_bias" in f.params and "predictions.bias" in f:
        f.put("lm_bias", f("predictions.bias"))
    return _done(f, p)


@torch.no_grad()
def load_ernie_m_state_dict(model, state_dict, dtype=None):
    """``ErnieMModel`` or ``ErnieMForSequenceClassification`` from an HF
    state dict (``ernie_m.*`` or bare names)."""
    f = _Fill(model, state_dict, dtype)
    p, k = _prefix(model, "ernie_m"), _hf_prefix(f, "ernie_m.")
    for n in ("word_embeddings", "position_embeddings"):
        f.put(f"{p}{n}.weight", f(f"{k}embeddings.{n}.weight"))
    f.norm(p + "emb_norm", k + "embeddings.layer_norm")
    for i in range(model.cfg.num_hidden_layers):
        ours, theirs = f"{p}layers.{i}.", f"{k}encoder.layers.{i}."
        for a in "qkv":
            f.linear(f"{ours}self_attn.{a}_proj",
                     f"{theirs}self_attn.self_attn.{a}_proj")
        f.linear(ours + "self_attn.out_proj", theirs + "self_attn.out_proj")
        for n in ("linear1", "linear2"):
            f.linear(ours + n, theirs + n)
        for n in ("norm1", "norm2"):
            f.norm(ours + n, theirs + n)
    f.head(p + "pooler", k + "pooler.dense")
    f.head("classifier", "classifier")
    return _done(f, p)
