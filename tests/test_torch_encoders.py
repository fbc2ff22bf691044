"""The BERT-family encoders and ``nn.transformer`` against the JAX package.

Each encoder at ``tiny()`` (BERT also with ``varlen_attention``, its
classifier, RoBERTa's classifier, ERNIE without task ids), with the JAX
model's weights carried over by ``load_jax_state_dict``, on the CPU in
fp32, where the flash wrappers run their plain versions. Inputs are
seeded numpy arrays with a right-padded row. Tolerances: the same
algorithm on both sides, only the summation order of XLA's and ATen's
products differs: outputs rtol 1e-4 and atol 1e-5 on the valid rows
(padded query rows are compared only where both sides define them), the
loss rtol 1e-5 and each gradient within 1e-4 of its RMS (plus 1e-7
absolute, for the key biases' gradients, which are 0 in exact
arithmetic). Dropout is
checked for its keep rate and scaling, not its bits (torch cannot draw
``jax.random``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.models import albert as jalbert
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import distilbert as jdistil
from paddle_tpu.models import electra as jelectra
from paddle_tpu.models import ernie as jernie
from paddle_tpu.models import ernie_m as jernie_m
from paddle_tpu.models import layoutlm as jlayout
from paddle_tpu.models import roberta as jroberta
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import albert as talbert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import distilbert as tdistil
from paddle_tpu_torch.models import electra as telectra
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import ernie_m as ternie_m
from paddle_tpu_torch.models import layoutlm as tlayout
from paddle_tpu_torch.models import roberta as troberta
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.ops import attention as tattn
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_common import to_np

B, S, VOCAB = 2, 12, 128
LENS = (12, 7)
# case -> (JAX class, JAX config, port class, port config, config kw,
#          the inputs the forward takes beyond the ids)
CASES = {
    "bert": (jbert.BertForPretraining, jbert.BertConfig,
             tbert.BertForPretraining, tbert.BertConfig, {},
             ("token_type_ids", "attention_mask")),
    "bert_varlen": (jbert.BertForPretraining, jbert.BertConfig,
                    tbert.BertForPretraining, tbert.BertConfig,
                    dict(varlen_attention=True),
                    ("token_type_ids", "attention_mask")),
    "bert_seqcls": (jbert.BertForSequenceClassification, jbert.BertConfig,
                    tbert.BertForSequenceClassification, tbert.BertConfig,
                    dict(varlen_attention=True),
                    ("token_type_ids", "attention_mask")),
    "roberta": (jroberta.RobertaForMaskedLM, jroberta.RobertaConfig,
                troberta.RobertaForMaskedLM, troberta.RobertaConfig, {},
                ("attention_mask",)),
    "roberta_seqcls": (jroberta.RobertaForSequenceClassification,
                       jroberta.RobertaConfig,
                       troberta.RobertaForSequenceClassification,
                       troberta.RobertaConfig, {}, ("attention_mask",)),
    "ernie": (jernie.ErnieForMaskedLM, jernie.ErnieConfig,
              ternie.ErnieForMaskedLM, ternie.ErnieConfig, {},
              ("token_type_ids", "attention_mask", "task_type_ids")),
    "ernie_no_task": (jernie.ErnieForMaskedLM, jernie.ErnieConfig,
                      ternie.ErnieForMaskedLM, ternie.ErnieConfig,
                      dict(use_task_id=False),
                      ("token_type_ids", "attention_mask")),
    "electra": (jelectra.ElectraForPreTraining, jelectra.ElectraConfig,
                telectra.ElectraForPreTraining, telectra.ElectraConfig, {},
                ("token_type_ids", "attention_mask")),
    "layoutlm": (jlayout.LayoutLMForMaskedLM, jlayout.LayoutLMConfig,
                 tlayout.LayoutLMForMaskedLM, tlayout.LayoutLMConfig, {},
                 ("bbox", "token_type_ids", "attention_mask")),
    "distilbert": (jdistil.DistilBertForMaskedLM, jdistil.DistilBertConfig,
                   tdistil.DistilBertForMaskedLM, tdistil.DistilBertConfig,
                   {}, ("attention_mask",)),
    "albert": (jalbert.AlbertForMaskedLM, jalbert.AlbertConfig,
               talbert.AlbertForMaskedLM, talbert.AlbertConfig, {},
               ("token_type_ids", "attention_mask")),
    "ernie_m": (jernie_m.ErnieMModel, jernie_m.ErnieMConfig,
                ternie_m.ErnieMModel, ternie_m.ErnieMConfig, {},
                ("attention_mask",)),
}


def _pair(case, seed=0, **kw):
    jcls, jcfg, tcls, tcfg, case_kw, _ = CASES[case]
    kw = {**case_kw, **kw}
    pt.seed(seed)
    jm = jcls(jcfg.tiny(**kw)).eval()
    tm = tcls(tcfg.tiny(**kw), device="cpu").eval()
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


def _inputs(case, seed=1):
    """numpy inputs: ids (RoBERTa's pad id 1 in the padding), a right-padded
    mask of LENS, token types, task types and boxes."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(2, VOCAB, (B, S))
    mask = (np.arange(S)[None, :] < np.asarray(LENS)[:, None]).astype(
        np.int64)
    if case.startswith("roberta"):
        ids = np.where(mask == 1, ids, 1)
    x0, y0 = rs.randint(0, 60, (B, S)), rs.randint(0, 60, (B, S))
    bbox = np.stack([x0, y0, x0 + rs.randint(1, 60, (B, S)),
                     y0 + rs.randint(1, 60, (B, S))], axis=-1)
    return dict(input_ids=ids, attention_mask=mask,
                token_type_ids=rs.randint(0, 2, (B, S)),
                task_type_ids=rs.randint(0, 3, (B, S)), bbox=bbox)


def _call(m, case, inp, conv):
    names = CASES[case][5]
    args = [conv(inp["input_ids"])]
    kw = {}
    for n in names:
        if n == "bbox":
            args.append(conv(inp["bbox"]))
        else:
            kw[n] = conv(inp[n])
    out = m(*args, **kw)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", CASES)
def test_eval_outputs_match_reference(case):
    """Every output of the eval forward (MLM / discriminator logits,
    hidden states, NSP / classifier / pooled outputs), at fp32, on the
    valid rows: the padded rows' values are not part of the contract (the
    dense path lets them attend only the valid keys too, so they agree;
    they are masked all the same)."""
    jm, tm = _pair(case)
    inp = _inputs(case)
    want = jax.jit(lambda m, x: _call(m, case, x, jnp.asarray))(
        jm, {k: jnp.asarray(v) for k, v in inp.items()})
    with torch.no_grad():
        got = _call(tm, case, inp, torch.as_tensor)
    assert len(got) == len(want)
    valid = inp["attention_mask"].astype(bool)
    for g, w in zip(got, want):
        g, w = to_np(g), to_np(w)
        assert g.shape == w.shape
        if g.ndim >= 2 and g.shape[:2] == (B, S):
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_parameters_are_the_reference_s(case):
    jm, tm = _pair(case)
    want = jm.state_dict()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert tuple(p.shape) == tuple(np.shape(want[name])), name


def _grads_close(tm, jgrads):
    want = jgrads.state_dict()
    params = dict(tm.named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        w = np.asarray(want[name], np.float32)
        rms = float(np.sqrt(np.mean(w ** 2))) or 1.0
        # a parameter the loss never reaches (the MLM loss and the pooler)
        # has no gradient here and a zero one there
        g = to_np(p.grad) if p.grad is not None else np.zeros_like(w)
        err = np.abs(g - w).max()
        # 1e-7 absolute: the key bias's gradient is 0 in exact arithmetic
        # (softmax ignores a constant score shift); both sides give noise
        assert err <= 1e-4 * rms + 1e-7, (name, err, rms)


@pytest.mark.parametrize("varlen", [False, True], ids=["dense", "varlen"])
def test_bert_pretraining_loss_and_grads_match_reference(varlen):
    """``BertForPretraining.loss`` (the masked MLM mean plus NSP) at
    dropout 0 in training mode, and every gradient, against
    ``value_and_grad`` of the reference's loss: a padded row, labels -100
    outside a random 30% of the positions."""
    kw = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
              varlen_attention=varlen)
    jm, tm = _pair("bert", **kw)
    jm.train()
    tm.train()
    inp = _inputs("bert", 2)
    rs = np.random.RandomState(3)
    mlm = np.where(rs.rand(B, S) < 0.3, inp["input_ids"], -100)
    nsp = rs.randint(0, 2, (B,))
    args = (inp["input_ids"], mlm, nsp, inp["token_type_ids"],
            inp["attention_mask"])

    def loss_fn(m, *a):
        return m.loss(*a)
    jloss, jgrads = jax.jit(value_and_grad(loss_fn))(
        jm, *(jnp.asarray(a) for a in args))
    loss = tm.loss(*(torch.as_tensor(a) for a in args))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_close(tm, jgrads)


def test_albert_shared_layer_gradient_matches_reference():
    """ALBERT applies its one layer three times: the shared parameters'
    gradients are the sum of the three applications', as the reference's
    (and every other gradient too)."""
    jm, tm = _pair("albert")
    inp = _inputs("albert", 4)
    mlm = np.where(np.random.RandomState(5).rand(B, S) < 0.4,
                   inp["input_ids"], -100)
    args = (inp["input_ids"], mlm, inp["token_type_ids"],
            inp["attention_mask"])

    def loss_fn(m, *a):
        return m.loss(*a)
    jloss, jgrads = jax.jit(value_and_grad(loss_fn))(
        jm, *(jnp.asarray(a) for a in args))
    loss = tm.loss(*(torch.as_tensor(a) for a in args))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_close(tm, jgrads)
    shared = [p for n, p in tm.named_parameters() if ".shared." in n]
    assert len(shared) == 16 and all(float(p.grad.abs().max()) > 0
                                     for p in shared)


def test_bert_varlen_matches_dense_mask():
    """The port of ``test_attn_mask_stack.py``'s case: ``varlen_attention``
    (kv_lens, the flash path) equals the additive-mask path (eager
    attention) on the valid positions, on both packages, and the port's
    varlen path equals the reference's."""
    kw = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    pt.seed(0)
    jm = jbert.BertModel(jbert.BertConfig(varlen_attention=True, **kw))
    m_dense = tbert.BertModel(tbert.BertConfig(**kw), device="cpu")
    m_varlen = tbert.BertModel(tbert.BertConfig(varlen_attention=True, **kw),
                               device="cpu")
    for m in (m_dense, m_varlen):
        load_jax_state_dict(m, jm.state_dict())
    rs = np.random.RandomState(5)
    b, s = 2, 24
    ids = rs.randint(0, 100, (b, s))
    lens = np.asarray([24, 11])
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int64)
    with torch.no_grad():
        seq_d, _ = m_dense(torch.as_tensor(ids),
                           attention_mask=torch.as_tensor(mask))
        seq_v, _ = m_varlen(torch.as_tensor(ids),
                            attention_mask=torch.as_tensor(mask))
    seq_j, _ = jax.jit(lambda m, i, a: m(i, attention_mask=a))(
        jm, jnp.asarray(ids), jnp.asarray(mask))
    valid = mask[..., None].astype(bool)
    np.testing.assert_allclose(to_np(seq_v) * valid, to_np(seq_d) * valid,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(seq_v) * valid, to_np(seq_j) * valid,
                               rtol=1e-4, atol=1e-5)


def test_varlen_refuses_a_non_prefix_mask():
    """A mask with a hole raises ValueError, as the reference's host-side
    check does, on both packages."""
    _, tm = _pair("bert_varlen")
    jm, _ = _pair("bert_varlen")
    ids = np.ones((1, 6), np.int64)
    hole = np.asarray([[1, 1, 0, 1, 0, 0]])
    with pytest.raises(ValueError, match="CONTIGUOUS"):
        tm(torch.as_tensor(ids), attention_mask=torch.as_tensor(hole))
    with pytest.raises(ValueError, match="CONTIGUOUS"):
        jm(jnp.asarray(ids), attention_mask=jnp.asarray(hole))
    lens = tbert.varlen_lengths(torch.as_tensor([[1, 1, 1, 0], [1, 0, 0, 0],
                                                 [0, 0, 0, 0]]))
    assert lens.dtype == torch.int32 and lens.tolist() == [3, 1, 0]


def _count_eager(monkeypatch):
    calls = []
    orig = tattn.eager_attention

    def counted(*a, **kw):
        calls.append(kw.get("dropout_p", 0.0))
        return orig(*a, **kw)
    monkeypatch.setattr(tattn, "eager_attention", counted)
    return calls


def test_attention_routes_as_the_reference_s(monkeypatch):
    """varlen and maskless forwards take the flash path (no eager call);
    a dense mask (ERNIE, ELECTRA, LayoutLM, the non-varlen BERT) and
    attention dropout while training take ``eager_attention``."""
    calls = _count_eager(monkeypatch)
    inp = _inputs("bert")
    ids = torch.as_tensor(inp["input_ids"])
    am = torch.as_tensor(inp["attention_mask"])
    _, tm = _pair("bert_varlen")
    with torch.no_grad():
        tm(ids, attention_mask=am)
        tm(ids)
    assert calls == []
    for case in ("bert", "ernie", "electra"):
        _, tm = _pair(case)
        with torch.no_grad():
            tm(ids, attention_mask=am)
        assert len(calls) == 2, case
        calls.clear()
    _, tm = _pair("bert_varlen", attention_probs_dropout_prob=0.1)
    tm.train()
    tm(ids, attention_mask=am, generator=torch.Generator().manual_seed(0))
    assert calls == [0.1, 0.1]


def test_dropout_keep_rate_and_scaling():
    """BERT with dropout 0.3 while training: ``nn.Dropout`` keeps ~70% of
    a large tensor's elements, each kept value exactly x / 0.7; the
    embeddings' output is the eval output through such a mask; the same
    generator seed gives the same loss, another seed another; eval mode
    is deterministic and equals a dropout-0 model's output."""
    x = torch.randn(400, 500, generator=torch.Generator().manual_seed(0))
    y = tnn.Dropout(0.3)(x, generator=torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=0, atol=0)
    _, tm = _pair("bert", hidden_dropout_prob=0.3,
                  attention_probs_dropout_prob=0.3)
    inp = _inputs("bert", 6)
    ids = torch.as_tensor(inp["input_ids"])
    emb = tm.bert.embeddings
    with torch.no_grad():
        ref = emb(ids)
        emb.train()
        out = emb(ids, generator=torch.Generator().manual_seed(2))
    kept = out != 0
    assert 0.6 < float(kept.float().mean()) < 0.8
    torch.testing.assert_close(out[kept], ref[kept] / 0.7)
    tm.train()
    mlm = torch.as_tensor(np.where(inp["token_type_ids"] == 1,
                                   inp["input_ids"], -100))

    def loss(seed):
        return float(tm.loss(ids, mlm, generator=torch.Generator()
                             .manual_seed(seed)).detach())
    assert loss(3) == loss(3) != loss(4)
    tm.eval()
    _, t0 = _pair("bert", hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
    with torch.no_grad():
        torch.testing.assert_close(tm(ids)[0], t0(ids)[0], rtol=0, atol=0)


# ---------------------------------------------------------- nn.transformer
def _layer_pair(jlayer, tlayer):
    load_jax_state_dict(tlayer, jlayer.state_dict())
    return jlayer.eval(), tlayer.eval()


def test_mha_matches_reference_causal_gqa_and_cache():
    """``MultiHeadAttention`` (the spec of ``tests/test_nn.py``'s MHA
    cases): causal, full with kv_lens, GQA, and a ``cache`` whose
    ``update(k, v)`` prepends stored keys and values, against the
    reference's on the same weights."""
    x = np.random.RandomState(0).randn(2, 6, 16).astype(np.float32)
    pt.seed(0)
    jm, tm = _layer_pair(jnn.MultiHeadAttention(16, 2),
                         tnn.MultiHeadAttention(16, 2, device="cpu"))
    for kw in (dict(is_causal=True), dict(kv_lens=[6, 3])):
        want = jax.jit(lambda m, a, kw=kw: m(a, **{
            k: (jnp.asarray(v) if k == "kv_lens" else v)
            for k, v in kw.items()}))(jm, jnp.asarray(x))
        with torch.no_grad():
            got = tm(torch.as_tensor(x), **{
                k: (torch.as_tensor(v) if k == "kv_lens" else v)
                for k, v in kw.items()})
        mask = np.ones((2, 6, 1), bool) if "kv_lens" not in kw else \
            (np.arange(6)[None, :, None] < np.asarray([6, 3])[:, None, None])
        np.testing.assert_allclose(to_np(got) * mask, to_np(want) * mask,
                                   rtol=1e-4, atol=1e-5)
    # causal: a change to the last token leaves the earlier outputs alone
    x2 = x.copy()
    x2[:, -1] = 99.0
    with torch.no_grad():
        a = tm(torch.as_tensor(x), is_causal=True)
        b = tm(torch.as_tensor(x2), is_causal=True)
    torch.testing.assert_close(a[:, :5], b[:, :5], rtol=0, atol=1e-5)
    pt.seed(1)
    jg, tg = _layer_pair(jnn.MultiHeadAttention(16, 4, num_kv_heads=2),
                         tnn.MultiHeadAttention(16, 4, num_kv_heads=2,
                                                device="cpu"))
    with torch.no_grad():
        got = tg(torch.as_tensor(x))
    assert got.shape == (2, 6, 16)
    np.testing.assert_allclose(
        to_np(got), to_np(jax.jit(lambda m, a: m(a))(jg, jnp.asarray(x))),
        rtol=1e-4, atol=1e-5)

    class Prepend:
        """A cache holding 3 earlier positions of keys and values."""

        def __init__(self, k, v):
            self.k, self.v = k, v

        def update(self, k, v):
            cat = (jnp.concatenate if isinstance(k, jax.Array)
                   else torch.cat)
            return (cat([self.k, k], 1), cat([self.v, v], 1), "new")
    past = np.random.RandomState(1).randn(2, 3, 2, 8).astype(np.float32)
    want, jc = jm(jnp.asarray(x), is_causal=True,
                  cache=Prepend(jnp.asarray(past), jnp.asarray(past * 2)))
    with torch.no_grad():
        got, tc = tm(torch.as_tensor(x), is_causal=True,
                     cache=Prepend(torch.as_tensor(past),
                                   torch.as_tensor(past * 2)))
    assert tc == jc == "new"
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_transformer_stacks_match_reference(pre):
    """``TransformerEncoder`` of ``TransformerEncoderLayer`` (the spec of
    ``tests/test_nn.py``'s encoder case) and the full ``Transformer``
    (encoder + decoder with its causal self-attention and cross
    attention), post-LN and pre-LN, in eval mode."""
    rs = np.random.RandomState(2)
    src = rs.randn(2, 5, 16).astype(np.float32)
    tgt = rs.randn(2, 4, 16).astype(np.float32)
    pt.seed(0)
    je, te = _layer_pair(
        jnn.TransformerEncoder(lambda: jnn.TransformerEncoderLayer(
            16, 2, 32, normalize_before=pre), 2),
        tnn.TransformerEncoder(lambda: tnn.TransformerEncoderLayer(
            16, 2, 32, normalize_before=pre, device="cpu"), 2))
    with torch.no_grad():
        got = te(torch.as_tensor(src))
    assert got.shape == (2, 5, 16)
    np.testing.assert_allclose(
        to_np(got), to_np(jax.jit(lambda m, a: m(a))(je, jnp.asarray(src))),
        rtol=1e-4, atol=1e-5)
    pt.seed(1)
    jt, tt = _layer_pair(
        jnn.Transformer(16, 2, 2, 2, 32, normalize_before=pre),
        tnn.Transformer(16, 2, 2, 2, 32, normalize_before=pre,
                        device="cpu"))
    with torch.no_grad():
        got = tt(torch.as_tensor(src), torch.as_tensor(tgt))
    want = jax.jit(lambda m, a, b: m(a, b))(jt, jnp.asarray(src),
                                            jnp.asarray(tgt))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-4,
                               atol=1e-5)
    mask = tnn.Transformer.generate_square_subsequent_mask(4, device="cpu")
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jnn.Transformer
                                 .generate_square_subsequent_mask(4)))
