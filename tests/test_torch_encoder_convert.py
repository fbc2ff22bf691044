"""The encoders' HF loaders (``models/convert.py``
``load_<family>_state_dict``): for each of BERT, RoBERTa, ERNIE (with and
without task ids), ELECTRA, LayoutLM, DistilBERT, ALBERT and ERNIE-M, an
HF model built from the config of ``tests/test_convert.py``'s case for
that family is loaded into the JAX model by the reference loader and
into the port by the port's loader. Every parameter equals the port's
bit for bit (fp32: both only transpose and copy), but the poolers that an
MLM checkpoint lacks (both sides keep their random init), and the port's output matches HF's within that case's tolerance
(2e-4), on the valid rows of a padded batch where the case has one. The
heads and poolers a checkpoint lacks keep their random init, as the
reference's loaders leave them; any other parameter left unwritten
raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import convert as jconv
from paddle_tpu_torch.models import convert as tconv
from tests._torch_threads import one_torch_thread  # noqa: F401

transformers = pytest.importorskip("transformers")

_BASE = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=64)
# case -> (HF class, HF config kw, port / reference module, model class,
#          config kw, loader, output of HF's result, inputs)
CASES = {
    "bert": ("BertModel", dict(_BASE, num_attention_heads=4,
                               type_vocab_size=2), "bert", "BertModel",
             dict(_BASE, num_attention_heads=4, type_vocab_size=2,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
             "bert", "last_hidden_state", ("ids",)),
    "roberta": ("RobertaForMaskedLM", dict(_BASE, max_position_embeddings=66,
                                           type_vocab_size=1, pad_token_id=1),
                "roberta", "RobertaForMaskedLM",
                dict(_BASE, max_position_embeddings=66, type_vocab_size=1,
                     pad_token_id=1), "roberta", "logits", ("ids", "mask")),
    "ernie_task": ("ErnieForMaskedLM", dict(_BASE, type_vocab_size=4,
                                            use_task_id=True,
                                            task_type_vocab_size=3),
                   "ernie", "ErnieForMaskedLM",
                   dict(_BASE, type_vocab_size=4, use_task_id=True,
                        task_type_vocab_size=3), "ernie", "logits",
                   ("ids", "token_type_ids", "task_type_ids")),
    "ernie": ("ErnieForMaskedLM", dict(_BASE, type_vocab_size=4,
                                       use_task_id=False),
              "ernie", "ErnieForMaskedLM",
              dict(_BASE, type_vocab_size=4, use_task_id=False), "ernie",
              "logits", ("ids", "token_type_ids")),
    "electra": ("ElectraForPreTraining", dict(_BASE, embedding_size=16),
                "electra", "ElectraForPreTraining",
                dict(_BASE, embedding_size=16), "electra", "logits",
                ("ids",)),
    "layoutlm": ("LayoutLMForMaskedLM", dict(_BASE,
                                             max_2d_position_embeddings=128),
                 "layoutlm", "LayoutLMForMaskedLM", None, "layoutlm",
                 "logits", ("ids", "bbox")),
    "distilbert": ("DistilBertForMaskedLM",
                   dict(vocab_size=96, dim=32, n_layers=2, n_heads=2,
                        hidden_dim=64, max_position_embeddings=64,
                        dropout=0.0, attention_dropout=0.0),
                   "distilbert", "DistilBertForMaskedLM", None, "distilbert",
                   "logits", ("ids",)),
    "albert": ("AlbertForMaskedLM", dict(_BASE, embedding_size=16,
                                         num_hidden_layers=3),
               "albert", "AlbertForMaskedLM", None, "albert", "logits",
               ("ids", "token_type_ids")),
    "ernie_m": ("ErnieMModel", dict(_BASE, max_position_embeddings=66,
                                    hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0),
                "ernie_m", "ErnieMModel", None, "ernie_m",
                "last_hidden_state", ("ids",)),
}


def _models(case):
    import importlib
    hf_cls, hf_kw, mod, cls, kw, loader, _, _ = CASES[case]
    T = transformers
    torch.manual_seed(0)
    cfg_cls = getattr(T, hf_cls.replace("ForMaskedLM", "Config")
                      .replace("ForPreTraining", "Config")
                      .replace("Model", "Config"))
    extra = {} if case in ("ernie_m", "distilbert") else dict(
        attn_implementation="eager")
    hf = getattr(T, hf_cls)(cfg_cls(**hf_kw, **extra)).eval()
    jmod = importlib.import_module(f"paddle_tpu.models.{mod}")
    tmod = importlib.import_module(f"paddle_tpu_torch.models.{mod}")
    jcfg_cls = getattr(jmod, cls.replace("ForMaskedLM", "Config")
                       .replace("ForPreTraining", "Config")
                       .replace("Model", "Config"))
    tcfg_cls = getattr(tmod, jcfg_cls.__name__)
    if kw is None:        # the reference's case uses tiny() at vocab 96
        jcfg = jcfg_cls.tiny(vocab_size=96)
        tcfg = tcfg_cls.tiny(vocab_size=96)
    else:
        jcfg, tcfg = jcfg_cls(**kw), tcfg_cls(**kw)
    pt.seed(0)
    sd = hf.state_dict()
    jm = getattr(jconv, f"load_{loader}_state_dict")(
        getattr(jmod, cls)(jcfg).eval(), sd)
    tm = getattr(tconv, f"load_{loader}_state_dict")(
        getattr(tmod, cls)(tcfg, device="cpu", seed=7).eval(), sd)
    return hf, jm, tm


def _inputs(case):
    rs = np.random.RandomState(0)
    ids = rs.randint(2, 96, (2, 12))
    out = {"ids": ids}
    if case == "roberta":
        ids[1, 9:] = 1                    # a padded row
        out["mask"] = (ids != 1).astype(np.int64)
    out["token_type_ids"] = rs.randint(0, 4 if "ernie" in case else 2,
                                       (2, 12))
    out["task_type_ids"] = rs.randint(0, 3, (2, 12))
    x0, y0 = rs.randint(0, 60, (2, 12)), rs.randint(0, 60, (2, 12))
    out["bbox"] = np.stack([x0, y0, x0 + rs.randint(1, 60, (2, 12)),
                            y0 + rs.randint(1, 60, (2, 12))], axis=-1)
    return out


def _hf_out(hf, case, inp):
    names = CASES[case][7]
    kw = {}
    if "mask" in names:
        kw["attention_mask"] = torch.tensor(inp["mask"])
    for n in ("token_type_ids", "task_type_ids", "bbox"):
        if n in names:
            kw[n] = torch.tensor(inp[n])
    with torch.no_grad():
        return getattr(hf(torch.tensor(inp["ids"]), **kw),
                       CASES[case][6]).numpy()


def _port_out(tm, case, inp):
    names = CASES[case][7]
    args, kw = [torch.as_tensor(inp["ids"])], {}
    if "bbox" in names:
        args.append(torch.as_tensor(inp["bbox"]))
    if "mask" in names:
        kw["attention_mask"] = torch.as_tensor(inp["mask"])
    for n in ("token_type_ids", "task_type_ids"):
        if n in names:
            kw[n] = torch.as_tensor(inp[n])
    with torch.no_grad():
        out = tm(*args, **kw)
    return (out[0] if isinstance(out, tuple) else out).numpy()


@pytest.mark.parametrize("case", CASES)
def test_loader_matches_the_reference_loader_and_hf(case):
    hf, jm, tm = _models(case)
    jp = jm.state_dict()
    tp = dict(tm.named_parameters())
    assert set(jp) == set(tp)
    # an MLM checkpoint has no pooler: both sides keep their random init
    has_pooler = any("pooler" in k for k in hf.state_dict())
    for k in jp:
        if "pooler" in k and not has_pooler:
            continue
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k], np.float32),
                                      err_msg=k)
    inp = _inputs(case)
    ref = _hf_out(hf, case, inp)
    got = _port_out(tm, case, inp)
    if "mask" in inp:
        valid = inp["mask"][:, :, None].astype(bool)
        got, ref = np.where(valid, got, 0), np.where(valid, ref, 0)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_bert_heads_load_and_a_missing_tensor_raises():
    """An HF ``BertForPreTraining`` checkpoint fills every parameter of
    ``BertForPretraining`` (the MLM transform, its LayerNorm and bias, the
    NSP head): the MLM logits match HF's; a BERT checkpoint missing a
    layer's tensor raises, naming it."""
    from paddle_tpu_torch.models import bert as tbert
    T = transformers
    torch.manual_seed(0)
    hf = T.BertForPreTraining(T.BertConfig(
        **dict(_BASE, num_attention_heads=4),
        attn_implementation="eager")).eval()
    cfg = tbert.BertConfig(**dict(_BASE, num_attention_heads=4))
    tm = tconv.load_bert_state_dict(
        tbert.BertForPretraining(cfg, device="cpu").eval(), hf.state_dict())
    ids = np.random.RandomState(1).randint(0, 96, (2, 10))
    with torch.no_grad():
        want = hf(torch.tensor(ids))
        mlm, nsp = tm(torch.as_tensor(ids))
    np.testing.assert_allclose(mlm.numpy(), want.prediction_logits.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(nsp.numpy(),
                               want.seq_relationship_logits.numpy(),
                               rtol=2e-4, atol=2e-4)
    sd = {k: v for k, v in hf.state_dict().items()
          if k != "bert.encoder.layer.1.output.dense.weight"}
    with pytest.raises(KeyError, match="layer.1.output.dense"):
        tconv.load_bert_state_dict(
            tbert.BertForPretraining(cfg, device="cpu"), sd)
