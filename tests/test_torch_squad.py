"""The port's SQuAD path against the JAX package's: tokenization,
featurization, span post-processing and metrics give identical outputs on
the same inputs; ``BertForQuestionAnswering``'s loss and gradients agree
within ``rtol 1e-5, atol 1e-7`` (fp32) with the weights carried over by
``weights.params_from_numpy``; and a tiny main-path closure (pretrain ->
save -> resume -> fine-tune from that checkpoint) follows the reference's
loss curve within ``rtol 1e-4`` (fp32: the frameworks sum in other orders,
and the differences grow over the 9 steps).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import checkpoint as jck
from deepspeed_tpu import metrics as jmetrics
from deepspeed_tpu import squad as jsquad
from deepspeed_tpu import tokenization as jtok
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.models import BertForQuestionAnswering as JQA
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import checkpoint as tck
from deepspeed_tpu_torch import metrics as tmetrics
from deepspeed_tpu_torch import squad as tsquad
from deepspeed_tpu_torch import tokenization as ttok
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.examples import pretrain_bert, squad_finetune
from deepspeed_tpu_torch.models import BertForPreTraining as TBert
from deepspeed_tpu_torch.models import BertForQuestionAnswering as TQA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, B = 128, 64, 4
TINY = dict(max_seq_len=SEQ, vocab_size=VOCAB, num_layers=2, hidden_size=64,
            num_heads=4)

CONTEXTS = [
    "The Normans were the people who in the 10th and 11th centuries gave "
    "their name to Normandy, a region in France.",
    "Tesla's alternating current induction motor was licensed by "
    "Westinghouse in 1888. The price was not disclosed.",
]
QAS = [(0, "In what country is Normandy located?", "France"),
       (0, "When were the Normans in Normandy?", "10th and 11th centuries"),
       (1, "Who licensed the induction motor?", "Westinghouse"),
       (1, "In what year?", "1888")]


def squad_file(tmp_path):
    paras = []
    for ci, ctx in enumerate(CONTEXTS):
        qas = [{"id": f"q{i}", "question": q,
                "answers": [{"text": a, "answer_start": ctx.index(a)}]}
               for i, (c, q, a) in enumerate(QAS) if c == ci]
        paras.append({"context": ctx, "qas": qas})
    path = tmp_path / "squad.json"
    path.write_text(json.dumps({"data": [{"paragraphs": paras}]}))
    return str(path)


def vocabs():
    texts = CONTEXTS + [q for _, q, _ in QAS]
    return (jtok.train_wordpiece(texts, vocab_size=120),
            ttok.train_wordpiece(texts, vocab_size=120))


def test_wordpiece_vocab_and_tokenization_are_identical():
    jv, tv = vocabs()
    assert tv.id_to_token == jv.id_to_token
    jt, tt = jtok.BertTokenizer(jv), ttok.BertTokenizer(tv)
    for text in CONTEXTS + ["Café déjà-vu, $5~ naïve UNKNOWNWORD!"]:
        assert tt.tokenize_with_offsets(text) == jt.tokenize_with_offsets(
            text)
        assert tt.encode(text) == jt.encode(text)


@pytest.mark.parametrize("seq_len,stride", [(64, 16), (24, 4)])
def test_featurize_and_postprocess_are_identical(tmp_path, seq_len, stride):
    path = squad_file(tmp_path)
    jex, tex = jsquad.load_squad_json(path), tsquad.load_squad_json(path)
    assert [e.__dict__ for e in tex] == [e.__dict__ for e in jex]
    jv, tv = vocabs()
    jf = jsquad.featurize(jex, jtok.BertTokenizer(jv), seq_len,
                          doc_stride=stride, max_query_len=12)
    tf = tsquad.featurize(tex, ttok.BertTokenizer(tv), seq_len,
                          doc_stride=stride, max_query_len=12)
    assert len(tf) == len(jf) and len(tf) >= len(QAS)
    for a, b in zip(tf, jf):
        for k, v in a.__dict__.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b.__dict__[k], err_msg=k)
            else:
                assert v == b.__dict__[k], k
    for x, y in zip(tsquad.batch_features(tf), jsquad.batch_features(jf)):
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(0)
    starts = np.asarray([f.start_position for f in tf])
    ends = np.asarray([f.end_position for f in tf])
    noisy_s = np.where(rng.random(len(tf)) < 0.3, 0, starts)
    scores = rng.normal(size=len(tf)).astype(np.float32)
    for s, e, sc in ((starts, ends, None), (noisy_s, ends, scores)):
        tp = tsquad.postprocess(tex, tf, s, e, sc)
        assert tp == jsquad.postprocess(jex, jf, s, e, sc)
        assert (tsquad.evaluate_predictions(tex, tp)
                == jsquad.evaluate_predictions(jex, tp))
    if seq_len == 64:        # every answer fits one window whole
        gold = tsquad.postprocess(tex, tf, starts, ends)
        assert tsquad.evaluate_predictions(tex, gold)["exact_match"] == 100.0


@pytest.mark.parametrize("max_answer_len", [30, 3])
def test_best_spans_and_span_metrics_are_identical(max_answer_len):
    rng = np.random.default_rng(1)
    sl = rng.normal(size=(6, 40)).astype(np.float32)
    el = rng.normal(size=(6, 40)).astype(np.float32)
    el[2] = sl[2]                                       # ties
    mask = np.ones((6, 40), np.int32)
    mask[1, 20:] = 0
    js, je = jmetrics.best_spans(sl, el, mask, max_answer_len)
    ts, te = tmetrics.best_spans(torch.tensor(sl), torch.tensor(el), mask,
                                 max_answer_len)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(te, je)
    gs, ge = rng.integers(0, 20, 6), rng.integers(20, 40, 6)
    assert (tmetrics.evaluate_spans(ts, te, gs, ge)
            == jmetrics.evaluate_spans(js, je, gs, ge))
    for p, g in (("The Cat!", "cat"), ("a b c", "b c d"), ("", "x")):
        assert tmetrics.text_f1(p, g) == jmetrics.text_f1(p, g)
        assert (tmetrics.text_exact_match(p, g)
                == jmetrics.text_exact_match(p, g))


def qa_batch(seed=0):
    return squad_finetune.synthetic_batch(np.random.default_rng(seed), B,
                                          SEQ, VOCAB)


def test_qa_loss_and_every_grad_match_jax():
    jm = JQA.from_size("tiny", **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    b = list(qa_batch())
    b[1] = b[1].copy()
    b[1][2, SEQ - 10:] = 0                    # a padded row
    specs = jm.partition_specs(params)
    fn = jax.jit(jax.shard_map(
        lambda p, *x: jax.value_and_grad(lambda q: jm.apply(q, *x))(p),
        mesh=make_mesh(devices=jax.devices()[:1]),
        in_specs=(specs,) + tuple(P() for _ in b), out_specs=(P(), specs),
        check_vma=False))
    jl, jg = fn(params, *b)
    tm = TQA.from_size("tiny", **TINY)
    weights.params_from_numpy(tm, params)
    loss = tm(*(torch.from_numpy(x) for x in b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jg = weights.flatten_tree(jax.tree_util.tree_map(np.asarray, jg))
    tg = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = jmetrics.make_span_predictor(jm, params)(*b[:3])
    for got, w in zip(tmetrics.make_span_predictor(tm)(*b[:3]), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------ closure

PRE_STEPS, RESUME_STEPS, FT_STEPS, MICRO, GAS = 2, 2, 3, 2, 2


def mlm_data(n):
    rng = np.random.default_rng(0)
    return [tuple(pretrain_bert.mlm_batch(rng, MICRO * GAS, VOCAB, SEQ))
            + (rng.integers(0, 2, MICRO * GAS).astype(np.int32),)
            for _ in range(n)]


def ds_config(opt, lr):
    return {"train_batch_size": MICRO * GAS,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": opt, "params": {"lr": lr, "eps": 1e-6}},
            "steps_per_print": 10 ** 9}


def closure_jax(d, pre_params, qa_params, data, ft_data):
    mesh = make_mesh(devices=jax.devices()[:1])
    cfg = ds_config("Lamb", 1e-3)
    mk = lambda p: deepspeed_tpu.initialize(
        config=cfg, model=JBert.from_size("tiny", use_nsp=True, **TINY),
        model_parameters=p, mesh=mesh)[0]
    e = mk(pre_params)
    losses = [float(e.train_batch(b)) for b in data[:PRE_STEPS]]
    e.save_checkpoint(d)
    e = mk(jax.tree_util.tree_map(np.zeros_like, pre_params))
    e.load_checkpoint(d)
    losses += [float(e.train_batch(b)) for b in data[PRE_STEPS:]]
    e.save_checkpoint(d, tag="final")
    qa, _, _, _ = deepspeed_tpu.initialize(
        config=ds_config("Adam", 3e-5), model=JQA.from_size("tiny", **TINY),
        model_parameters=qa_params, mesh=mesh)
    loaded, _ = jck.init_from_module_tree(
        qa, jck.load_module_tree(d, tag="final"))
    losses += [float(qa.train_batch(b)) for b in ft_data]
    return losses, loaded


def closure_torch(d, pre_params, qa_params, data, ft_data):
    cfg = ds_config("Lamb", 1e-3)
    mk = lambda p: deepspeed_tpu_torch.initialize(
        config=cfg, model=TBert.from_size("tiny", use_nsp=True, **TINY),
        model_parameters=p, device="cpu")[0]
    e = mk(pre_params)
    losses = [float(e.train_batch(b)) for b in data[:PRE_STEPS]]
    e.save_checkpoint(d)
    e = mk(None)                                   # another init
    e.load_checkpoint(d)
    losses += [float(e.train_batch(b)) for b in data[PRE_STEPS:]]
    e.save_checkpoint(d, tag="final")
    qa, _, _, _ = deepspeed_tpu_torch.initialize(
        config=ds_config("Adam", 3e-5), model=TQA.from_size("tiny", **TINY),
        model_parameters=qa_params, device="cpu")
    loaded, _ = tck.init_from_module_tree(
        qa, tck.load_module_tree(d, tag="final"))
    losses += [float(qa.train_batch(b)) for b in ft_data]
    return losses, loaded


def test_tiny_closure_follows_the_reference(tmp_path):
    pre = jax.tree_util.tree_map(np.asarray, JBert.from_size(
        "tiny", use_nsp=True, **TINY).init_params(jax.random.PRNGKey(0)))
    pre["nsp_w"] = np.random.default_rng(2).normal(
        size=pre["nsp_w"].shape).astype(np.float32) * 0.02
    qa = jax.tree_util.tree_map(np.asarray, JQA.from_size(
        "tiny", **TINY).init_params(jax.random.PRNGKey(1)))
    data = mlm_data(PRE_STEPS + RESUME_STEPS)
    rng = np.random.default_rng(3)
    ft = [squad_finetune.synthetic_batch(rng, MICRO * GAS, SEQ, VOCAB)
          for _ in range(FT_STEPS)]
    jl, jloaded = closure_jax(str(tmp_path / "j"), pre, qa, data, ft)
    tl, tloaded = closure_torch(str(tmp_path / "t"), pre, qa, data, ft)
    assert sorted(tloaded) == sorted(jloaded)
    assert len(tloaded) == 17                  # the whole backbone
    assert len(tl) == PRE_STEPS + RESUME_STEPS + FT_STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_example_drivers_hand_off_a_checkpoint(tmp_path, capsys):
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps(dict(ds_config("Lamb", 1e-3),
                                   bf16={"enabled": True})))
    d = str(tmp_path / "ck")
    final = pretrain_bert.main(["--deepspeed_config", str(cfg), "--steps",
                                "2", "--device", "cpu",
                                "--save-checkpoint", d])
    assert np.isfinite(final)
    assert os.path.exists(tck.model_file(d, "pretrain"))
    losses, result = squad_finetune.main(
        ["--deepspeed_config", str(cfg), "--steps", "2", "--device", "cpu",
         "--init-checkpoint", d])
    out = capsys.readouterr().out
    assert "transferred 16 leaves" in out       # all but wte (vocab 512)
    assert "bert_squad_progress: step=1" in out
    assert np.isfinite(losses).all() and result["total"] == 128
