"""The torch port's retrieval evaluation vs the JAX package, on the CPU.

- ``evaluator/nq_eval.py``: the port's tokenizer reads Unicode categories
  where the reference uses the ``regex`` package; hypothesis holds its tokens,
  ``has_answers`` and ``regex_match`` to the reference's over unicode text
  (mixed scripts, combining marks, digits, punctuation, controls, spaces).
  Code points that Python's Unicode database leaves unassigned (``Cn``) are
  left out: the ``regex`` package carries a newer database, which assigns
  some of them; a test over every code point pins that these are the only
  ones the two classify differently.
- ``Trainer.evaluate``: a tiny BERT dual encoder with the same weights in
  both packages (the port's weights reach JAX through ``params_to_jax``) on
  ``helpers.make_exactmatch_dataset``; both Trainers encode the corpus into
  their index in slabs, search, label with ``AnswerMatcher`` and write the
  metrics json and the retrieval dump. Metrics must agree within 1e-6 and the
  dumps row for row, docids equal except where their scores tie (within
  1e-5 relative: fp32 sums in another order, and after an epoch of training
  the two trajectories' rounding; readings up to 3.4e-6). The JAX side runs
  its Pallas kernels in interpret mode; on the CPU every search mode runs the
  exact scan in both.
"""

import json
import os
import random
import unicodedata

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from denseretrievaltoolkits_tpu import config as jconfig
from denseretrievaltoolkits_tpu.data import loaders as jloaders
from denseretrievaltoolkits_tpu.data.datasets import CorpusDataset, ExactMatchDataset
from denseretrievaltoolkits_tpu.data.samplers import RandomSampleNegatives
from denseretrievaltoolkits_tpu.evaluator import nq_eval as jnq
from denseretrievaltoolkits_tpu.index.io import load_index as jax_load_index
from denseretrievaltoolkits_tpu.models import bert as jbert
from denseretrievaltoolkits_tpu.models import biencoder as jbi
from denseretrievaltoolkits_tpu.train.trainer import Trainer as JaxTrainer
from denseretrievaltoolkits_torch import config as tconfig
from denseretrievaltoolkits_torch.data import loaders as tloaders
from denseretrievaltoolkits_torch.evaluator import nq_eval as tnq
from denseretrievaltoolkits_torch.models import bert as tbert
from denseretrievaltoolkits_torch.models import biencoder as tbi
from denseretrievaltoolkits_torch.models.convert import params_to_jax
from denseretrievaltoolkits_torch.train.trainer import Trainer

from helpers import make_exactmatch_dataset, make_tokenizer

# --- nq_eval ----------------------------------------------------------------------------------

# characters each class of the tokenizer must handle: letters of several
# scripts, combining marks (Mn, Mc, Me), digits and other numbers, punctuation
# and symbols, controls and format characters, and every kind of space
SPECIAL = list("aZ\u00e9\u00df\u0414\u0436\u03a9\u03c0\u4e2d\u6587\ud55c\uae00"  # scripts
               "\u0639\u0631\u05d4\u05e2\u0905\u0928\u0941"  # Arabic, Hebrew, Devanagari
               "\u0301\u0308\u0903\u20dd"  # combining marks: Mn, Mn, Mc, Me
               "0179\u0663\u096a\u00bd\u2163\u00b2"  # digits, other numbers
               ".,;:!?'\"()[]-_/@#$%&*+=<>\u20ac\u00a3\u00a9\u2122\U0001f600"  # P*, S*
               "\x00\x07\t\n\r\x0b\x0c\x1f\x7f\u00ad\u200b\u200d\u2060\ufeff"  # Cc, Cf
               " \u00a0\u1680\u2002\u2009\u2028\u2029\u3000")  # Zs, Zl, Zp
CHARS = st.one_of(st.sampled_from(SPECIAL),
                  st.characters(exclude_categories=("Cn", "Cs")))
TEXT = st.text(alphabet=CHARS, max_size=40)
HYPOTHESIS = settings(max_examples=300, deadline=None, database=None)


@HYPOTHESIS
@given(TEXT)
def test_tokenizer_matches_reference(text):
    want, got = jnq.SimpleTokenizer().tokenize(text), tnq.SimpleTokenizer().tokenize(text)
    assert got.words() == want.words()
    assert got.words(uncased=True) == want.words(uncased=True)
    nfd = unicodedata.normalize("NFD", text)
    assert tnq._words_of(text, tnq.SimpleTokenizer()) == \
        jnq._words_of(nfd, jnq.SimpleTokenizer())
    assert len(got) == len(want) and got.slice(1, 3).words() == want.slice(1, 3).words()


def test_tokenizer_classes_agree_on_every_assigned_code_point():
    """Each code point alone: a word character, a single-character token or
    skipped, by the reference's pattern and by the port's categories. They
    differ only where Python's database has no category (``Cn``) and the
    ``regex`` package's newer one assigns a letter or mark."""
    pattern = jnq.SimpleTokenizer()._regexp
    classes = {None: tnq._SKIP}
    differ = []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates are no characters
            continue
        ch = chr(cp)
        m = pattern.fullmatch(ch)
        want = classes[None] if m is None else (tnq._WORD if m.group(1) else tnq._SINGLE)
        if tnq._char_class(ch) != want:
            differ.append(ch)
    assert {unicodedata.category(ch) for ch in differ} <= {"Cn"}


@HYPOTHESIS
@given(TEXT, st.lists(TEXT, min_size=1, max_size=3), st.integers(0, 10), st.integers(1, 3))
def test_has_answers_and_regex_match_match_reference(text, answers, start, n):
    """Answers drawn at random and cut from the text's own tokens (so some
    match); the token and the regex criteria, and ``AnswerMatcher``."""
    words = jnq.SimpleTokenizer().tokenize(text).words()
    answers = answers + [" ".join(words[start:start + n])]
    for regex in (False, True):
        assert tnq.has_answers(text, answers, regex=regex) == \
            jnq.has_answers(text, answers, regex=regex)
    assert tnq.AnswerMatcher().match("d", text, answers) == \
        jnq.AnswerMatcher().match("d", text, answers)
    for pattern in answers:
        assert tnq.regex_match(text, pattern) == jnq.regex_match(text, pattern)


def test_evaluate_retrieval_matches_reference(tmp_path):
    retrieval = {
        "q1": {"answers": ["Paris"], "contexts": [{"text": "France\ncapital is Rome"},
                                                  {"text": "t\nparis, the city"}]},
        "q2": {"answers": ["Zürich"], "contexts": [{"has_answer": False},
                                                   {"has_answer": True}]},
        "q3": {"answers": ["Ω-7"], "contexts": [{"text": "only\nω - 7 here"}]},
    }
    path = tmp_path / "retrieval.json"
    path.write_text(json.dumps(retrieval))
    for regex in (False, True):
        assert tnq.evaluate_retrieval(str(path), [1, 2], regex) == \
            jnq.evaluate_retrieval(str(path), [1, 2], regex)


# --- Trainer.evaluate, end to end ----------------------------------------------------------------


def _args(module, tmp, name, **kw):
    base = dict(output_dir=str(tmp / name / "out"), cache_train_dir=str(tmp / name / "cache"),
                train_batch_size=4, eval_batch_size=4, corpus_batch_size=8, max_epochs=1,
                eval_per_train=1, save_per_train=1, learning_rate=1e-3, optimizer="adamw",
                topk="1,5,10", retrieve_num=10, log_every=0, index_slab_rows=16)
    base.update(kw)
    return module.TrainingArguments(**base)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Tokenizer, the synthetic NQ-style splits (48 corpus passages) and the
    tiny BERT config, shared by both packages' loaders."""
    tmp = tmp_path_factory.mktemp("eval")
    tokenizer = make_tokenizer(tmp)
    data_dir, corpus_path, _, _ = make_exactmatch_dataset(tmp, random.Random(0), n_train=16,
                                                          n_eval=8, n_corpus=48, n_neg=4)
    kw = dict(data_dir=data_dir, corpus_path=corpus_path, train_n_passages=2, q_max_len=16,
              p_max_len=24, data_cache_dir=str(tmp / "hfcache"))
    jdata, tdata = jconfig.DataArguments(**kw), tconfig.DataArguments(**kw)
    dataset = ExactMatchDataset(jdata, tokenizer)
    corpus = CorpusDataset(jdata, tokenizer)
    cfg = dict(vocab_size=tokenizer.vocab_size, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64, max_position_embeddings=48)
    return tmp, tokenizer, jdata, tdata, dataset, corpus, cfg


def _pair(data, name, **kw):
    """A JAX Trainer and a port Trainer over the same weights and data."""
    tmp, tokenizer, jdata, tdata, dataset, corpus, cfg = data
    port = tbi.DRModel.build(tconfig.ModelArguments(), bert_config=tbert.BertConfig(**cfg),
                             seed=11, device="cpu")
    # BERT's init (std 0.02) gives random-weight CLS reps that score every
    # passage within ~1e-5 of each other, a ranking of fp32 ties; seeded noise
    # of std 0.3 on every weight spreads the scores over several units
    rng = np.random.default_rng(12)
    with torch.no_grad():
        for prm in port.parameters():
            prm.add_(torch.from_numpy(0.3 * rng.standard_normal(prm.shape).astype(np.float32)))
    jmodel = jbi.DRModel(jbi.DRModelSpec(bert_config=jbert.BertConfig(**cfg)))
    jparams = jax.tree.map(jnp.asarray, {"lm_q": params_to_jax(port.lm_q.state_dict())})
    pairs = []
    for loaders, args, dargs in ((jloaders, jconfig, jdata), (tloaders, tconfig, tdata)):
        factory = loaders.ExactMatchDataloader(dargs, dataset, tokenizer,
                                               RandomSampleNegatives(jdata, seed=0),
                                               batch_size=[4, 4, 4])
        train, ev, test = factory.get_dataloader()
        corpus_dl = loaders.CorpusDataloader(dargs, corpus, tokenizer,
                                             batch_size=8).get_dataloader()
        pairs.append(dict(args=_args(args, tmp, f"{name}-{args.__name__.split('.')[0]}", **kw),
                          train=train, eval=ev, test=test, corpus=corpus_dl))
    j, t = pairs
    jtrainer = JaxTrainer(j["args"], jmodel, jparams, corpus_dataloader=j["corpus"],
                          train_loader=j["train"], eval_loader=j["eval"], test_loader=j["test"])
    ttrainer = Trainer(t["args"], port, corpus_dataloader=t["corpus"], train_loader=t["train"],
                       eval_loader=t["eval"], test_loader=t["test"])
    return jtrainer, ttrainer


@pytest.fixture(scope="module")
def trainers(data):
    return _pair(data, "evaluate")


def _dump(args, ep):
    with open(os.path.join(args.retrieve_dir, f"{ep}.0.json")) as fh:
        return [json.loads(line) for line in fh]


def _metrics(args, ep):
    with open(os.path.join(args.cache_train_dir, f"{ep}.0_metrics")) as fh:
        return json.load(fh)


def _assert_same_evaluation(jargs, targs, ep):
    """Metrics within 1e-6; the dumps row for row: the same queries, answers
    and texts, docids equal except where the two scores tie."""
    want, got = _metrics(jargs, ep), _metrics(targs, ep)
    assert want.keys() == got.keys() and want["query_num"] == got["query_num"] == 8
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    jd, td = _dump(jargs, ep), _dump(targs, ep)
    assert len(jd) == len(td) == 8 * 10

    def tie(x, y):
        return abs(x - y) <= 1e-5 * max(1.0, abs(x))

    for rank, (a, b) in enumerate(zip(jd, td)):
        assert (a["query_id"], a["query"], a["answers"]) == (b["query_id"], b["query"],
                                                              b["answers"])
        assert tie(a["score"], b["score"])
        if a["doc_id"] == b["doc_id"]:
            assert a["document"] == b["document"]
            continue
        # a tie: JAX ranks the port's doc elsewhere in this list with a tied
        # score, or the two tie at the k-th place and each keeps its own
        twins = [r for r in jd if r["query_id"] == a["query_id"] and r["doc_id"] == b["doc_id"]]
        assert (twins and tie(twins[0]["score"], b["score"])) or rank % 10 == 9, (a, b)


EVAL_CASES = [("float32", "exact", 11), ("int8", "exact", 12), ("int4", "exact", 13),
              ("int4", "serve", 13), ("int4", "i8q", 13)]


@pytest.mark.parametrize("dtype,mode,ep", EVAL_CASES, ids=[f"{d}-{m}" for d, m, _ in EVAL_CASES])
def test_evaluate_matches_jax(trainers, dtype, mode, ep):
    """Both Trainers evaluate the eval split at ``index_dtype`` / ``search_mode``
    (int4 serve and i8q reuse the int4 index of the same epoch, as the
    reference does); the corpus goes into the index in three 16-row slabs."""
    jtrainer, ttrainer = trainers
    for trainer in trainers:
        trainer.training_args.index_dtype = dtype
        trainer.training_args.search_mode = mode
    want = jtrainer.evaluate(jtrainer.eval_loader, ep)
    got = ttrainer.evaluate(ttrainer.eval_loader, ep)
    assert ttrainer.index.dtype == dtype and len(ttrainer.index._device_slabs) == 3
    assert got.keys() == want.keys()
    _assert_same_evaluation(jtrainer.training_args, ttrainer.training_args, ep)
    assert os.path.exists(os.path.join(ttrainer.training_args.encode_corpus_dir, f"{ep}.0.npy"))
    assert ttrainer.idx == jtrainer.idx and len(ttrainer.idx) == 48


def test_load_index_after_index_corpus(trainers):
    """The saved int4 index reloads bit for bit through ``_load_index``, in
    the port and in the JAX package, with its docid order."""
    _, ttrainer = trainers
    args = ttrainer.training_args
    args.index_dtype, args.search_mode = "int4", "exact"
    ttrainer.evaluate(ttrainer.eval_loader, 14)
    values, scales = ttrainer.index._native_int8_payload()
    q = np.random.default_rng(5).normal(size=(3, 32)).astype(np.float32)
    before = ttrainer.index.search(q, 10)
    idx = list(ttrainer.idx)
    ttrainer._load_index(14)
    assert ttrainer.idx == idx and ttrainer.index.docid == idx and ttrainer.index.dtype == "int4"
    back_v, back_s = ttrainer.index._native_int8_payload()
    np.testing.assert_array_equal(back_v, values)
    np.testing.assert_array_equal(back_s, scales)
    for a, b in zip(ttrainer.index.search(q, 10), before):
        np.testing.assert_array_equal(a, b)
    jidx = jax_load_index(args.index_file + "14")
    np.testing.assert_array_equal(jidx._native_int8_payload()[0], values)
    assert jidx.docid == idx


def test_train_with_eval_and_test_loaders_matches_jax(data):
    """``Trainer.train`` for one epoch with ``eval_per_train=1`` and a
    ``test_loader`` (int4 index, exact): both packages write the epoch-1 and
    the final (-1) metrics and dumps, and they agree."""
    jtrainer, ttrainer = _pair(data, "train", index_dtype="int4")
    jtrainer.train()
    ttrainer.train()
    for ep in (1, -1):
        _assert_same_evaluation(jtrainer.training_args, ttrainer.training_args, ep)
    assert ttrainer.step == 4
    assert os.path.isdir(os.path.join(ttrainer.training_args.cache_train_dir, "result1"))
    with open(os.path.join(ttrainer.training_args.index_order_dir, "1.docid.txt")) as fh:
        assert json.load(fh)["id"] == ttrainer.idx


def test_evaluate_docid_labels_and_sentinel_rows(trainers):
    """``label_kind="docids"`` labels a hit by docid membership, and -1 rows
    (fewer finite candidates than k) count as misses and are not dumped."""
    _, ttrainer = trainers
    real = ttrainer.index

    class Sentinel:
        docid = real.docid
        dtype = real.dtype
        _device_slabs = real._device_slabs

        def __len__(self):
            return len(real)

        def search(self, q, k, mode="exact"):
            s, i = real.search(q, k, mode="exact")
            s, i = np.array(s), np.array(i)
            i[:, -2:] = -1
            return s, i

    try:
        ttrainer.index, ttrainer._indexed_ep = Sentinel(), 99
        m = ttrainer.evaluate(ttrainer.eval_loader, 99)
        assert m["query_num"] == 8 and len(_dump(ttrainer.training_args, 99)) == 8 * 8
        ttrainer.label_kind = "docids"
        m = ttrainer.evaluate(ttrainer.eval_loader, 99)  # answer strings are no docids: no hits
        assert m["Recall@10"] == 0.0
    finally:
        ttrainer.index, ttrainer.label_kind = real, "answers"
