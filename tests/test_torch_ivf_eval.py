"""The torch port's evaluation into trained factory indexes vs the JAX package, on the CPU.

``Trainer.evaluate`` with ``index_factory`` "IVF8,SQ8", "IVFR8,SQ8" and
"PCAR16,Flat": both Trainers encode the corpus (48 passages, the tiny BERT
of ``tests/test_torch_eval.py``, same weights), spill it to the memmap,
train the index on it (k-means or PCA from the same seed), build it
through ``add_chunks`` in 16-row chunks and search. With nprobe = nlist
every cell is probed and no probe pair drops, so the bulk search returns the
exact top-10 of its cells' scoring: metrics within 1e-6 and the dumps row
for row, docids equal except at scores that tie: within 1e-5 relative for
fp32 sums in another order, and within two quanta of the TPU selection,
which rounds a score to 2^id_bits ulps (id_bits 4 for the 16-row cells of
IVF8, 9 for IVFR8's 512-row blocks: 2^-14 relative), where the port's
scores are exact.
"""

import os
import pickle

import numpy as np
import pytest

from denseretrievaltoolkits_tpu.evaluator import retrieval as jretrieval
from denseretrievaltoolkits_tpu.index.io import load_index as jax_load_index
from denseretrievaltoolkits_torch.evaluator import retrieval as tretrieval
from denseretrievaltoolkits_torch.index import ivf, transforms

from test_torch_eval import _assert_same_evaluation, _pair, data  # noqa: F401 (fixture)

CASES = [("IVF8,SQ8", "bulk", ivf.IVFFlatIndex, 21), ("IVF8,SQ8", "i8q", ivf.IVFFlatIndex, 21),
         ("IVFR8,SQ8", "bulk", ivf.IVFRaggedIndex, 22),
         ("IVF8,Flat", "probe", ivf.IVFFlatIndex, 23),
         ("PCAR16,Flat", "exact", transforms.TransformedIndex, 24)]
# the relative tie of a case: two quanta of the TPU selection's rounding where
# the JAX side searches on its packed selection, else fp32 summation order
REL = {"IVFR8,SQ8": 2 * 2.0 ** (9 - 23), "IVF8,SQ8": 2 * 2.0 ** (4 - 23)}


@pytest.fixture(scope="module")
def trainers(data):  # noqa: F811
    return _pair(data, "trained", nprobe=8)


@pytest.mark.parametrize("factory,mode,cls,ep", CASES, ids=[f"{f}-{m}" for f, m, _, _ in CASES])
def test_evaluate_trained_factory_matches_jax(trainers, factory, mode, cls, ep):
    """Both Trainers evaluate into the factory string's index (i8q reuses the
    epoch's IVF index, as the reference does)."""
    jtrainer, ttrainer = trainers
    for trainer in trainers:
        trainer.training_args.index_factory = factory
        trainer.training_args.search_mode = mode
    want = jtrainer.evaluate(jtrainer.eval_loader, ep)
    got = ttrainer.evaluate(ttrainer.eval_loader, ep)
    assert type(ttrainer.index) is cls and type(jtrainer.index).__name__ == cls.__name__
    assert ttrainer.index.is_trained and len(ttrainer.index) == 48
    assert got.keys() == want.keys()
    _assert_same_evaluation(jtrainer.training_args, ttrainer.training_args, ep,
                            rel=max(1e-5, REL.get(factory, 0)))
    assert ttrainer.idx == jtrainer.idx


def test_spill_removed_without_artifacts_and_index_built(data):  # noqa: F811
    """``save_corpus_artifacts=False``: the encoded corpus still spills to the
    memmap for the trained build, which is removed after; nothing is saved."""
    _, ttrainer = _pair(data, "nosave", nprobe=8, index_factory="IVFR8,SQ8",
                        save_corpus_artifacts=False, search_mode="bulk")
    args = ttrainer.training_args
    m = ttrainer.evaluate(ttrainer.eval_loader, 1)
    assert m["query_num"] == 8 and len(ttrainer.index) == 48
    assert not os.path.exists(os.path.join(args.encode_corpus_dir, "1.0.npy"))
    assert not os.path.exists(args.index_file + "1.meta.json")
    rows = ttrainer.index._row_ids.numpy()
    assert sorted(rows[rows >= 0].tolist()) == list(range(48))


def test_load_index_and_retrieval_cli_serve_the_saved_ivf_index(trainers, tmp_path):
    """The evaluation's saved IVF index reloads through ``_load_index`` bit for
    bit and searches alike; the JAX package loads it too; the retrieval CLI
    (``run(index_path=..., search_mode="bulk")``) ranks as JAX's run."""
    jtrainer, ttrainer = trainers
    args = ttrainer.training_args
    args.index_factory, args.search_mode = "IVF8,SQ8", "bulk"
    ttrainer.evaluate(ttrainer.eval_loader, 25)
    before = ttrainer.index
    q = np.random.default_rng(5).normal(size=(6, 32)).astype(np.float32)
    s0, i0 = before.search(q, 10)
    ttrainer._load_index(25)
    after = ttrainer.index
    assert type(after) is ivf.IVFFlatIndex and after.docid == ttrainer.idx
    for name in ("centroids", "_values", "_row_ids", "_scales"):
        np.testing.assert_array_equal(getattr(after, name).numpy(), getattr(before, name).numpy())
    s1, i1 = after.search(q, 10)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(s1, s0)
    jidx = jax_load_index(args.index_file + "25")
    np.testing.assert_array_equal(np.asarray(jidx._row_ids), after._row_ids.numpy())
    with open(tmp_path / "q.pkl", "wb") as fh:
        pickle.dump((q, [f"q{i}" for i in range(6)]), fh)
    got_s, got_d = tretrieval.run(str(tmp_path / "q.pkl"), save_ranking_to=str(tmp_path / "t.pkl"),
                                  depth=10, batch_size=4, search_mode="bulk",
                                  index_path=args.index_file + "25", device="cpu")
    want_s, want_d = jretrieval.run(str(tmp_path / "q.pkl"),
                                    save_ranking_to=str(tmp_path / "j.pkl"), depth=10,
                                    batch_size=4, search_mode="bulk",
                                    index_path=args.index_file + "25")
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    for a, b, sa in zip(np.asarray(got_d), np.asarray(want_d), np.asarray(want_s)):
        differ = a != b
        # a swap only between two scores that tie within 1e-5
        assert not differ.any() or np.ptp(sa[differ]) <= 1e-5 * max(1.0, np.abs(sa).max())
