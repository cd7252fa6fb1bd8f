"""The twins of the JAX recipes that import ``bench.py`` (flat and PCAR arms), on the CPU.

``jax.random``'s rows cannot be made in torch, so both packages get the same
numpy rows: :func:`patch_rows` replaces ``bench._make_centers``,
``bench._clustered_chunk``, ``bench._pq_sample`` (and ``bench.N_DOCS_INT8``,
``bench.N_QUERIES``) for the JAX recipes, which import them inside ``main``, and
``bench_data``'s namesakes for the twins. The rows follow ``bench.py``'s
contract (granules of 100,000 keyed by their start, a free-standing block at
a start >= 1e9); sample blocks are cut to :data:`SAMPLE_ROWS` on both sides to
keep the CPU fits short. The JAX serve kernels round their scores (ROADMAP
queue 3), so recall fields are compared within :data:`RECALL_TOL`, and the IVF
arms, which off the TPU may take other paths, are held to bounds.
"""

import json
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from denseretrievaltoolkits_tpu.data.collators import pad_batch as jpad_batch
from denseretrievaltoolkits_tpu.index.transforms import PCATransform as JPCA
from denseretrievaltoolkits_tpu.ops import quant as jquant
from denseretrievaltoolkits_tpu.ops import topk as jtopk
from denseretrievaltoolkits_torch.index.transforms import PCATransform
from denseretrievaltoolkits_torch.ops import quant as tquant
from denseretrievaltoolkits_torch.recipes import bench_data as bd
from denseretrievaltoolkits_torch.recipes import bench_pcar_38m, bench_pcar_sq4, \
    latency_probe, varlen_probe
from recipes import bench_pcar_38m as jax_38m
from recipes import latency_probe as jax_latency

SAMPLE_ROWS = 16384
RECALL_TOL = 0.02
N_COMP = 256


class NumpyRows:
    """The mixture of bench.py:306-362 drawn by numpy: N_COMP centres, each granule
    (or free-standing block) from ``default_rng(start)``; granules are memoized, and
    every call returns a new array."""

    def __init__(self, seed=77):
        self.centers = np.random.default_rng(seed).standard_normal(
            (N_COMP, bd.DIM), dtype=np.float32)
        self._memo = {}

    def _block(self, key, rows):
        if (key, rows) not in self._memo:
            rng = np.random.default_rng(key)
            which = rng.integers(0, N_COMP, rows)
            self._memo[(key, rows)] = (self.centers[which] + bd.IVF_SIGMA * rng.standard_normal(
                (rows, bd.DIM), dtype=np.float32)).astype(np.float32)
        return self._memo[(key, rows)]

    def __call__(self, start, rows):
        if start >= 10**9:
            return self._block(start, min(rows, SAMPLE_ROWS) if start >= 2 * 10**9
                               else rows).copy()
        assert start % bd.GEN_GRANULE == 0, start
        parts, off = [], start
        while off < start + rows:
            n = min(bd.GEN_GRANULE, start + rows - off)
            parts.append(self._block(off, bd.GEN_GRANULE)[:n])
            off += n
        return np.concatenate(parts)


# one mixture for every test of both recipe files: each granule is drawn once a process
ROWS = NumpyRows()


def spectrumed(rows, start, n):
    return rows(start, n) * ((np.arange(bd.DIM) + 1.0) ** -0.35).astype(np.float32)


def patch_rows(monkeypatch, rows, n_docs=200_000, n_queries=32):
    """Both packages' generators, sample and corpus sizes onto ``rows``."""
    lam = ((np.arange(bd.DIM) + 1.0) ** -0.35).astype(np.float32)
    monkeypatch.setattr(bench, "_make_centers", lambda: None)
    monkeypatch.setattr(bench, "_clustered_chunk",
                        lambda centers, start, n: jnp.asarray(rows(start, n)))
    monkeypatch.setattr(bench, "_pq_sample", lambda: rows(2 * 10**9, 262_144) * lam)
    monkeypatch.setattr(bench, "N_DOCS_INT8", n_docs)
    monkeypatch.setattr(bench, "N_QUERIES", n_queries)
    monkeypatch.setattr(bench, "_roundtrip", lambda: 0.0)
    monkeypatch.setattr(bench, "_SPEC_STATE", {})
    monkeypatch.setattr(bd, "make_centers", lambda device="cuda": torch.from_numpy(rows.centers))
    monkeypatch.setattr(bd, "clustered_chunk",
                        lambda centers, start, n: torch.from_numpy(rows(start, n)))
    monkeypatch.setattr(bd, "N_DOCS_INT8", n_docs)
    monkeypatch.setattr(bd, "N_QUERIES", n_queries)
    monkeypatch.setattr(bd, "_SPEC_STATE", {})


def memoized(fn):
    """``fn`` computing once per arguments (arrays and objects by identity): the JAX
    recipes' timing loops repeat a call on the same live arrays, whose output no check
    reads but the first."""
    seen = {}

    def call(*a, **kw):
        k = tuple(x if isinstance(x, (int, float, str, type(None))) else id(x)
                  for x in a) + tuple(sorted(kw.items()))
        if k not in seen:
            seen[k] = fn(*a, **kw)
        return seen[k]
    return call


def _last_json(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _exact_top(q, x, k):
    return np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :k]


def _recall(ids, ref, k):
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, ref)]))


# -- bench_data ------------------------------------------------------------------------------


def test_clustered_chunk_is_chunking_invariant(monkeypatch):
    """Three chunkings of [0, 3 granules) give the same rows (the granule cut to 1,000
    rows here, from 100,000); a free-standing block at 1e9 is the same on every call
    and differs from the corpus rows."""
    monkeypatch.setattr(bd, "GEN_GRANULE", 1000)
    centers = bd.make_centers("cpu")
    whole = bd.clustered_chunk(centers, 0, 3000)
    for cuts in ((0, 1000, 2000, 3000), (0, 2000, 3000)):
        parts = [bd.clustered_chunk(centers, a, b - a) for a, b in zip(cuts, cuts[1:])]
        assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(bd.clustered_chunk(centers, 1000, 500), whole[1000:1500])
    q = bd.clustered_chunk(centers, 10**9, 64)
    assert torch.equal(q, bd.clustered_chunk(centers, 10**9, 64))
    assert q.shape == (64, bd.DIM) and not torch.equal(q, whole[:64])
    # the mixture's scale: rows = centre (N(0, 1)) + 0.5 N(0, 1)
    assert abs(float(whole.std()) - (1 + bd.IVF_SIGMA ** 2) ** 0.5) < 0.02
    with pytest.raises(ValueError, match="multiple of 1000"):
        bd.clustered_chunk(centers, 500, 10)


def test_slab_reference_equals_one_pass(monkeypatch):
    """The slab-streamed reference (two 100,000-row slabs merged on the host) has the
    one-pass reference's top-100 sets, and agrees with the exact fp32 ranking of the
    same rows (int8 rows: ties and near ties aside)."""
    rows = ROWS
    patch_rows(monkeypatch, rows)
    centers = bd.make_centers()
    q = bd.spectrumed_chunk(centers, 10**9, 16)
    _, slabbed = bd.slab_reference(centers, q.to(torch.bfloat16), 200_000, 100_000)
    _, one = bd.slab_reference(centers, q.to(torch.bfloat16), 200_000, 200_000)
    for a, b in zip(slabbed, one):
        assert set(a) == set(b)
    exact = _exact_top(q.numpy(), spectrumed(rows, 0, 200_000), 100)
    assert _recall(slabbed, exact, 100) >= 0.97


# -- varlen_probe ------------------------------------------------------------------------------


def test_varlen_workload_matches_jax_pad_batch():
    """The same numpy sequences (default_rng(0)) padded by the JAX package's
    ``pad_batch``: the same bucket widths and batch counts, and the same padded
    token totals (the ceiling) as the twin's."""
    _, fixed, bucketed, order = varlen_probe.workload(30522)
    rng = np.random.default_rng(0)
    N, B = 16384, 256
    lens = np.clip(np.exp(rng.normal(4.25, 0.55, N)), 16, 156).astype(int)
    seqs = [rng.integers(1, 30522, L).tolist() for L in lens]
    jfixed = [jpad_batch(seqs[i:i + B], 156, 0) for i in range(0, N, B)]
    srt = np.argsort(lens, kind="stable")
    jbuck = [jpad_batch([seqs[i] for i in srt][i:i + B], 156, 0, bucket_step=32)
             for i in range(0, N, B)]
    np.testing.assert_array_equal(order, srt)
    widths = Counter(b["input_ids"].shape[1] for b in bucketed)
    assert widths == Counter(b["input_ids"].shape[1] for b in jbuck)
    assert sum(b["input_ids"].size for b in fixed) == sum(b["input_ids"].size for b in jfixed)
    assert sum(b["input_ids"].size for b in bucketed) == \
        sum(b["input_ids"].size for b in jbuck)
    for ours, theirs in zip(bucketed[::16], jbuck[::16]):
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(ours[key], theirs[key])


def test_varlen_twin_bucketed_reps_match_fixed(capsys):
    """A tiny config (one layer 128 wide, bert-base's vocabulary) in bf16 on 'fused' (K1 /
    K2's plain versions here) over 256 of the workload's passages in batches of 64: the
    bucketed arm's pooled reps equal the padded arm's (cosine >= 0.999); the twin prints
    the JAX file's lines."""
    from denseretrievaltoolkits_torch.models.bert import BertConfig
    from denseretrievaltoolkits_torch.models.biencoder import DRModelForInference, DRModelSpec
    from denseretrievaltoolkits_torch.models.convert import init_params_numpy

    config = BertConfig(hidden_size=128, num_hidden_layers=1, num_attention_heads=2,
                        intermediate_size=256)
    model = DRModelForInference(DRModelSpec(bert_config=config, dtype="bfloat16",
                                            attention="fused"), device="cpu")
    model.load_tower_tree("lm_q", init_params_numpy(config, 0))
    out = varlen_probe.trials(model, *varlen_probe.workload(config.vocab_size, 256, 64)[1:],
                              1, "cpu")
    assert out["min_cosine"] >= 0.999
    assert sum(out["widths"].values()) == 4 and out["tokens_fixed"] == 256 * 156
    text = capsys.readouterr().out
    for prefix in ("# bucket widths -> batch counts:", "# padded tokens: fixed",
                   "# trial 0: fixed"):
        assert prefix in text


# -- latency_probe ------------------------------------------------------------------------------


def test_latency_probe_twin_against_jax(monkeypatch, capsys):
    """Both recipes at 100,000 rows (nlist 16, nprobe 4) on the same rows, at B = 1 and 8
    (the B = 64 arm is the same code; on a CPU the JAX probe mode takes 13 s there):
    the twin prints the JAX line's keys and every batch's three arms; its flat arm (K8
    at J = 4) finds >= 0.95 of the exact top-100 of the 8 queries (49 blocks of 2048
    rows hold about 2 of them each, and J = 4 drops a block's fifth), its IVF arms
    >= 0.8."""
    rows = ROWS
    patch_rows(monkeypatch, rows)
    # both recipes call each search once before timing it: the timing loops make no call
    monkeypatch.setattr(bench, "_p50_latency_ms", lambda fn, rt=None, n=20: 1.0)
    monkeypatch.setattr(bd, "p50_latency_ms", lambda fn, device="cuda", n=20: 1.0)
    for mod in (jax_latency, latency_probe):
        monkeypatch.setattr(mod, "BATCHES", (1, 8))
    for name, value in (("N_DOCS", 100_000), ("NLIST", 16), ("NPROBE", 4)):
        monkeypatch.setattr(jax_latency, name, value)
    monkeypatch.setenv("LAT_DOCS", "100000")
    monkeypatch.setenv("LAT_NLIST", "16")
    monkeypatch.setenv("LAT_NPROBE", "4")
    jax_latency.main()
    (want,) = _last_json(capsys.readouterr().out)
    got = latency_probe.main(["--device", "cpu"])
    (printed,) = _last_json(capsys.readouterr().out)
    assert printed == {k: v for k, v in got.items() if k != "ids"}
    assert sorted(printed) == sorted(want)
    assert {b: sorted(a) for b, a in printed["p50_ms"].items()} == \
        {b: sorted(a) for b, a in want["p50_ms"].items()}
    exact = _exact_top(rows(10**9, 64)[:8], rows(0, 100_000), 100)
    assert _recall(got["ids"]["flat"], exact, 100) >= 0.95
    for arm in ("bulk", "probe"):
        assert _recall(got["ids"][arm], exact, 100) >= 0.8, arm


# -- the PCAR recipes ----------------------------------------------------------------------------


def test_pcar_38m_twin_against_jax(monkeypatch, capsys):
    """Both recipes at 100,000 rows, 16 queries, 50,000-row slabs on the same rows (the
    granule cut to 50,000): the same JSON keys, the PCA's kept variance within 1e-3, and serve / i8q
    recall@100 within RECALL_TOL of the JAX recipe's. The timing loops compute once
    (the JAX serve calls memoized on their packed rows, ``bench_data.best_seconds``
    one call)."""
    rows = ROWS
    patch_rows(monkeypatch, rows)
    monkeypatch.setattr(bd, "GEN_GRANULE", 50_000)
    monkeypatch.setattr(bd, "best_seconds", lambda fn, device="cuda", repeats=3, calls=5:
                        (1.0, fn()))
    for name in ("pallas_topk_serve_sq4", "pallas_topk_serve_sq4_i8q"):
        monkeypatch.setattr(jtopk, name, memoized(getattr(jtopk, name)))
    for name, value in (("N", 100_000), ("NQ", 16), ("SLAB", 50_000)):
        monkeypatch.setattr(jax_38m, name, value)
    monkeypatch.setenv("PCAR38M_DOCS", "100000")
    monkeypatch.setenv("PCAR38M_QUERIES", "16")
    monkeypatch.setenv("PCAR38M_SLAB", "50000")
    jax_38m.main()
    (want,) = _last_json(capsys.readouterr().out)
    got = bench_pcar_38m.main(["--device", "cpu"])
    (printed,) = _last_json(capsys.readouterr().out)
    assert sorted(printed) == sorted(want)
    for arm in ("serve", "i8q"):
        assert sorted(printed[arm]) == sorted(want[arm])
        assert abs(printed[arm]["recall100"] - want[arm]["recall100"]) <= RECALL_TOL, arm
    assert abs(printed["pca_kept_variance"] - want["pca_kept_variance"]) <= 1e-3
    assert (printed["n_docs"], printed["n_queries"], printed["dout"]) == (100_000, 16, 384)
    assert got["ref_ids"].shape == (16, 100)


def test_pcar_sq4_stages_against_jax(monkeypatch):
    """bench_pcar_sq4 runs at import over 8.8M rows in JAX, so its twin's stages are
    held to the JAX package's on 8192 spectrumed rows: the PCA fit (the same kept
    variance, the same projected subspace), K9's codes and scales (scales within
    2e-6, at least 99% of the codes equal), then serve (K11) and i8q (K12 sq4) on
    the same packed rows, at J = 16 on 512-row blocks (8192 rows hold too few
    2048-row blocks for the recipe's J = 4): recall@100 against the int8 reference
    within RECALL_TOL of the JAX kernels'."""
    rows = ROWS
    patch_rows(monkeypatch, rows)
    centers = bd.make_centers()
    x = spectrumed(rows, 0, 8192)
    port = PCATransform(bd.DIM, 384, rotate=True, device="cpu")
    port.train(x)
    ref = JPCA(bd.DIM, 384, rotate=True)
    ref.train(x)
    W, JW = port.matrix, np.asarray(ref.matrix)
    var = lambda m: float(np.sum(np.var(x @ m, axis=0)) / np.sum(np.var(x, axis=0)))  # noqa
    assert abs(var(W) - var(JW)) < 1e-4
    # the same subspace: each projection's rows are the other's up to the rotation
    np.testing.assert_allclose(W @ W.T, JW @ JW.T, atol=2e-4)
    n_pad = 8192
    v4, s4 = bench_pcar_sq4.build_int4(centers, torch.from_numpy(JW), n_pad, chunk=n_pad)
    jv, js = jquant.quantize_int4_device(jnp.asarray(x @ JW))
    # the projected rows come from two products (torch's, numpy's) a few ulps apart, and
    # the JAX scale is absmax x fl(1/7) (tests/test_torch_int4.py)
    np.testing.assert_allclose(s4.numpy(), np.asarray(js), rtol=2e-6)
    assert np.mean(v4.numpy() == np.asarray(jv)) > 0.99
    q = spectrumed(rows, 10**9, 16)
    values, scales = tquant.quantize_int8_device(torch.from_numpy(x))
    ref_ids = bd.serve_topj(torch.from_numpy(q).to(torch.bfloat16), values, scales, 100, 16,
                            2048, n_pad)[1].numpy()
    qt_f = q @ JW
    J, block = 16, 512  # 16 blocks of 8192 rows: 256 slots for the top 100
    got = bd.serve_topj(torch.from_numpy(qt_f).to(torch.bfloat16), v4, s4, 100, J, block,
                        n_pad, int4=True)[1].numpy()
    want = np.asarray(jtopk.pallas_topk_serve_sq4(jnp.asarray(qt_f, jnp.bfloat16), jv, js,
                                                  100, J, block, n_pad, tq=16)[1])
    assert abs(_recall(got, ref_ids, 100) - _recall(want, ref_ids, 100)) <= RECALL_TOL
    qi, qs = tquant.quantize_queries(torch.from_numpy(qt_f))
    got8 = bd.i8q_topj(qi, qs, v4, s4, 100, J, block, n_pad, int4=True)[1].numpy()
    jqi, jqs = jtopk.quantize_queries(jnp.asarray(qt_f))
    want8 = np.asarray(jtopk.pallas_topk_serve_sq4_i8q(jqi, jv, js, jqs, 100, J, block, n_pad,
                                                       tq=16)[1])
    assert abs(_recall(got8, ref_ids, 100) - _recall(want8, ref_ids, 100)) <= RECALL_TOL
    assert _recall(got, ref_ids, 100) >= 0.5
