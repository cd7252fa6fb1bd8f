"""Batch retrieval: requests of queries through the query tower, then an exact top-k
over a device-resident int8 index, results on the host.

Set-up draws ``pool_requests`` requests of ``queries_per_request`` tokenized queries from
the seed as host arrays, makes the corpus on the device from the seed, slab by slab from
the clustered mixture (``harness.traffic.mixture_slab``), and adds each slab to the
port's ``FlatIPIndex`` through ``add_device`` (quantized on arrival); then serves two
requests to warm up. With the mixture's ``away_from_query_mean``, every row is made
orthogonal to the mean direction of the float32 reference's reps of the first request's
queries: random-weight towers give reps that share most of their length, and without
this every query of a request would look for the same rows. The window is a closed loop
of one caller: each step serves the next request of the pool (the query tower's
``encode_query``, then ``FlatIPIndex.search`` in ``mode`` for the top ``k``, scores and
ids back on the host) and times it from the call to the results on the host.
``search_queries_per_s`` counts the window's queries over its seconds; ``search_p95_ms``
is the 95th percentile of every request's latency.

The check takes ``check_requests`` requests of those served, drawn from the seed. It
compares the query tower's reps with the float32 reference's (``query_rep_err``), and
judges the returned top-k by the reference's exact search over the same rows, quantized
again by the reference from the float32 rows made again slab by slab, and scored with the
port's query reps (``search_id_gap``, ``search_score_err``: ``harness.compare.topk_gaps``).
The search is judged from the port's reps, so that the tower's rounding does not blur
it; the tower is judged by itself. The control: the query tower's reference in fp8, and
the port's own lower-precision search (``i8q``: the queries quantized to int8) on the
same reps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, refs
from harness.port import dual_encoder
from harness.traffic import (away_from, lengths, mixture_centres, mixture_slab, numpy_rng,
                             slab_sizes, token_batch)
from reference.precision import CASTS, strict_fp32
from reference.search import ExactTopK


class Driver:
    unit_span = "request"
    control_variants = ("control",)

    def __init__(self, run):
        from denseretrievaltoolkits_torch.index.flat import FlatIPIndex
        from denseretrievaltoolkits_torch.ops.topk import certified_topk

        self.run, self.certified_topk = run, certified_topk
        tr, cfg = run.traffic, run.config
        self.k, self.mode = tr["k"], tr["mode"]
        self.model, weights = dual_encoder(run, serving=True)
        del weights
        run.mark("model")
        dim = cfg.get("hidden_size", cfg.get("d_model"))
        rng = numpy_rng(run.seed, "queries")
        self.requests = []
        for _ in range(tr["pool_requests"]):
            lens = lengths(rng, tr["queries_per_request"], tr["query_len"])
            self.requests.append((token_batch(rng, lens, cfg["dual_encoder"]["q_max_len"],
                                              cfg["assumed"]["token_ids"]), lens))
        run.mark("queries")
        mix = tr["mixture"]
        self.away = self._query_mean() if mix.get("away_from_query_mean") else None
        self.index = FlatIPIndex(dim, dtype=tr["index_dtype"], device=run.device)
        centres = mixture_centres(run.seed, mix["components"], dim, run.device)
        for i, rows in slab_sizes(tr["corpus_rows"], tr["slab_rows"]):
            self.index.add_device(self._slab(centres, i, rows))
        del centres
        run.mark("index")
        for r in range(2):
            self._serve(self.requests[r][0])
        self.served = {}  # pool index -> (q reps on the device, scores, ids) of its last serve
        self.latency = []
        self.n = 0
        run.counters.update(units=0, queries=0, query_lengths=[],
                            escalated=None if self._escalated() is None else 0)

    def _escalated(self):
        """The port's count of queries its certificate sent to a second pass (None where
        the port keeps no such count)."""
        return getattr(self.certified_topk, "escalated_queries", None)

    def _query_mean(self) -> torch.Tensor:
        """The unit mean direction of the float32 reference's reps of the first request's
        queries (the benchmark's own data: the port's reps take no part)."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        try:
            mean = refs.reps(self.run, self.requests[0][0], CASTS["exact"]).mean(dim=0)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
            torch.set_float32_matmul_precision(flags[2])
        return mean / mean.norm()

    def _slab(self, centres, index: int, rows: int) -> torch.Tensor:
        """Slab ``index`` of the corpus, fp32 on the device, as set-up made it."""
        sigma = self.run.traffic["mixture"]["sigma"]
        x = mixture_slab(centres, self.run.seed, index, rows, sigma)
        return x if self.away is None else away_from(x, self.away)

    def _serve(self, batch):
        with self.run.span("encode_query"):
            q = self.model.encode_query(batch)
        with self.run.span("search"):
            scores, ids = self.index.search(q, self.k, mode=self.mode)
        return q, scores, ids

    def step(self) -> None:
        i = self.n % len(self.requests)
        batch, lens = self.requests[i]
        before = self._escalated()
        t0 = time.perf_counter()
        self.served[i] = self._serve(batch)
        self.latency.append(time.perf_counter() - t0)
        self.n += 1
        c = self.run.counters
        if before is not None:
            c["escalated"] += self._escalated() - before
        c["units"] += 1
        c["queries"] += len(lens)
        c["query_lengths"].append(lens)

    def finish(self) -> None:
        pass  # every request's results are on the host already

    def end_to_end(self, window_s: float):
        return {"search_queries_per_s": self.run.counters["queries"] / window_s,
                "search_p95_ms": float(np.percentile(self.latency, 95)) * 1e3}

    def _sample(self):
        rng = numpy_rng(self.run.seed, "check")
        done = sorted(self.served)
        n = min(self.run.traffic["check_requests"], len(done))
        return [int(i) for i in rng.choice(done, n, replace=False)]

    def program_control(self) -> None:
        """The port's own lower-precision search over the checked requests' reps: the
        control of the search numbers (needs the index: call before :meth:`release`)."""
        self.lower = {i: self.index.search(self.served[i][0], self.k, mode="i8q")
                      for i in self._sample()}

    def release(self) -> None:
        self.checked = {i: self.served[i] for i in self._sample()}
        del self.model, self.index, self.served
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _judge(self, answers):
        """The reference's top-k gaps of ``answers`` {pool index: (scores, ids)}."""
        strict_fp32()
        run, tr = self.run, self.run.traffic
        order = sorted(self.checked)
        q = torch.cat([self.checked[i][0] for i in order]).float().to(run.device)
        ids = torch.cat([torch.as_tensor(answers[i][1]) for i in order]).to(run.device)
        got = torch.cat([torch.as_tensor(answers[i][0]) for i in order]).to(run.device)
        top = ExactTopK(q, self.k, ids)
        centres = mixture_centres(run.seed, tr["mixture"]["components"], q.shape[1],
                                  run.device)
        start = 0
        for s, rows in slab_sizes(tr["corpus_rows"], tr["slab_rows"]):
            top.add_slab(start, self._slab(centres, s, rows))
            start += rows
        return compare.topk_gaps(top.top_s, top.probe_scores, ids, got)

    def readings(self, variant: str):
        order = sorted(self.checked)
        batch = {k: np.concatenate([self.requests[i][0][k] for i in order])
                 for k in self.requests[0][0]}
        want = refs.reps(self.run, batch, CASTS["exact"])
        if variant == "sound":
            rep = compare.rel_err(torch.cat([self.checked[i][0] for i in order]), want)
            gaps = self._judge({i: self.checked[i][1:] for i in order})
        else:
            rep = compare.rel_err(refs.reps(self.run, batch, CASTS["fp8"]), want)
            gaps = self._judge(self.lower)
        return {"query_rep_err": rep, "search_id_gap": gaps["id_gap"],
                "search_score_err": gaps["score_err"]}
