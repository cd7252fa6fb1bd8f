"""Corpus encode: passages through the passage tower, reps back on the host.

Set-up draws ``calls_in_pool`` calls' worth of passages from the seed (``batches_per_call``
batches of ``batch`` passages, lognormal lengths, padded to ``pad_to``) as host arrays,
as a tokenized corpus is, and encodes the first call once to warm up. Each step of the
window is one ``run_encode.encode_batches`` call on the next call's batches, cycling;
``encode_passages_per_s`` counts the passages whose reps came back over the window's
seconds. The check compares ``check_rows`` passages, drawn from the seed among those the
window encoded, with the float32 reference's reps of the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import compare, refs
from harness.port import dual_encoder
from harness.traffic import lengths, numpy_rng, token_batch
from reference.precision import CASTS


class Driver:
    unit_span = "encode_call"
    control_variants = ("control",)

    def __init__(self, run):
        from denseretrievaltoolkits_torch.run_encode import encode_batches

        self.run, self.encode_batches = run, encode_batches
        tr = run.traffic
        self.batch = tr["batch"]
        self.model, weights = dual_encoder(run, serving=True)
        del weights
        run.mark("model")
        rng = numpy_rng(run.seed, "passages")
        self.calls = []
        for c in range(tr["calls_in_pool"]):
            lens = lengths(rng, tr["batch"] * tr["batches_per_call"], tr["passage_len"])
            rows = token_batch(rng, lens, tr["pad_to"], run.config["assumed"]["token_ids"])
            batches = [([f"c{c}b{b}r{r}" for r in range(self.batch)],
                        {k: v[b * self.batch:(b + 1) * self.batch] for k, v in rows.items()})
                       for b in range(tr["batches_per_call"])]
            self.calls.append((rows, lens, batches))
        run.mark("passages")
        self.encode_batches(self.model, self.calls[0][2], "passage", self.batch)  # warm-up
        self.reps = {}  # call index -> the reps its last encode returned
        self.n = 0
        run.counters.update(units=0, passages=0, encode_lengths=[])

    def step(self) -> None:
        i = self.n % len(self.calls)
        rows, lens, batches = self.calls[i]
        self.reps[i], _ = self.encode_batches(self.model, batches, "passage", self.batch)
        self.n += 1
        c = self.run.counters
        c["units"] += 1
        c["passages"] += len(lens)
        c["encode_lengths"].append(lens)

    def finish(self) -> None:
        pass  # every call's reps are on the host already

    def end_to_end(self, window_s: float):
        return {"encode_passages_per_s": self.run.counters["passages"] / window_s}

    def release(self) -> None:
        del self.model
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """(call index, row indices) of the checked passages, drawn from the seed."""
        rng = numpy_rng(self.run.seed, "check")
        i = int(rng.choice(sorted(self.reps)))
        rows = self.calls[i][0]
        n = min(self.run.traffic["check_rows"], len(rows["input_ids"]))
        return i, np.sort(rng.choice(len(rows["input_ids"]), n, replace=False))

    def readings(self, variant: str):
        i, pick = self._sample()
        rows = {k: v[pick] for k, v in self.calls[i][0].items()}
        want = refs.reps(self.run, rows, CASTS["exact"])
        if variant == "sound":
            got = torch.as_tensor(self.reps[i][pick])
        else:
            got = refs.reps(self.run, rows, CASTS["fp8"])
        return {"passage_rep_err": compare.rel_err(got, want)}
