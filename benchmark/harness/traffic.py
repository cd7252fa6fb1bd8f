"""The traffic generator: token sequences and corpus rows, all drawn from the run's seed.

One generator reads every traffic mix (``benchmark/traffic/<name>.json``): a mix gives
lengths as ``{"median", "sigma", "min", "max"}`` and the tokens come from the
configuration's ``assumed.token_ids``. Every stream of random numbers is keyed by the
seed and a stream name, so the same seed gives the same inputs and two streams never
share numbers.

Frozen copies (the port keeps its own, which may change):

- :func:`lengths` and :func:`token_batch` follow ``chip_smoke.py:make_batches``
  (commit 2b7f364): lognormal lengths clipped to [min, max], BERT ids
  ``[CLS] + U[low, high) + [SEP]``, right-padded with 0 to the mix's padded length.
- :func:`mixture_centres` and :func:`mixture_slab` follow
  ``denseretrievaltoolkits_torch/recipes/bench_data.py`` (commit 2b7f364:
  ``make_centers`` / ``_block``): centres N(0, 1), rows ``centre + sigma N(0, 1)``,
  made on the device from ``torch.Generator``s. Here the centres' and the rows'
  generators are keyed by the seed, and each slab of rows by its index (the
  recipe keys 100,000-row granules by their start under the fixed seeds 77 and 5),
  so the reference makes any slab again without the others.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit seed for (seed, stream...): any whole ``seed``, negative or past 2**32."""
    words = [seed % 2**64] + [s if isinstance(s, int) else _word(s) for s in stream]
    words = [int(w) for w in words]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def _word(text: str) -> int:
    return int.from_bytes(str(text).encode()[:8].ljust(8, b"\0"), "little")


def numpy_rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *stream))


def torch_gen(device, seed: int, *stream) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *stream))


def lengths(rng: np.random.Generator, n: int, spec: Dict) -> np.ndarray:
    """``n`` lognormal token counts of median ``spec['median']`` and log-sd ``spec['sigma']``,
    clipped to [min, max]: the sequence's real tokens, specials included."""
    raw = rng.lognormal(math.log(spec["median"]), spec["sigma"], n)
    return np.clip(raw.astype(np.int64), spec["min"], spec["max"])


def token_batch(rng: np.random.Generator, lens: np.ndarray, pad_to: int,
                tokens: Dict) -> Dict[str, np.ndarray]:
    """``input_ids`` / ``attention_mask`` int32 [n, pad_to]: each row ``lens[i]`` real
    tokens, the first ``tokens['first']`` (none where null), the last ``tokens['last']``,
    the rest U[low, high); 0 after."""
    n = len(lens)
    ids = rng.integers(tokens["low"], tokens["high"], (n, pad_to), dtype=np.int64)
    cols = np.arange(pad_to)[None, :]
    lens = np.asarray(lens)[:, None]
    if tokens.get("first") is not None:
        ids[:, 0] = tokens["first"]
    ids = np.where(cols == lens - 1, tokens["last"], ids)
    mask = cols < lens
    return {"input_ids": np.where(mask, ids, 0).astype(np.int32),
            "attention_mask": mask.astype(np.int32)}


def mixture_centres(seed: int, n: int, dim: int, device) -> torch.Tensor:
    """[n, dim] fp32 centres N(0, 1)."""
    return torch.randn(n, dim, generator=torch_gen(device, seed, "centres"), device=device)


def mixture_slab(centres: torch.Tensor, seed: int, index: int, rows: int,
                 sigma: float) -> torch.Tensor:
    """Slab ``index`` of the corpus: [rows, dim] fp32, each a random centre plus
    ``sigma`` N(0, 1)."""
    g = torch_gen(centres.device, seed, "slab", index)
    which = torch.randint(0, centres.shape[0], (rows,), generator=g, device=centres.device)
    noise = torch.randn(rows, centres.shape[1], generator=g, device=centres.device)
    return centres[which].add_(noise, alpha=sigma)


def away_from(rows: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """``rows`` [n, dim] with their component along the unit ``direction`` [dim] taken out,
    in place. The products are elementwise sums, not a matrix product, so that no TF32
    setting changes them."""
    return rows.sub_((rows * direction).sum(dim=1, keepdim=True) * direction)


def slab_sizes(total: int, slab: int):
    """[(index, rows)] of ``total`` rows in slabs of ``slab``."""
    return [(i, min(slab, total - start)) for i, start in enumerate(range(0, total, slab))]
