"""The traffic generator repeats per seed, keeps streams apart and stays in its bounds."""

import numpy as np
import pytest
import torch

import benchsupport  # noqa: F401
from harness import traffic
from harness.weights import make_weights

SEEDS = (0, 7, 2**31 + 11, 2**33 + 5, -3)
SPEC = {"median": 60, "sigma": 0.5, "min": 8, "max": 156}
TOKENS = {"first": 101, "last": 102, "low": 1000, "high": 30522}


@pytest.mark.parametrize("seed", SEEDS)
def test_token_batches_repeat_per_seed(seed):
    def draw():
        rng = traffic.numpy_rng(seed, "passages")
        lens = traffic.lengths(rng, 512, SPEC)
        return lens, traffic.token_batch(rng, lens, 156, TOKENS)

    (l1, b1), (l2, b2) = draw(), draw()
    assert np.array_equal(l1, l2)
    assert all(np.array_equal(b1[k], b2[k]) for k in b1)
    assert l1.min() >= 8 and l1.max() <= 156
    assert np.array_equal(b1["attention_mask"].sum(1), l1)
    assert (b1["input_ids"][:, 0] == 101).all()
    assert (b1["input_ids"][np.arange(512), l1 - 1] == 102).all()
    assert (b1["input_ids"][b1["attention_mask"] == 0] == 0).all()


def test_streams_and_seeds_differ():
    a = traffic.numpy_rng(5, "passages").integers(0, 2**31, 8)
    b = traffic.numpy_rng(5, "queries").integers(0, 2**31, 8)
    c = traffic.numpy_rng(6, "passages").integers(0, 2**31, 8)
    assert not np.array_equal(a, b) and not np.array_equal(a, c)
    assert traffic.stream_seed(2**31 + 1, "x") != traffic.stream_seed(1, "x")


def test_lengths_follow_the_mix():
    lens = traffic.lengths(traffic.numpy_rng(3, "l"), 20000, SPEC)
    assert abs(np.median(lens) - 60) <= 2
    t5 = {"first": None, "last": 1, "low": 3, "high": 32100}
    b = traffic.token_batch(traffic.numpy_rng(3, "t"), np.array([1, 4]), 6, t5)
    assert b["input_ids"].tolist()[0][:2] == [1, 0] and b["input_ids"][1, 3] == 1


@pytest.mark.parametrize("seed", (1, 2**31 + 99))
def test_corpus_slabs_repeat_per_seed_and_slab(seed):
    centres = traffic.mixture_centres(seed, 16, 32, "cpu")
    a = traffic.mixture_slab(centres, seed, 3, 100, 0.5)
    b = traffic.mixture_slab(traffic.mixture_centres(seed, 16, 32, "cpu"), seed, 3, 100, 0.5)
    assert torch.equal(a, b)
    assert not torch.equal(a, traffic.mixture_slab(centres, seed, 4, 100, 0.5))
    assert traffic.slab_sizes(10, 4) == [(0, 4), (1, 4), (2, 2)]


def test_weights_repeat_per_seed():
    cfg = {"model_type": "t5", "vocab_size": 50, "d_model": 8, "d_kv": 4, "d_ff": 16,
           "num_layers": 2, "num_heads": 2, "relative_attention_num_buckets": 32}
    a, b = make_weights(cfg, 9, "cpu"), make_weights(cfg, 9, "cpu")
    c = make_weights(cfg, 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["shared"], c["shared"])
    assert torch.equal(a["encoder.attn_ln"], torch.ones(2, 8))


def test_reference_int8_scale_is_absmax_over_127_rounded_once():
    """The reference's scales are the correctly rounded quotient, as K7's IEEE division:
    not a product with the rounded reciprocal of 127."""
    import torch

    from reference.search import quantize_int8

    x = torch.randn(4096, 768, generator=torch.Generator().manual_seed(3))
    _, scale = quantize_int8(x)
    assert torch.equal(scale, (x.abs().amax(dim=1).double() / 127).float())


def test_rows_away_from_a_direction_are_orthogonal_to_it():
    centres = traffic.mixture_centres(5, 16, 32, "cpu")
    rows = traffic.mixture_slab(centres, 5, 0, 100, 0.5)
    d = torch.nn.functional.normalize(torch.randn(32), dim=0)
    away = traffic.away_from(rows.clone(), d)
    assert float((away @ d).abs().max()) < 1e-4
    assert torch.equal(away, traffic.away_from(rows.clone(), d))
