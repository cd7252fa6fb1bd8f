"""The yardstick's FLOP and byte counts against hand arithmetic at the cells' sizes."""

import pytest

from benchsupport import BENCH
from harness import roofline
from harness.core import load_json


def test_bert_base_forward_flops_per_passage():
    # 12 layers of 2 L (4 H^2 + 2 H F) + 4 L^2 H at L = 68, H = 768, F = 3072
    per_layer = 2 * 68 * (4 * 768**2 + 2 * 768 * 3072) + 4 * 68**2 * 768
    assert roofline.encoder_flops(12, 768, 768, 3072, [68]) == pytest.approx(12 * per_layer)
    assert 12 * per_layer == 11_721_572_352


def test_model_dims_of_the_configurations():
    bert = load_json(BENCH, "configs", "dpr-bert-base.json")
    t5 = load_json(BENCH, "configs", "t5-base-meanpool.json")
    assert roofline.model_dims(bert) == (12, 768, 768, 3072)
    assert roofline.model_dims(t5) == (12, 768, 768, 3072)
    assert roofline.lengths_flops(bert, []) == 0.0


def test_int8_search_bound_at_ms_marco():
    # 2 N H Q products at 989 TFLOP/s outweigh the rows read once at 3.35 TB/s
    N, H, Q = 8_841_823, 768, 1024
    ops_s = 2 * N * H * Q / 989e12
    bytes_s = (N * H + 4 * N + 4 * Q * H) / 3.35e12
    assert ops_s == pytest.approx(0.014059, rel=1e-3) and bytes_s < ops_s
    assert roofline.flat_search_bound_s(N, H, Q, 1.0) == pytest.approx(ops_s)
    # one query is bound by the bytes
    assert roofline.flat_search_bound_s(N, H, 1, 1.0) == pytest.approx(
        (N * H + 4 * N + 4 * H) / 3.35e12)


def test_loss_flops_and_bound():
    assert roofline.contrastive_flops(128, 256, 768) == 2 * 128 * 256 * 768
    assert roofline.bound(3.35e12, 0, "bf16") == pytest.approx(1.0)
    assert roofline.bound(0, 989e12, "bf16") == pytest.approx(1.0)
    assert roofline.bound(0, 67e12, "fp32") == pytest.approx(1.0)
