"""The port's recipe twins (``denseretrievaltoolkits_torch/recipes/``) on the CPU.

- ``quality_trend``'s generators write byte-identical files to the JAX recipe's
  for seeds 0 and 1, on both workloads, and its model directory too;
- a tiny run of the twin with ``--rerank`` writes ``trend.json`` with the epoch
  and test rows, and the reranker's metrics;
- ``quality_multiseed`` has the JAX recipe's arms, skips finished cells and
  writes the JAX recipe's ``summary.json`` from the same cells;
- ``profile_encoder --smoke --device cpu`` writes its keys.
"""

import filecmp
import json
import os
import random
from argparse import Namespace

import pytest

from denseretrievaltoolkits_torch.recipes import profile_encoder, quality_multiseed, \
    quality_trend
from recipes import quality_multiseed as jax_multiseed
from recipes import quality_trend as jax_trend


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.funny_files
    for name in cmp.common_files:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("workload", ["planted", "topical"])
def test_generators_write_the_same_bytes(tmp_path, seed, workload):
    for mod, side in ((jax_trend, "jax"), (quality_trend, "port")):
        out = str(tmp_path / side)
        if workload == "planted":
            mod.make_dataset(out, random.Random(seed), 40, 10, 300, n_neg=4)
        else:
            mod.make_topical_dataset(out, random.Random(seed), 40, 10, 300, n_neg=4,
                                     n_topics=32)
        mod.make_model_dir(out)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_quality_trend_twin_runs_with_rerank(tmp_path):
    out = str(tmp_path / "trend")
    result = quality_trend.main(["--out", out, "--epochs", "1", "--train", "64", "--eval", "16",
                                 "--corpus", "300", "--lr", "1e-3", "--rerank", "--device",
                                 "cpu"])
    with open(os.path.join(out, "trend.json")) as fh:
        trend = json.load(fh)
    assert sorted(trend) == ["-1", "1"] and trend == result["trend"]
    assert trend["-1"]["query_num"] == 16 and "MRR@10" in trend["1"]
    with open(os.path.join(out, "rr_cache", "3.0_RR_metrics")) as fh:
        assert json.load(fh) == result["rerank"]
    assert result["rerank"]["query_num"] == 16
    with open(os.path.join(out, "args.json")) as fh:
        args = json.load(fh)
    assert args["learning_rate"] == 1e-3 and args["max_epochs"] == 1


def test_quality_multiseed_arms_resume_and_summary(tmp_path, monkeypatch):
    opts = Namespace(mine_every=3)
    assert quality_multiseed.make_arms(opts) == jax_multiseed.make_arms(opts)
    calls = []

    def fake_trend(argv):
        out = argv[argv.index("--out") + 1]
        seed = int(argv[argv.index("--seed") + 1])
        calls.append(argv)
        assert argv[argv.index("--device") + 1] == "cpu"
        os.makedirs(out, exist_ok=True)
        mrr = 0.1 * (seed + 1) + (0.05 if "--mine" in argv else 0.0)
        with open(os.path.join(out, "trend.json"), "w") as fh:
            json.dump({"1": {"MRR@10": 0.0}, "-1": {"MRR@10": mrr, "NDCG@10": mrr / 2,
                                                    "Recall@10": 0.5, "Recall@100": 0.9}}, fh)

    monkeypatch.setattr(quality_trend, "main", fake_trend)
    argv = ["--out", str(tmp_path / "port"), "--seeds", "0", "1", "--corpus", "500",
            "--device", "cpu"]
    summary = quality_multiseed.main(argv)
    assert len(calls) == 6 and summary["mine"]["MRR@10"]["values"] == [0.15, 0.25]
    quality_multiseed.main(argv)  # every cell finished: nothing runs
    assert len(calls) == 6
    # the JAX recipe over the same finished cells writes the same summary
    import shutil

    shutil.copytree(tmp_path / "port", tmp_path / "jax", ignore=shutil.ignore_patterns(
        "summary.json"))
    jax_multiseed.main(["--out", str(tmp_path / "jax"), "--seeds", "0", "1", "--corpus", "500"])
    got, want = (json.load(open(tmp_path / side / "summary.json")) for side in ("port", "jax"))
    assert got["summary"] == want["summary"]


def test_profile_encoder_smoke_writes_its_keys(tmp_path):
    out = str(tmp_path / "profile.json")
    profile_encoder.main(["--smoke", "--device", "cpu", "--out", out])
    with open(out) as fh:
        res = json.load(fh)
    keys = {f"{k}_{a}" for k in ("encode_12L", "encode_2L", "per_layer_marginal", "fixed_cost")
            for a in profile_encoder.ATTENTIONS}
    keys |= {"attn_inner_plain_x12", "attn_inner_flash_x12", "proj_mlp_matmuls_x12",
             "train_forward_only", "train_forward_backward", "train_full_step", "B", "S"}
    assert keys <= set(res) and res["device"] == "cpu"
    assert res["encode_12L_fused_max_abs_err_vs_xla"] < 0.5  # bf16 through the plain versions
    assert res["attn_inner_flash_max_abs_err"] < 0.1
