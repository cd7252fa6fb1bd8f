"""BENCHMARK.json against the benchmark's contract, and against the files it names."""

import json
import os
import re

import pytest

from benchsupport import BENCH, ROOT

MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "d_model",
               "d_ff", "d_kv", "expansion", "experts_per_tok", "num_experts_per_tok")


def _line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_the_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MANIFEST["configs"]] + [w["name"] for w in MANIFEST["workloads"]] \
        + [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in MANIFEST["configs"]:
        assert _line(c["why"]) and _line(c["source"])
    for w in MANIFEST["workloads"]:
        assert _line(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])
    for word in MANIFEST["command"]:
        assert _line(word)


def test_entries_have_only_the_contract_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_configs_are_files_under_paths_and_cut_no_width():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)


def test_every_configuration_has_a_cell_and_every_cell_its_files():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MANIFEST["workloads"]:
        spec = json.load(open(os.path.join(BENCH, "workloads", w["name"] + ".json")))
        assert (spec["config"], spec["traffic"], spec["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        traffic = json.load(open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(BENCH, "drivers", traffic["driver"] + ".py"))
        assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def _reported(cell):
    return {m["name"] for m in MANIFEST["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MANIFEST["end_to_end"])
    for w in MANIFEST["workloads"]:
        e2e = _reported(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_cells_report_its_moves_and_it_has_a_reader(metric):
    for cell in metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]]):
        assert metric["moves"] in _reported(cell), (metric["name"], cell)
    assert os.path.exists(os.path.join(BENCH, "metrics", metric["name"] + ".py"))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_metrics_of_one_layer_share_its_name_and_paths_hold_only_names():
    for m in MANIFEST["per_layer"]:
        assert m["layer"] == m["layer"].strip()
    for dirpath, dirnames, filenames in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_every_cells_files_carry_their_tiny_sizes():
    """The CPU tests shrink a cell by its files' ``tiny`` keys alone."""
    for w in MANIFEST["workloads"]:
        for kind, name in (("configs", w["config"]), ("traffic", w["traffic"])):
            with open(os.path.join(BENCH, kind, name + ".json")) as fh:
                assert isinstance(json.load(fh).get("tiny"), dict), (kind, name)
