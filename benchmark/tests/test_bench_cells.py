"""Each cell at a tiny size on the port's CPU path: the run is correct against the
reference, reports its metrics, and comes out not correct under its control and under
each fault its timed path can have (a step that leaves the state unchanged, half the
batch left out, an answer altered where it is produced). One chip: no exchange to leave
out."""

import math

import pytest

from benchsupport import CELLS, ROOT, core, tiny

import control

SEED = 2**31 + 101
MANIFEST = core.load_json(ROOT, "BENCHMARK.json")
KIND = {c: core.load_json(core.BENCH, "traffic", core.load_json(
    core.BENCH, "workloads", c + ".json")["traffic"] + ".json")["driver"] for c in CELLS}


def run(cell, trace=False):
    return core.run_cell(cell, SEED, 0.3, trace, device="cpu", manifest=MANIFEST, **tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_reports_its_metrics(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in core.cell_end_to_end(MANIFEST, cell)}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_layers_it_can_on_the_cpu(cell):
    out = run(cell, trace=True)
    assert out["correct"]
    assert {"device_ops", "idle_gaps"} <= set(out["breakdown"])
    source = {m["name"]: m["source"] for m in core.cell_per_layer(MANIFEST, cell)}
    # no device operation runs on the CPU: only the host clock and the port's counters
    assert set(out["metrics"]) == {n for n, s in source.items()
                                   if s in ("host_clock", "program_counter")}
    for n, v in out["metrics"].items():
        assert 0 <= v["value"] if source[n] == "program_counter" else 0 < v["value"] < 100


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    limits = core.load_json(core.BENCH, "workloads", cell + ".json")["limits"]
    got = control.readings(cell, SEED, 0.3, "cpu", **tiny(cell))
    assert all(got["sound"][k] <= limits[k] for k in limits), got["sound"]
    assert any(not math.isfinite(got["control"][k]) or got["control"][k] > limits[k]
               for k in limits), got["control"]


def _alter_row(fn):
    def altered(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[0] = -out[0]
        return out
    return altered


@pytest.mark.parametrize("cell", [c for c in CELLS if KIND[c] == "encode"])
def test_altered_rep_fails(cell, monkeypatch):
    from denseretrievaltoolkits_torch.models.biencoder import DRModel

    monkeypatch.setattr(DRModel, "encode_passage", _alter_row(DRModel.encode_passage))
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", [c for c in CELLS if KIND[c] == "search"])
def test_altered_answer_fails(cell, monkeypatch):
    from denseretrievaltoolkits_torch.index.flat import FlatIPIndex

    search = FlatIPIndex.search

    def altered(self, q, k=1000, mode="exact"):
        scores, ids = search(self, q, k, mode)
        ids[0, 0] = (ids[0, 0] + 1) % len(self)
        return scores, ids

    monkeypatch.setattr(FlatIPIndex, "search", altered)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", [c for c in CELLS if KIND[c] == "search"])
def test_altered_query_rep_fails(cell, monkeypatch):
    from denseretrievaltoolkits_torch.models.biencoder import DRModel

    monkeypatch.setattr(DRModel, "encode_query", _alter_row(DRModel.encode_query))
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", [c for c in CELLS if KIND[c] == "train"])
def test_unchanged_state_fails(cell, monkeypatch):
    from denseretrievaltoolkits_torch.train.optimizers import ScheduledOptimizer

    monkeypatch.setattr(ScheduledOptimizer, "step", lambda self: None)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", [c for c in CELLS if KIND[c] == "train"])
def test_half_batch_fails(cell, monkeypatch):
    from denseretrievaltoolkits_torch.models.biencoder import DRModel

    loss = DRModel.loss

    def half(self, q, p):
        n = q.shape[0] // 2
        return loss(self, q[:n], p[:n * (p.shape[0] // q.shape[0])])

    monkeypatch.setattr(DRModel, "loss", half)
    assert not run(cell)["correct"]


def test_planted_faults_read_in_the_reference():
    """The control script's faults: the half batch moves the first gradient."""
    cell = next(c for c in CELLS if KIND[c] == "train")
    got = control.readings(cell, SEED, 0.3, "cpu", **tiny(cell))
    assert got["half_batch"]["grad_gap"] > 3 * got["sound"]["grad_gap"]
