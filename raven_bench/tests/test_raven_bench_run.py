"""Whole runs of every cell on the CPU at a small scale, the held cells
too: the program's answers pass the check, and so does the sound stand-in
(the reference in float32 with its scaler folded) in the manifest's cells;
the control (the reference in bfloat16 in the program's place) and a
program broken underneath the timed path fail it.  The harness's look for
a card is skipped; the rest of a run is the same."""

import functools
import time

import pytest
import torch

from raven_bench.harness import cell, layout
from raven_bench.harness.control import ControlProgram
from raven_bench.tests import held_cells

SCALE = 0.005                  # 5,000 patients, 29,095 flights
MANIFEST = [w["name"] for w in layout.manifest()["workloads"]]
CELLS = MANIFEST + held_cells.CELLS


@pytest.fixture(autouse=True)
def _held(monkeypatch):
    monkeypatch.setattr(layout, "manifest", held_cells.manifest)


def _run(name, seed=2**31 + 7, program=None, traced=False, seconds=1.0):
    return cell.run_cell(name, seed, seconds, traced, time.monotonic(),
                         device="cpu", scale=SCALE, program=program)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    r = _run(name, seconds=3.0)      # long enough to answer on a busy CPU
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["mismatch_share"]["value"] == 0
    want = {m["name"] for m in layout.metrics_of(layout.manifest(), name,
                                                 "end_to_end")}
    assert set(r["metrics"]) == want
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", MANIFEST)
def test_the_sound_stand_in_is_correct(name):
    r = _run(name, program=functools.partial(
        ControlProgram, dtype=torch.float32, fold=True))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    r = _run(name, program=ControlProgram)
    assert not r["correct"], r["checks"]
    assert r["checks"]["mismatch_share"]["value"] > 0


def _alter_one_answer(monkeypatch):
    """A wrong answer where it is produced: every execution's answer has
    the model's value in its middle valid row changed."""
    import torch

    from repro_torch.relational.table import Table
    from repro_torch.serve import prediction_service as ps

    def alter(out):
        if isinstance(out, Table):
            rows = torch.nonzero(out.valid)[:, 0]
            name = [k for k, v in out.columns.items()
                    if v.dtype == torch.float32][-1]
            col = out.columns[name].clone()
            col[rows[len(rows) // 2]] += 0.5
            out = out.with_columns({name: col})
        return out

    for method in ("_execute", "_execute_direct"):
        real = getattr(ps.PredictionService, method)

        def wrapped(self, *a, _real=real, **k):
            return alter(_real(self, *a, **k))

        monkeypatch.setattr(ps.PredictionService, method, wrapped)


def _drop_half_the_batch(monkeypatch):
    """Half of every execution's rows left out: the second half of each
    input table is marked invalid, so scores, means and top rows come
    from the rest."""
    from repro_torch.serve import prediction_service as ps
    real = ps.PredictionService._input_tables

    def halved(self, compiled, tables):
        tabs = real(self, compiled, tables)
        out = {}
        for k, t in tabs.items():
            v = t.valid.clone()
            v[v.shape[0] // 2:] = False
            out[k] = t.with_valid(v)
        return out

    monkeypatch.setattr(ps.PredictionService, "_input_tables", halved)

    real_stack = ps._stack_pad

    def stack_halved(tables, target):
        t = real_stack(tables, target)
        v = t.valid.clone()
        v[int(v.sum()) // 2:] = False
        return t.with_valid(v)

    monkeypatch.setattr(ps, "_stack_pad", stack_halved)


@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batch],
                         ids=["answer_altered", "half_the_batch_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_per_layer_metrics(name):
    r = _run(name, traced=True)
    assert r["correct"], r["checks"]
    names = {m["name"] for m in layout.metrics_of(layout.manifest(), name,
                                                  "per_layer")}
    # no device work on the CPU: the device readers find nothing to read
    assert set(r["metrics"]) <= names
    assert held_cells.reading(r["metrics"], "execute_ms.p50") >= 0
    assert held_cells.reading(r["metrics"], "compiles_in_window") == 0
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
