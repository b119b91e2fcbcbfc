"""The manifest and the layout the harness discovers by name."""

import ast
import json
import re
from pathlib import Path

import pytest

from raven_bench.harness import cell, layout
from raven_bench.tests import held_cells

BENCH = layout.BENCH
MAN = json.loads(layout.MANIFEST.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_has_exactly_the_contract_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["raven_bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in MAN["configs"]]
                         + [w["traffic"] for w in MAN["workloads"]]
                         + [w["config"] for w in MAN["workloads"]])
def test_every_name_uses_only_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_unit_a_direction_and_a_reader(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert callable(layout.module("metrics", metric["name"]).read)
    for w in metric.get("workloads", []):
        assert w in CELLS


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert "workloads" not in target or w in target["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in CELLS:
        e2e = [m["name"] for m in layout.metrics_of(MAN, w, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layout.metrics_of(MAN, w, "per_layer")


def test_strings_fit_the_contract():
    for c in MAN["configs"]:
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert len(c["why"]) <= 200
        assert (layout.ROOT / c["file"]).is_file()
        assert c["file"].startswith("raven_bench/")
    for w in MAN["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    assert len(layout.MANIFEST.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell_name", CELLS + held_cells.CELLS)
def test_each_cell_finds_its_pieces_by_name(cell_name):
    man = held_cells.manifest()
    w = layout.workload(man, cell_name)
    cfg = layout.config(man, w["config"])
    mix = layout.traffic(w["traffic"])
    assert callable(layout.module("data", cfg["data"]["generator"]).generate)
    kind = cfg["model"]["kind"]
    assert callable(layout.module("models", kind).build)
    assert callable(layout.module("reference", kind).outputs)
    assert set(cfg["limits"]) <= {"mismatch_share", "avg_rel_gap"}
    for role in mix["roles"]:
        assert role["send"] in ("sql", "table")
        for q in role["mix"]:
            assert q["expect"]["kind"] in ("rows", "group_avg", "top_k")


def test_held_per_layer_metrics_have_their_readers():
    for m in held_cells.manifest()["per_layer"]:
        assert callable(layout.module("metrics", m["name"]).read)


def test_a_dotted_name_without_a_file_reads_with_its_parent():
    assert layout.module("metrics", "latency_p95_ms.streams") is \
        layout.module("metrics", "latency_p95_ms")
    with pytest.raises(SystemExit):
        layout.module("metrics", "no_such_metric.p50")


def test_layout_refuses_a_name_it_does_not_have():
    with pytest.raises(SystemExit):
        layout.module("metrics", "no_such_metric")
    with pytest.raises(SystemExit):
        layout.workload(MAN, "no.such_cell")


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p for d in ("reference", "data", "counts", "models")
    for p in (BENCH / d).glob("*.py")), ids=lambda p: p.name)
def test_the_yardstick_imports_neither_jax_nor_either_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro",
                                 "repro_torch"}


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    assert "repro_torch" not in cell.FORBIDDEN
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("x"))
    assert "repro_torchlike" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in cell.forbidden_modules()
