"""Where each piece of the benchmark lives, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<file>`` (a manifest entry's ``file``): one configuration;
- ``traffic/<traffic>.json``: one traffic mix, read by ``harness/traffic.py``;
- ``data/<generator>.py``: a frozen data generator, named by a config;
- ``models/<kind>.py``: how a model of that kind is made from the seed;
- ``reference/<kind>.py``: the plain reference of that kind of model;
- ``metrics/<metric>.py``: the reader of one metric; where there is no
  such file, the reader of the name less its last dotted part, so that
  ``latency_p95_ms.streams`` (the same number, reported as a layer's
  metric in another kind of cell) reads with ``metrics/latency_p95_ms.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

_modules: Dict[Path, ModuleType] = {}


def manifest() -> Dict:
    return json.loads(MANIFEST.read_text())


def workload(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in {MANIFEST.name}")


def config(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise SystemExit(f"no config {name!r} in {MANIFEST.name}")


def traffic(name: str) -> Dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def module(folder: str, name: str) -> ModuleType:
    """``<folder>/<name>.py`` under the benchmark, loaded once.  Names may
    hold dots (``front_door_ms.p50``), so files load by path."""
    path = BENCH / folder / f"{name}.py"
    if path not in _modules:
        if not path.is_file() and folder == "metrics" and "." in name:
            return module(folder, name.rsplit(".", 1)[0])
        if not path.is_file():
            raise SystemExit(f"no {folder} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"raven_bench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def metrics_of(man: Dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in man[kind]
            if "workloads" not in m or cell in m["workloads"]]
