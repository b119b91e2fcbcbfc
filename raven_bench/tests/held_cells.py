"""Cells kept in the folder and run by these tests, but out of
``BENCHMARK.json`` until their configuration cites a public source for its
scale and its forest, and their mixes one for their traffic: Fig 1's
hospital tables with a forest through ``tree_gemm`` under three mixes.
``manifest()`` is the manifest with them added."""

import json

from raven_bench.harness import layout

CELLS = [f"los_rf64.{t}" for t in ("cohort_scan", "online_scoring", "mixed")]


def manifest():
    man = json.loads(layout.MANIFEST.read_text())
    man["configs"].append({"name": "los_rf64",
                           "file": "raven_bench/configs/los_rf64.json"})
    man["workloads"] += [{"name": c, "config": "los_rf64",
                          "traffic": c.split(".")[1], "chips": 1}
                         for c in CELLS]
    man["per_layer"] += [
        {"name": "tree_gemm_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "rows_per_s",
         "workloads": CELLS},
        {"name": "requests_per_execution", "unit": "requests",
         "better": "higher", "source": "program_counter",
         "layer": "front door", "moves": "rows_per_s",
         "workloads": CELLS[1:]}]
    return man
