"""Cells kept in the folder and run by these tests, but out of
``BENCHMARK.json`` until their configuration cites a public source for its
scale and its forest, and their mixes one for their traffic: Fig 1's
hospital tables with a forest through ``tree_gemm`` under three mixes.
``manifest()`` is the manifest with them added, and with them added to the
metrics that the manifest names for one flights cell alone but that a
held cell reports as well."""

import json

from raven_bench.harness import layout

CELLS = [f"los_rf64.{t}" for t in ("cohort_scan", "online_scoring", "mixed")]
# Reported in every held cell: the rates, latencies and layers of a mix
# of scans and scoring requests.
REPORTED = ("rows_per_s", "latency_p50_ms", "front_door_ms.p50",
            "compiles_in_window", "execute_ms.p50", "device_idle_share",
            "mfu", "lane_wait_ms.p50")


def manifest():
    man = json.loads(layout.MANIFEST.read_text())
    man["configs"].append({"name": "los_rf64",
                           "file": "raven_bench/configs/los_rf64.json"})
    man["workloads"] += [{"name": c, "config": "los_rf64",
                          "traffic": c.split(".")[1], "chips": 1}
                         for c in CELLS]
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in REPORTED and "workloads" in m:
            m["workloads"] = m["workloads"] + CELLS
    man["per_layer"] += [
        {"name": "tree_gemm_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "rows_per_s",
         "workloads": CELLS},
        {"name": "requests_per_execution", "unit": "requests",
         "better": "higher", "source": "program_counter",
         "layer": "front door", "moves": "rows_per_s",
         "workloads": CELLS[1:]}]
    return man


def reading(metrics, base):
    """The reading of ``base`` in a result's metrics, under its own name
    or a cell's split of it (``mfu.streams``)."""
    got = [n for n in metrics if n == base or n.startswith(base + ".")]
    assert len(got) == 1, (base, sorted(metrics))
    return metrics[got[0]]["value"]
