"""Cells on the card at a small scale, the held cells too: correct, and a
traced window that sees the program's kernels.  Skips without a card."""

import time

import pytest
import torch

from raven_bench.harness import cell, layout
from raven_bench.tests import held_cells

CELLS = [w["name"] for w in layout.manifest()["workloads"]] + held_cells.CELLS


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(layout, "manifest", held_cells.manifest)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    r = cell.run_cell(name, 2**31 + 99, 2.0, True, time.monotonic(),
                      device="cuda", scale=0.05)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert 0 <= held_cells.reading(r["metrics"], "device_idle_share") < 100
    if "tree_gemm_roofline" in r["metrics"]:
        assert 0 < r["metrics"]["tree_gemm_roofline"]["value"] <= 100
