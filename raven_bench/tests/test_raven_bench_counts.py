"""The frozen work counts and peaks."""

import numpy as np
import pytest

from raven_bench.counts import peaks, tree_sizes, work
from raven_bench.counts.tree_gemm_cost import forest_cost, tree_gemm_cost


def test_tree_gemm_cost_reproduces_the_kernel_bound():
    # 1,000,000 rows, 64 trees, I = L = 256: 8.39e12 int8 operations and
    # 3.28e10 gathers, 4.728 ms by operations at the data-sheet peaks
    w = tree_gemm_cost(1_000_000, 7, 64, 256, 256, 2)
    assert w["ops"]["int8"] == 2 * 1_000_000 * 64 * 256 * 256
    assert w["ops"]["int8"] == pytest.approx(8.39e12, rel=1e-3)
    assert w["ops"]["fp32"] == pytest.approx(3.28e10, rel=1e-3)
    assert peaks.least_seconds(w["ops"], w["bytes"]) * 1e3 == \
        pytest.approx(4.728, abs=5e-4)


@pytest.mark.parametrize("ops, nbytes, want", [
    ({"fp32": 67e12}, 0.0, 1.0),              # bound by operations
    ({"int8": 1979e12, "fp32": 67e12}, 0.0, 2.0),
    ({"fp32": 1.0}, 3.35e12, 1.0),            # bound by bytes
])
def test_least_seconds_is_the_larger_bound(ops, nbytes, want):
    assert peaks.least_seconds(ops, nbytes) == pytest.approx(want)


def test_query_work_counts_the_cohort_not_the_table():
    n = 1000
    cols = {"pid": np.arange(n, dtype=np.int32),
            "age": np.arange(n, dtype=np.int32) % 90}
    expect = {"kind": "rows", "filter": [["pid", ">=", ":lo"],
                                         ["pid", "<", ":hi"]],
              "columns": {"pid": "pid", "s": "predict"}}
    ops, nbytes = work.query_work(expect, {"lo": 100, "hi": 350}, cols,
                                  "pid", ["age"], {"fp32": 512.0}, 0)
    assert ops == {"fp32": 512.0 * 250}
    # pid and age read on the 250 rows, pid and s written on them
    assert nbytes == 4 * (250 + 250 + 250 * 2)


def test_query_work_reads_a_non_key_filter_column_on_every_row():
    n = 1000
    cols = {"d": np.arange(n, dtype=np.float32), "k": np.zeros(n, np.int32)}
    expect = {"kind": "group_avg", "filter": [["proba", ">=", 0],
                                              ["d", ">=", ":d"]],
              "key": ["k", "k"], "avg": ["p", "proba"]}
    ops, nbytes = work.query_work(expect, {"d": 600.0}, cols, None,
                                  ["d"], {"fp32": 2.0}, 3)
    assert ops == {"fp32": 2.0 * 400}
    assert nbytes == 4 * (1000 + 400 + 3 * 2)


def test_forest_cost_of_equal_trees_is_tree_gemm_cost():
    a = tree_gemm_cost(1000, 7, 4, 255, 256, 2)
    b = forest_cost(1000, 7, [(255, 256)] * 4, 2)
    assert a["ops"] == b["ops"]
    assert a["bytes"] == pytest.approx(b["bytes"])


def test_reachable_skips_decided_nodes():
    # root x0 <= 0; its left child tests x0 <= 1 again (always left there)
    tree = {"feature": np.int32([0, 0, 0, 0, 0, 0, 0]),
            "threshold": np.float32([0, 1, 2, 0, 0, 0, 0]),
            "left": np.int32([1, 3, 5, -1, -1, -1, -1]),
            "right": np.int32([2, 4, 6, -1, -1, -1, -1])}
    assert tree_sizes.reachable(tree, [(-9.0, 9.0)]) == (2, 3)
    # the data never exceeds 0.5: the root's right subtree is cut too
    assert tree_sizes.reachable(tree, [(-9.0, 0.5)]) == (1, 2)
    assert tree_sizes.reachable(tree, [(-9.0, -1.0)]) == (0, 1)
