"""The work of one ``tree_gemm`` call, frozen from the program's
``kernels/cost.py`` ``tree_gemm_cost``.

2 N T I L int8 tensor-core operations (S = gates . c) and N T (I + L)
float32 gathers and compares; x read once, the operands (int8 c, int32 d
and feat, float32 b and e) once, the output written once.  N rows, F
features, T trees, I internal nodes and L leaves a tree, O outputs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def tree_gemm_cost(n: int, f: int, t: int, i: int, l: int, o: int
                   ) -> Dict[str, object]:
    return {"ops": {"int8": 2.0 * n * t * i * l,
                    "fp32": 1.0 * n * t * (i + l)},
            "bytes": 4.0 * n * f + t * i * l
            + 4.0 * t * (l + 2 * i + l * o) + 4.0 * n * o}


def forest_cost(n: int, f: int, sizes: Sequence[Tuple[int, int]], o: int
                ) -> Dict[str, object]:
    """``tree_gemm_cost`` of a forest whose trees differ in size: ``sizes``
    holds each tree's (internal nodes, leaves); x is read once and the
    output written once for the whole forest."""
    ops = {"int8": 0.0, "fp32": 0.0}
    nbytes = 4.0 * n * f + 4.0 * n * o
    for i, l in sizes:
        w = tree_gemm_cost(n, 0, 1, i, l, 0)
        ops["int8"] += w["ops"]["int8"]
        ops["fp32"] += w["ops"]["fp32"]
        nbytes += w["bytes"] + 4.0 * l * o         # + the leaves' e
    return {"ops": ops, "bytes": nbytes}
