"""A tree's own size: the internal nodes and leaves a row can reach.

A node whose test always goes one way, given its ancestors' tests and the
range of each feature over the data, is no work: its subtree is its
reachable child's.  Bounds are closed intervals [lo, hi] of the feature; a
node ``x <= t`` is decided left when hi <= t and right when lo > t.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def reachable(tree: Dict, bounds: Sequence[Tuple[float, float]]
              ) -> Tuple[int, int]:
    """(internal nodes, leaves) of ``tree`` (plain arrays ``feature``,
    ``threshold``, ``left``, ``right``) that rows within ``bounds`` reach,
    counting only nodes whose test can go either way."""
    feature, threshold = tree["feature"], tree["threshold"]
    left, right = tree["left"], tree["right"]
    internal = leaves = 0
    stack = [(0, tuple(tuple(b) for b in bounds))]
    while stack:
        node, bnd = stack.pop()
        if left[node] < 0:
            leaves += 1
            continue
        f, t = int(feature[node]), float(threshold[node])
        lo, hi = bnd[f]
        if hi <= t:
            stack.append((int(left[node]), bnd))
        elif lo > t:
            stack.append((int(right[node]), bnd))
        else:
            internal += 1
            lb = list(bnd)
            lb[f] = (lo, t)
            rb = list(bnd)
            rb[f] = (float(np.nextafter(np.float32(t), np.float32(np.inf))),
                     hi)
            stack.append((int(left[node]), tuple(lb)))
            stack.append((int(right[node]), tuple(rb)))
    return internal, leaves
