"""The control: the plain reference, computed in the precision below the
one the configuration states (bfloat16 for float32), put in the program's
place.  It answers every request of the window from the reference's
outputs, and the check that follows must find it not correct.

Given ``float32`` and ``fold``, the same class is the sound stand-in: the
reference in the configuration's own precision, its scaler folded into the
model (Raven's inlining), which a later program may rightly do.  Its
readings are the lower side of each limit beside the program's."""

from __future__ import annotations

import collections
from typing import Dict

import numpy as np

from . import layout
from ..reference import query


class Answer(dict):
    """A host answer, with the row count the harness reads off a table."""

    @property
    def capacity(self) -> int:
        return len(self["valid"])


class ControlProgram:
    loop = False                # each client thread serves itself

    def __init__(self, cfg: Dict, mix: Dict, tables: Dict[str, Dict],
                 state: Dict, device: str, dtype=None, fold: bool = False):
        import torch
        from .cell import _columns
        self.torch = torch
        self.device = torch.device(device)
        self.dtype = dtype or torch.bfloat16
        cols = _columns(tables)
        ref_mod = layout.module("reference", cfg["model"]["kind"])
        self.ref = {**cols, **ref_mod.outputs(state, cols, self.dtype,
                                              self.device, fold=fold)}

    def send(self, req, timeout: float):
        ref = self.ref
        if req.rows:
            start, count = req.rows
            n = len(next(iter(ref.values())))
            idx = np.arange(start, start + count) % n
            ref = {k: v[idx] for k, v in ref.items()}
        return Answer(query.answer(req.query["expect"], req.binding, ref,
                                   self.dtype)), None

    def stats(self) -> Dict[str, int]:
        return collections.Counter()

    def close(self) -> None:
        pass
