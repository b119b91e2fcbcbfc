"""Cost analysis of an eager torch program: the port's counterpart of the
JAX package's ``launch/hlo_analysis.py``.

Torch has no HLO: there is no compiled program to parse.  Instead the
program runs, usually on ``meta`` tensors (shapes and dtypes, no storage),
under :class:`CostCounter`, a ``TorchDispatchMode`` that sees every aten
op it dispatches and counts:

- **flops**: by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention), split by the class of their operands (float32
  on the CUDA cores, bfloat16 or float16 or int8 on the tensor cores).
  Elementwise work is not counted, as the HLO analysis does not count it.
- **bytes**: every op's inputs plus outputs, each once (the traffic of an
  op that is not fused with its neighbours).  Views, and allocations that
  write nothing (``empty``), move nothing.  An in-place scatter into a
  buffer (``index_put_``, ``scatter_``, ``copy_`` into a slice) moves
  twice its update, not the buffer (the HLO analysis models a
  dynamic-update-slice the same way).
- **ops with no meta kernel**: ``bincount`` (the embedding gradient's
  segment sum) gets its output shape from its ``minlength``; its bytes are
  counted as any op's.
- **kernels**: the five kernel wrappers evaluate abstractly on ``meta``
  tensors and report their analytic work (``kernels.cost``), which is
  counted here and by kernel; the empty outputs they allocate count
  nothing.

Eager torch runs every layer, so unlike the HLO analysis, which scales a
``while`` body by its trip count, nothing needs scaling: the counts are
the whole program's.  Collective bytes are not seen by a single-process
run at all; ``launch.dryrun`` reckons them from the sharding rules and
the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import cost as kcost

__all__ = ["CostCounter", "Cost"]

aten = torch.ops.aten

# allocations and metadata that move no bytes
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
               aten.detach, aten.alias, aten._local_scalar_dense}
# in-place scatters: traffic is twice the update, not the buffer
_SCATTERS = {aten.index_put_, aten.index_put, aten._index_put_impl_,
             aten.scatter_, aten.index_copy_, aten.copy_,
             aten.masked_scatter_, aten.slice_scatter, aten.select_scatter}


def _bincount_meta(seg, weights=None, minlength=0):
    # The length max(seg) + 1 is data: every caller here passes
    # ``minlength`` = the segment count with ``seg`` inside it.
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.empty((minlength,), dtype=dtype, device="meta")


# ops that have no meta kernel, evaluated on meta tensors by shape rules
_META_IMPLS = {aten.bincount.default: _bincount_meta}


def _on_meta(args) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_meta
               for t in tree_leaves(args))


def _op_class(args) -> str:
    dtypes = {t.dtype for t in tree_leaves(args)
              if isinstance(t, torch.Tensor) and t.is_floating_point()}
    if torch.float32 in dtypes or torch.float64 in dtypes:
        return "fp32"
    ints = {t.dtype for t in tree_leaves(args)
            if isinstance(t, torch.Tensor)}
    return "int8" if ints & {torch.int8, torch.uint8} and not dtypes \
        else "bf16"


def _bytes(tensors) -> float:
    return float(sum(math.prod(t.shape) * t.element_size()
                     for t in tensors if isinstance(t, torch.Tensor)))


@dataclasses.dataclass
class Cost:
    """A program's counts: flops by operation class (``kernels.cost.PEAKS``
    keys), bytes moved, and per kernel wrapper its calls, flops, bytes and
    operations by class."""
    flops_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    bytes: float = 0.0
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def flops(self) -> float:
        return sum(self.flops_by_class.values())

    def compute_s(self) -> float:
        """Seconds of the counted operations at the card's peaks."""
        return sum(n / kcost.PEAKS[c] for c, n in self.flops_by_class.items())

    def memory_s(self) -> float:
        return self.bytes / kcost.PEAK_BYTES_PER_S

    def add_flops(self, cls: str, n: float) -> None:
        if n:
            self.flops_by_class[cls] = self.flops_by_class.get(cls, 0.0) + n


class CostCounter(TorchDispatchMode):
    """Count the aten ops dispatched inside ``with CostCounter() as c:``
    (``c.cost`` then holds the totals) and the kernel wrappers' reports."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._collect = None

    def _kernel(self, name: str, ops: Dict[str, float], moved: float
                ) -> None:
        for cls, n in ops.items():
            self.cost.add_flops(cls, n)
        self.cost.bytes += moved
        entry = self.cost.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "ops": {}})
        entry["calls"] += 1
        entry["flops"] += sum(ops.values())
        entry["bytes"] += moved
        for cls, n in ops.items():
            entry["ops"][cls] = entry["ops"].get(cls, 0.0) + n

    def __enter__(self):
        self._collect = kcost.collecting(self._kernel)
        self._collect.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._collect.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_IMPLS and _on_meta((args, kwargs)):
            out = _META_IMPLS[func](*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        packet = func.overloadpacket
        c = self.cost
        if packet in flop_registry:
            c.add_flops(_op_class(args),
                        float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out)))
        if func.is_view or packet in _NO_TRAFFIC:
            return out
        if packet in _SCATTERS:
            update = [a for a in tree_leaves(args[1:])
                      if isinstance(a, torch.Tensor)]
            c.bytes += 2.0 * _bytes(update)
            return out
        c.bytes += _bytes(tree_leaves((args, kwargs))) \
            + _bytes(tree_leaves(out))
        return out
