"""Logical-axis -> mesh-axis sharding rules (the JAX package's
``distributed/sharding.py``, MaxText-style).

Parameters carry logical axes (``embed``, ``heads``, ``kv``, ``mlp``,
``vocab``, ``expert``; ``models.layers``); a rule table maps them onto a
mesh's axes per workload:

- **train**: FSDP (ZeRO-3) x TP: ``embed`` shards over the data axes,
  ``heads/kv/mlp/vocab/expert`` over ``model``.  Activations: batch over
  the data axes, sequence over ``model`` between blocks (Megatron sequence
  parallelism).
- **serve**: TP only: weights replicated over the data axes, batch over
  them, the KV cache's sequence over ``model``.

A spec is a plain tuple with the entries of the JAX package's
``PartitionSpec``: per dim None (replicated), a mesh axis name, or a tuple
of names (the dim split over their product, row-major).  A placement is a
``(mesh, spec)`` pair, the counterpart of ``NamedSharding``.  ``place``
cuts a tensor into one shard per device of a real mesh along its spec and
``gather`` puts the shards back together, bit for bit.  The port keeps
layers as per-layer lists where JAX stacks them, so a per-layer leaf's
spec is the JAX stacked leaf's without its leading ``layers`` entry (the
rules map ``layers`` to None).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh

__all__ = ["Rules", "Spec", "Placement", "train_rules", "serve_rules",
           "logical_to_pspec", "tree_pspecs", "tree_shardings",
           "activation_specs", "data_axes_of", "place", "gather",
           "shard_count", "entry_axes", "axes_leaves"]

Rules = Dict[str, Any]
Spec = Tuple[Any, ...]


class Placement(NamedTuple):
    """Where a tensor lives: a mesh and its spec (``NamedSharding``)."""
    mesh: Mesh
    spec: Spec


def data_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def train_rules(mesh: Mesh) -> Rules:
    fsdp = data_axes_of(mesh)
    return {"layers": None, "vocab": "model", "embed": fsdp,
            "heads": "model", "kv": "model", "mlp": "model",
            "expert": "model"}


def serve_rules(mesh: Mesh) -> Rules:
    return {"layers": None, "vocab": "model", "embed": None,
            "heads": "model", "kv": "model", "mlp": "model",
            "expert": "model"}


def _entry(ent):
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis is
    that axis, an empty one None."""
    if isinstance(ent, (tuple, list)):
        ent = tuple(ent)
        return None if not ent else ent[0] if len(ent) == 1 else ent
    return ent


def logical_to_pspec(axes: Tuple[Optional[str], ...], rules: Rules,
                     shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """One parameter's logical axes -> its spec.  ``shape`` is accepted
    for the JAX package's signature and, as there, changes nothing."""
    return tuple(_entry(rules.get(ax)) if ax is not None else None
                 for ax in axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map_axes(tree, fn):
    """``fn`` on every logical-axes tuple of a dict/list tree."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(v, fn) for k, v in tree.items()}
    return [_map_axes(v, fn) for v in tree]


def axes_leaves(tree) -> list:
    """The logical-axes tuples of a tree in ``train.tree``'s leaf order
    (dict keys sorted, lists in order), so they zip with the leaves of the
    tree they describe."""
    if _is_axes(tree):
        return [tree]
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    return [a for k in keys for a in axes_leaves(tree[k])]


def tree_pspecs(logical_axes_tree, rules: Rules):
    return _map_axes(logical_axes_tree,
                     lambda axes: logical_to_pspec(axes, rules))


def tree_shardings(mesh: Mesh, logical_axes_tree, rules: Rules):
    """Every leaf's :class:`Placement` on ``mesh``."""
    return _map_axes(logical_axes_tree, lambda axes: Placement(
        mesh, logical_to_pspec(axes, rules)))


def activation_specs(mesh: Mesh, mode: str) -> Dict[str, Any]:
    """The activation placements of the JAX package's model:

    train: residual [B,S,D] -> (data axes, model, -) sequence parallelism;
           logits [B,S,V] -> (data axes, -, model); heads left to the
           projections (head counts like Hymba's 25 need not divide model).
    serve: residual batch over the data axes only (S = 1 for decode)."""
    fsdp = data_axes_of(mesh)
    data = _entry(fsdp)
    residual = (data, "model", None) if mode == "train" \
        else (data, None, None)
    return {"residual": Placement(mesh, residual), "heads": None,
            "logits": Placement(mesh, (data, None, "model"))}


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry splits its dim over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_count(mesh: Mesh, spec: Spec) -> int:
    """How many distinct shards a spec cuts a tensor into on ``mesh``."""
    n = 1
    for entry in spec:
        for a in entry_axes(entry):
            n *= mesh.shape[a]
    return n


def _block(mesh: Mesh, spec: Spec, coord: Dict[str, int]) -> Tuple:
    """The block index, per dim, that the device at ``coord`` holds."""
    out = []
    for entry in spec:
        idx = 0
        for a in entry_axes(entry):
            idx = idx * mesh.shape[a] + coord[a]
        out.append(idx)
    return tuple(out)


def _parts(mesh: Mesh, spec: Spec) -> Tuple[int, ...]:
    return tuple(shard_count(mesh, (entry,)) for entry in spec)


def place(x: torch.Tensor, mesh: Mesh, spec: Spec) -> np.ndarray:
    """``x`` cut along ``spec`` on a real mesh: an object array of the
    mesh's shape whose entry at each device is that device's shard (a
    dim that does not divide is cut as ``torch.tensor_split`` cuts it)."""
    if len(spec) != x.dim():
        raise ValueError(f"place: spec {spec} for a {x.dim()}-dim tensor")
    if mesh.devices is None:
        raise ValueError("place: an abstract mesh holds no devices")
    parts = _parts(mesh, spec)
    out = np.empty(mesh.sizes, dtype=object)
    for pos in itertools.product(*(range(n) for n in mesh.sizes)):
        coord = dict(zip(mesh.axis_names, pos))
        shard = x
        for dim, (blk, n) in enumerate(zip(_block(mesh, spec, coord),
                                           parts)):
            if n > 1:
                shard = torch.tensor_split(shard, n, dim=dim)[blk]
        out[pos] = shard.to(mesh.devices[pos], copy=True)
    return out


def gather(shards: np.ndarray, mesh: Mesh, spec: Spec,
           device: Any = None) -> torch.Tensor:
    """The tensor that ``place`` cut, from its shards, on ``device``
    (default: the first device's)."""
    parts = _parts(mesh, spec)
    blocks: Dict[Tuple, torch.Tensor] = {}
    for pos in itertools.product(*(range(n) for n in mesh.sizes)):
        blk = _block(mesh, spec, dict(zip(mesh.axis_names, pos)))
        blocks.setdefault(blk, shards[pos])
    device = device if device is not None else shards.reshape(-1)[0].device

    def join(prefix: Tuple[int, ...]) -> torch.Tensor:
        dim = len(prefix)
        if dim == len(parts):
            return blocks[prefix].to(device)
        pieces = [join(prefix + (i,)) for i in range(parts[dim])]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)
    return join(())
