"""Elastic scaling: reshard any checkpoint onto any mesh (the JAX
package's ``distributed/elastic.py``).

Checkpoints store whole (unsharded) leaves (``train.checkpoint``), so going
from N devices to M is: build the new mesh, derive each leaf's placement
from the same logical-axis rules, restore, and cut every leaf into the new
mesh's shards.  ``plan_rescale`` checks capacity (does the fully sharded
state still fit a device?) and the batch split; ``rescale_state`` does the
move.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from ..launch.mesh import Mesh
from ..train.checkpoint import restore_checkpoint
from ..train.tree import leaves, unflatten
from .sharding import axes_leaves, logical_to_pspec, place, train_rules

__all__ = ["RescalePlan", "plan_rescale", "rescale_state",
           "H100_80GB_HBM3_BYTES"]

# Device memory of one NVIDIA H100 80GB HBM3 (SXM5): 80 GB (data sheet).
H100_80GB_HBM3_BYTES = 80 * 10 ** 9


@dataclasses.dataclass
class RescalePlan:
    old_devices: int
    new_devices: int
    bytes_per_device: int
    fits: bool
    global_batch_multiple: int     # new data-parallel degree

    def summary(self) -> str:
        return (f"rescale {self.old_devices} -> {self.new_devices} devices; "
                f"{self.bytes_per_device/1e9:.2f} GB/device "
                f"({'fits' if self.fits else 'DOES NOT FIT'}); "
                f"global batch must divide {self.global_batch_multiple}")


def _tree_bytes(tree_like) -> int:
    return sum(math.prod(x.shape) * x.element_size()
               for x in leaves(tree_like))


def plan_rescale(state_like, old_mesh: Optional[Mesh], new_mesh: Mesh,
                 hbm_per_device: int = H100_80GB_HBM3_BYTES) -> RescalePlan:
    """Capacity and batch plan of moving ``state_like`` (tensors, ``meta``
    ones included) onto ``new_mesh``, fully sharded (FSDP x TP)."""
    total = _tree_bytes(state_like)
    new_n = new_mesh.size
    per_dev = total // new_n
    data_par = 1
    for a in ("pod", "data"):
        if a in new_mesh.shape:
            data_par *= new_mesh.shape[a]
    return RescalePlan(
        old_devices=old_mesh.size if old_mesh is not None else 0,
        new_devices=new_n,
        bytes_per_device=per_dev,
        fits=per_dev < hbm_per_device * 0.9,
        global_batch_multiple=data_par,
    )


def rescale_state(ckpt_root: str, state_like, new_mesh: Mesh,
                  logical_axes=None, rules: Optional[Dict] = None,
                  step: Optional[int] = None):
    """Restore a checkpoint cut onto ``new_mesh`` -> (tree of shard grids,
    step, the manifest's ``extra``).  Each leaf of ``state_like`` (any
    device, ``meta`` included: only its shape is read) is restored on the
    host and placed with its logical axes from ``logical_axes`` (a tree of
    axes tuples in ``state_like``'s structure; None replicates every leaf)
    under ``rules`` (default: the train rules): every entry of a leaf's
    grid is that device's shard, a copy on it.  Works for scaling up and
    down; all movement is host restore plus copies to the devices."""
    rules = rules if rules is not None else train_rules(new_mesh)
    host, step, extra = restore_checkpoint(ckpt_root, state_like, step,
                                           device="cpu")
    flat = leaves(host)
    axes = axes_leaves(logical_axes) if logical_axes is not None \
        else [(None,) * leaf.dim() for leaf in flat]
    if len(axes) != len(flat):
        raise ValueError(f"rescale_state: {len(axes)} axes tuples for "
                         f"{len(flat)} leaves")
    return unflatten(state_like, [
        place(leaf, new_mesh, logical_to_pspec(a, rules))
        for leaf, a in zip(flat, axes)]), step, extra
