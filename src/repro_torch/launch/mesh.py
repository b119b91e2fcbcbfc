"""Device meshes (the JAX package's ``launch/mesh.py``).

A :class:`Mesh` names its axes, gives each a size and, where it is real,
holds a grid of ``torch.device``s of that shape: the device list that
``serve.sharded`` and ``models.moe``'s expert-parallel paths place shards
on, one process driving every card.  An abstract mesh (``devices`` None)
has only the sizes: torch has no placeholder devices, so the dry-run
reckons a production mesh's costs from its sizes alone.

Production layout on H100 cards: 256 cards as (data=32, model=8) and two
such pods as (pod=2, data=32, model=8).  The model axis stays inside one
8-card NVLink domain (an HGX H100 host) and the data axes cross hosts over
InfiniBand.  The JAX package lays its 256 TPU chips out as (16, 16), the
shape of a TPU torus; that shape would put tensor-parallel collectives on
the slower inter-host links here.

Nothing here is built at import: each mesh is made by a function call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh",
           "make_data_mesh", "PRODUCTION_SHAPE"]

# (data, model) of one pod; the multi-pod mesh prepends pod=2.
PRODUCTION_SHAPE = (32, 8)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, and (unless abstract) an object array of
    ``torch.device``s of that shape."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[np.ndarray] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"Mesh: axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices is not None \
                and tuple(self.devices.shape) != tuple(self.sizes):
            raise ValueError(f"Mesh: a device grid of shape "
                             f"{self.devices.shape} for sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _grid(devices: Sequence[Any], sizes: Tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return grid.reshape(sizes)


def _local_devices(device: Any) -> list:
    """The cards (``device`` cuda; at least one must exist) or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to build a CPU mesh")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh: (data=32, model=8), or with
    ``multi_pod`` (pod=2, data=32, model=8).  No devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2,) + PRODUCTION_SHAPE)
    return Mesh(("data", "model"), PRODUCTION_SHAPE)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: Any = "cuda") -> Mesh:
    """A (data, model) mesh over the local devices: the cards (the
    default; raises without one) or, with ``device="cpu"``, the CPU.  As in
    the JAX package the sizes clamp to what exists; a list of devices
    given as ``device`` is taken as it is (tests pass the CPU several
    times to stand for several cards)."""
    local = [torch.device(d) for d in device] \
        if isinstance(device, (list, tuple)) else _local_devices(device)
    n = len(local)
    data = max(1, min(data, n))
    model = max(1, min(model, n // data))
    return Mesh(("data", "model"), (data, model),
                _grid(local[:data * model], (data, model)))


def make_data_mesh(devices: Any = 0, device: Any = "cuda") -> Mesh:
    """A 1-D data-parallel mesh, on the device list ``serve.sharded``
    takes: ``devices=0`` (or None) every local device, an int clamps to
    what exists, a list of devices is taken as it is."""
    if isinstance(devices, (list, tuple)):
        local = [torch.device(d) for d in devices]
    else:
        found = _local_devices(device)
        n = len(found) if devices in (0, None) \
            else max(1, min(int(devices), len(found)))
        local = found[:n]
    return Mesh(("data",), (len(local),), _grid(local, (len(local),)))
