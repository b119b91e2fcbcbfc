"""Checkpoints: atomic, versioned, restartable (the JAX package's
``train/checkpoint.py``, on the same on-disk layout).

One directory per step:

    <root>/step_000000123.tmp-<nonce>/   written, then renamed into place
    <root>/step_000000123/               (crash-safe)
        manifest.json                    tree keys, shapes, dtypes; last
        shard_000.npz ...                leaves, ~512 MB per file

Restore picks the newest *complete* step directory (the manifest, written
last, marks completeness).  ``keep_last`` prunes old checkpoints.  Leaves
are keyed by their path in the port's dict/list trees (``train.tree``).
numpy has no bfloat16: such a leaf is stored as its ``uint16`` bits with
``"bfloat16"`` as the manifest's dtype, and restored bit for bit.  The
manifest's ``process_index`` is the ``torch.distributed`` rank where a
process group is initialized, else 0.
"""

from __future__ import annotations

import json
import os
import secrets
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .tree import leaves_with_paths, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints"]

_SHARD_BYTES = 512 * 1024 * 1024


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a tensor leaf."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(root: str, step: int, tree, keep_last: int = 3,
                    extra: Optional[Dict] = None) -> str:
    root_p = Path(root)
    root_p.mkdir(parents=True, exist_ok=True)
    final = root_p / f"step_{step:09d}"
    tmp = root_p / f"step_{step:09d}.tmp-{secrets.token_hex(4)}"
    tmp.mkdir()

    manifest = {"step": step, "created": time.time(),
                "process_index": _process_index(),
                "extra": extra or {}, "leaves": [], "shards": []}
    shard: Dict[str, np.ndarray] = {}
    shard_bytes = 0
    shard_idx = 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if not shard:
            return
        fname = f"shard_{shard_idx:03d}.npz"
        np.savez(tmp / fname, **shard)
        manifest["shards"].append(fname)
        shard = {}
        shard_bytes = 0
        shard_idx += 1

    for key, leaf in leaves_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        safe = key.replace("/", "~")
        manifest["leaves"].append({
            "key": key, "shard": shard_idx, "name": safe,
            "shape": list(arr.shape), "dtype": dtype})
        shard[safe] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _SHARD_BYTES:
            flush()
    flush()
    # manifest written LAST: its presence marks a complete checkpoint
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    os.replace(tmp, final)

    if keep_last > 0:
        steps = sorted(list_checkpoints(root))
        for old in steps[:-keep_last]:
            shutil.rmtree(root_p / f"step_{old:09d}", ignore_errors=True)
    return str(final)


def list_checkpoints(root: str) -> List[int]:
    root_p = Path(root)
    if not root_p.exists():
        return []
    out = []
    for d in root_p.iterdir():
        if d.is_dir() and d.name.startswith("step_") \
                and "tmp" not in d.name and (d / "manifest.json").exists():
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = list_checkpoints(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, tree_like, step: Optional[int] = None,
                       device: Any = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` -> (tree, step, the
    manifest's ``extra``).  Each leaf keeps the checkpoint's dtype and
    goes to ``device``, or, where that is None, to the device of the
    matching leaf of ``tree_like``."""
    step = step if step is not None else latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    d = Path(root) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}
    arrays: Dict[str, np.ndarray] = {}
    for shard_name in manifest["shards"]:
        with np.load(d / shard_name) as z:
            for k in z.files:
                arrays[k] = z[k]

    out = []
    for path, like in leaves_with_paths(tree_like):
        key = path.replace("/", "~")
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(like.shape)}")
        t = torch.from_numpy(arr)
        if dtypes[key] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t.to(device if device is not None else like.device))
    return unflatten(tree_like, out), step, manifest.get("extra", {})
