"""Carry LM parameters between the JAX package and the port.

The JAX package keeps a nested dict of arrays whose ``"layers"`` entry
(and the encoder-decoder's ``"enc_layers"`` and ``"cross_layers"``)
stacks every per-layer parameter on a leading ``[L, ...]`` axis; the port
keeps each as a list of L per-layer dicts.  Every other leaf (``enc_norm``
among them) and the MoE's ``[E, ...]`` expert weights inside a layer pass
as they are.  Values pass through unchanged (float32 stays float32), so a
round trip is bitwise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..relational.table import resolve_device
from .layers import ParamDef
from .transformer import build_model

__all__ = ["lm_params_from_numpy", "lm_params_to_numpy"]

_STACKED = ("layers", "enc_layers", "cross_layers")


def _check_shapes(tpl, tree, path: str) -> None:
    if isinstance(tpl, ParamDef):
        if tuple(tree.shape) != tpl.shape:
            raise ValueError(f"{path}: shape {tuple(tree.shape)}, the model "
                             f"expects {tpl.shape}")
        return
    if isinstance(tpl, dict):
        if set(tree) != set(tpl):
            raise ValueError(f"{path}: keys {sorted(tree)}, the model "
                             f"expects {sorted(tpl)}")
        for k in tpl:
            _check_shapes(tpl[k], tree[k], f"{path}/{k}")
        return
    if len(tree) != len(tpl):
        raise ValueError(f"{path}: {len(tree)} layers, the model expects "
                         f"{len(tpl)}")
    for i, (t, x) in enumerate(zip(tpl, tree)):
        _check_shapes(t, x, f"{path}/{i}")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return np.stack(layers)


def lm_params_from_numpy(cfg, tree: Dict[str, Any],
                         device: Any = None) -> Dict[str, Any]:
    """The JAX package's LM parameters (nested dict of numpy arrays, layers
    stacked on axis 0) -> the port's, as tensors on ``device`` (``None``
    means the card, and raises without one; pass ``device="cpu"`` for the
    CPU)."""
    device = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a)).to(device)

    out = _map({k: v for k, v in tree.items() if k not in _STACKED}, put)
    for key in _STACKED:
        if key not in tree:
            continue
        leaf = tree[key]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        out[key] = [_map(_unstack(tree[key], i), put)
                    for i in range(np.shape(leaf)[0])]
    _check_shapes(build_model(cfg, device="cpu").param_template(), out,
                  "params")
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16: widen it (exactly) to float32
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters -> the JAX package's layout (numpy, layers
    stacked on axis 0)."""
    out = _map({k: v for k, v in params.items() if k not in _STACKED},
               _host)
    for key in _STACKED:
        if key in params:
            out[key] = _stack([_map(lp, _host) for lp in params[key]])
    return out
