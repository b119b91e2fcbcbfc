"""The port's logical axes, abstract trees, input specs, sharding rules and
cells against the JAX package's, and its shard placement.

The JAX package stacks each layer's parameters on a leading ``layers``
axis where the port keeps a list of per-layer dicts (``models.convert``),
so a JAX stacked leaf ``['layers'][key]...`` with axes ``("layers",) + a``
and shape ``(L,) + s`` corresponds to the port's ``['layers'][i][key]...``
with axes ``a`` and shape ``s`` for every layer i (likewise
``enc_layers`` and ``cross_layers``).

- ``param_logical_axes`` and ``abstract_params`` (shapes, dtypes) for all
  ten configurations, leaf by leaf through that mapping.
- ``logical_to_pspec`` of every leaf under the train and the serve rules,
  on the single-pod and the multi-pod mesh, equals JAX's ``PartitionSpec``
  entries (the layer leaves without their leading None).
- ``input_specs`` (train, prefill, decode with its caches) and
  ``abstract_train_state``: the same structure, shapes and dtypes.
- ``cell_skips`` and ``runnable_cells`` equal.
- ``place``/``gather`` round-trip bitwise on meshes of 1, 2 and 4 CPU
  devices, dims that do and do not divide, one and two mesh axes a dim.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_skips as jax_cell_skips
from repro.configs import get_config as jax_get_config
from repro.configs import runnable_cells as jax_runnable_cells
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro.train.train_state import \
    abstract_train_state as jax_abstract_train_state
from repro_torch.configs import (SHAPES, cell_skips, get_config, list_archs,
                                 runnable_cells)
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import (Mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.train.train_state import abstract_train_state

_STACKED = ("layers", "enc_layers", "cross_layers")


def _jax_leaves(tree, is_leaf=None):
    """{path keys tuple: leaf} of a JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=is_leaf):
        out[tuple(getattr(p, "key", getattr(p, "idx", None))
                  for p in path)] = leaf
    return out


def _port_leaves(tree, prefix=(), is_leaf=lambda x: False):
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (k,), is_leaf))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, prefix + (i,), is_leaf))
        return out
    return {prefix: tree}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _pairs(jax_tree, port_tree, n_layers, is_leaf=None, port_leaf=None):
    """(JAX leaf, [port leaves of each layer] or [port leaf]) for every
    JAX leaf; every port leaf is used exactly once."""
    jl = _jax_leaves(jax_tree, is_leaf)
    pl = _port_leaves(port_tree, is_leaf=port_leaf or (lambda x: False))
    used = set()
    out = []
    for path, leaf in jl.items():
        if path[0] in _STACKED:
            keys = [(path[0], i) + path[1:] for i in range(n_layers[path[0]])]
        else:
            keys = [path]
        used.update(keys)
        out.append((path, leaf, [pl[k] for k in keys]))
    assert used == set(pl), set(pl) ^ used
    return out


def _models(arch):
    jm = jax_build_model(jax_get_config(arch))
    pm = build_model(get_config(arch), device="meta")
    cfg = pm.cfg
    n = {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers,
         "cross_layers": cfg.n_layers}
    return jm, pm, n


_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32, "int8": torch.int8}


@pytest.mark.parametrize("arch", list_archs())
def test_param_logical_axes_match_jax(arch):
    jm, pm, n = _models(arch)
    for path, axes, port in _pairs(jm.param_logical_axes(),
                                   pm.param_logical_axes(), n,
                                   is_leaf=_is_axes, port_leaf=_is_axes):
        want = axes[1:] if path[0] in _STACKED else axes
        if path[0] in _STACKED:
            assert axes[0] == "layers", path
        assert all(p == want for p in port), (path, want, port)


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_match_jax(arch):
    jm, pm, n = _models(arch)
    for path, sds, port in _pairs(jm.abstract_params(),
                                  pm.abstract_params(), n):
        want = sds.shape[1:] if path[0] in _STACKED else sds.shape
        for p in port:
            assert p.device.type == "meta"
            assert tuple(p.shape) == tuple(want), path
            assert p.dtype == _DT[str(sds.dtype)], path


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", list_archs())
def test_pspecs_match_jax(arch, mode, multi_pod):
    jm, pm, n = _models(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    port_rules = getattr(sharding, f"{mode}_rules")(mesh)
    jax_rules = getattr(jax_sharding, f"{mode}_rules")(mesh)
    assert port_rules == jax_rules
    want = jax_sharding.tree_pspecs(jm.param_logical_axes(), jax_rules)
    got = sharding.tree_pspecs(pm.param_logical_axes(), port_rules)
    for path, spec, port in _pairs(
            want, got, n,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec),
            port_leaf=lambda x: isinstance(x, tuple)):
        entries = tuple(spec)
        if path[0] in _STACKED:
            assert entries[0] is None
            entries = entries[1:]
        assert all(p == entries for p in port), (path, entries, port)
    placed = sharding.tree_shardings(mesh, pm.param_logical_axes(),
                                     port_rules)
    assert placed["embed"].mesh is mesh
    assert placed["embed"].spec == got["embed"]


def test_activation_specs_match_jax():
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for mode in ("train", "serve"):
            got = sharding.activation_specs(mesh, mode)
            fsdp = jax_sharding.data_axes_of(mesh)
            assert sharding.data_axes_of(mesh) == fsdp
            from jax.sharding import PartitionSpec as P
            res = P(fsdp, "model", None) if mode == "train" \
                else P(fsdp, None, None)
            assert got["residual"].spec == tuple(res)
            assert got["logits"].spec == tuple(P(fsdp, None, "model"))
            assert got["heads"] is None


def _spec_leaves(tree):
    return _port_leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_jax(arch):
    jm, pm, _ = _models(arch)
    for name, shape in SHAPES.items():
        if (arch, name) in cell_skips():
            continue
        want = _jax_leaves(jm.input_specs(JAX_SHAPES[name]))
        got = _spec_leaves(pm.input_specs(shape))
        assert set(got) == set(want), (name, set(got) ^ set(want))
        for path, sds in want.items():
            t = got[path]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(sds.shape), (name, path)
            assert t.dtype == _DT[str(sds.dtype)], (name, path)


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2"])
def test_abstract_train_state_matches_jax(arch):
    jm, pm, n = _models(arch)
    want = jax_abstract_train_state(jm)
    got = abstract_train_state(pm)
    assert got["opt"]["step"].shape == () and \
        got["opt"]["step"].dtype == torch.int32
    for part in ("params", ("opt", "m"), ("opt", "v")):
        w = want[part] if isinstance(part, str) else want[part[0]][part[1]]
        g = got[part] if isinstance(part, str) else got[part[0]][part[1]]
        for path, sds, port in _pairs(w, g, n):
            shp = sds.shape[1:] if path[0] in _STACKED else sds.shape
            for p in port:
                assert tuple(p.shape) == tuple(shp)
                assert p.dtype == _DT[str(sds.dtype)] and p.is_meta


def test_cells_match_jax():
    assert cell_skips() == jax_cell_skips()
    assert runnable_cells() == jax_runnable_cells()
    assert len(cell_skips()) == 8
    assert all("sub-quadratic" in r for r in cell_skips().values())


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("spec_of", [
    lambda d: (d, None), lambda d: (None, "model"), lambda d: (d, "model"),
    lambda d: (("data", "model"), None), lambda d: (None, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_place_then_gather_is_bitwise(n_dev, spec_of, dtype):
    data = 2 if n_dev == 4 else 1
    mesh = make_local_mesh(data, n_dev // data, device=["cpu"] * n_dev)
    assert mesh.size == n_dev
    spec = spec_of("data")
    x = torch.randn(7, 10, generator=torch.Generator().manual_seed(n_dev)) \
        .to(dtype)
    shards = sharding.place(x, mesh, spec)
    assert shards.shape == mesh.sizes
    total = sum(s.numel() for s in shards.reshape(-1))
    assert total == x.numel() * n_dev // sharding.shard_count(mesh, spec)
    back = sharding.gather(shards, mesh, spec)
    assert back.dtype == dtype and torch.equal(back, x)


def test_mesh_shapes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 32, "model": 8} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert single.devices is None and multi.size == 512
    with pytest.raises(ValueError, match="abstract"):
        sharding.place(torch.zeros(4), single, ("model",))
    local = make_local_mesh(4, 4, device=["cpu"] * 2)       # clamps
    assert local.sizes == (2, 1)
    with pytest.raises(ValueError):
        Mesh(("data",), (2,), np.empty((3,), object))
