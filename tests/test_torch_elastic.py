"""Elastic rescaling: ``plan_rescale`` against the JAX package's, and
``rescale_state`` restoring a checkpointed train state onto meshes of 1, 2
and 4 CPU devices, every leaf cut by its logical axes under the train
rules and put back together bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.distributed.elastic import plan_rescale as jax_plan_rescale
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import (H100_80GB_HBM3_BYTES,
                                             plan_rescale, rescale_state)
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import build_model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.train_state import init_train_state
from repro_torch.train.tree import leaves, leaves_with_paths


class _JaxMesh:
    """The two attributes the JAX ``plan_rescale`` reads."""

    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))
        self.devices = type("D", (), {"size": int(torch.tensor(sizes)
                                                  .prod())})()


_MESHES = [(("data", "model"), (16, 16)), (("data", "model"), (32, 8)),
           (("pod", "data", "model"), (2, 32, 8)), (("data", "model"), (1, 1)),
           (("data",), (4,))]


@pytest.mark.parametrize("hbm", [16 * 1024 ** 3, H100_80GB_HBM3_BYTES])
@pytest.mark.parametrize("names,sizes", _MESHES)
@pytest.mark.parametrize("gib", [1, 64, 4096])
def test_plan_rescale_matches_jax(names, sizes, hbm, gib):
    n = gib * (1 << 28)                         # float32 elements
    jax_state = {"w": jax.ShapeDtypeStruct((n,), jnp.float32),
                 "s": jax.ShapeDtypeStruct((3,), jnp.bfloat16)}
    state = {"w": torch.empty((n,), device="meta"),
             "s": torch.empty((3,), dtype=torch.bfloat16, device="meta")}
    old = Mesh(("data", "model"), (2, 2))
    want = jax_plan_rescale(jax_state, _JaxMesh(old.axis_names, old.sizes),
                            _JaxMesh(names, sizes), hbm_per_device=hbm)
    got = plan_rescale(state, old, Mesh(names, sizes), hbm_per_device=hbm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()


def test_default_memory_is_the_h100s():
    state = {"w": torch.empty((20 * 10 ** 9,), device="meta")}   # 80 GB
    assert not plan_rescale(state, None, Mesh(("data",), (1,))).fits
    assert plan_rescale(state, None, Mesh(("data",), (2,))).fits
    assert H100_80GB_HBM3_BYTES == 80 * 10 ** 9


def _state_axes(model):
    axes = model.param_logical_axes()
    return {"params": axes, "opt": {"m": axes, "v": axes, "step": ()}}


@pytest.mark.parametrize("data,model_n", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_rescale_state_restores_bitwise(tmp_path, data, model_n):
    cfg = dataclasses.replace(reduced_config(get_config("granite-moe-1b-a400m")),
                              d_head=64)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    state["opt"]["step"].fill_(7)
    for x in leaves(state["opt"]["m"]):
        x.normal_(generator=torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp_path), 3, state, extra={"note": "x"})
    mesh = make_local_mesh(data, model_n, device=["cpu"] * (data * model_n))
    like = {"params": model.abstract_params(),
            "opt": {"m": model.abstract_params(),
                    "v": model.abstract_params(),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
    axes = _state_axes(model)
    placed, step, extra = rescale_state(str(tmp_path), like, mesh,
                                        logical_axes=axes)
    assert step == 3 and extra == {"note": "x"}
    rules = sharding.train_rules(mesh)
    for (path, want), (_, grid), leaf_axes in zip(
            leaves_with_paths(state), leaves_with_paths(placed),
            sharding.axes_leaves(axes)):
        spec = sharding.logical_to_pspec(leaf_axes, rules)
        assert grid.shape == mesh.sizes
        back = sharding.gather(grid, mesh, spec)
        assert back.dtype == want.dtype and torch.equal(back, want), path
    # the embedding [vocab, embed] splits over model (vocab) and data
    emb = placed["params"]["embed"][0, 0]
    vocab, d = state["params"]["embed"].shape
    assert emb.shape == (-(-vocab // model_n), -(-d // data))


def test_rescale_state_replicates_without_axes(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones(3, 4)}}
    save_checkpoint(str(tmp_path), 1, tree)
    mesh = make_local_mesh(1, 2, device=["cpu"] * 2)
    placed, _, _ = rescale_state(str(tmp_path), tree, mesh)
    for leaf, grid in zip(leaves(tree), leaves(placed)):
        assert all(torch.equal(s, leaf) for s in grid.reshape(-1))
