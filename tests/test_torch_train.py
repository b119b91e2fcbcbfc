"""The port's training path against the JAX package's, on the CPU.

- The schedules (WSD, cosine, constant) at every step of a run (rtol
  1e-6, with a floor of 1e-6 of the peak where the cosine cancels), and
  ``adamw_update`` over five steps on a float32 tree (dict keys, a list,
  a nested dict; clipping active), against the JAX package's: float32,
  rtol 1e-6 (XLA may contract a multiply-add where torch rounds twice).
- Three train steps of ``reduced_config(minicpm-2b)`` (``d_head`` 64)
  from the JAX package's parameters on the same ``TokenStream`` batches
  against its jitted train step: losses within rtol 1e-4, gradient norms
  within 2e-3, each leaf's parameter update within 10% relative L2 of
  JAX's (every layer computes in bfloat16, rounded at other places; AdamW
  normalizes each element's step, so an element whose gradient nearly
  cancels moves by about lr either way).
- The four tests of ``tests/test_train_loop.py``, ported: the loss drops
  and a run with an injected failure ends within 1e-4 of a clean run's
  final loss; gradient accumulation over 2 microbatches equals the whole
  batch (loss 1e-5, parameters 2e-5); a NaN loss skips the update (every
  parameter, moment and the step count bitwise unchanged); the
  compression hook runs.
- The launcher's ``main`` with ``--device cpu --reduced``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.train_state import init_train_state as jax_init_state
from repro.train.train_state import make_train_step as jax_make_step
from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.data.lm_data import TokenStream
from repro_torch.distributed.compression import compress_tree
from repro_torch.distributed.fault_tolerance import FailureInjector
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import TrainLoopConfig, train
from repro_torch.train.train_state import init_train_state, make_train_step

_SCHEDULES = [
    dict(schedule="wsd", peak_lr=3e-3, warmup_steps=7, total_steps=60,
         decay_fraction=0.2),
    dict(schedule="cosine", peak_lr=1e-3, warmup_steps=5, total_steps=50),
    dict(schedule="constant", peak_lr=2e-4),
    dict(schedule="wsd", peak_lr=1.0, warmup_steps=0, total_steps=3),
]


@pytest.mark.parametrize("kw", _SCHEDULES,
                         ids=["wsd", "cosine", "constant", "wsd_short"])
def test_schedules_match_jax(kw):
    steps = np.arange(0, 80, dtype=np.int32)
    want = np.asarray([jax_opt.schedule_fn(jax_opt.AdamWConfig(**kw))(
        jnp.asarray(s)) for s in steps], np.float32)
    fn = opt.schedule_fn(opt.AdamWConfig(**kw))
    got = np.asarray([float(fn(torch.tensor(int(s), dtype=torch.int32)))
                      for s in steps], np.float32)
    # near the cosine's end 1 + cos(pi t) cancels: an ulp of cos is 2e-5
    # of the lr there, so the floor is 1e-6 of the peak
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * kw["peak_lr"])


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "layers": [(scale * rng.standard_normal(7)).astype(np.float32)
                       for _ in range(3)],
            "b": {"c": (scale * rng.standard_normal((2, 3, 4)))
                  .astype(np.float32)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("kw", _SCHEDULES[:2], ids=["wsd", "cosine"])
def test_adamw_update_matches_jax(kw):
    rng = np.random.default_rng(4)
    cfg_kw = dict(kw, weight_decay=0.1, clip_norm=1.0)
    params = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_opt.adamw_init(jp)
    tp = _to_torch(params)
    tstate = opt.adamw_init(tp)
    for step in range(5):
        grads = _tree(rng, scale=0.5 + step)       # norms past the clip
        jp, jstate = jax_opt.adamw_update(jax_opt.AdamWConfig(**cfg_kw), jp,
                                          jax.tree_util.tree_map(
                                              jnp.asarray, grads), jstate)
        tg = _to_torch(grads)
        before = copy.deepcopy(tg)
        out_p, out_s = opt.adamw_update(opt.AdamWConfig(**cfg_kw), tp, tg,
                                        tstate)
        assert out_p is tp and out_s is tstate            # in place
        for a, b in zip(jax.tree_util.tree_leaves(before),
                        jax.tree_util.tree_leaves(tg)):
            assert torch.equal(a, b)                      # grads untouched
        np.testing.assert_allclose(
            float(opt.global_norm(tg)),
            float(jax_opt.global_norm(grads)), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    for tree_j, tree_t in ((jp, tp), (jstate["m"], tstate["m"]),
                           (jstate["v"], tstate["v"])):
        for a, b in zip(jax.tree_util.tree_leaves(tree_j),
                        jax.tree_util.tree_leaves(tree_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)


def _tiny():
    cfg = dataclasses.replace(reduced_config(get_config("minicpm-2b")),
                              d_head=64)
    return cfg, build_model(cfg, device="cpu")


def test_three_train_steps_match_jax():
    cfg, model = _tiny()
    jcfg = dataclasses.replace(
        jax_reduced_config(jax_get_config("minicpm-2b")), d_head=64)
    jmodel = jax_build_model(jcfg, remat=False)
    jstate = jax_init_state(jmodel, jax.random.PRNGKey(0))
    start = jax.tree_util.tree_map(np.asarray, jstate["params"])
    params = lm_params_from_numpy(cfg, start, device="cpu")
    state = {"params": params, "opt": opt.adamw_init(params)}
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=10, schedule="wsd")
    jstep = jax.jit(jax_make_step(jmodel, jax_opt.AdamWConfig(**kw)))
    step = make_train_step(model, opt.AdamWConfig(**kw))
    stream = TokenStream(cfg.vocab_size, 24, 4, seed=3)
    for i in range(3):
        batch = stream.batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-3)
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
    assert int(state["opt"]["step"]) == 3
    got = dict(jax.tree_util.tree_leaves_with_path(
        lm_params_to_numpy(state["params"])))
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jstate["params"])):
        p0 = dict(jax.tree_util.tree_leaves_with_path(start))[path]
        rel = np.linalg.norm((got[path] - p0) - (w - p0)) \
            / np.linalg.norm(w - p0)
        assert rel < 0.1, (jax.tree_util.keystr(path), rel)


def test_loss_drops_and_restart_exact(tmp_path):
    cfg, model = _tiny()
    shape = ShapeConfig("t", "train", 24, 4)
    loop = TrainLoopConfig(n_steps=14, ckpt_root=str(tmp_path / "a"),
                           ckpt_every=5, log_every=7,
                           opt=opt.AdamWConfig(peak_lr=3e-3, warmup_steps=3,
                                               total_steps=14))
    clean = train(model, shape, loop)
    assert clean["restarts"] == 0
    l0, l1 = clean["losses"][0][1], clean["losses"][-1][1]
    assert l1 < l0
    loop2 = dataclasses.replace(loop, ckpt_root=str(tmp_path / "b"))
    injector = FailureInjector(fail_at=8)
    crashy = train(model, shape, loop2, injector=injector)
    assert crashy["restarts"] == 1 and injector.failures_seen == 1
    assert crashy["resumed_from"] == [5]
    # determinism across the crash: identical final loss
    assert abs(clean["losses"][-1][1] - crashy["losses"][-1][1]) < 1e-4


def _copy_state(state):
    return {"params": copy.deepcopy(state["params"]),
            "opt": copy.deepcopy(state["opt"])}


def test_grad_accum_equivalent():
    cfg, model = _tiny()
    stream = TokenStream(cfg.vocab_size, 16, 4, seed=1)
    batch = stream.batch(0)
    adamw = opt.AdamWConfig(peak_lr=1e-3)
    state1 = init_train_state(model, torch.Generator().manual_seed(0))
    state2 = _copy_state(state1)
    s1, m1 = make_train_step(model, adamw, grad_accum=1)(state1, batch)
    s2, m2 = make_train_step(model, adamw, grad_accum=2)(state2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s1["params"]),
                    jax.tree_util.tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_nan_batch_skipped():
    cfg, model = _tiny()
    state = init_train_state(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, opt.AdamWConfig(peak_lr=1e-3))
    bad = {"tokens": np.zeros((2, 16), np.int32)}
    # poison the params' embed so the loss is NaN
    poisoned = {"params": dict(state["params"],
                               embed=state["params"]["embed"] * np.nan),
                "opt": state["opt"]}
    before = _copy_state(poisoned)
    new_state, metrics = step(poisoned, bad)
    assert int(metrics["skipped"]) == 1
    assert not np.isfinite(float(metrics["loss"]))
    # parameters, moments and step count unchanged (the skip kept them)
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(new_state)):
        assert torch.equal(a, b) or (torch.isnan(a).all()
                                     and torch.isnan(b).all())
    assert int(new_state["opt"]["step"]) == 0
    # without the skip the NaN step goes through
    unguarded = make_train_step(model, opt.AdamWConfig(peak_lr=1e-3),
                                skip_nonfinite=False)
    after, metrics = unguarded(before, bad)
    assert int(metrics["skipped"]) == 0 and int(after["opt"]["step"]) == 1
    assert torch.isnan(after["params"]["final_norm"]).all()


def test_compression_hook_runs():
    cfg, model = _tiny()
    state = init_train_state(model, torch.Generator().manual_seed(0))
    batch = TokenStream(cfg.vocab_size, 16, 2, seed=2).batch(0)
    step = make_train_step(model, opt.AdamWConfig(peak_lr=1e-3),
                           compress_grads=compress_tree)
    new_state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(metrics["skipped"]) == 0
    assert int(new_state["opt"]["step"]) == 1


def test_launcher_trains_reduced_on_the_cpu(tmp_path, capsys):
    stats = launcher.main(["--arch", "minicpm-2b", "--reduced", "--steps",
                           "12", "--seq-len", "24", "--batch", "4",
                           "--ckpt", str(tmp_path), "--device", "cpu"])
    assert stats["steps_run"] == 12 and stats["restarts"] == 0
    (s0, l0), (s1, l1) = stats["losses"]
    assert (s0, s1) == (10, 12) and l1 < l0
    assert "done: 12 steps, 0 restarts" in capsys.readouterr().out
    assert (tmp_path / "step_000000012" / "manifest.json").exists()


def test_launcher_runs_on_the_card_or_raises(tmp_path):
    argv = ["--arch", "minicpm-2b", "--reduced", "--steps", "1",
            "--seq-len", "16", "--batch", "2", "--ckpt", str(tmp_path)]
    if torch.cuda.is_available():
        assert launcher.main(argv)["steps_run"] == 1
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launcher.main(argv)
