"""The port's checkpoints, restart supervision, gradient compression and
token stream, on the CPU: the checkpoint, fault-tolerance, compression,
data and schedule tests of ``tests/test_distributed.py`` ported, plus

- ``TokenStream`` batches bitwise equal to the JAX package's for the same
  (seed, step), extra specs included, and ``PrefetchIterator`` handing out
  the same batches (as tensors on a device where one is given);
- the int8 quantizer bitwise equal to the JAX package's;
- a bfloat16 leaf stored as its uint16 bits and restored bit for bit;
- a crash before the rename leaving no complete step behind.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm_data import TokenStream as JaxTokenStream
from repro.distributed import compression as jax_compression
from repro_torch.data.lm_data import PrefetchIterator, TokenStream
from repro_torch.distributed.compression import (
    compress_tree, dequantize_int8, make_error_feedback_compressor,
    quantize_int8)
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     RestartableRunner)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import (latest_step, list_checkpoints,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import AdamWConfig, wsd_schedule
from repro_torch.train.tree import leaves


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4)), "step": torch.tensor(7)},
            "layers": [torch.full((2,), 3.0), torch.zeros((1, 2))]}
    save_checkpoint(str(tmp_path), 5, tree, extra={"note": "x"})
    got, step, extra = restore_checkpoint(str(tmp_path), tree)
    assert step == 5 and extra == {"note": "x"}
    assert isinstance(got["layers"], list) and len(got["layers"]) == 2
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_000000005" / "manifest.json")
                          .read_text())
    assert manifest["process_index"] == 0
    assert [leaf["key"] for leaf in manifest["leaves"]] == [
        "['a']", "['b']['c']", "['b']['step']", "['layers'][0]",
        "['layers'][1]"]


def test_checkpoint_keep_last(tmp_path):
    tree = {"w": torch.zeros((4,))}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep_last=2)
    assert list_checkpoints(str(tmp_path)) == [4, 5]
    assert latest_step(str(tmp_path)) == 5


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros((5,))})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"v": torch.zeros((4,))})


def test_bfloat16_leaf_round_trips_bitwise(tmp_path):
    x = torch.randn((5, 7), generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    x[0, 0] = float("nan")
    x[0, 1] = float("-inf")
    save_checkpoint(str(tmp_path), 3, {"x": x, "f": torch.ones(2)})
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json")
                          .read_text())
    assert {leaf["key"]: leaf["dtype"] for leaf in manifest["leaves"]} \
        == {"['x']": "bfloat16", "['f']": "float32"}
    got, _, _ = restore_checkpoint(str(tmp_path), {"x": x, "f": x[0, :2]},
                                   device="cpu")
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_crash_before_rename_leaves_no_complete_step(tmp_path, monkeypatch):
    tree = {"w": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 1, tree)

    def crash(src, dst):
        raise OSError("crash before the rename")

    monkeypatch.setattr(ckpt.os, "replace", crash)
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 2, {"w": torch.arange(4.0) + 1})
    monkeypatch.undo()
    assert list_checkpoints(str(tmp_path)) == [1]
    leftovers = [p.name for p in Path(tmp_path).iterdir()]
    assert any(".tmp-" in name for name in leftovers)   # the partial dir
    got, step, _ = restore_checkpoint(str(tmp_path), tree)
    assert step == 1 and torch.equal(got["w"], tree["w"])


def test_restart_exactly_once(tmp_path):
    """After an injected failure the runner resumes from the checkpoint and
    the final state equals an uninterrupted run (determinism)."""

    def init():
        return {"x": torch.tensor(0.0), "hist": torch.zeros((30,))}

    def step(state, i):
        hist = state["hist"].clone()
        hist[i] = i
        return {"x": state["x"] + i, "hist": hist}, {"i": i}

    def run(runner, injector):
        final = {}

        def stepper(state, i):
            s2, m = step(state, i)
            final["state"] = s2
            return s2, m
        stats = runner.run(init, stepper, 23, injector=injector)
        return final["state"], stats

    clean, stats_a = run(RestartableRunner(str(tmp_path / "a"),
                                           ckpt_every=5), None)
    inj = FailureInjector(fail_at=13)
    crashy, stats_b = run(RestartableRunner(str(tmp_path / "b"),
                                            ckpt_every=5), inj)
    assert inj.failures_seen == 1
    assert stats_a["restarts"] == 0 and stats_b["restarts"] == 1
    assert stats_b["resumed_from"] == [10] and stats_b["final_step"] == 23
    assert torch.equal(clean["x"], crashy["x"])
    assert torch.equal(clean["hist"], crashy["hist"])


def test_runner_gives_up_after_max_restarts(tmp_path):
    runner = RestartableRunner(str(tmp_path), ckpt_every=1, max_restarts=2)
    inj = FailureInjector(fail_at=1, n_failures=5)
    with pytest.raises(RuntimeError, match="injected"):
        runner.run(lambda: {"x": torch.zeros(1)},
                   lambda s, i: (s, {}), 4, injector=inj)
    assert inj.failures_seen == 3


def test_quantize_int8_bounds_error():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,)) * 3)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_quantize_int8_matches_jax_bitwise():
    x = (np.random.default_rng(5).normal(size=(257,)) * 2).astype(np.float32)
    x[:4] = [0.5, -1.5, 2.5, 0.0]      # halves: round to even in both
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_compression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jax_compression.dequantize_int8(
                                      jq, js)))


def test_error_feedback_converges():
    """With error feedback the accumulated compressed gradient tracks the
    accumulated true gradient (the residual stays bounded)."""
    comp = make_error_feedback_compressor()
    rng = np.random.default_rng(1)
    total_true = np.zeros(50)
    total_sent = np.zeros(50)
    residual = None
    for _ in range(30):
        g = {"w": torch.from_numpy(rng.normal(size=50) * 0.1).float()}
        sent, residual = comp(g, residual)
        total_true += g["w"].numpy()
        total_sent += sent["w"].numpy()
    drift = np.abs(total_true - total_sent).max()
    res = residual["w"].abs().max().item()
    assert drift <= res + 1e-5    # drift equals the current residual


def test_compress_tree_small_relative_error():
    g = {"a": torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, 64))), "b": [torch.ones(3, dtype=torch.bfloat16)]}
    out = compress_tree(g)
    rel = (out["a"] - g["a"]).abs().max() / g["a"].abs().max()
    assert float(rel) < 0.01
    assert out["a"].dtype == torch.float64
    assert out["b"][0].dtype == torch.bfloat16


def test_token_stream_deterministic_and_seekable():
    s1 = TokenStream(1000, 32, 4, seed=9)
    s2 = TokenStream(1000, 32, 4, seed=9)
    np.testing.assert_array_equal(s1.batch(17)["tokens"],
                                  s2.batch(17)["tokens"])
    assert not np.array_equal(s1.batch(17)["tokens"],
                              s1.batch(18)["tokens"])


@pytest.mark.parametrize("seed,step", [(0, 0), (9, 17), (3, 2 ** 33 + 5)])
def test_token_stream_bitwise_equals_jax(seed, step):
    specs = {"patch_embeds": ((3, 8), np.float32),
             "src_embeds": ((5, 8), np.float32)}
    ours = TokenStream(122_753, 64, 3, seed=seed, extra_specs=specs)
    theirs = JaxTokenStream(122_753, 64, 3, seed=seed, extra_specs=specs)
    a, b = ours.batch(step), theirs.batch(step)
    assert list(a) == list(b) == ["tokens", "patch_embeds", "src_embeds"]
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert a["tokens"].dtype == np.int32
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 122_753


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_iterator_hands_out_the_stream(device):
    stream = TokenStream(500, 16, 2, seed=4,
                         extra_specs={"x": ((2,), np.float32)})
    it = PrefetchIterator(stream, start_step=3, depth=2, device=device)
    try:
        for want_step in (3, 4, 5, 6):
            step, batch = next(it)
            assert step == want_step
            for k, v in stream.batch(step).items():
                got = batch[k]
                if device is not None:
                    assert isinstance(got, torch.Tensor)
                    assert got.device.type == device
                    got = got.numpy()
                np.testing.assert_array_equal(got, v)
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_wsd_schedule_shape():
    cfg = AdamWConfig(peak_lr=1.0, schedule="wsd", warmup_steps=10,
                      total_steps=100, decay_fraction=0.2)
    lrs = [float(wsd_schedule(cfg, torch.tensor(s))) for s in
           (0, 5, 10, 50, 79, 90, 100)]
    assert lrs[1] < lrs[2]            # warmup rising
    assert lrs[2] == lrs[3] == 1.0    # stable plateau at peak
    assert lrs[4] == 1.0              # still stable just before decay
    assert lrs[5] < 1.0 and lrs[6] < lrs[5]   # decaying
