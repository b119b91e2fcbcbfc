"""The port's hand-written CUDA kernels (tree GEMM, the featurized linear
scorer, flash attention with its log-sum-exp, decode attention, the WKV6
and SSD scans) against their plain torch versions, on the card, and the
training path over them (the flash VJP, remat's launches, a repeatable
step, the scan wrappers refusing a gradient when called directly, the
scans' autograd Functions, RWKV-6 and Hymba train steps) and the
wrappers' abstract ``meta`` route. A CUDA kernel
has no CPU mode, so every test here carries the ``cuda`` marker and skips
(inside a fixture) where no card is present. The file imports no JAX, so it
runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.decode_attention import \
    split_layout
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.featurized_linear import ops as fl_ops
from repro_torch.kernels.featurized_linear.ref import featurized_linear_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_with_lse_ref)
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.tree_gemm import ops as tg_ops
from repro_torch.ml import RandomForest, ensemble_to_gemm
from repro_torch.ml.hummingbird import EnsembleGemm

_GRID = [  # (seed, n_trees, depth, n_features, nan_frac, n_rows)
    (0, 1, 2, 2, 0.0, 48),
    (1, 6, 6, 9, 0.0, 48),
    (2, 4, 5, 5, 0.05, 129),
    (3, 3, 4, 3, 0.25, 1),
    (4, 12, 8, 7, 0.05, 5000),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _forest_and_x(seed, n_trees, depth, n_features, nan_frac, n_rows):
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(512, n_features)).astype(np.float32)
    y = (xf[:, 0] > xf[:, -1]).astype(np.int32)
    rf = RandomForest(n_trees=n_trees, max_depth=depth, min_leaf=2,
                      seed=seed).fit(xf, y)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    x[rng.random(x.shape) < nan_frac / 2] = np.inf
    x[rng.random(x.shape) < nan_frac / 2] = -np.inf
    return rf, x


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [128, 8])
@pytest.mark.parametrize("case", _GRID, ids=lambda c: f"seed{c[0]}")
def test_tree_gemm_kernel_matches_plain_bitwise(case, pad, cuda_device):
    """Bitwise against the plain version and traversal, NaN/±inf included;
    pad 8 gives I and L that are not multiples of the kernel's tiles."""
    rf, x = _forest_and_x(*case)
    ens = ensemble_to_gemm(rf.trees, pad_to=pad)
    xt = torch.from_numpy(x).to(cuda_device)
    before = tg_ops.launches
    got = tg_ops.tree_gemm(ens.to_device(cuda_device), xt)
    torch.cuda.synchronize()
    assert tg_ops.launches == before + 1
    want = tg_ops.tree_gemm(ens, torch.from_numpy(x))   # plain, on the CPU
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  rf.predict_scores(xt).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 63, 65, 1001, 100_003])
@pytest.mark.parametrize("pad,n_trees", [(128, 6), (8, 6), (128, 1)],
                         ids=["pad128", "pad8", "one_tree"])
def test_tree_gemm_kernel_edge_cases_bitwise(n_rows, pad, n_trees,
                                             cuda_device):
    """chip_smoke's edge cases: ragged row counts around the 128-row block,
    NaN/±inf, one tree, I and L padded to 8 (not the kernel's tiles)."""
    rf, x = _forest_and_x(5, n_trees, 8, 7, 0.05, n_rows)
    ens = ensemble_to_gemm(rf.trees, pad_to=pad)
    got = tg_ops.tree_gemm(ens.to_device(cuda_device),
                           torch.from_numpy(x).to(cuda_device))
    want = tg_ops.tree_gemm(ens, torch.from_numpy(x))    # plain, on the CPU
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_tree_gemm_kernel_needs_feature_indices(cuda_device):
    rf, x = _forest_and_x(*_GRID[1])
    ens = ensemble_to_gemm(rf.trees, pad_to=128)
    no_feat = EnsembleGemm(ens.a, ens.b, ens.c, ens.d, ens.e,
                           n_trees=ens.n_trees)
    before = tg_ops.launches
    with pytest.raises(ValueError, match="feature indices"):
        tg_ops.tree_gemm(no_feat.to_device(cuda_device),
                         torch.from_numpy(x).to(cuda_device))
    assert tg_ops.launches == before


@pytest.mark.cuda
def test_tree_gemm_kernel_rejects_cpu_ensemble_on_cuda_x(cuda_device):
    rf, x = _forest_and_x(*_GRID[1])
    ens = ensemble_to_gemm(rf.trees, pad_to=128)
    with pytest.raises(ValueError, match="on cpu"):
        tg_ops.tree_gemm(ens.to_device("cpu"),
                         torch.from_numpy(x).to(cuda_device))


# -- the featurized linear scorer --------------------------------------------

_FLIGHT_ROWS = 5_819_079        # the benchmark's flights table


def _flights_operands(n, code_dtype, device, seed=0):
    """The flights model's kept featurizers (40 origins, 40 destinations and
    2 carriers out of 322, 322 and 14 codes, at scattered codes; taxi_out
    and dep_hour scaled), its weights, and ``n`` rows of raw columns."""
    from repro_torch.ml import OneHotEncoder, StandardScaler
    rng = np.random.default_rng(seed)
    enc = OneHotEncoder(["origin", "dest", "carrier"])
    enc.categories = {c: np.sort(rng.choice(d, k, replace=False))
                      .astype(np.int32)
                      for c, d, k in (("origin", 322, 40), ("dest", 322, 40),
                                      ("carrier", 14, 2))}
    sc = StandardScaler(["taxi_out", "dep_hour"])
    sc.mean, sc.std = np.float32([16.1, 13.2]), np.float32([8.9, 4.8])
    w = rng.normal(1.0, 0.5, (84, 1)).astype(np.float32)
    w[-2:] = rng.normal(0.0, 0.5, (2, 1))
    cols = {"origin": rng.integers(-2, 330, n),
            "dest": rng.integers(0, 322, n),
            "carrier": rng.integers(0, 16, n),
            "taxi_out": rng.gamma(4.0, 4.0, n).astype(np.float32),
            "dep_hour": rng.integers(0, 24, n).astype(np.int32)}
    for c in ("origin", "dest", "carrier"):
        cols[c] = cols[c] % 2 == 0 if code_dtype == "bool" \
            else cols[c].astype(np.int32)
    return ([enc, sc], w, np.float32([-2.1]),
            {k: torch.as_tensor(v, device=device) for k, v in cols.items()})


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 4097, _FLIGHT_ROWS])
@pytest.mark.parametrize("code_dtype,offset", [
    ("int32", 0), ("int32", 1), ("int32", 3), ("bool", 0), ("bool", 2)])
def test_featurized_linear_kernel_matches_plain_bitwise(n, code_dtype,
                                                        offset, cuda_device):
    """The kernel against its plain version on the card, bitwise, at the
    benchmark's row count and at edge sizes; ``offset`` > 0 starts every
    column at an odd row, so the call takes the element-by-element
    loads."""
    feats, w, b, cols = _flights_operands(n + offset, code_dtype,
                                          cuda_device, seed=n)
    cols = {k: v[offset:] for k, v in cols.items()}
    op = fl_ops.prepare(feats, w, b, cuda_device)
    before = fl_ops.launches
    got = fl_ops.featurized_linear(op, cols)
    torch.cuda.synchronize()
    assert fl_ops.launches == before + 1
    want = featurized_linear_ref([cols[c] for c in op.columns], op.blocks,
                                 op.table, op.bias)
    assert got.shape == (n, 1) and got.is_cuda
    assert _bitwise(got, want)


@pytest.mark.cuda
def test_featurized_linear_kernel_is_the_unfused_fold_at_5_8m_rows(
        cuda_device):
    """At 5,819,079 rows the kernel's logits are bitwise those of the
    featurizers' matrix and ``rowwise_matmul`` on the card."""
    from repro_torch.ml.linear import rowwise_matmul
    feats, w, b, cols = _flights_operands(_FLIGHT_ROWS, "int32", cuda_device)
    op = fl_ops.prepare(feats, w, b, cuda_device)
    got = fl_ops.featurized_linear(op, cols)
    x = torch.cat([f.transform(cols) for f in feats], dim=1)
    want = rowwise_matmul(x, torch.as_tensor(w, device=cuda_device)) \
        + torch.as_tensor(b, device=cuda_device)
    assert _bitwise(got, want)


@pytest.mark.cuda
def test_featurized_linear_kernel_refuses_what_it_does_not_take(cuda_device):
    feats, w, b, cols = _flights_operands(100, "int32", cuda_device)
    op = fl_ops.prepare(feats, w, b, cuda_device)
    before = fl_ops.launches
    with pytest.raises(TypeError, match="float64"):
        fl_ops.featurized_linear(op, {**cols, "taxi_out":
                                      cols["taxi_out"].double()})
    with pytest.raises(TypeError, match="int64"):
        fl_ops.featurized_linear(op, {**cols, "origin":
                                      cols["origin"].long()})
    with pytest.raises(ValueError, match="on cpu"):
        fl_ops.featurized_linear(op, {**cols, "dep_hour":
                                      cols["dep_hour"].cpu()})
    assert fl_ops.launches == before


@pytest.mark.cuda
def test_served_flights_queries_launch_featurized_linear_once_each(
        cuda_device):
    """The benchmark's two query shapes served on the card: each execution
    launches the kernel exactly once, and the answers equal the unfused
    plans' bitwise."""
    from repro_torch.core import ModelStore
    from repro_torch.data import flight_features
    from repro_torch.relational.table import Table
    from repro_torch.serve import PredictionService
    fcols, fy = flight_features(300_000, seed=3)
    pipe = _flight_pipeline(0.01, 100).fit(
        {k: v[:20_000] for k, v in fcols.items()}, fy[:20_000])
    store = ModelStore()
    store.register_table("flights", Table.from_pydict(fcols))
    store.register_model("delay", pipe)
    sqls = ["SELECT origin, dest, PREDICT_PROBA(MODEL='delay') AS p "
            "FROM flights WHERE taxi_out >= 15",
            "SELECT dep_hour, AVG(__pred_0_delay) AS p FROM flights WHERE "
            "PREDICT_PROBA(MODEL='delay') >= 0 AND distance >= 900 "
            "GROUP BY dep_hour"]
    svc = PredictionService(store, enable_result_cache=False)
    before, runs = fl_ops.launches, svc.stats.batch_executions
    got = [svc.run(q) for q in sqls + sqls]
    torch.cuda.synchronize()
    executions = svc.stats.batch_executions - runs
    assert executions == 4
    assert fl_ops.launches - before == executions
    svc.close()
    orig = fl_ops.fusable
    fl_ops.fusable = lambda *a: False
    try:
        plain = PredictionService(store, enable_result_cache=False)
        want = [plain.run(q) for q in sqls + sqls]
        plain.close()
    finally:
        fl_ops.fusable = orig
    for g, w_ in zip(got, want):
        assert torch.equal(g.valid, w_.valid)
        for k in w_.columns:
            assert torch.equal(g.columns[k], w_.columns[k]), k


# -- attention ------------------------------------------------------------
# float32 within 2e-5 and bfloat16 within 2e-2 of the plain version on the
# same card inputs (tests/test_kernels.py's tolerances): the kernel sums in
# another order, and rounds p against a running maximum where the plain
# version uses the final one.
_ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
_FLASH_SHAPES = [  # (b, s, t, h, kv, d): groups 1, 2, 4; ragged S and T
    (2, 193, 193, 4, 4, 64),
    (1, 130, 130, 8, 4, 128),
    (2, 77, 77, 8, 2, 256),
    (1, 100, 300, 4, 1, 128),
]
_FLASH_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
                (False, 0, 0.0)]


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", _FLASH_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("causal,window,cap", _FLASH_MASKS,
                         ids=["causal", "window64", "softcap30", "bidir"])
def test_flash_attention_kernel_matches_plain(shape, dtype, causal, window,
                                              cap, cuda_device):
    b, s, t, h, kv, d = shape
    gen = torch.Generator().manual_seed(s * 7 + d)
    q = _randn(gen, (b, s, h, d), dtype, cuda_device)
    k = _randn(gen, (b, t, kv, d), dtype, cuda_device)
    v = _randn(gen, (b, t, kv, d), dtype, cuda_device)
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=cap)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    assert float((got.float() - want.float()).abs().max()) <= _ATT_TOL[dtype]


# The bfloat16 path is the wgmma + TMA kernel: head dims 64, 128 and 256,
# GQA groups 1, 4 and 5, B > 1, S and T off the 64-row tile and S != T, a
# single token; window 64 over 193 rows leaves the last rows a fully masked
# leading key tile.
_WGMMA_SHAPES = [  # (b, s, t, h, kv, d)
    (2, 193, 193, 4, 4, 64),
    (1, 130, 300, 8, 2, 128),
    (2, 77, 150, 10, 2, 256),
    (3, 150, 150, 25, 5, 64),
    (2, 1, 1, 8, 8, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _WGMMA_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("causal,window,cap", _FLASH_MASKS,
                         ids=["causal", "window64", "softcap30", "bidir"])
def test_flash_attention_bf16_wgmma_matches_plain(shape, causal, window, cap,
                                                  cuda_device):
    b, s, t, h, kv, d = shape
    gen = torch.Generator().manual_seed(s * 3 + t + d)
    q, k, v = (_randn(gen, (b, n, heads, d), torch.bfloat16, cuda_device)
               for n, heads in ((s, h), (t, kv), (t, kv)))
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=cap)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    want = attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    assert float((got.float() - want.float()).abs().max()) \
        <= _ATT_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_misaligned_base(cuda_device):
    gen = torch.Generator().manual_seed(0)
    buf = _randn(gen, (2 * 64 * 4 * 64 + 1,), torch.bfloat16, cuda_device)
    q = buf[1:].view(2, 64, 4, 64)        # contiguous, 2 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [  # (b, t, h, kv, d): groups 1, 4, 2, 5
    (4, 1024, 36, 36, 64), (3, 777, 8, 2, 128), (2, 300, 8, 4, 256),
    (3, 129, 8, 4, 64), (2, 50, 40, 8, 128),
    # Hymba-1.5B's ring and global caches (25 query, 5 KV heads), and G 12
    # (two tiles of query heads)
    (4, 1024, 25, 5, 64), (4, 2048, 25, 5, 64), (2, 400, 24, 2, 64)],
    ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["plain", "softcap30"])
def test_decode_attention_kernel_matches_plain(shape, dtype, cap,
                                               cuda_device):
    b, t, h, kv, d = shape
    gen = torch.Generator().manual_seed(t + d)
    q = _randn(gen, (b, 1, h, d), dtype, cuda_device)
    k = _randn(gen, (b, t, kv, d), dtype, cuda_device)
    v = _randn(gen, (b, t, kv, d), dtype, cuda_device)
    lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32)
    lens[0] = 1                              # ragged, down to one slot
    lens = lens.to(cuda_device)
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k, v, lens, softcap=cap)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    want = decode_attention_ref(q, k, v, lens, softcap=cap)
    assert float((got.float() - want.float()).abs().max()) <= _ATT_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["split_edges", "split_edges_mha", "len0"])
def test_decode_attention_kernel_at_split_edges(case, dtype, cuda_device):
    """Lengths on and either side of the kernel's split boundaries, with
    later splits left empty, and a row of cache_len 0 (the plain mean over
    all T slots)."""
    b, t, h, kv, d = {"split_edges": (4, 1024, 25, 5, 64),
                      "split_edges_mha": (4, 1024, 36, 36, 64),
                      "len0": (3, 300, 8, 2, 128)}[case]
    sl = split_layout(t)[1]
    lens = {"split_edges": [sl, sl + 1, sl - 1, 3 * sl],
            "split_edges_mha": [sl - 1, sl, sl + 1, t],
            "len0": [0, 1, t]}[case]
    gen = torch.Generator().manual_seed(sl + d)
    q = _randn(gen, (b, 1, h, d), dtype, cuda_device)
    k = _randn(gen, (b, t, kv, d), dtype, cuda_device)
    v = _randn(gen, (b, t, kv, d), dtype, cuda_device)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    for cap in (0.0, 30.0):
        got = decode_ops.decode_attention(q, k, v, cache_len, softcap=cap)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        want = decode_attention_ref(q, k, v, cache_len, softcap=cap)
        assert float((got.float() - want.float()).abs().max()) \
            <= _ATT_TOL[dtype]


@pytest.mark.cuda
def test_decode_attention_replays_from_cuda_graph(cuda_device):
    """A wrapper call captured in a CUDA graph at Hymba's ring shape: after
    cache_len (one row to 0), k and v change in place, the replay equals
    an eager call on the same inputs bitwise."""
    b, t, h, kv, d = 4, 1024, 25, 5, 64
    gen = torch.Generator().manual_seed(5)
    q = _randn(gen, (b, 1, h, d), torch.bfloat16, cuda_device)
    k = _randn(gen, (b, t, kv, d), torch.bfloat16, cuda_device)
    v = _randn(gen, (b, t, kv, d), torch.bfloat16, cuda_device)
    cache_len = torch.tensor([533, 715, 1024, 1024], dtype=torch.int32,
                             device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_ops.decode_attention(q, k, v, cache_len)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_ops.decode_attention(q, k, v, cache_len)
    cache_len.copy_(torch.tensor([17, 1000, 0, 1024], dtype=torch.int32))
    k.copy_(_randn(gen, k.shape, torch.bfloat16, cuda_device))
    v.copy_(_randn(gen, v.shape, torch.bfloat16, cuda_device))
    graph.replay()
    eager = decode_ops.decode_attention(q, k, v, cache_len)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    want = decode_attention_ref(q, k, v, cache_len)
    assert float((out.float() - want.float()).abs().max()) \
        <= _ATT_TOL[torch.bfloat16]


# -- Gemma-2 2B's attention, the paged cache, the MoE combine ---------------
# Gemma-2 2B: 8 query heads over 4 KV heads of 256 (G 2), the attention
# soft cap 50, local layers over the last 4,096 positions.
_GEMMA2 = {"h": 8, "kv": 4, "d": 256, "window": 4096, "cap": 50.0}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [_GEMMA2["window"], 0],
                         ids=["local", "global"])
def test_flash_attention_at_gemma2_shapes(window, cuda_device):
    """A prefill past the window (S = T = 4,200): the local layers' mask
    drops the first keys of the last rows."""
    s, h, kv, d = 4200, _GEMMA2["h"], _GEMMA2["kv"], _GEMMA2["d"]
    gen = torch.Generator().manual_seed(s + window)
    q, k, v = (_randn(gen, (1, s, heads, d), torch.bfloat16, cuda_device)
               for heads in (h, kv, kv))
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=True, window=window,
                                    softcap=_GEMMA2["cap"])
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    want = attention_ref(q, k, v, causal=True, window=window,
                         softcap=_GEMMA2["cap"])
    assert float((got.float() - want.float()).abs().max()) \
        <= _ATT_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("t,lens", [
    (8192, [129, 715, 4112, 5016]),     # a global layer's cache
    (4096, [129, 715, 4096, 4096])],    # a local layer's ring, full
    ids=["global", "ring"])
def test_decode_attention_at_gemma2_shapes(t, lens, cuda_device):
    h, kv, d = _GEMMA2["h"], _GEMMA2["kv"], _GEMMA2["d"]
    gen = torch.Generator().manual_seed(t)
    q = _randn(gen, (4, 1, h, d), torch.bfloat16, cuda_device)
    k = _randn(gen, (4, t, kv, d), torch.bfloat16, cuda_device)
    v = _randn(gen, (4, t, kv, d), torch.bfloat16, cuda_device)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = decode_ops.decode_attention(q, k, v, cache_len,
                                      softcap=_GEMMA2["cap"])
    want = decode_attention_ref(q, k, v, cache_len, softcap=_GEMMA2["cap"])
    assert float((got.float() - want.float()).abs().max()) \
        <= _ATT_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_decode_attention_over_paged_gather_is_bitwise_contiguous(
        cuda_device):
    """Four sequences of 1 to 2,000 tokens appended interleaved into one
    pool of 16-slot blocks at Gemma-2's KV shape: decode attention over
    ``batch_gather`` equals it over contiguous caches holding the same
    tokens, bitwise."""
    from repro_torch.serve import PagedKVCache
    h, kv, d = _GEMMA2["h"], _GEMMA2["kv"], _GEMMA2["d"]
    lengths, block = [1, 517, 1300, 2000], 16
    max_blocks = -(-max(lengths) // block)
    gen = torch.Generator().manual_seed(11)
    pools = [PagedKVCache(len(lengths) * max_blocks, block, kv, d,
                          max_blocks, device=cuda_device) for _ in "kv"]
    t = max_blocks * block
    contiguous = [torch.zeros((len(lengths), t, kv, d), dtype=torch.bfloat16,
                              device=cuda_device) for _ in "kv"]
    tokens = [_randn(gen, (n, 2, kv, d), torch.bfloat16, cuda_device)
              for n in lengths]
    order = [i for i, n in enumerate(lengths) for _ in range(n)]
    order = [order[j] for j in torch.randperm(len(order), generator=gen)]
    pos = [0] * len(lengths)
    for i in order:
        for pool, cont, which in zip(pools, contiguous, (0, 1)):
            if i not in pool.tables:
                pool.allocate(i)
            pool.append(i, tokens[i][pos[i], which])
            cont[i, pos[i]] = tokens[i][pos[i], which]
        pos[i] += 1
    (pk, lens), (pv, _) = (pool.batch_gather(list(range(len(lengths))))
                           for pool in pools)
    assert lens.tolist() == lengths and pk.shape == contiguous[0].shape
    q = _randn(gen, (len(lengths), 1, h, d), torch.bfloat16, cuda_device)
    paged = decode_ops.decode_attention(q, pk, pv, lens,
                                        softcap=_GEMMA2["cap"])
    flat = decode_ops.decode_attention(q, *contiguous, lens,
                                       softcap=_GEMMA2["cap"])
    torch.cuda.synchronize()
    assert torch.equal(paged, flat)


@pytest.mark.cuda
def test_moe_combine_is_bitwise_repeatable_on_the_card(cuda_device):
    """Granite-MoE's layer at full width (32 experts, top-8, d_model 1024,
    d_ff 512) on 333 bfloat16 tokens, twice: bitwise equal outputs (the
    combine sums each token's experts in a fixed order, no atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import init_params
    from repro_torch.models.moe import moe_apply, moe_params
    cfg = get_config("granite-moe-1b-a400m")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = init_params(moe_params(cfg), gen, torch.bfloat16)
    x = torch.randn((1, 333, cfg.d_model), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    counts = {}
    a = moe_apply(cfg, p, x, counts=counts)
    b = moe_apply(cfg, p, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    assert int(counts["routed"]) == 333 * cfg.experts_per_token


# -- scans ----------------------------------------------------------------
# y and the final state within 3e-4 of the plain version (tests/
# test_kernels.py's tolerance): the kernels sum each chunk's terms in
# another order than the per-step recurrence.
_SCAN_TOL = 3e-4


# Each case runs on float32 inputs and on the LM paths' dtypes and layout:
# RWKV-6 hands the kernel bfloat16 r, k, v, u and a float32 w; Hymba
# bfloat16 x, dt, B, C, split out of one projection row, and a float32 a.
_SCAN_INPUTS = ["float32", "path"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (b, s, h, strong decay)
    (1, 32, 2, False), (2, 48, 4, False), (1, 40, 1, False),
    (1, 32, 2, True), (3, 37, 2, False), (1, 699, 32, False),
    (2, 1, 3, False),
    # the state pass between chunks: strong decay over 13 chunks of 16,
    # and B 3 over 4 chunks with S off the chunk
    (2, 200, 3, True), (3, 53, 2, False)],
    ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("inputs", _SCAN_INPUTS)
def test_rwkv6_scan_kernel_matches_plain(shape, inputs, cuda_device):
    b, s, h, strong = shape
    gen = torch.Generator().manual_seed(s + h)
    r, k, v = (_randn(gen, (b, s, h, 64), torch.float32, cuda_device) * 0.5
               for _ in range(3))
    w = torch.full_like(r, 1e-6) if strong else torch.sigmoid(
        _randn(gen, (b, s, h, 64), torch.float32, cuda_device)) * 0.5 + 0.45
    u = _randn(gen, (h, 64), torch.float32, cuda_device) * 0.1
    if inputs == "path":
        r, k, v, u = (x.to(torch.bfloat16) for x in (r, k, v, u))
    before = wkv_ops.launches
    y, st = wkv_ops.rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv_ops.launches == before + 1
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_want, st_want = wkv6_scan_ref(r, k, v, w, u)
    assert float((y - y_want).abs().max()) <= _SCAN_TOL
    assert float((st - st_want).abs().max()) <= _SCAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [  # (b, s, h, p, n, strong decay)
    (1, 32, 2, 8, 4, False), (2, 64, 3, 16, 8, False),
    (1, 48, 2, 8, 4, False), (2, 300, 3, 64, 16, False),
    (1, 200, 2, 64, 16, True), (1, 1300, 50, 64, 16, False),
    (2, 1, 3, 64, 16, False),
    # the state pass between chunks: strong decay over 18 chunks of 64,
    # and B 3 over 4 chunks with S off the chunk and P, N off the tiles
    (2, 1100, 3, 64, 16, True), (3, 200, 2, 18, 12, False)],
    ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("inputs", _SCAN_INPUTS)
def test_ssd_scan_kernel_matches_plain(shape, inputs, cuda_device):
    b, s, h, p, n, strong = shape
    gen = torch.Generator().manual_seed(s + p)
    row = _randn(gen, (b, s, h * p + 2 * n), torch.float32, cuda_device)
    dt = torch.nn.functional.softplus(
        _randn(gen, (b, s, h), torch.float32, cuda_device))
    a = -torch.exp(_randn(gen, (h,), torch.float32, cuda_device) * 0.3)
    if strong:                                 # dt * |a| up to ~300
        dt, a = dt * 30, a * 10
    if inputs == "path":
        row, dt = row.to(torch.bfloat16), dt.to(torch.bfloat16)
        x, bm, cm = torch.split(row * 0.5, [h * p, n, n], dim=-1)
        x = x.reshape(b, s, h, p)               # views: not copied
    else:
        x, bm, cm = (t.contiguous() for t in
                     torch.split(row * 0.5, [h * p, n, n], dim=-1))
        x = x.reshape(b, s, h, p)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd_scan(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_want, st_want = ssd_scan_ref(x, dt, a, bm, cm)
    assert float((y - y_want).abs().max()) <= _SCAN_TOL
    assert float((st - st_want).abs().max()) <= _SCAN_TOL


# -- the prediction service on the card ---------------------------------------

_SVC_FEATS = ["age", "gender", "pregnant", "rcount"]
_SVC_SQL = ("SELECT pid, age, PREDICT(MODEL='rf') AS s FROM patient_info "
            "WHERE age > 30")


def _card_store(n_rows=3000):
    from repro_torch.core import ModelStore
    from repro_torch.data import hospital_tables
    from repro_torch.ml import Pipeline, PipelineMetadata, StandardScaler
    from repro_torch.relational.table import to_numpy
    tables = hospital_tables(n_rows, seed=5)
    data = {c: to_numpy(t.column(c)) for t in tables.values()
            for c in t.names}
    pipe = Pipeline([StandardScaler(_SVC_FEATS).fit(data)],
                    RandomForest(n_trees=8, max_depth=6),
                    PipelineMetadata(name="rf", task="classification"))
    pipe.fit({k: data[k] for k in _SVC_FEATS},
             (data["length_of_stay"] > 7.0).astype(np.int32))
    store = ModelStore()
    for name, t in tables.items():
        store.register_table(name, t)
    store.register_model("rf", pipe)
    return store


def _svc_script(svc, store):
    pi = store.get_table("patient_info")

    def rows(lo, hi):
        return type(pi)({k: v[lo:hi] for k, v in pi.columns.items()},
                        pi.valid[lo:hi], pi.schema)

    outs = [svc.run(_SVC_SQL), svc.run(_SVC_SQL)]
    tickets = [svc.submit(_SVC_SQL, {"patient_info": rows(lo, hi)})
               for lo, hi in ((0, 100), (100, 1100), (5, 6))]
    svc.flush()
    outs += [t.result(timeout=60) for t in tickets]
    outs.append(svc.run("SELECT pid, PREDICT_PROBA(MODEL='rf') AS p "
                        "FROM patient_info JOIN blood_tests ON pid"))
    return outs


@pytest.mark.cuda
def test_prediction_service_on_the_card_goes_through_tree_gemm(cuda_device):
    """``PredictionService(ModelStore())`` serves on the card; under the
    ``"cuda"`` strategy every execution launches the tree GEMM kernel once
    (no chunking, no result splice), and the answers equal traversal's
    bitwise."""
    from repro_torch.core import OptimizerConfig
    from repro_torch.serve import PredictionService
    store = _card_store()
    assert store.device.type == "cuda"
    kernel = PredictionService(store, enable_result_cache=False,
                               optimizer_config=OptimizerConfig(
                                   tree_strategy="cuda"))
    trav = PredictionService(store, optimizer_config=OptimizerConfig(
        tree_strategy="traversal"))
    before = tg_ops.launches
    got = _svc_script(kernel, store)
    launched = tg_ops.launches - before
    want = _svc_script(trav, store)
    assert launched == kernel.stats.batch_executions > 0
    for g, w in zip(got, want):
        assert g.valid.is_cuda
        assert torch.equal(g.valid, w.valid)
        for k in w.columns:
            assert torch.equal(g.columns[k], w.columns[k]), k
    assert kernel.stats.coalesced_requests == 2
    kernel.close()
    trav.close()


@pytest.mark.cuda
def test_auto_calibrates_on_the_models_own_forest(cuda_device):
    """On the card ``"auto"`` times the strategies on the model being
    planned (cached once per model content in the store), so its
    prediction at the calibration's own size is the measured line."""
    from repro_torch.core import CrossOptimizer, parse_query
    from repro_torch.core.cost_model import (_CAL_SIZES,
                                             calibrated_tree_costs,
                                             tree_strategy_costs)
    from repro_torch.core.model_store import content_fingerprint
    store = _card_store()
    # no predicate: model pruning would plan (and calibrate) a pruned forest
    plan, report = CrossOptimizer(store).optimize(parse_query(
        "SELECT pid, PREDICT(MODEL='rf') AS s FROM patient_info", store))
    model = store.get_model("rf").model
    key = ("tree_strategy", "cuda", content_fingerprint(model))
    cal = store.get_calibration(key)
    assert cal is not None and cal.cuda_flop is not None
    assert calibrated_tree_costs(catalog=store, model=model) is cal
    costs = tree_strategy_costs(model, _CAL_SIZES["cuda"][1], 4, cal)
    assert all(0 < v < 10.0 for v in costs.values())
    assert any(r == "tree_strategy" for r, _ in report.entries)


@pytest.mark.cuda
def test_sharded_service_on_the_card_equals_whole_table(cuda_device):
    """The partition-parallel tier on one card: ``patient_info`` and
    ``blood_tests`` co-partitioned on pid (4 partitions), query (a) served
    partition-wise under the ``"cuda"`` strategy — one tree GEMM launch a
    morsel, rows equal to the whole-table service's bitwise — and through
    the hash exchange against a misaligned copy of ``blood_tests``."""
    from repro_torch.core import ExecutionConfig, OptimizerConfig
    from repro_torch.serve import PredictionService
    store = _card_store()
    n = store.get_table("patient_info").capacity
    bounds = [n // 4, n // 2, 3 * n // 4]
    for name in ("patient_info", "blood_tests"):
        store.register_table(name, store.get_table(name),
                             partition_by="pid", partition_bounds=bounds)
    store.register_table("blood_x", store.get_table("blood_tests"),
                         partition_by="pid",
                         partition_bounds=[b + 7 for b in bounds])
    opt = OptimizerConfig(tree_strategy="cuda")
    whole = PredictionService(store, optimizer_config=opt)
    # no result cache: a second query would splice the first's capture
    sharded = PredictionService(
        store, optimizer_config=opt, enable_result_cache=False,
        execution_config=ExecutionConfig(
            sharded=True, shard_devices=1, shard_morsel_rows=1024,
            shard_exchange_cost_gate=False))
    for side in ("blood_tests", "blood_x"):
        # a blood_tests column keeps the join (the model reads only
        # patient_info, so join elimination would drop it otherwise)
        sql = (f"SELECT pid, hematocrit, PREDICT(MODEL='rf') AS s "
               f"FROM patient_info JOIN {side} ON pid")
        want = whole.run(sql)
        before, waves = tg_ops.launches, sharded.stats.shard_waves
        got = sharded.run(sql)
        # one device: a wave is a morsel (or an exchange bucket)
        assert tg_ops.launches - before \
            == sharded.stats.shard_waves - waves > 1
        assert got.valid.is_cuda and torch.equal(got.valid, want.valid)
        for k in want.columns:
            assert torch.equal(got.columns[k][got.valid],
                               want.columns[k][want.valid]), k
    assert sharded.stats.sharded_executions == 2
    assert sharded.stats.shard_join_executions == 2
    assert sharded.stats.exchange_executions == 1
    whole.close()
    sharded.close()


@pytest.mark.cuda
def test_sharded_service_over_every_card_equals_one_card(cuda_device):
    """``shard_devices=0`` takes every card: morsels and exchange buckets
    run on their own cards (one worker thread a card, the forest staged
    on each), and the answers equal one card's bitwise."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    from repro_torch.core import ExecutionConfig, OptimizerConfig
    from repro_torch.serve import PredictionService
    store = _card_store()
    n = store.get_table("patient_info").capacity
    bounds = [n * i // 8 for i in range(1, 8)]
    for name in ("patient_info", "blood_tests"):
        store.register_table(name, store.get_table(name),
                             partition_by="pid", partition_bounds=bounds)
    store.register_table("blood_x", store.get_table("blood_tests"),
                         partition_by="pid",
                         partition_bounds=[b + 7 for b in bounds])
    opt = OptimizerConfig(tree_strategy="cuda")

    def service(devices):
        return PredictionService(
            store, optimizer_config=opt, enable_result_cache=False,
            execution_config=ExecutionConfig(
                sharded=True, shard_devices=devices, shard_morsel_rows=256,
                shard_exchange_cost_gate=False))

    one, every = service(1), service(0)
    for side in ("blood_tests", "blood_x"):
        sql = (f"SELECT pid, hematocrit, PREDICT(MODEL='rf') AS s "
               f"FROM patient_info JOIN {side} ON pid")
        want = one.run(sql)
        before = tg_ops.launches
        got = every.run(sql)
        assert tg_ops.launches - before == (8 if side == "blood_tests"
                                            else 16)
        assert got.valid.device == want.valid.device
        assert torch.equal(got.valid, want.valid)
        for k in want.columns:
            assert torch.equal(got.columns[k], want.columns[k]), k
    agg = ("SELECT gender, AVG(__pred_0_rf) AS p FROM patient_info JOIN "
           "blood_tests ON pid WHERE PREDICT_PROBA(MODEL='rf') >= 0 "
           "GROUP BY gender")
    want, got = one.run(agg), every.run(agg)
    for k in want.columns:              # partials fold in partition order
        assert torch.equal(got.columns[k], want.columns[k]), k
    info = every.shard_info()
    assert info["devices"] == torch.cuda.device_count()
    assert every.stats.shard_waves < one.stats.shard_waves
    one.close()
    every.close()


# -- the fits and k-means on the card (no kernel of their own: plain
# tensor code, held to itself and to the port's CPU run) --------------------

FIT_ATOL = 1e-5                   # card vs CPU: linear weights and bias
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6   # card vs CPU: MLP parameters


def _flight_pipeline(l1, steps):
    from repro_torch.ml import (LogisticRegression, OneHotEncoder, Pipeline,
                                PipelineMetadata, StandardScaler)
    return Pipeline([OneHotEncoder(["origin", "dest", "carrier", "dow"]),
                     StandardScaler(["distance", "taxi_out", "dep_hour"])],
                    LogisticRegression(l1=l1, steps=steps),
                    PipelineMetadata(name="delay"))


@pytest.mark.cuda
def test_operator_spans_account_for_an_execution_on_the_card(cuda_device):
    """A served query's ``op.<op>`` spans carry ``device_ms``, the stream
    time from each node's boundary event to the next one's, read when the
    trace is read: over one warm execution at 2M flights they sum to
    80-100% of its ``execute`` span (the rest is host time before the
    first event and after the last).  The query is the benchmark's
    ``hourly_delay``, whose grouped mean keeps the card busy for most of
    the execution; ``route_risk`` scores 2M rows in one featurized-linear
    launch and is over before the host's own work around it."""
    from repro_torch.core import ModelStore
    from repro_torch.data import flight_features
    from repro_torch.relational.table import Table
    from repro_torch.serve import PredictionService
    fcols, fy = flight_features(2_000_000, seed=3)
    pipe = _flight_pipeline(0.01, 100).fit(
        {k: v[:20_000] for k, v in fcols.items()}, fy[:20_000])
    store = ModelStore()
    store.register_table("flights", Table.from_pydict(fcols))
    store.register_model("delay", pipe)
    svc = PredictionService(store)
    sql = ("SELECT dep_hour, AVG(__pred_0_delay) AS p FROM flights WHERE "
           "PREDICT_PROBA(MODEL='delay') >= 0 AND distance >= 900 "
           "GROUP BY dep_hour")
    for _ in range(3):
        svc.run(sql)
    tr = svc.traces()[-1]
    ex = tr.find("execute")
    ops = [s for s in ex.children if s.name.startswith("op.")]
    assert ops and all(s.attrs["device_ms"] >= 0 for s in ops)
    share = sum(s.attrs["device_ms"] for s in ops) / (ex.duration * 1e3)
    assert 0.8 <= share <= 1.0, (share, tr.pretty())
    svc.close()


@pytest.mark.cuda
def test_logistic_fit_on_the_card_is_deterministic_and_matches_cpu(
        cuda_device):
    from repro_torch.data import flight_features
    fcols, fy = flight_features(20_000, seed=3)
    card = [_flight_pipeline(0.01, 100).fit(fcols, fy).model
            for _ in range(2)]
    cpu = _flight_pipeline(0.01, 100).fit(fcols, fy, device="cpu").model
    assert np.array_equal(card[0].weights, card[1].weights)
    assert card[0].bias == card[1].bias
    np.testing.assert_allclose(card[0].weights, cpu.weights, rtol=0,
                               atol=FIT_ATOL)
    assert abs(card[0].bias - cpu.bias) <= FIT_ATOL
    only_one = set(card[0].zero_weight_features()) ^ set(
        cpu.zero_weight_features())
    assert all(abs(card[0].weights[i]) < FIT_ATOL
               and abs(cpu.weights[i]) < FIT_ATOL for i in only_one)


@pytest.mark.cuda
def test_mlp_fit_on_the_card_is_deterministic_and_matches_cpu(cuda_device):
    from repro_torch.data import hospital_features
    from repro_torch.ml import MLP
    cols, y = hospital_features(20_000, seed=6)
    x = np.stack([cols[c] for c in ("age", "gender", "pregnant", "rcount",
                                    "hematocrit", "neutrophils", "bp")],
                 1).astype(np.float32)
    x = (x - x.mean(0)) / x.std(0)
    card = [MLP(hidden=(64, 32), steps=60).fit(x, y) for _ in range(2)]
    cpu = MLP(hidden=(64, 32), steps=60).fit(x, y, device="cpu")
    for a, b, c in zip(card[0].params, card[1].params, cpu.params):
        for k in ("w", "b"):
            assert np.array_equal(a[k], b[k])
            np.testing.assert_allclose(a[k], c[k], rtol=MLP_RTOL,
                                       atol=MLP_ATOL)


@pytest.mark.cuda
def test_kmeans_on_the_card_matches_cpu(cuda_device):
    from repro_torch.core.clustering import kmeans
    from repro_torch.data import flight_features
    fcols, _ = flight_features(20_000, seed=3)
    x = torch.as_tensor(np.stack([fcols[c] for c in ("origin", "dest",
                                                     "carrier")], 1),
                        dtype=torch.float32)
    rng = np.random.default_rng(0)
    for k in (2, 8, 16):
        init = rng.choice(x.shape[0], k, replace=False)
        cc, ca = kmeans(x.to(cuda_device), k, init_idx=init)
        hc, ha = kmeans(x, k, init_idx=init)
        assert ca.device.type == "cuda"
        assert torch.equal(ca.cpu(), ha)
        np.testing.assert_allclose(cc.cpu().numpy(), hc.numpy(), rtol=0,
                                   atol=1e-6)


# -- training: the flash kernel's lse, the flash VJP, remat, scan refusal ----
# (name, (b, s, t, h, kv, d), causal, window, softcap): MiniCPM-2B's train
# shape; Gemma-2's local and global layers past the 4,096 window; a
# bidirectional and a cross case with S != T; one token; S > T with a
# window of 16, whose rows from 55 on see no key (lse -1e30 in both).
_LSE_CASES = [
    ("minicpm_train", (8, 256, 256, 36, 36, 64), True, 0, 0.0),
    ("gemma2_local", (1, 4200, 4200, 8, 4, 256), True, 4096, 50.0),
    ("gemma2_global", (1, 4200, 4200, 8, 4, 256), True, 0, 50.0),
    ("bidir", (2, 130, 130, 8, 2, 128), False, 0, 0.0),
    ("cross", (2, 77, 150, 10, 2, 64), False, 0, 30.0),
    ("one_token", (2, 1, 1, 8, 8, 128), True, 0, 0.0),
    ("rows_see_no_key", (1, 200, 40, 4, 2, 64), True, 16, 0.0),
]
_LSE_TOL = 1e-4


def _visible_rows(s, t, causal, window):
    """[S] bool: the query rows that see at least one key."""
    rows = torch.arange(s)
    if not causal:
        return torch.ones(s, dtype=torch.bool)
    first = rows - (window - 1 if window > 0 else rows)
    return first.clamp(min=0) < t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", _LSE_CASES, ids=lambda c: c[0])
def test_flash_attention_lse_matches_plain(case, dtype, cuda_device):
    name, (b, s, t, h, kv, d), causal, window, cap = case
    gen = torch.Generator().manual_seed(s + t + d)
    q, k, v = (_randn(gen, (b, n, heads, d), dtype, cuda_device)
               for n, heads in ((s, h), (t, kv), (t, kv)))
    before = flash_ops.launches
    out, lse = flash_ops.flash_attention_with_lse(q, k, v, causal, window,
                                                  cap)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    want_out, want_lse = attention_with_lse_ref(q, k, v, causal, window, cap)
    assert float((lse - want_lse).abs().max()) <= _LSE_TOL
    seen = _visible_rows(s, t, causal, window).to(cuda_device)
    assert bool((lse[:, :, ~seen] == -1e30).all())
    assert float((out.float() - want_out.float())[:, seen].abs().max()) \
        <= _ATT_TOL[dtype]
    # the inference call writes the same output without the lse
    assert torch.equal(out, flash_ops.flash_attention(q, k, v, causal,
                                                      window, cap))


# the CPU flash-VJP tests' cases: (b, s, t, h, kv, d, mask_kind, window,
# cap, block_size)
_VJP_CASES = [
    (2, 96, 96, 4, 2, 64, "window", 0, 0.0, 32),
    (1, 64, 64, 4, 4, 64, "window", 16, 0.0, 32),
    (1, 80, 80, 2, 1, 64, "window", 0, 20.0, 32),
    (2, 64, 64, 4, 2, 64, "window", 24, 20.0, 32),
    (1, 40, 40, 10, 2, 64, "causal", 0, 0.0, 512),
    (2, 48, 48, 4, 2, 128, "bidir", 0, 0.0, 512),
    (2, 24, 56, 4, 2, 64, "cross", 0, 30.0, 512),
    (1, 70, 70, 4, 1, 64, "causal", 0, 0.0, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _VJP_CASES,
                         ids=lambda c: f"{c[6]}{c[7]}_cap{c[8]:g}_{c[1]}")
def test_flash_vjp_on_the_card_matches_float32_plain_autograd(case,
                                                              cuda_device):
    """dq, dk, dv of the flash VJP (forward: the float32 kernel with its
    lse) against autograd through the float32 plain version on the card,
    within the JAX flash-VJP test's 3e-4 / 1e-3."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.attention import full_attention
    b, s, t, h, kv, d, kind, window, cap, block = case
    cfg = dataclasses.replace(reduced_config(get_config("qwen2.5-14b")),
                              attn_softcap=cap)
    gen = torch.Generator().manual_seed(s + h)
    q, k, v = (_randn(gen, (b, n, heads, d), torch.float32, cuda_device)
               for n, heads in ((s, h), (t, kv), (t, kv)))
    cot = _randn(gen, (b, s, h, d), torch.float32, cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = flash_ops.launches
    out = full_attention(cfg, *leaves, mask_kind=kind, window=window,
                         block_size=block)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = attention_ref(*ref_leaves, causal=kind in ("causal", "window"),
                         window=window, softcap=cap)
    (want * cot).sum().backward()
    assert float((out - want).abs().max()) <= _ATT_TOL[torch.float32]
    for got, ref in zip(leaves, ref_leaves):
        torch.testing.assert_close(got.grad, ref.grad, atol=3e-4,
                                   rtol=1e-3)


def _small_lm(cuda_device, remat, n_layers=2):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_config("minicpm-2b")),
                              d_head=64, n_layers=n_layers)
    return build_model(cfg, device=cuda_device, remat=remat)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_launches_flash_once_a_layer_or_twice_under_remat(
        remat, cuda_device):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    model = _small_lm(cuda_device, remat, n_layers=3)
    state = init_train_state(model, torch.Generator(
        device=cuda_device).manual_seed(0))
    batch = {"tokens": np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 32)).astype(np.int32)}
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3))
    before = flash_ops.launches
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert flash_ops.launches - before == 3 * (2 if remat else 1)
    assert int(metrics["skipped"]) == 0
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
def test_train_step_on_the_card_is_bitwise_repeatable(cuda_device):
    """Two steps from equal states on equal batches (many repeated tokens:
    the embedding's gradient is a sorted segment sum, not atomics) give
    bitwise equal parameters."""
    import copy

    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    model = _small_lm(cuda_device, remat=True)
    state = init_train_state(model, torch.Generator(
        device=cuda_device).manual_seed(1))
    twin = copy.deepcopy(state)
    tokens = np.random.default_rng(1).integers(0, 8, (4, 64))
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3))
    for s in (state, twin):
        step(s, {"tokens": tokens.astype(np.int32)})
    torch.cuda.synchronize()
    from repro_torch.train.tree import leaves
    for a, b in zip(leaves(state), leaves(twin)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_a_gradient_on_the_card(cuda_device):
    gen = torch.Generator().manual_seed(0)
    r, k, v = (_randn(gen, (1, 32, 2, 64), torch.float32, cuda_device)
               for _ in range(3))
    w = torch.full_like(r, 0.9)
    u = _randn(gen, (2, 64), torch.float32, cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv_ops.rwkv6_scan(r.requires_grad_(), k, v, w, u)
    x = _randn(gen, (1, 32, 2, 64), torch.float32, cuda_device)
    dt = torch.full((1, 32, 2), 0.1, device=cuda_device)
    a = torch.full((2,), -0.5, device=cuda_device)
    bm, cm = (_randn(gen, (1, 32, 16), torch.float32, cuda_device)
              for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd_scan(x, dt.requires_grad_(), a, bm, cm)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(x.requires_grad_(), x, x)
    with torch.no_grad():                 # no gradient: the kernels run
        wkv_ops.rwkv6_scan(r, k, v, w, u)
        ssd_ops.ssd_scan(x, dt, a, bm, cm)
        flash_ops.flash_attention(x, x, x)
    torch.cuda.synchronize()


def _grads(fn, inputs, cots):
    xs = [x.clone().requires_grad_() for x in inputs]
    y, st = fn(*xs)
    ((y * cots[0]).sum() + (st * cots[1]).sum()).backward()
    return [x.grad for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(2, 37, 2), (1, 256, 4), (3, 1, 2)])
def test_wkv6_function_on_the_card_matches_plain_autograd(b, s, h,
                                                          cuda_device):
    """``WKV6Scan`` on the card (forward the kernel, once; backward the
    chunked form) against autograd through the float32 recurrence, within
    1e-4 relative L2 (both in float32 on the card: reductions in other
    orders)."""
    from repro_torch.models.rwkv6 import WKV6Scan
    gen = torch.Generator().manual_seed(s)
    r, k, v = (0.5 * _randn(gen, (b, s, h, 64), torch.float32, cuda_device)
               for _ in range(3))
    w = torch.exp(-torch.exp(_randn(gen, (b, s, h, 64), torch.float32,
                                    cuda_device) * 0.5 - 1.0))
    u = 0.3 * _randn(gen, (h, 64), torch.float32, cuda_device)
    cots = (_randn(gen, (b, s, h, 64), torch.float32, cuda_device),
            _randn(gen, (b, h, 64, 64), torch.float32, cuda_device))
    before = wkv_ops.launches
    got = _grads(WKV6Scan.apply, (r, k, v, w, u), cots)
    assert wkv_ops.launches == before + 1
    want = _grads(wkv6_scan_ref, (r, k, v, w, u), cots)
    for g, ww in zip(got, want):      # one step: some gradients are 0
        assert float((g - ww).norm() / ww.norm().clamp_min(1e-30)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n", [(2, 37, 2, 64, 16),
                                       (1, 300, 3, 64, 16),
                                       (2, 1, 2, 32, 8)])
def test_ssd_function_on_the_card_matches_plain_autograd(b, s, h, p, n,
                                                         cuda_device):
    from repro_torch.models.ssm import SSDScan
    gen = torch.Generator().manual_seed(s)
    x = _randn(gen, (b, s, h, p), torch.float32, cuda_device)
    dt = torch.nn.functional.softplus(
        _randn(gen, (b, s, h), torch.float32, cuda_device) * 0.5 - 1.0)
    a = -torch.exp(0.5 * _randn(gen, (h,), torch.float32, cuda_device))
    bm, cm = (_randn(gen, (b, s, n), torch.float32, cuda_device)
              for _ in range(2))
    cots = (_randn(gen, (b, s, h, p), torch.float32, cuda_device),
            _randn(gen, (b, h, p, n), torch.float32, cuda_device))
    before = ssd_ops.launches
    got = _grads(SSDScan.apply, (x, dt, a, bm, cm), cots)
    assert ssd_ops.launches == before + 1
    want = _grads(ssd_scan_ref, (x, dt, a, bm, cm), cots)
    for g, ww in zip(got, want):      # one step: some gradients are 0
        assert float((g - ww).norm() / ww.norm().clamp_min(1e-30)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_scan_families_train_on_the_card_with_exact_launches(arch,
                                                              cuda_device):
    """A remat train step of RWKV-6 / Hymba (reduced, d_head 64) on the
    card: each layer's scan (and Hymba's flash) launches twice, the loss
    is finite and the gradients match the CPU's per leaf within 8%
    relative L2 (Hymba's ``dt_bias`` and ``d_skip``: 25%)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.train.train_state import loss_and_grads
    from repro_torch.train.tree import leaves
    over = dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64) \
        if arch.startswith("rwkv6") else dict(d_head=64)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **over)
    card = build_model(cfg, device=cuda_device, remat=True)
    params = card.init_params(torch.Generator(device=cuda_device)
                              .manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    counts = (wkv_ops.launches, ssd_ops.launches, flash_ops.launches)
    loss, grads = loss_and_grads(card, params, {"tokens": tokens})
    torch.cuda.synchronize()
    got = (wkv_ops.launches - counts[0], ssd_ops.launches - counts[1],
           flash_ops.launches - counts[2])
    two = 2 * cfg.n_layers
    assert got == ((two, 0, 0) if cfg.rwkv else (0, two, two))
    assert bool(torch.isfinite(loss))
    cpu = build_model(cfg, device="cpu", remat=True)
    cpu_params = [p.cpu() for p in leaves(params)]
    from repro_torch.train.tree import unflatten
    loss_h, grads_h = loss_and_grads(cpu, unflatten(params, cpu_params),
                                     {"tokens": tokens})
    assert abs(float(loss) - float(loss_h)) <= 1e-3 * abs(float(loss_h))
    from repro_torch.train.tree import leaves_with_paths
    for (key, gc), (_, gh) in zip(leaves_with_paths(grads),
                                  leaves_with_paths(grads_h)):
        # tests/test_torch_train_loss.py's tolerances
        tol = 0.25 if key.endswith(("['dt_bias']", "['d_skip']")) else 0.08
        rel = float((gc.cpu() - gh).norm() / gh.norm().clamp_min(1e-30))
        assert rel <= tol, (key, rel)


@pytest.mark.cuda
def test_meta_routes_report_and_do_not_launch(cuda_device):
    """The five wrappers on ``meta`` tensors: empty outputs of the right
    shapes, the analytic work reported to the cost counter, no launch."""
    from repro_torch.launch.cost_analysis import CostCounter
    m = torch.device("meta")
    before = (wkv_ops.launches, ssd_ops.launches, flash_ops.launches,
              decode_ops.launches)
    with CostCounter() as counter:
        q = torch.empty((2, 64, 4, 64), dtype=torch.bfloat16, device=m)
        kv = torch.empty((2, 64, 2, 64), dtype=torch.bfloat16, device=m)
        assert flash_ops.flash_attention(q, kv, kv).shape == q.shape
        out, lse = flash_ops.flash_attention_with_lse(q, kv, kv)
        assert lse.shape == (2, 4, 64) and lse.dtype == torch.float32
        q1 = torch.empty((2, 1, 4, 64), dtype=torch.bfloat16, device=m)
        lens = torch.empty((2,), dtype=torch.int32, device=m)
        assert decode_ops.decode_attention(q1, kv, kv, lens).shape == \
            q1.shape
        r = torch.empty((1, 32, 2, 64), device=m)
        y, st = wkv_ops.rwkv6_scan(r, r, r, r, torch.empty((2, 64),
                                                           device=m))
        assert st.shape == (1, 2, 64, 64)
        x = torch.empty((1, 32, 2, 64), device=m)
        y, st = ssd_ops.ssd_scan(x, torch.empty((1, 32, 2), device=m),
                                 torch.empty((2,), device=m),
                                 torch.empty((1, 32, 16), device=m),
                                 torch.empty((1, 32, 16), device=m))
        assert st.shape == (1, 2, 64, 16)
    kernels = counter.cost.kernels
    assert kernels["flash_attention"]["calls"] == 2
    assert {"decode_attention", "rwkv6_scan", "ssd_scan"} <= set(kernels)
    assert (wkv_ops.launches, ssd_ops.launches, flash_ops.launches,
            decode_ops.launches) == before
