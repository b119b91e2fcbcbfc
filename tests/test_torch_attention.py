"""The port's attention kernels' plain versions and its attention module
against the JAX package's.

The same inputs (numpy, from a seed; bfloat16 cases round the same float32
draws to bfloat16 on both sides) go through:

- the JAX Pallas kernels in interpret mode (``flash_attention`` and
  ``decode_attention`` with ``interpret=True``) and the port's wrappers on
  CPU tensors, which take the plain versions (``ref.py``), at the shapes of
  ``tests/test_kernels.py`` and with its tolerances: 2e-5 in float32 (the
  two sum in other orders) and 2e-2 in bfloat16 (both round p to bfloat16
  before P.V, but against a running max in the Pallas kernel and the final
  max in the plain version, and the output is rounded to bfloat16);
- the JAX ``models/attention.py`` (blockwise, p kept in float32) and the
  port's ``models/attention.py``: 2e-5 in float32, where rounding p to v's
  dtype is a no-op, and 2e-2 in bfloat16;
- the Pallas decode kernel in interpret mode and the port's mirror of its
  CUDA kernel's split of the cache and combine
  (``decode_attention_split_ref``), at the same tolerances: the mirror
  rounds p against each split's own max.

The CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_kernels_cuda.py``, which imports no JAX.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import attention as jax_attn
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_kernel
from repro_torch.kernels.decode_attention.decode_attention import (
    scratch_floats, split_layout)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as attn

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _normal(rng, shape, dtype):
    """The same draw for both packages: float32 numpy, rounded to bfloat16
    on each side when asked."""
    x = rng.normal(size=shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)


# ---------------------------------------------------------------- kernels

_FLASH_SHAPES = [  # tests/test_kernels.py's (b, s, h, kv, d, dtype)
    (1, 128, 4, 2, 64, "float32"),
    (2, 192, 4, 4, 64, "float32"),
    (1, 128, 8, 2, 128, "float32"),
    (2, 256, 2, 1, 64, "bfloat16"),
]
_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
          (False, 0, 0.0)]


@pytest.mark.parametrize("b,s,h,kv,d,dtype", _FLASH_SHAPES)
@pytest.mark.parametrize("causal,window,cap", _MASKS)
def test_flash_plain_matches_pallas_interpret(b, s, h, kv, d, dtype, causal,
                                              window, cap):
    rng = np.random.default_rng(b * 100 + s)
    (jq, q), (jk, k), (jv, v) = (_normal(rng, (b, s, h, d), dtype),
                                 _normal(rng, (b, s, kv, d), dtype),
                                 _normal(rng, (b, s, kv, d), dtype))
    want = jax_flash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                     block_q=64, block_k=64, interpret=True)
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=cap)
    assert flash_ops.launches == before       # the CPU takes the plain path
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, _TOL[dtype])
    torch.testing.assert_close(
        got, attention_ref(q, k, v, causal=causal, window=window,
                           softcap=cap), rtol=0, atol=0)


@pytest.mark.parametrize("b,t,h,kv,d,dtype,cap", [
    (2, 256, 8, 2, 64, "float32", 0.0),       # tests/test_kernels.py's
    (1, 300, 4, 4, 128, "float32", 0.0),
    (3, 128, 8, 1, 64, "float32", 0.0),
    (2, 200, 4, 2, 64, "bfloat16", 0.0),
    (2, 130, 4, 1, 128, "float32", 30.0),
])
def test_decode_plain_matches_pallas_interpret(b, t, h, kv, d, dtype, cap):
    rng = np.random.default_rng(t)
    (jq, q), (jk, k), (jv, v) = (_normal(rng, (b, 1, h, d), dtype),
                                 _normal(rng, (b, t, kv, d), dtype),
                                 _normal(rng, (b, t, kv, d), dtype))
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    want = jax_decode(jq, jk, jv, jnp.asarray(lens), softcap=cap,
                      block_k=128, interpret=True)
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k, v, torch.from_numpy(lens),
                                      softcap=cap)
    assert decode_ops.launches == before
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, _TOL[dtype])
    torch.testing.assert_close(
        got, decode_attention_ref(q, k, v, torch.from_numpy(lens),
                                  softcap=cap), rtol=0, atol=0)


def test_decode_plain_ignores_slots_past_cache_len():
    """What lies beyond cache_len[b] does not reach the output."""
    rng = np.random.default_rng(3)
    _, q = _normal(rng, (2, 1, 4, 64), "float32")
    _, k = _normal(rng, (2, 96, 2, 64), "float32")
    _, v = _normal(rng, (2, 96, 2, 64), "float32")
    lens = torch.tensor([5, 96], dtype=torch.int32)
    out = decode_ops.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[0, 5:] = 1e3
    v2[0, 5:] = -1e3
    torch.testing.assert_close(decode_ops.decode_attention(q, k2, v2, lens),
                               out, rtol=0, atol=0)


# The split mirror over every group size the configs use and more (G 12
# takes two tiles of 8 query heads in the kernel), every head dim and both
# dtypes; T 96 with rows of length 0, 1, T and on and either side of the
# boundaries of 2 and 3 splits (48 and 32 slots); split counts 1, 2, 3, 7
# (splits of 14, the last one 12) and one slot a split.
_SPLIT_LENS = [0, 1, 31, 32, 33, 47, 48, 49, 96]
_SPLIT_COUNTS = [1, 2, 3, 7, 96]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 5, 8, 12])
def test_decode_split_ref_matches_pallas_interpret(g, d, dtype):
    kv, t = 2, 96
    b = len(_SPLIT_LENS)
    rng = np.random.default_rng(g * 1000 + d)
    (jq, q), (jk, k), (jv, v) = (_normal(rng, (b, 1, g * kv, d), dtype),
                                 _normal(rng, (b, t, kv, d), dtype),
                                 _normal(rng, (b, t, kv, d), dtype))
    lens = np.array(_SPLIT_LENS, np.int32)
    for cap in (0.0, 30.0):
        want = jax_decode(jq, jk, jv, jnp.asarray(lens), softcap=cap,
                          block_k=128, interpret=True)
        plain = decode_attention_ref(q, k, v, torch.from_numpy(lens),
                                     softcap=cap)
        for n_splits in _SPLIT_COUNTS:
            got = decode_attention_split_ref(q, k, v, torch.from_numpy(lens),
                                             softcap=cap, n_splits=n_splits)
            assert got.dtype == q.dtype and got.shape == q.shape
            _close(got, want, _TOL[dtype])
            _close(got, plain.float().numpy(), _TOL[dtype])


def test_split_layout_is_fixed_by_shapes():
    """The split count and length come from the cache's length T alone:
    no length in it (and no batch size, head count or card) enters, and
    the splits cover the cache."""
    import inspect
    assert list(inspect.signature(split_layout).parameters) == ["t"]
    assert split_layout(1024) == (16, 64)     # MiniCPM-2B, Hymba's ring
    assert split_layout(2048) == (32, 64)     # Hymba's global layers
    assert split_layout(50) == (1, 64)
    assert split_layout(32768) == (64, 512)   # splits capped at 512 slots
    for t in (1, 50, 63, 64, 65, 777, 1024, 2048, 2049, 16384, 32768):
        n, sl = split_layout(t)
        assert sl % 64 == 0 and 64 <= sl <= 512
        assert n * sl >= t > (n - 1) * sl
        assert n <= 32 or sl == 512
    # the partials (m, l, acc[D]) of every split, batch row and query head
    assert scratch_floats(4, 25, 64, 2048) == 4 * 25 * 32 * 66
    # the longest split is the CUDA source's (its scores sit in shared
    # memory)
    source = decode_kernel.SOURCE.read_text()
    assert re.search(r"constexpr int kMaxSplit = (\d+);", source).group(1) \
        == str(decode_kernel.MAX_SPLIT)


def test_decode_split_rows_are_independent():
    """A row's output does not move, bit for bit, when another row's
    length, k or v changes: the layout is the same for every row."""
    rng = np.random.default_rng(21)
    _, q = _normal(rng, (4, 1, 25, 64), "bfloat16")
    _, k = _normal(rng, (4, 1024, 5, 64), "bfloat16")
    _, v = _normal(rng, (4, 1024, 5, 64), "bfloat16")
    n_splits, _ = split_layout(1024)
    lens = torch.tensor([533, 715, 1024, 64], dtype=torch.int32)
    out = decode_attention_split_ref(q, k, v, lens, n_splits=n_splits)
    k2, v2 = k.clone(), v.clone()
    k2[1:] = -k2[1:]
    v2[1:] = 2 * v2[1:]
    for new_lens in ([533, 0, 1, 2], [533, 1024, 65, 700]):
        got = decode_attention_split_ref(q, k2, v2, torch.tensor(
            new_lens, dtype=torch.int32), n_splits=n_splits)
        torch.testing.assert_close(got[0], out[0], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_ring_cache_equals_unwrapped(dtype):
    """A decode ring (Hymba's local layers): once the ring wraps, slot
    pos % T holds position pos, so the valid slots are out of order and a
    split mixes old and new positions.  The output equals that of the same
    rows in position order."""
    t, kv, g, d = 256, 2, 5, 64
    rng = np.random.default_rng(22)
    _, q = _normal(rng, (2, 1, g * kv, d), dtype)
    _, k = _normal(rng, (2, t, kv, d), dtype)    # by position p0 .. p0+t-1
    _, v = _normal(rng, (2, t, kv, d), dtype)
    lens = torch.tensor([t, t], dtype=torch.int32)
    first = torch.tensor([300, 777])             # p0 of each row
    slots = (first[:, None] + torch.arange(t)[None, :]) % t
    kr, vr = torch.empty_like(k), torch.empty_like(v)
    for row in range(2):
        kr[row, slots[row]] = k[row]
        vr[row, slots[row]] = v[row]
    want = decode_attention_ref(q, k, v, lens)
    for n_splits in (1, 4, split_layout(t)[0]):
        _close(decode_attention_split_ref(q, kr, vr, lens,
                                          n_splits=n_splits),
               want.float().numpy(), _TOL[dtype])
    _close(decode_ops.decode_attention(q, kr, vr, lens),
           want.float().numpy(), _TOL[dtype])


@pytest.mark.parametrize("case", ["head_dim", "dtype", "groups", "device",
                                  "contiguous", "window", "rank"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    v = torch.zeros(1, 8, 2, 64)
    kw = {}
    if case == "head_dim":
        q, k, v = q[..., :16].contiguous(), k[..., :16].contiguous(), \
            v[..., :16].contiguous()
    elif case == "dtype":
        k = k.to(torch.bfloat16)
    elif case == "groups":
        k, v = torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64)
    elif case == "device":      # q on another device than k and v
        q = q.to("meta")
    elif case == "contiguous":
        q = torch.zeros(1, 4, 8, 64).transpose(1, 2)
    elif case == "window":
        kw = {"window": -1}
    else:
        q = q[0]
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("case", ["head_dim", "len_dtype", "len_shape",
                                  "query_len", "device"])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(case):
    q = torch.zeros(2, 1, 4, 64)
    kc = torch.zeros(2, 16, 2, 64)
    lens = torch.ones(2, dtype=torch.int32)
    if case == "head_dim":
        q, kc = torch.zeros(2, 1, 4, 32), torch.zeros(2, 16, 2, 32)
    elif case == "len_dtype":
        lens = lens.long()
    elif case == "len_shape":
        lens = torch.ones(3, dtype=torch.int32)
    elif case == "query_len":
        q = torch.zeros(2, 2, 4, 64)
    else:                       # q on another device than the caches
        q = q.to("meta")
    with pytest.raises(ValueError):
        decode_ops.decode_attention(q, kc, kc, lens)


# ----------------------------------------------------------------- module

def _cfg(softcap=0.0, qkv_bias=False, qk_norm=False):
    return dataclasses.replace(get_config("qwen2.5-14b"), d_model=64,
                               n_heads=4, n_kv_heads=2, d_head=64,
                               attn_softcap=softcap, qkv_bias=qkv_bias,
                               qk_norm=qk_norm, window_size=24)


def _jax_cfg(cfg):
    return dataclasses.replace(jax_get_config("qwen2.5-14b"),
                               **dataclasses.asdict(cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind,cap", [("causal", 0.0), ("window", 0.0),
                                           ("bidir", 0.0), ("causal", 30.0)])
def test_full_attention_matches_jax_module(dtype, mask_kind, cap):
    cfg = _cfg(softcap=cap)
    rng = np.random.default_rng(11)
    (jq, q), (jk, k), (jv, v) = (_normal(rng, (2, 70, 4, 64), dtype),
                                 _normal(rng, (2, 70, 2, 64), dtype),
                                 _normal(rng, (2, 70, 2, 64), dtype))
    want = jax_attn.full_attention(_jax_cfg(cfg), jq, jk, jv,
                                   mask_kind=mask_kind)
    got = attn.full_attention(cfg, q, k, v, mask_kind=mask_kind)
    assert got.dtype == q.dtype
    _close(got, want, _TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_decode_attention_matches_jax_module(dtype, cap):
    cfg = _cfg(softcap=cap)
    rng = np.random.default_rng(12)
    (jq, q), (jk, k), (jv, v) = (_normal(rng, (3, 1, 4, 64), dtype),
                                 _normal(rng, (3, 40, 2, 64), dtype),
                                 _normal(rng, (3, 40, 2, 64), dtype))
    lens = np.array([1, 17, 40], np.int32)
    want = jax_attn.decode_attention(_jax_cfg(cfg), jq, jk, jv,
                                     jnp.asarray(lens))
    got = attn.decode_attention(cfg, q, k, v, torch.from_numpy(lens))
    _close(got, want, _TOL[dtype])


@pytest.mark.parametrize("qkv_bias,qk_norm", [(False, False), (True, False),
                                              (False, True)])
def test_project_qkv_matches_jax_module(qkv_bias, qk_norm):
    """Projections, optional bias and QK norm, and RoPE at explicit
    positions (decode's) in float32; atol 1e-5 covers the two packages'
    float32 sin/cos, rsqrt and matmul order."""
    cfg = _cfg(qkv_bias=qkv_bias, qk_norm=qk_norm)
    rng = np.random.default_rng(13)
    shapes = {"wq": (64, 256), "wk": (64, 128), "wv": (64, 128),
              "wo": (256, 64), "bq": (256,), "bk": (128,), "bv": (128,),
              "q_norm": (64,), "k_norm": (64,)}
    wanted = {"wq", "wk", "wv", "wo"} \
        | ({"bq", "bk", "bv"} if qkv_bias else set()) \
        | ({"q_norm", "k_norm"} if qk_norm else set())
    p = {n: (rng.normal(size=s) * 0.2).astype(np.float32)
         for n, s in shapes.items() if n in wanted}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [40, 41, 42, 43, 44]], np.int32)
    want = jax_attn.project_qkv(_jax_cfg(cfg),
                                {n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x), positions=jnp.asarray(pos))
    got = attn.project_qkv(cfg, {n: torch.from_numpy(a)
                                 for n, a in p.items()},
                           torch.from_numpy(x),
                           positions=torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
