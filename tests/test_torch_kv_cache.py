"""The port's paged KV cache (``serve/kv_cache.py``) against the JAX
package's, on the CPU: the twins of ``tests/test_kv_cache.py``'s three
tests (allocator reuse, pool exhaustion, and attention over the paged
gather equal to attention over contiguous caches, through the port's
``decode_attention`` wrapper, whose CPU side is its plain version), and one
call script through both packages' ``PagedKVCache``: equal block tables,
free lists, lengths, pools and gathers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.serve import PagedKVCache


def test_alloc_free_reuse():
    c = PagedKVCache(n_blocks=4, block=2, n_kv=1, hd=4,
                     max_blocks_per_seq=2, device="cpu")
    c.allocate(0)
    for _ in range(4):
        c.append(0, torch.ones((1, 4)))
    assert c.free_blocks() == 2
    with pytest.raises(ValueError, match="already allocated"):
        c.allocate(0)
    c.free(0)
    assert c.free_blocks() == 4


def test_pool_exhaustion():
    c = PagedKVCache(n_blocks=1, block=2, n_kv=1, hd=4,
                     max_blocks_per_seq=2, device="cpu")
    c.allocate(0)
    c.append(0, torch.ones((1, 4)))
    c.append(0, torch.ones((1, 4)))
    with pytest.raises(MemoryError, match="exhausted"):
        c.append(0, torch.ones((1, 4)))


def test_sequence_past_its_table_raises():
    c = PagedKVCache(n_blocks=4, block=2, n_kv=1, hd=4,
                     max_blocks_per_seq=1, device="cpu")
    c.allocate(0)
    c.append(0, torch.ones((1, 4)))
    c.append(0, torch.ones((1, 4)))
    with pytest.raises(MemoryError, match="full"):
        c.append(0, torch.ones((1, 4)))


@settings(max_examples=15, deadline=None)
@given(st.lists(st.integers(1, 9), min_size=1, max_size=3),
       st.integers(0, 100))
def test_paged_attention_equals_contiguous(lengths, seed):
    """Attention over the paged gather == attention over a contiguous
    cache, for ragged sequence lengths sharing one pool."""
    rng = np.random.default_rng(seed)
    kv, hd, block = 2, 64, 4
    max_blocks = 3
    pool_blocks = max_blocks * len(lengths)
    cache_k = PagedKVCache(pool_blocks, block, kv, hd, max_blocks,
                           dtype=torch.float32, device="cpu")
    cache_v = PagedKVCache(pool_blocks, block, kv, hd, max_blocks,
                           dtype=torch.float32, device="cpu")
    contiguous_k = np.zeros((len(lengths), max_blocks * block, kv, hd),
                            np.float32)
    contiguous_v = np.zeros_like(contiguous_k)
    # interleave appends across sequences (fragmenting the pool)
    order = [s for s, n in enumerate(lengths) for _ in range(n)]
    rng.shuffle(order)
    pos = [0] * len(lengths)
    for s in order:
        if s not in cache_k.tables:
            cache_k.allocate(s)
            cache_v.allocate(s)
        kt = rng.normal(size=(kv, hd)).astype(np.float32)
        vt = rng.normal(size=(kv, hd)).astype(np.float32)
        cache_k.append(s, torch.from_numpy(kt))
        cache_v.append(s, torch.from_numpy(vt))
        contiguous_k[s, pos[s]] = kt
        contiguous_v[s, pos[s]] = vt
        pos[s] += 1

    sids = list(range(len(lengths)))
    pk, lens = cache_k.batch_gather(sids)
    pv, _ = cache_v.batch_gather(sids)
    assert lens.dtype == torch.int32 and lens.tolist() == lengths
    q = torch.from_numpy(rng.normal(size=(len(lengths), 1, kv * 2, hd))
                         .astype(np.float32))
    out_paged = decode_ops.decode_attention(q, pk, pv, lens)
    out_ref = decode_ops.decode_attention(
        q, torch.from_numpy(contiguous_k), torch.from_numpy(contiguous_v),
        torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(out_paged.numpy(), out_ref.numpy(),
                               atol=1e-5)


def test_call_script_matches_jax():
    """One script of allocations, interleaved appends, frees and reuse
    through both packages: tables, free lists, lengths, pools and gathers
    equal."""
    rng = np.random.default_rng(3)
    args = (6, 4, 2, 8, 3)                   # blocks, block, kv, hd, per seq
    jc = JaxPagedKVCache(*args, dtype=jnp.float32)
    tc = PagedKVCache(*args, dtype=torch.float32, device="cpu")
    script = [("alloc", 0), ("alloc", 1), ("append", 0, 5), ("append", 1, 3),
              ("append", 0, 2), ("free", 1), ("alloc", 2), ("append", 2, 9),
              ("alloc", 1), ("append", 1, 1)]
    for step in script:
        kind, sid = step[:2]
        if kind == "alloc":
            jc.allocate(sid)
            tc.allocate(sid)
        elif kind == "free":
            jc.free(sid)
            tc.free(sid)
        else:
            for _ in range(step[2]):
                tok = rng.normal(size=(2, 8)).astype(np.float32)
                jc.append(sid, jnp.asarray(tok))
                tc.append(sid, torch.from_numpy(tok))
        assert tc._free == jc._free and tc.lengths == jc.lengths
        assert tc.tables.keys() == jc.tables.keys()
        for s in jc.tables:
            np.testing.assert_array_equal(tc.tables[s], jc.tables[s])
    assert np.array_equal(tc.pool.numpy(), np.asarray(jc.pool))
    sids = sorted(jc.tables)
    jv, jl = jc.batch_gather(sids)
    tv, tl = tc.batch_gather(sids)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert tl.tolist() == np.asarray(jl).tolist()
    for s in sids:
        (jg, jn), (tg, tn) = jc.gather(s), tc.gather(s)
        assert jn == tn and np.array_equal(tg.numpy(), np.asarray(jg))
