"""Property tests: random expression trees over an int32 and a float32
column evaluate to the same dtype and the same bits in the port and in the
JAX package (both eager), including literal-only subtrees, which both
compute in 32 bits; and constant folding preserves the port's values.

Eager is the reference here: the port computes every operator correctly
rounded, as eager JAX does, while a jitted JAX plan contracts ``a * b + c``
into one fused multiply-add and divides by a literal through its
reciprocal (ROADMAP, queue 3).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.relational import expr as jexpr
from repro_torch.relational import expr as texpr

settings.register_profile("torch_expr", max_examples=30, deadline=None)
settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "torch_expr"))

# Magnitudes of 2**-10 and up keep every intermediate far from float32's
# subnormal range, which XLA's CPU backend flushes to zero and torch keeps
# (ROADMAP, queue 3).
_NUM = st.one_of(st.just(0.0), st.floats(0.0009765625, 10, width=32),
                 st.floats(-10, -0.0009765625, width=32))
_ARITH = ["+", "-", "*", "/"]
_CMP = ["<", "<=", ">", ">=", "==", "!="]


@st.composite
def numeric(draw, depth=0):
    """A numeric expression as nested tuples, built in either package
    later; typed as SQL types them (arithmetic on numbers, comparisons give
    booleans, AND/OR on booleans, CASE picks numbers)."""
    if depth > 2 or draw(st.booleans()):
        return draw(st.sampled_from([
            ("col", "a"), ("col", "b"), ("const", draw(_NUM)),
            ("const", draw(st.integers(-5, 5)))]))
    kind = draw(st.sampled_from(["bin", "bin", "neg", "case"]))
    if kind == "neg":
        return ("neg", draw(numeric(depth + 1)))
    if kind == "case":
        return ("case", draw(boolean(depth + 1)), draw(numeric(depth + 1)),
                draw(numeric(depth + 1)))
    return ("bin", draw(st.sampled_from(_ARITH)), draw(numeric(depth + 1)),
            draw(numeric(depth + 1)))


@st.composite
def boolean(draw, depth=0):
    if depth > 2 or draw(st.booleans()):
        return ("bin", draw(st.sampled_from(_CMP)), draw(numeric(depth + 1)),
                draw(numeric(depth + 1)))
    return ("bin", draw(st.sampled_from(["and", "or"])),
            draw(boolean(depth + 1)), draw(boolean(depth + 1)))


trees = st.one_of(numeric(), boolean())


def build(m, t):
    kind = t[0]
    if kind == "col":
        return m.Col(t[1])
    if kind == "const":
        return m.Const(t[1])
    if kind == "neg":
        return m.UnaryOp("neg", build(m, t[1]))
    if kind == "case":
        return m.CaseWhen(((build(m, t[1]), build(m, t[2])),), build(m, t[3]))
    return m.BinOp(t[1], build(m, t[2]), build(m, t[3]))


def _columns(vals):
    a = np.asarray(vals, np.float32)
    b = np.arange(len(vals), dtype=np.int32) - 2
    return ({"a": jnp.asarray(a), "b": jnp.asarray(b)},
            {"a": torch.from_numpy(a), "b": torch.from_numpy(b)})


def _as_numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@given(trees, st.lists(_NUM, min_size=3, max_size=8))
def test_expression_matches_jax_bitwise(tree, vals):
    jcols, tcols = _columns(vals)
    with np.errstate(all="ignore"):
        want = np.asarray(build(jexpr, tree).evaluate(jcols))
    got = _as_numpy(texpr.value_tensor(build(texpr, tree).evaluate(tcols)))
    assert got.dtype == want.dtype, (tree, got.dtype, want.dtype)
    np.testing.assert_array_equal(np.broadcast_to(got, want.shape), want)


@given(trees, st.lists(_NUM, min_size=3, max_size=8))
def test_fold_constants_preserves_value(tree, vals):
    _, tcols = _columns(vals)
    expr = build(texpr, tree)
    before = _as_numpy(texpr.value_tensor(expr.evaluate(tcols)))
    after = _as_numpy(texpr.value_tensor(
        texpr.fold_constants(expr).evaluate(tcols)))
    if before.dtype.kind == "b":
        np.testing.assert_array_equal(np.broadcast_to(after, before.shape),
                                      before)
    else:
        np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)
