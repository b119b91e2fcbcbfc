"""Partitioned-table sharded execution + zone-map partition pruning, on
the port (``repro_torch.serve.sharded`` and the service's sharded tier).
Every case of ``tests/test_partitioned_execution.py`` runs on the port
and, through the same calls on the same seeded numpy inputs, on the JAX
package: zone maps, morsel placements and pruned partition sets equal
the reference's; the port's answers equal the JAX service's (built with
``jit=False``) bitwise on the valid rows and the mask; ``ServiceStats``
and ``shard_info()`` equal field by field.  The scheduler
(``plan_morsels``, ``side_bucket_rows``) is held to the reference's
outputs under hypothesis over sizes and device counts, and the executor
over four CPU devices equals one device bitwise.

Four layers:

1. **Zone maps / PartitionedTable units** — min/max, small-domain
   bitsets, null counts, ragged tails, all-NULL partitions.
2. **Morsel scheduler units** — one shared pow-2 bucket whatever the
   partition/device ratio, partitions never split, LPT balance, waves.
3. **Pruning soundness** — a pruned partition never holds a valid row
   satisfying the predicate, and sharded pruned execution is bit-exact
   on valid rows against whole-table execution.
4. **Service integration** — ``ExecutionConfig(sharded=True)`` routes
   row-local plans over partitioned catalog tables through the sharded
   executor; warm repeats compile nothing; override tables never prune
   or shard; the ledgers.
"""

import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.core import (CrossOptimizer, ExecutionConfig, ModelStore,
                              OptimizerConfig, compile_plan)
from repro_torch.core.cost_model import estimate_rows
from repro_torch.core.ir import Plan, plan_signature
from repro_torch.core.partition import PartitionedTable
from repro_torch.ml.convert import pipeline_from_state, pipeline_state
from repro_torch.relational.expr import col
from repro_torch.relational.table import Table
from repro_torch.serve import PredictionService, plan_morsels
from repro_torch.serve.sharded import ShardedExecutor, side_bucket_rows

pytestmark = pytest.mark.tier1

CPU4 = [torch.device("cpu")] * 4


def _ns(pkg: str, jit: bool = False):
    if pkg == "jax":
        import repro.core as core
        from repro.core.ir import Plan as P
        from repro.core.partition import PartitionedTable as PT
        from repro.relational.expr import col as c
        from repro.relational.expr import extract_constraints as ec
        from repro.relational.table import Table as T
        from repro.serve import PredictionService as S
        from repro.serve.sharded import ShardedExecutor as X
        store_kw, mask = {}, (lambda v: np.asarray(v, bool))
        executor = (lambda devices=0: X())
    else:
        import repro_torch.core as core
        from repro_torch.relational.expr import extract_constraints as ec
        P, PT, c, T, S = Plan, PartitionedTable, col, Table, \
            PredictionService
        store_kw = {"device": "cpu"}
        mask = (lambda v: torch.as_tensor(np.asarray(v, bool)))
        executor = (lambda devices=0: ShardedExecutor(devices, home="cpu"))
    return types.SimpleNamespace(
        pkg=pkg, jit=jit, core=core, Plan=P, PartitionedTable=PT, col=c,
        extract_constraints=ec, Table=T, PredictionService=S,
        ModelStore=lambda: core.ModelStore(**store_kw), mask=mask,
        executor=executor)


J, T = _ns("jax"), _ns("torch")


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    """Dtype and bytes of an array or tensor: bitwise equality, NaN
    payloads included."""
    a = np.ascontiguousarray(_host(x))
    return a.dtype, a.shape, a.tobytes()


def _table(ns, values, valid=None, **extra):
    cols = {"a": np.asarray(values)}
    for k, v in extra.items():
        cols[k] = np.asarray(v)
    t = ns.Table.from_pydict(cols)
    if valid is not None:
        t = t.with_valid(ns.mask(valid))
    return t


def _filter_plan(ns, pred):
    plan = ns.Plan()
    s = plan.emit("scan", "RA", [], "table", table="t")
    plan.output = plan.emit("filter", "RA", [s], "table",
                            predicate=pred(ns.col))
    return plan


def _optimize(ns, store, plan, **cfg):
    return ns.core.CrossOptimizer(
        store, ns.core.OptimizerConfig(**cfg)).optimize(plan)


def _valid_rows(table):
    mask = _host(table.valid)
    return {k: _host(v)[mask] for k, v in table.columns.items()}


def _assert_same_valid_rows(got, want):
    g, w = _valid_rows(got), _valid_rows(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert g[k].dtype == w[k].dtype, k
        assert (g[k] == w[k]).all(), k


def _zones(pt):
    """A partitioned table's layout and zone maps as plain data."""
    return [(p.index, p.start, p.stop, p.zone.n_rows, p.zone.null_count,
             {k: asdict(z) for k, z in p.zone.columns.items()})
            for p in pt.partitions]


def _both(fn):
    """``fn(ns)`` in both packages; the port's result must equal the JAX
    package's (plain data)."""
    want, got = fn(J), fn(T)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# 1. Zone maps / PartitionedTable
# ---------------------------------------------------------------------------

def test_zone_maps_collect_min_max_domain_and_nulls():
    def fn(ns):
        t = _table(ns, [0, 1, 2, 10, 11, 12, 20, 21],
                   valid=[1, 1, 1, 1, 0, 1, 0, 0],
                   b=np.linspace(0.0, 7.0, 8).astype(np.float32))
        return _zones(ns.PartitionedTable.build(t, partition_rows=3))

    zones = _both(fn)
    pt = PartitionedTable.build(
        _table(T, [0, 1, 2, 10, 11, 12, 20, 21],
               valid=[1, 1, 1, 1, 0, 1, 0, 0],
               b=np.linspace(0.0, 7.0, 8).astype(np.float32)),
        partition_rows=3)
    assert pt.n_partitions == 3 and len(zones) == 3
    assert [p.n_rows for p in pt.partitions] == [3, 3, 2]   # ragged tail
    z0 = pt.partitions[0].zone
    assert (z0.columns["a"].min, z0.columns["a"].max) == (0.0, 2.0)
    assert z0.columns["a"].domain == frozenset((0.0, 1.0, 2.0))
    assert z0.null_count == 0
    z1 = pt.partitions[1].zone
    assert z1.null_count == 1
    assert z1.columns["a"].domain == frozenset((10.0, 12.0))  # valid only
    z2 = pt.partitions[2].zone                                # all-NULL
    assert z2.n_valid == 0
    assert z2.columns["a"].min is None
    # float columns keep min/max but no exact domain
    assert z0.columns["b"].domain is None


def test_partition_slices_reassemble_the_table():
    """``PartitionedTable.slice`` / ``Table.row_slice``: per-partition
    slices concatenate back to the base table."""
    t = _table(T, np.arange(11), valid=[1, 0, 1] * 3 + [1, 1],
               b=np.linspace(0, 1, 11).astype(np.float32))
    pt = PartitionedTable.build(t, partition_rows=4)
    got_cols = {k: [] for k in t.columns}
    got_valid = []
    for p in pt.partitions:
        piece = pt.slice(p.index)
        assert piece.capacity == p.n_rows
        assert piece.schema is t.schema
        for k in t.columns:
            got_cols[k].append(_host(piece.columns[k]))
        got_valid.append(_host(piece.valid))
    for k in t.columns:
        assert (np.concatenate(got_cols[k]) == _host(t.columns[k])).all(), k
    assert (np.concatenate(got_valid) == _host(t.valid)).all()
    jt = _table(J, np.arange(11), valid=[1, 0, 1] * 3 + [1, 1],
                b=np.linspace(0, 1, 11).astype(np.float32))
    assert _zones(pt) == _zones(J.PartitionedTable.build(jt, 4))


@pytest.mark.timeout_guard(600)
def test_nan_rows_disable_zone_stats_not_pruning():
    """NaN poisons ordered stats (min/max propagate it, and a NaN row
    *satisfies* ``!=``): a float partition containing NaN publishes no
    stats and must survive every constraint."""
    values = np.asarray([np.nan, 10.0, 50.0, 60.0], np.float32)

    def fn(ns):
        pt = ns.PartitionedTable.build(_table(ns, values),
                                       partition_rows=2)
        out = []
        for pred in (lambda c: c("a") < 25, lambda c: c("a") != 10.0,
                     lambda c: c("a") == 10.0):
            out.append(pt.prune(ns.extract_constraints(pred(ns.col))))
        z0 = pt.partitions[0].zone.columns["a"]
        return out, (z0.min, z0.max)

    prunes, stats = _both(fn)
    assert stats == (None, None)                      # stats withheld
    for surv, _pruned in prunes:
        assert 0 in surv
    assert 1 in prunes[0][1]           # the NaN-free partition prunes
    # end-to-end: the valid row 10.0 must appear in sharded output
    _check_prune_sound_and_bit_exact(values, None, lambda c: c("a") < 25, 2)


def test_partitions_must_tile_the_table():
    t = _table(T, [1, 2, 3, 4])
    pt = PartitionedTable.build(t, partition_rows=2)
    with pytest.raises(ValueError):
        PartitionedTable(t, pt.partitions[:1])
    with pytest.raises(ValueError):
        PartitionedTable.build(t, partition_rows=0)


def test_prune_is_conservative_and_exact_on_domains():
    def fn(ns):
        t = _table(ns, [0, 1, 5, 6, 7, 9], valid=[1, 1, 1, 1, 0, 0])
        pt = ns.PartitionedTable.build(t, partition_rows=2)
        cons = ns.extract_constraints((ns.col("a") == 5)
                                      & (ns.col("a") >= 0))
        return pt.prune([]), pt.prune(cons)

    (_s0, pruned0), (surv, pruned) = _both(fn)
    assert pruned0 == (2,)                 # all-NULL prunes unconditionally
    assert surv == (1,) and 0 in pruned    # domain {0,1} excludes 5


def test_register_table_partitioned_roundtrip():
    def fn(ns):
        store = ns.ModelStore()
        t = _table(ns, np.arange(10))
        store.register_table("t", t, partition_rows=4)
        pt = store.get_partitioned("t")
        assert pt is not None and pt.n_partitions == 3
        assert store.get_table("t") is pt.table
        # re-registering unpartitioned drops zone maps
        store.register_table("t", t)
        assert store.get_partitioned("t") is None
        # a pre-built PartitionedTable registers as-is
        store.register_table("t", ns.PartitionedTable.build(t, 5))
        return _zones(store.get_partitioned("t"))

    assert len(_both(fn)) == 2


# ---------------------------------------------------------------------------
# 2. Morsel scheduler
# ---------------------------------------------------------------------------

def test_morsels_share_one_bucket_and_never_split_partitions():
    sizes = [(i, r) for i, r in enumerate([100, 100, 100, 100, 37, 100])]
    pl = plan_morsels(sizes, n_devices=2, min_bucket_rows=8)
    assert pl.total_rows == 537
    seen = [i for dev in pl.assignments for m in dev for i in m.partitions]
    assert sorted(seen) == list(range(6))             # every partition once
    for dev in pl.assignments:
        for m in dev:
            assert m.rows <= pl.bucket_rows
    # bucket covers the ideal per-device share, pow-2
    assert pl.bucket_rows >= 537 / 2
    assert pl.bucket_rows & (pl.bucket_rows - 1) == 0


def test_morsel_waves_when_partitions_exceed_devices():
    sizes = [(i, 64) for i in range(16)]
    pl = plan_morsels(sizes, n_devices=4, min_bucket_rows=8,
                      morsel_rows=128)          # cap -> 2 partitions/morsel
    assert pl.bucket_rows == 128
    assert pl.n_morsels == 8
    assert pl.n_waves == 2                      # 8 morsels over 4 devices
    loads = [sum(m.rows for m in dev) for dev in pl.assignments]
    assert max(loads) == min(loads) == 256      # LPT balances exactly here


def test_morsel_bucket_fits_largest_partition():
    pl = plan_morsels([(0, 10), (1, 1000)], n_devices=4,
                      min_bucket_rows=8, morsel_rows=64)
    assert pl.bucket_rows >= 1000               # partitions are atomic


def test_empty_placement():
    pl = plan_morsels([], n_devices=3)
    assert pl.n_morsels == 0 and pl.n_waves == 0 and pl.total_rows == 0


def _placement(pl):
    return (pl.bucket_rows, pl.total_rows, pl.n_morsels, pl.n_waves,
            pl.padded_rows,
            [[(m.partitions, m.rows) for m in dev]
             for dev in pl.assignments])


def test_scheduler_matches_reference_property():
    """``plan_morsels`` and ``side_bucket_rows`` equal the reference's
    outputs on the same inputs, over partition sizes (empty partitions
    included), device counts, morsel caps and bucket floors."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from repro.core.partition import Partition as JPartition
    from repro.core.partition import ZoneMap as JZoneMap
    from repro.serve import sharded as ref
    from repro_torch.core.partition import Partition, ZoneMap

    def parts(cls, zone, rows):
        out, start = [], 0
        for i, r in enumerate(rows):
            out.append(cls(index=i, start=start, stop=start + r,
                           zone=zone(n_rows=r, null_count=0, columns={})))
            start += r
        return out

    @settings(max_examples=80, deadline=None)
    @given(rows=st.lists(st.integers(0, 300), max_size=20),
           keep=st.lists(st.booleans(), min_size=20, max_size=20),
           side=st.lists(st.integers(0, 300), min_size=20, max_size=20),
           n_devices=st.integers(0, 9), morsel_rows=st.integers(1, 512),
           min_bucket_rows=st.integers(1, 64))
    def check(rows, keep, side, n_devices, morsel_rows, min_bucket_rows):
        surviving = [(i, r) for i, r in enumerate(rows) if keep[i]]
        got = plan_morsels(surviving, n_devices, min_bucket_rows,
                           morsel_rows)
        want = ref.plan_morsels(surviving, n_devices, min_bucket_rows,
                                morsel_rows)
        assert _placement(got) == _placement(want)
        sides = side[:len(rows)]
        assert side_bucket_rows(got, parts(Partition, ZoneMap, sides),
                                min_bucket_rows) \
            == ref.side_bucket_rows(want, parts(JPartition, JZoneMap,
                                                sides), min_bucket_rows)

    check()


def test_executor_device_lists():
    """``devices=0`` is every local device of the home's type (the one
    CPU here), a count clamps to what exists, a list is taken as given."""
    assert ShardedExecutor(home="cpu").devices == [torch.device("cpu")]
    assert ShardedExecutor(8, home="cpu").n_devices == 1
    four = ShardedExecutor(CPU4)
    assert four.n_devices == 4 and four.mesh_shape == (4,)
    assert four.home == torch.device("cpu")
    with pytest.raises(ValueError):
        ShardedExecutor([])
    # no home: the card, as every entry point of the port
    if torch.cuda.is_available():
        assert ShardedExecutor().home.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedExecutor()


# ---------------------------------------------------------------------------
# 3. Pruning soundness + bit-exactness (deterministic pinned cases)
# ---------------------------------------------------------------------------

def _prune_and_execute(ns, values, valid, pred, partition_rows,
                       devices=0):
    store = ns.ModelStore()
    t = _table(ns, values, valid=valid)
    store.register_table("t", t, partition_rows=partition_rows)
    pt = store.get_partitioned("t")
    opt, _report = _optimize(ns, store, _filter_plan(ns, pred))
    surviving = opt.find("scan")[0].attrs.get("partitions")
    oracle = np.asarray(pred(ns.col).evaluate(
        {k: _host(v) for k, v in t.columns.items()})).astype(bool)
    oracle &= _host(t.valid)
    if surviving is not None:
        for p in pt.partitions:
            if p.index not in surviving:
                assert not oracle[p.start:p.stop].any(), \
                    f"pruned partition {p.index} has a matching valid row"
    # sharded pruned execution == valid rows of whole-table execution
    surv = surviving if surviving is not None \
        else tuple(range(pt.n_partitions))
    fn = ns.core.compile_plan(opt, store)          # raw closure
    want = fn({"t": t})
    executor = ns.executor(devices)
    parts = [pt.partitions[i] for i in surv]
    placement = executor.plan(parts, min_bucket_rows=4)
    got = executor.execute(fn, pt, "t", parts, placement)
    _assert_same_valid_rows(got, want)
    return surviving, got


def _check_prune_sound_and_bit_exact(values, valid, pred, partition_rows):
    """In both packages: pruning sound, sharded == whole-table on valid
    rows; the port's surviving set and answer equal the reference's, and
    over four CPU devices equal one device's bitwise."""
    j_surv, j_out = _prune_and_execute(J, values, valid, pred,
                                       partition_rows)
    t_surv, t_out = _prune_and_execute(T, values, valid, pred,
                                       partition_rows)
    assert t_surv == j_surv
    assert (_host(t_out.valid) == _host(j_out.valid)).all()
    _assert_same_valid_rows(t_out, j_out)
    _s4, t4 = _prune_and_execute(T, values, valid, pred, partition_rows,
                                 devices=CPU4)
    assert _bits(t4.valid) == _bits(t_out.valid)
    for k in t_out.columns:
        assert _bits(t4.columns[k]) == _bits(t_out.columns[k]), k


PINNED = [
    # (values, valid, predicate, partition_rows)
    ([0, 1, 2, 3, 4, 5, 6, 7], None, lambda c: c("a") < 3, 2),
    ([0, 1, 2, 3], [0, 0, 0, 0], lambda c: c("a") >= 0, 2),  # all-NULL
    ([5, 5, 5, 9], [1, 1, 0, 1], lambda c: c("a") == 5, 1),  # 1-row parts
    ([1, 2, 3, 4, 5], [1, 0, 1, 0, 1],
     lambda c: (c("a") > 1) & (c("a") <= 4), 2),
    ([3], [1], lambda c: c("a") != 3, 1),                    # 1-row, 1-part
    ([0, 0, 0, 1, 1, 1], None, lambda c: c("a") != 0, 3),    # domain !=
    # float32 rounding: zone tests must compare in the runtime's float32
    # (0.1f > 0.1 in float64 would unsoundly prune the matching row)
    (np.asarray([0.1, 50.0], np.float32), None, lambda c: c("a") <= 0.1, 1),
    (np.asarray([0.1, 0.3, 7.0, 9.0], np.float32), [1, 0, 1, 1],
     lambda c: (c("a") > 0.1) & (c("a") < 8.5), 2),
]


@pytest.mark.timeout_guard(600)
@pytest.mark.parametrize("values,valid,pred,partition_rows", PINNED)
def test_pruning_pinned_cases(values, valid, pred, partition_rows):
    _check_prune_sound_and_bit_exact(values, valid, pred, partition_rows)


def test_pruning_composes_with_predicate_pushdown():
    """A filter that starts *above* a computed column still prunes: the
    pushdown rule moves it onto the scan first."""
    def fn(ns):
        store = ns.ModelStore()
        store.register_table("t", _table(ns, np.arange(100)),
                             partition_rows=10)
        plan = ns.Plan()
        s = plan.emit("scan", "RA", [], "table", table="t")
        m = plan.emit("map", "RA", [s], "table", name="twice",
                      expr=ns.col("a") * 2)
        plan.output = plan.emit("filter", "RA", [m], "table",
                                predicate=ns.col("a") < 25)
        opt, report = _optimize(ns, store, plan)
        assert report.fired("predicate_pushdown")
        assert report.fired("partition_pruning")
        return report.partitions["t"]

    assert _both(fn) == (3, 10)


def test_pruning_respects_disable_flag_and_consumer_forks():
    def fn(ns):
        store = ns.ModelStore()
        store.register_table("t", _table(ns, np.arange(40)),
                             partition_rows=10)
        plan = _filter_plan(ns, lambda c: c("a") < 5)
        opt, _ = _optimize(ns, store, plan, enable_partition_pruning=False)
        off = "partitions" in opt.find("scan")[0].attrs
        # fork: a second consumer of the scan sees unfiltered rows
        plan = _filter_plan(ns, lambda c: c("a") < 5)
        scan_id = plan.find("scan")[0].id
        plan.output = plan.emit("union", "RA", [plan.output, scan_id],
                                "table")
        opt, _ = _optimize(ns, store, plan)
        return off, "partitions" in opt.find("scan")[0].attrs

    assert _both(fn) == (False, False)


def test_partition_aware_signatures_and_row_estimates():
    store = ModelStore(device="cpu")
    store.register_table("t", _table(T, np.sort(np.arange(100) % 50)),
                         partition_rows=10)
    opt_a, _ = _optimize(T, store, _filter_plan(T, lambda c: c("a") < 10))
    opt_b, _ = _optimize(T, store, _filter_plan(T, lambda c: c("a") < 10))
    opt_c, _ = _optimize(T, store, _filter_plan(T, lambda c: c("a") < 10),
                         enable_partition_pruning=False)
    assert plan_signature(opt_a) == plan_signature(opt_b)
    assert plan_signature(opt_a) != plan_signature(opt_c)
    scan = opt_a.find("scan")[0]
    rows = estimate_rows(opt_a, store)
    surv = scan.attrs["partitions"]
    assert rows[scan.id] == 10.0 * len(surv)      # partition-count-aware
    # the same signatures as the reference's plans
    from repro.core.ir import plan_signature as jsig
    jstore = J.ModelStore()
    jstore.register_table("t", _table(J, np.sort(np.arange(100) % 50)),
                          partition_rows=10)
    jopt, _ = _optimize(J, jstore, _filter_plan(J, lambda c: c("a") < 10))
    assert jsig(jopt) == plan_signature(opt_a)
    assert jopt.find("scan")[0].attrs["partitions"] == surv


# ---------------------------------------------------------------------------
# 3b. Hypothesis property (plus the seeded twin below)
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                # pragma: no cover
    HAVE_HYPOTHESIS = False

_OPS = ["==", "!=", "<", "<=", ">", ">="]


def _mk_pred(spec):
    def pred(c):
        out = None
        for op, value in spec:
            a = c("a")
            term = {"==": a == value, "!=": a != value, "<": a < value,
                    "<=": a <= value, ">": a > value, ">=": a >= value}[op]
            out = term if out is None else out & term
        return out
    return pred


if HAVE_HYPOTHESIS:
    @pytest.mark.timeout_guard(900)
    @given(
        values=st.lists(st.integers(min_value=-4, max_value=4),
                        min_size=1, max_size=24),
        valid_bits=st.lists(st.booleans(), min_size=24, max_size=24),
        partition_rows=st.integers(min_value=1, max_value=9),
        spec=st.lists(st.tuples(st.sampled_from(_OPS),
                                st.integers(min_value=-5, max_value=5)),
                      min_size=1, max_size=3),
    )
    @settings(max_examples=40, deadline=None)
    def test_pruned_partition_never_holds_matching_row(
            values, valid_bits, partition_rows, spec):
        _check_prune_sound_and_bit_exact(
            values, valid_bits[:len(values)], _mk_pred(spec),
            partition_rows)


@pytest.mark.timeout_guard(900)
def test_pruning_randomized_sweep():
    """Seeded twin of the hypothesis property (the sweep runs even where
    hypothesis is absent — change both together)."""
    rng = np.random.RandomState(42)
    for _ in range(40):
        n = int(rng.randint(1, 25))
        values = rng.randint(-4, 5, n)
        valid = rng.rand(n) < rng.choice([0.0, 0.5, 1.0])
        partition_rows = int(rng.randint(1, 10))
        spec = [(_OPS[rng.randint(len(_OPS))], int(rng.randint(-5, 6)))
                for _ in range(rng.randint(1, 4))]
        _check_prune_sound_and_bit_exact(values, valid, _mk_pred(spec),
                                         partition_rows)


# ---------------------------------------------------------------------------
# 4. Service integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def partitioned_store():
    """The same ``people`` table (clustered on age, 10 partitions) and
    logistic-regression pipeline in both packages: fitted by the JAX
    package, carried into the port."""
    from repro.ml import (LogisticRegression, Pipeline, PipelineMetadata,
                          StandardScaler)
    rng = np.random.RandomState(0)
    n = 2000
    age = np.sort(rng.randint(0, 100, n))          # clustered on age
    x = rng.randn(n).astype(np.float32)
    cols = {"pid": np.arange(n), "age": age, "x": x}
    data = {"age": age.astype(np.float32), "x": x}
    sc = StandardScaler(["age", "x"]).fit(data)
    pipe = Pipeline([sc], LogisticRegression(steps=15),
                    PipelineMetadata(name="m", task="classification"))
    pipe.fit(data, (age > 50).astype(np.int32))
    out = {}
    for ns, model in ((J, pipe), (T, pipeline_from_state(
            pipeline_state(pipe)))):
        t = ns.Table.from_pydict(cols)
        store = ns.ModelStore()
        store.register_table("people", t, partition_rows=200)
        store.register_model("m", model)
        out[ns.pkg] = (store, t)
    assert out["torch"][0].model_digest("m") \
        == out["jax"][0].model_digest("m")
    return out


SQL = "SELECT pid, PREDICT(MODEL='m') AS s FROM people WHERE age < 30"


def _sharded_service(ns, store, **knobs):
    if ns.pkg == "jax":
        knobs.pop("shard_devices", None)
    return ns.PredictionService(store, jit=ns.jit,
                                execution_config=ns.core.ExecutionConfig(
                                    sharded=True, shard_min_bucket_rows=32,
                                    **knobs))


def _differential(body, stores=None, jit=False):
    """``body(ns, store, table)`` in both packages, returning
    ``(outputs, services)``: the port's outputs equal the JAX package's
    on the mask and the valid rows (when both run unjitted), and every
    service's ``ServiceStats`` and ``shard_info()`` field by field."""
    res = {}
    for pkg in ("jax", "torch"):
        ns = _ns(pkg, jit)
        store, t = stores[pkg] if stores is not None else (None, None)
        outs, svcs = body(ns, store, t)
        res[pkg] = (outs, [asdict(s.stats) for s in svcs],
                    [s.shard_info() for s in svcs])
        for s in svcs:
            s.close()
    (jo, js, ji), (to, ts, ti) = res["jax"], res["torch"]
    assert ts == js and ti == ji
    if not jit:
        assert len(to) == len(jo)
        for jv, tv in zip(jo, to):
            assert tv.capacity == jv.capacity
            assert (_host(tv.valid) == _host(jv.valid)).all()
            _assert_same_valid_rows(tv, jv)


def test_service_sharded_bit_exact_and_pruned(partitioned_store):
    def body(ns, store, _t):
        base = ns.PredictionService(store, jit=ns.jit)
        svc = _sharded_service(ns, store)
        want = base.run(SQL)
        got = svc.run(SQL)
        _assert_same_valid_rows(got, want)
        info = svc.shard_info()
        assert info["enabled"] and info["sharded_executions"] == 1
        assert info["partitions_pruned"] >= 5      # age-clustered
        assert got.capacity < want.capacity        # pruned rows not placed
        return [got, want], [base, svc]

    _differential(body, partitioned_store)


@pytest.mark.timeout_guard(600)
def test_service_sharded_four_devices_equal_one(partitioned_store):
    """Morsels over four CPU devices (one worker thread each): the same
    answers, bitwise, as one device; one twin, waves spread."""
    store, _ = partitioned_store["torch"]
    sql = "SELECT pid, PREDICT(MODEL='m') AS s FROM people"
    one = _sharded_service(T, store)
    four = _sharded_service(T, store, shard_devices=CPU4)
    try:
        want, got = one.run(sql), four.run(sql)
        assert _bits(got.valid) == _bits(want.valid)
        for k in want.columns:
            assert _bits(got.columns[k]) == _bits(want.columns[k]), k
        assert four.shard_info()["mesh_shape"] == (4,)
        # one 2,048-row morsel on one device; 512-row morsels (two
        # partitions each) on four: 5 morsels, 2 waves
        assert (one.stats.shard_waves, four.stats.shard_waves) == (1, 2)
        assert four.stats.shard_compiles == 1
    finally:
        one.close()
        four.close()


def test_service_sharded_zero_compiles_on_warm_repeat(partitioned_store):
    def body(ns, store, _t):
        svc = _sharded_service(ns, store)
        svc.run(SQL)
        before = (svc.stats.cache_misses, svc.stats.shard_compiles,
                  svc.stats.jit_traces)
        for _ in range(3):
            svc.run(SQL)
        after = (svc.stats.cache_misses, svc.stats.shard_compiles,
                 svc.stats.jit_traces)
        assert before == after
        assert svc.stats.shard_hits >= 3
        assert svc.stats.jit_traces > 0
        return [], [svc]

    _differential(body, partitioned_store, jit=True)


def test_service_sharded_unpruned_full_bit_exact(partitioned_store):
    sql = "SELECT pid, PREDICT(MODEL='m') AS s FROM people"

    def body(ns, store, _t):
        base = ns.PredictionService(store, jit=ns.jit)
        svc = _sharded_service(ns, store)
        want, got = base.run(sql), svc.run(sql)
        assert got.capacity == want.capacity       # nothing pruned
        assert (_host(got.valid) == _host(want.valid)).all()
        for k in want.columns:
            assert (_host(got.columns[k])
                    == _host(want.columns[k])).all(), k
        return [got, want], [base, svc]

    _differential(body, partitioned_store)


def test_service_sharded_capture_populates_result_cache(partitioned_store):
    """The executor reassembles per-morsel capture slices in partition
    order; the stored value is bit-exact the whole-table serve's capture,
    so a second query splices from it."""
    sql = "SELECT pid, PREDICT(MODEL='m') AS s FROM people"
    sql2 = "SELECT pid, x, PREDICT(MODEL='m') AS s FROM people"

    def body(ns, store, _t):
        svc = _sharded_service(ns, store)
        svc.run(sql)
        assert svc.stats.sharded_executions == 1
        assert svc.stats.result_puts == 1
        out = svc.run(sql2)
        assert svc.stats.result_hits == 1
        assert svc.stats.spliced_executions == 1
        base = ns.PredictionService(store, jit=ns.jit)   # unsharded
        want = base.run(sql2)
        _assert_same_valid_rows(out, want)
        return [out, want], [svc, base]

    _differential(body, partitioned_store)


def test_service_sharded_pruned_serve_skips_capture(partitioned_store):
    """When zone maps pruned partitions the reassembled capture covers
    only surviving rows — not the value the result-cache key claims — so
    it must be discarded, never stored."""
    def body(ns, store, _t):
        svc = _sharded_service(ns, store)
        out = svc.run(SQL)                          # age < 30: prunes
        assert svc.shard_info()["partitions_pruned"] > 0
        assert svc.stats.result_puts == 0
        return [out], [svc]

    _differential(body, partitioned_store)


def test_service_override_tables_never_prune_or_shard(partitioned_store):
    def body(ns, store, t):
        svc = _sharded_service(ns, store)
        # rows that the catalog zone maps would prune away must still be
        # served when the caller supplies their own table
        sub = type(t)({k: v[-64:] for k, v in t.columns.items()},
                      t.valid[-64:], t.schema)
        out = svc.run(SQL, {"people": sub})
        assert out.capacity == 64
        assert svc.stats.sharded_executions == 0
        assert "partitions" not in [a for n in svc.compile(
            SQL, {"people": sub}).plan.nodes.values() for a in n.attrs]
        return [out], [svc]

    _differential(body, partitioned_store)


def test_service_all_partitions_pruned(partitioned_store):
    def body(ns, store, _t):
        svc = _sharded_service(ns, store)
        out = svc.run("SELECT pid, PREDICT(MODEL='m') AS s FROM people "
                      "WHERE age < 0")
        assert out.capacity == 0
        assert svc.shard_info()["prune_rate"] == 1.0
        return [out], [svc]

    _differential(body, partitioned_store)


def test_stale_pruning_falls_back_to_full_scan():
    """A table re-registered between compile and execute (invalidation
    evicts the cache entry, but an in-flight execution can already hold
    it) may keep its partition *count* while its data changed — the
    version snapshot must void the stale pruned-partition set."""
    rng = np.random.RandomState(1)
    first = np.sort(rng.randint(0, 100, 400))
    second = np.sort(rng.randint(0, 100, 400))[::-1].copy()

    def body(ns, _store, _t):
        store = ns.ModelStore()
        store.register_table("t", _table(ns, first), partition_rows=50)
        svc = ns.PredictionService(
            store, jit=ns.jit, execution_config=ns.core.ExecutionConfig(
                sharded=True, shard_min_bucket_rows=16))
        compiled = svc.compile(_filter_plan(ns, lambda c: c("a") < 20))
        stale = compiled.plan.find("scan")[0].attrs["partitions"]
        assert len(stale) < 8                          # pruning happened
        # same partition count, inverted clustering: the stale set is
        # wrong
        t2 = _table(ns, second)
        store.register_table("t", t2, partition_rows=50)
        out = svc._execute_sharded(compiled, {"t": t2})
        assert svc.stats.partitions_scanned == 8       # full scan
        want = second[second < 20]
        got = _host(out.column("a"))[_host(out.valid)]
        assert got.shape == want.shape and (got == want).all()
        # partitioning dropped entirely mid-flight: whole-table fallback
        store.register_table("t", t2)                  # unpartitioned
        out2 = svc._execute_sharded(compiled, {"t": t2})
        got = _host(out2.column("a"))[_host(out2.valid)]
        assert (got == want).all()
        return [out, out2], [svc]

    _differential(body)


def test_sharded_config_is_part_of_the_cache_key(partitioned_store):
    store, _ = partitioned_store["torch"]
    svc1 = PredictionService(store)
    c1 = svc1.compile(SQL)
    svc2 = _sharded_service(T, store)
    c2 = svc2.compile(SQL)
    assert c1.key != c2.key
    # every knob is in the key, an explicit device list included
    base = ExecutionConfig(sharded=True)
    for knob, value in (("shard_devices", 2), ("shard_devices", CPU4),
                        ("shard_morsel_rows", 1024),
                        ("shard_min_bucket_rows", 8),
                        ("shard_exchange", False),
                        ("shard_exchange_cost_gate", False)):
        other = ExecutionConfig(sharded=True, **{knob: value})
        assert other.cache_key() != base.cache_key(), knob
        hash(other.cache_key())
    assert ExecutionConfig().cache_key() \
        == ExecutionConfig(sharded=False).cache_key()
    svc1.close(); svc2.close()
