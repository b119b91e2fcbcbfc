"""The frozen generators and the traffic generator repeat by seed, and
draw the parameters each mix names."""

import itertools

import numpy as np
import pytest

from raven_bench.harness import layout, traffic

MAN = layout.manifest()
SEED = 2**31 + 12345           # larger than 32 signed bits hold


def _info(n=1_000_000):
    return {"ranges": {"pid": (0, n - 1), "distance": (100.0, 3000.0),
                       "taxi_out": (-10.0, 40.0)},
            "anchor_rows": n, "pool_rows": n}


@pytest.mark.parametrize("gen, n", [("hospital", 5000), ("flights", 5000)])
def test_data_repeats_by_seed(gen, n):
    mod = layout.module("data", gen)
    a, b, c = mod.generate(n, SEED), mod.generate(n, SEED), \
        mod.generate(n, SEED + 1)
    for t in a:
        for col in a[t]:
            assert np.array_equal(a[t][col], b[t][col])
    assert any(not np.array_equal(a[t][col], c[t][col])
               for t in a for col in a[t] if col != "pid")


def test_flights_has_the_kaggle_domains():
    f = layout.module("data", "flights").generate(
        200_000, 3, n_airports=322, n_carriers=14)["flights"]
    assert f["origin"].max() < 322 and f["dest"].max() < 322
    assert f["carrier"].max() < 14 and f["dow"].max() < 7


def _take(name, role_no=0, client=0, seed=SEED, k=60):
    mix = layout.traffic(name)
    gen = traffic.requests(mix["roles"][role_no], client, seed, role_no,
                           _info())
    return list(itertools.islice(gen, k))


MIXES = sorted(p.stem for p in (layout.BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_traffic_repeats_by_seed(name):
    a, b, c = _take(name), _take(name), _take(name, seed=SEED + 1)
    key = [(r.query["name"], r.binding, r.rows) for r in a]
    assert key == [(r.query["name"], r.binding, r.rows) for r in b]
    assert key != [(r.query["name"], r.binding, r.rows) for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_names_its_source(name):
    src = layout.traffic(name)["source"]
    assert src and "\n" not in src
    cells = {w["traffic"] for w in MAN["workloads"]}
    assert (name in cells) == (not src.startswith("none"))


def test_cohort_scan_mix_and_widths():
    reqs = _take("cohort_scan", k=100)       # ten cycles of ten
    names = [r.query["name"] for r in reqs]
    assert names.count("score") == 50 and names.count("gender_avg") == 30 \
        and names.count("top100") == 20
    widths = np.array([r.binding["hi"] - r.binding["lo"] for r in reqs])
    assert widths.min() >= 10_000 and widths.max() <= 1_000_000
    assert all(0 <= r.binding["lo"] and r.binding["hi"] <= 1_000_000
               for r in reqs)
    # log-uniform: the median width near sqrt(1e4 * 1e6)
    assert 50_000 < np.median(widths) < 200_000


def test_online_scoring_rows_are_log_uniform_in_range():
    reqs = _take("online_scoring", k=160)
    rows = np.array([r.rows[1] for r in reqs])
    assert rows.min() >= 4096 and rows.max() <= 131072
    assert all(r.input_rows == r.rows[1] for r in reqs)
    assert all(r.rows[0] + r.rows[1] <= 1_000_000 for r in reqs)
    # every cycle of 16 covers the same 16 strata of log(rows)
    u = np.log(rows / 4096) / np.log(32)
    for cyc in u.reshape(-1, 16):
        for i, v in enumerate(sorted(cyc * 16)):
            assert i - 0.01 <= v <= i + 1.01


def _domain(name, key):
    """The stated domain of parameter ``key`` in mix ``name``."""
    for m in layout.traffic(name)["roles"][0]["mix"]:
        for p in m.get("params", []):
            if p.get("name") == key:
                return p["domain"]
    raise KeyError(key)


@pytest.mark.parametrize("name, streams", [("delay_report", 4),
                                           ("delay_power", 1)])
def test_delay_streams_as_tpch_runs_them(name, streams):
    """Both shapes equally often in every cycle, thresholds float32 and
    uniform over the column's stated domain, stratified within the
    cycle."""
    assert layout.traffic(name)["roles"][0]["clients"] == streams
    assert _domain(name, "d") == [100.0, 3000.0]
    assert _domain(name, "t") == [-10.0, 40.0]
    reqs = _take(name, k=50)
    for r in reqs:
        (key, v), = r.binding.items()
        lo, hi = _domain(name, key)
        assert lo <= v <= hi and np.float32(v) == v
    names = [r.query["name"] for r in reqs]
    for cyc in range(0, 50, 10):
        assert names[cyc:cyc + 10].count("hourly_delay") == 5
        assert names[cyc:cyc + 10].count("route_risk") == 5
    for cyc in range(0, 50, 10):
        for key in ("d", "t"):
            lo, hi = _domain(name, key)
            v = sorted(r.binding[key] for r in reqs[cyc:cyc + 10]
                       if key in r.binding)
            for i, x in enumerate(v):        # one draw in each fifth
                assert i / 5 - 1e-6 <= (x - lo) / (hi - lo) <= (i + 1) / 5 \
                    + 1e-6


@pytest.mark.parametrize("name", ["delay_report", "delay_power"])
def test_thresholds_follow_the_domain_not_the_seeds_data(name):
    """The same seed draws the same thresholds whatever the table's own
    least and most values are; a wider stated domain moves them."""
    def take(info, mix=None):
        mix = mix or layout.traffic(name)
        gen = traffic.requests(mix["roles"][0], 0, SEED, 0, info)
        return [r.binding for r in itertools.islice(gen, 40)]

    other = _info()
    other["ranges"] = {**other["ranges"], "distance": (31.0, 4983.0),
                       "taxi_out": (-12.3, 41.7)}
    assert take(_info()) == take(other)
    wide = layout.traffic(name)
    for m in wide["roles"][0]["mix"]:
        for p in m["params"]:
            p["domain"] = [2 * p["domain"][0] - p["domain"][1],
                           p["domain"][1]]
    moved = take(_info(), wide)
    assert all(a != b for a, b in zip(take(_info()), moved))


def test_mixed_has_two_analysts_and_sixteen_apps():
    mix = layout.traffic("mixed")
    assert [(r["role"], r["clients"]) for r in mix["roles"]] == \
        [("analyst", 2), ("app", 16)]
    assert mix["admission"] == {}


def test_warm_buckets_reach_every_stacked_size():
    role = layout.traffic("online_scoring")["roles"][0]
    b = traffic.warm_buckets(role, 1.0, 64, 1 << 20)
    assert b == [1 << k for k in range(12, 21)] + [2 << 20]
