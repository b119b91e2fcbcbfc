"""SQL front-door diagnostics on the port: every failure is a
*positioned* SqlError.  The cases of ``tests/test_sql_front_door.py`` run
on the port's parser and service, and differential cases hold the port
against the JAX package: the same corpus of valid, truncated and mutated
queries parses to equal plan signatures or fails with the same error type,
message and offset in both packages, and one ``sql()`` script (parse-cache
hits, positional and named bindings, errors through the ticket) leaves
equal answers and equal ``ServiceStats``.

The contract under test (satellite of the multi-tenant front door): any
malformed, truncated or mutated query string surfaces as
:class:`~repro_torch.core.sql_frontend.SqlError` carrying

- ``pos`` — an integer character offset into the original text,
  ``0 <= pos <= len(sql)``;
- a caret snippet in ``str(err)`` whose ``^`` aligns with that offset;

never a raw ``IndexError``/``StopIteration``/``AttributeError`` escaping
the parser.  Unknown tables/columns/models (resolved against the catalog)
raise :class:`SqlLookupError`, which is *also* a ``KeyError`` — the
pre-front-door contract for catalog lookups.

Without a ``hypothesis`` dependency the property is checked by exhaustive
truncation plus seeded random mutation — deterministic across runs.
"""

import random
import string

import numpy as np
import pytest

from repro_torch.core import ModelStore
from repro_torch.core.sql_frontend import SqlError, SqlLookupError, parse_query
from repro_torch.serve import PredictionService
from repro_torch.data import hospital_tables
from repro.ml import DecisionTree, Pipeline, PipelineMetadata, StandardScaler
from repro_torch.ml.convert import pipeline_from_state, pipeline_state


def _carry(pipe):
    """A pipeline fitted by the JAX package, carried into the port as
    numpy state (the two packages' fits are not bitwise equal)."""
    return pipeline_from_state(pipeline_state(pipe))


pytestmark = pytest.mark.tier1

FEATS = ["age", "gender", "pregnant", "rcount"]

VALID_QUERIES = [
    "SELECT pid, age FROM patient_info WHERE age > 30",
    ("SELECT pid, PREDICT(MODEL='m') AS p FROM patient_info "
     "WHERE age > 30 AND PREDICT(MODEL='m') > 5"),
    ("SELECT gender, AVG(length_of_stay) AS alos FROM patient_info "
     "GROUP BY gender ORDER BY alos DESC LIMIT 3"),
    "SELECT pid FROM patient_info WHERE age > :lo AND age < :hi",
    "SELECT pid, age FROM patient_info WHERE age > ? ORDER BY age LIMIT 5",
]


def _jax_fit(store):
    pi = store.get_table("patient_info")
    data = {c: np.asarray(pi.column(c)) for c in pi.names}
    sc = StandardScaler(FEATS).fit(data)
    pipe = Pipeline([sc], DecisionTree(task="regression", max_depth=4),
                    PipelineMetadata(name="m", task="regression"))
    pipe.fit({k: data[k] for k in FEATS}, data["length_of_stay"])
    return pipe


@pytest.fixture(scope="module")
def store():
    store = ModelStore(device="cpu")
    for n, t in hospital_tables(200, seed=7).items():
        store.register_table(n, t)
    store.register_model("m", _carry(_jax_fit(store)))
    return store


@pytest.fixture(scope="module")
def jstore(store):
    from repro.core import ModelStore as JModelStore
    from repro.data import hospital_tables as jhospital
    js = JModelStore()
    for n, t in jhospital(200, seed=7).items():
        js.register_table(n, t)
    js.register_model("m", _jax_fit(js))
    assert js.model_digest("m") == store.model_digest("m")
    return js


def _assert_positioned(err: SqlError, sql: str):
    assert isinstance(err, SqlError)
    assert isinstance(err.pos, int), f"no position on: {err.message}"
    assert 0 <= err.pos <= len(sql)
    rendered = str(err)
    assert f"(at offset {err.pos})" in rendered
    lines = rendered.splitlines()
    if err.sql is not None:
        # caret line aligns under the snippet line
        assert lines[-1].strip() == "^"


# ---------------------------------------------------------------------------
# Directed cases: the offset points at the offending token
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql, fragment", [
    ("SELECT FROM patient_info", "FROM"),
    ("SELECT pid patient_info", "patient_info"),
    ("SELECT pid FROM", None),                     # end of query
    ("SELECT pid FROM patient_info WHERE", None),
    ("SELECT pid FROM patient_info WHERE age >", None),
    ("SELECT pid FROM patient_info WHERE age > 'x", "'x"),
    ("SELECT pid FROM patient_info GROUP BY", None),
    ("SELECT pid, PREDICT(MODEL=) AS p FROM patient_info", ")"),
    ("SELECT pid, PREDICT(MODEL'm') AS p FROM patient_info", "'m'"),
    ("SELECT pid, PREDICT() AS p FROM patient_info", ")"),
    ("SELECT pid FROM patient_info WHERE age > 30 !", "!"),
])
def test_offset_points_at_offending_token(store, sql, fragment):
    with pytest.raises(SqlError) as exc:
        parse_query(sql, store)
    _assert_positioned(exc.value, sql)
    if fragment is None:
        assert exc.value.pos == len(sql)
    else:
        assert exc.value.pos == sql.index(fragment)


@pytest.mark.parametrize("sql, name, kind", [
    ("SELECT pid FROM no_such_table", "no_such_table", "table"),
    ("SELECT zzz FROM patient_info", "zzz", "column"),
    ("SELECT pid FROM patient_info WHERE bogus > 1", "bogus", "column"),
    ("SELECT pid FROM patient_info ORDER BY nope", "nope", "column"),
    # model-name errors point at the string *token* (opening quote)
    ("SELECT pid, PREDICT(MODEL='ghost') AS p FROM patient_info",
     "'ghost'", "model"),
])
def test_unknown_names_are_lookup_errors(store, sql, name, kind):
    with pytest.raises(SqlLookupError) as exc:
        parse_query(sql, store)
    _assert_positioned(exc.value, sql)
    assert f"unknown {kind}" in exc.value.message
    assert exc.value.pos == sql.index(name)
    # backward compat: catalog misses were KeyErrors before positioning
    assert isinstance(exc.value, KeyError)


def test_caret_alignment_renders_under_offset(store):
    sql = "SELECT pid FROM patient_info WHERE bogus > 1"
    with pytest.raises(SqlError) as exc:
        parse_query(sql, store)
    rendered = str(exc.value).splitlines()
    snippet, caret = rendered[-2], rendered[-1]
    # both lines share the same indent, so the caret's string index lands
    # exactly on the offending character in the snippet line
    assert snippet[caret.index("^"):].startswith("bogus")


def test_mixed_param_styles_rejected(store):
    sql = "SELECT pid FROM patient_info WHERE age > ? AND age < :hi"
    with pytest.raises(SqlError) as exc:
        parse_query(sql, store)
    _assert_positioned(exc.value, sql)
    assert "mix" in exc.value.message


# ---------------------------------------------------------------------------
# Property: truncation and mutation never escape SqlError
# ---------------------------------------------------------------------------

def test_every_truncation_fails_positioned_or_parses(store):
    for sql in VALID_QUERIES:
        for cut in range(len(sql)):
            trunc = sql[:cut]
            try:
                parse_query(trunc, store)
            except SqlError as err:
                _assert_positioned(err, trunc)
            # no other exception type may escape


def test_seeded_mutations_fail_positioned_or_parse(store):
    rng = random.Random(0xC0FFEE)
    alphabet = string.ascii_letters + string.digits + " '()<>=*,.?:!@#$%"
    checked = failures = 0
    for sql in VALID_QUERIES:
        for _ in range(200):
            s = list(sql)
            for _ in range(rng.randint(1, 3)):
                op = rng.randrange(3)
                i = rng.randrange(len(s)) if s else 0
                if op == 0 and s:
                    s[i] = rng.choice(alphabet)         # substitute
                elif op == 1 and s:
                    del s[i]                            # delete
                else:
                    s.insert(i, rng.choice(alphabet))   # insert
            mutated = "".join(s)
            checked += 1
            try:
                parse_query(mutated, store)
            except SqlError as err:
                failures += 1
                _assert_positioned(err, mutated)
    assert checked == 1000
    assert failures > 300, "mutation corpus too tame to mean anything"


def test_random_garbage_fails_positioned(store):
    rng = random.Random(7)
    printable = string.printable
    for _ in range(300):
        garbage = "".join(rng.choice(printable)
                          for _ in range(rng.randint(0, 60)))
        try:
            parse_query(garbage, store)
        except SqlError as err:
            _assert_positioned(err, garbage)


# ---------------------------------------------------------------------------
# Catalogs without schema skip name resolution (old contract)
# ---------------------------------------------------------------------------

class _ModelsOnly:
    def get_model(self, name):
        raise KeyError(name)


def test_schemaless_catalog_skips_column_resolution():
    plan = parse_query("SELECT anything FROM wherever WHERE x > 1",
                       _ModelsOnly())
    assert plan.output is not None


def test_schemaless_catalog_still_positions_model_errors():
    sql = "SELECT pid, PREDICT(MODEL='nope') AS p FROM t"
    with pytest.raises(SqlLookupError) as exc:
        parse_query(sql, _ModelsOnly())
    assert exc.value.pos == sql.index("'nope'")


# ---------------------------------------------------------------------------
# Differential: the same texts through both packages' front doors
# ---------------------------------------------------------------------------

def _corpus():
    rng = random.Random(0xBEEF)
    alphabet = string.ascii_letters + string.digits + " '()<>=*,.?:!@#$%"
    out = []
    for sql in VALID_QUERIES:
        out.append(sql)
        out += [sql[:cut] for cut in range(0, len(sql), 7)]
        for _ in range(40):
            s = list(sql)
            i = rng.randrange(len(s))
            op = rng.randrange(3)
            if op == 0:
                s[i] = rng.choice(alphabet)
            elif op == 1:
                del s[i]
            else:
                s.insert(i, rng.choice(alphabet))
            out.append("".join(s))
    out += ["SELECT nope FROM patient_info", "SELECT pid FROM nowhere",
            "SELECT PREDICT(MODEL='zz') AS p FROM patient_info"]
    return out


def test_parse_outcomes_match_jax(store, jstore):
    from repro.core import parse_query as jparse
    from repro.core.ir import plan_signature as jsig
    from repro_torch.core.ir import plan_signature as tsig

    def outcome(parse, sig, sql, catalog):
        try:
            return ("ok", sig(parse(sql, catalog)))
        except Exception as err:       # compared across packages below
            return (type(err).__name__, str(err), getattr(err, "pos", None))

    corpus = _corpus()
    parsed = 0
    for sql in corpus:
        want = outcome(jparse, jsig, sql, jstore)
        got = outcome(parse_query, tsig, sql, store)
        assert got == want, sql
        parsed += want[0] == "ok"
    assert 10 <= parsed < len(corpus)


def _sql_script(svc, errors):
    q = ("SELECT pid, PREDICT(MODEL='m') AS p FROM patient_info "
         "WHERE age > :lo AND age < :hi")
    outs = [svc.sql(q, params={"lo": 20, "hi": 60}),
            svc.sql(q, params={"lo": 20, "hi": 60}),
            svc.sql(q, params={"hi": 70, "lo": 30}),
            svc.sql(VALID_QUERIES[4], params=[41]),
            svc.sql(VALID_QUERIES[4], params=[41.5]),
            svc.sql(VALID_QUERIES[2]), svc.sql(VALID_QUERIES[2])]
    for bad in ("SELECT pid FROM patient_info WHERE", "SELECT zz FROM t"):
        try:
            svc.sql(bad)
        except Exception as err:
            errors.append((type(err).__name__, str(err)))
    return outs


def test_service_sql_script_matches_jax(store, jstore):
    from dataclasses import asdict

    from repro.serve import PredictionService as JService
    jsvc = JService(jstore, jit=False)
    tsvc = PredictionService(store, jit=False)
    jerr, terr = [], []
    jouts, touts = _sql_script(jsvc, jerr), _sql_script(tsvc, terr)
    assert terr == jerr and len(terr) == 2
    for jo, to in zip(jouts, touts):
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid))
        for k in jo.columns:
            np.testing.assert_array_equal(to.columns[k].numpy(),
                                          np.asarray(jo.columns[k]))
    assert asdict(tsvc.stats) == asdict(jsvc.stats)
    assert tsvc.stats.sql_parse_hits >= 3
    jsvc.close()
    tsvc.close()
