"""One run of one cell: set up the program from the seed, warm every shape
the cell's traffic uses, drive the closed-loop clients for the window,
read the metrics, then hold the answers against the plain reference.

The program under test is ``repro_torch`` (its ``PredictionService`` over a
``ModelStore`` on the card); the clients, the window and the reference are
the benchmark's own.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import layout, modes
from . import trace as trace_mod
from .traffic import Request, requests, seed_rng, warm_buckets

# Requests still open when the window closes get this long to answer.
GRACE_S = 60.0
# How long the driver of many clients waits on its oldest request before
# it looks at the others again.
POLL_S = 0.0005
# Service spans an idle gap of the device is put down to, innermost first.
SPAN_ORDER = ("bucket_pad", "result_cache_splice", "execute", "optimize",
              "codegen", "queue_wait", "parse")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Record:
    req: Request
    issued: float
    done: float = 0.0
    ok: bool = False
    error: str = ""
    trace: Any = None
    out: Any = None             # the answer, while kept for the check

    @property
    def latency(self) -> float:
        return self.done - self.issued


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: str
    cfg: Dict
    mix: Dict
    seconds: float
    setup_s: float
    t0: float
    t_end: float
    records: List[Record]
    stats0: Dict[str, int]
    stats1: Dict[str, int]
    model_state: Dict
    model_kind: Any             # models/<kind>.py
    columns: Dict[str, np.ndarray]
    device_trace: Optional[trace_mod.DeviceTrace] = None
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def completed(self) -> List[Record]:
        """Requests answered inside the window."""
        return [r for r in self.records if r.ok and r.done <= self.t_end]

    @property
    def answered(self) -> List[Record]:
        """Requests issued in the window and answered, late or not."""
        return [r for r in self.records if r.ok]

    def delta(self, name: str) -> int:
        return self.stats1[name] - self.stats0[name]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _tables(cfg: Dict, seed: int, scale: float) -> Dict[str, Dict]:
    d = cfg["data"]
    n = max(1, int(round(d["rows"] * scale)))
    gen = layout.module("data", d["generator"])
    tables = gen.generate(n, seed, **d.get("args", {}))
    for name, spec in cfg.get("derived", {}).items():
        cols = {}
        for src in spec["from"]:
            cols.update(tables[src])
        tables[name] = {c: cols[c] for c in spec["columns"]}
    return tables


def _columns(tables: Dict[str, Dict]) -> Dict[str, np.ndarray]:
    """Every column of every table, by name: the tables are row-aligned
    (joined on their key), so a name means one array."""
    out: Dict[str, np.ndarray] = {}
    for t in tables.values():
        for c, a in t.items():
            if c in out and not np.array_equal(out[c], a):
                raise ValueError(f"column {c} differs between tables")
            out[c] = a
    return out


class Program:
    """The system under test, set up as a user sets it up: tables and a
    model registered in a ``ModelStore`` on the device, served by a
    ``PredictionService`` with the configuration's settings."""

    def __init__(self, cfg: Dict, mix: Dict, tables: Dict[str, Dict],
                 state: Dict, device: str):
        import torch

        from repro_torch.core import ModelStore, OptimizerConfig
        from repro_torch.ml.convert import pipeline_from_state
        from repro_torch.relational.table import Table
        from repro_torch.serve import AdmissionConfig, PredictionService
        self.torch = torch
        self.Table = Table
        self.device = torch.device(device)
        self.store = ModelStore(device=device)
        for name, cols in tables.items():
            self.store.register_table(name, Table.from_pydict(cols))
        self.store.register_model(cfg["model"]["name"],
                                  pipeline_from_state(state))
        svc_cfg = cfg["service"]
        admission = mix.get("admission")
        self.svc = PredictionService(
            self.store,
            optimizer_config=OptimizerConfig(**svc_cfg.get("optimizer", {})),
            enable_result_cache=svc_cfg.get("enable_result_cache", True),
            admission=None if admission is None
            else AdmissionConfig(**admission))
        self.loop = admission is not None and \
            AdmissionConfig(**admission).background
        self.pool = {name: {c: np.ascontiguousarray(a)
                            for c, a in cols.items()}
                     for name, cols in tables.items()}

    def table(self, name: str, start: int, count: int):
        """A request's own table: rows of the pool, copied to the device."""
        torch = self.torch
        schema = self.store.get_table(name).schema
        pool = self.pool[name]
        n = len(next(iter(pool.values())))
        idx = (np.arange(start, start + count) % n) if start + count > n \
            else slice(start, start + count)
        cols = {c: torch.from_numpy(np.ascontiguousarray(a[idx])).to(
            self.device) for c, a in pool.items()}
        valid = torch.ones(count, dtype=torch.bool, device=self.device)
        return self.Table(cols, valid, schema)

    def submit(self, req: Request):
        """Admit one request (its own table copied to the device first)
        -> the service's ticket."""
        q = req.query
        tables = None
        if req.rows:
            tables = {q["table"]: self.table(q["table"], *req.rows)}
        return self.svc.submit(q["sql"], tables, params=req.binding or None)

    def send(self, req: Request, timeout: float):
        """One request through the front door, as ``svc.sql``/``svc.run``
        send it (submit, then flush where no admission loop runs), keeping
        the ticket's trace.  -> (answer, trace)"""
        ticket = self.submit(req)
        if not self.loop:
            self.svc.flush()
        return ticket.result(timeout=timeout), ticket.trace()

    def stats(self) -> Dict[str, int]:
        return dict(vars(self.svc.stats))

    def close(self) -> None:
        self.svc.close()


def _host(out) -> Dict[str, np.ndarray]:
    if isinstance(out, dict):
        return out
    from repro_torch.relational.table import to_numpy
    h = {k: to_numpy(v) for k, v in out.columns.items()}
    h["valid"] = to_numpy(out.valid)
    return h


def _warm(prog: Program, mix: Dict, seed: int, info: Dict,
          scale: float) -> None:
    """Every query of the mix in its order, three rounds (the second
    settles which query's result the others splice, the third runs as the
    window will); every row bucket a table-sending role can reach."""
    from repro_torch.serve import AdmissionConfig
    adm = AdmissionConfig(**(mix.get("admission") or {}))
    for role_no, role in enumerate(mix["roles"]):
        gen = requests(role, 0, seed ^ 0x5EED, role_no, info, scale)
        first: Dict[str, List[Request]] = {}
        while any(len(first.get(m["name"], [])) < 3 for m in role["mix"]):
            r = next(gen)
            first.setdefault(r.query["name"], []).append(r)
        for k in range(3):
            for m in role["mix"]:
                prog.send(first[m["name"]][k], GRACE_S)
        if role["send"] == "table":
            for m in role["mix"]:
                for b in warm_buckets(role, scale, adm.min_bucket_rows,
                                      adm.max_bucket_rows):
                    r = dataclasses.replace(first[m["name"]][0], rows=(0, b))
                    prog.send(r, GRACE_S)
    if prog.device.type == "cuda":
        prog.torch.cuda.synchronize()


class Client:
    """One closed-loop client: its request sequence, and the reservoir of
    its answers kept for the check (a uniform sample of ``keep``)."""

    def __init__(self, role_no: int, role: Dict, c: int, seed: int,
                 info: Dict, scale: float):
        self.gen = requests(role, c, seed, role_no, info, scale)
        self.keep_rng = seed_rng(seed, 2, role_no, c)
        self.keep = int(role["keep"])
        self.seen = 0
        self.reservoir: List[Record] = []

    def finish(self, rec: Record, out: Any) -> None:
        if out is None:
            return
        self.seen += 1
        if len(self.reservoir) < self.keep:
            self.reservoir.append(rec)
            rec.out = out
            return
        j = int(self.keep_rng.integers(0, self.seen))
        if j < self.keep:
            self.reservoir[j].out = None
            self.reservoir[j] = rec
            rec.out = out


def _drive(prog: Program, mix: Dict, seed: int, info: Dict, scale: float,
           t0: float, t_end: float) -> List[Record]:
    """The closed loops: every client sends its next request when its last
    one is answered, from ``t0`` until ``t_end``.  An analyst has a thread
    of its own (where no admission loop runs, it executes its own request,
    ``flush``, as ``svc.sql`` does).  Under background admission one
    thread drives all of a role's table-sending clients, their requests in
    flight together, so that sixteen client threads do not contend with
    the service's own for the interpreter."""
    records: List[Record] = []
    lock = threading.Lock()
    roles = [[Client(i, role, c, seed, info, scale)
              for c in range(int(role["clients"]))]
             for i, role in enumerate(mix["roles"])]

    def one(cl: Client) -> None:
        time.sleep(max(0.0, t0 - time.monotonic()))
        for req in cl.gen:
            now = time.monotonic()
            if now >= t_end:
                break
            rec = Record(req, now)
            try:
                out, rec.trace = prog.send(req, t_end + GRACE_S - now)
                rec.done, rec.ok = time.monotonic(), True
            except Exception as err:       # counted as failed, run goes on
                rec.done, rec.error = time.monotonic(), repr(err)
                out = None
            cl.finish(rec, out)
            with lock:
                records.append(rec)

    def issue(cl: Client):
        rec = Record(next(cl.gen), time.monotonic())
        try:
            return rec, prog.submit(rec.req)
        except Exception as err:           # counted as failed
            rec.done, rec.error = time.monotonic(), repr(err)
            with lock:
                records.append(rec)
            return None

    def many(clients: List[Client]) -> None:
        time.sleep(max(0.0, t0 - time.monotonic()))
        flight = {}
        for k, cl in enumerate(clients):
            got = issue(cl)
            if got:
                flight[k] = got
        while flight:
            oldest = min(flight, key=lambda k: flight[k][0].issued)
            try:
                flight[oldest][1].result(timeout=POLL_S)
            except TimeoutError:
                if time.monotonic() > t_end + GRACE_S:
                    break
            except Exception:              # read again below
                pass
            for k in [k for k, (_, tk) in flight.items() if tk.done]:
                rec, tk = flight.pop(k)
                rec.done = time.monotonic()
                out = None
                try:
                    out = tk.result(timeout=0)
                    rec.ok = True
                except Exception as err:   # counted as failed
                    rec.error = repr(err)
                rec.trace = tk.trace()
                clients[k].finish(rec, out)
                with lock:
                    records.append(rec)
                if rec.done < t_end:
                    got = issue(clients[k])
                    if got:
                        flight[k] = got
        for rec, _ in flight.values():     # never answered
            rec.done, rec.error = time.monotonic(), "no answer"
            with lock:
                records.append(rec)

    threads = []
    for role, clients in zip(mix["roles"], roles):
        if prog.loop and role["send"] == "table":
            threads.append(threading.Thread(target=many, args=(clients,),
                                            daemon=True))
        else:
            threads += [threading.Thread(target=one, args=(cl,), daemon=True)
                        for cl in clients]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=max(0.0, t_end + GRACE_S + 5 - time.monotonic()))
    hung = sum(th.is_alive() for th in threads)
    if hung:
        raise RuntimeError(f"{hung} clients still waiting {GRACE_S} s "
                           "after the window closed")
    return records


def _check(run: Run, kept: List[tuple], device: str) -> Dict[str, float]:
    """Hold every kept answer against the reference.  -> the numbers
    compared, by name."""
    from ..reference import query as ref_query
    cfg = run.cfg
    ref_mod = layout.module("reference", cfg["model"]["kind"])
    import torch
    cols = run.columns
    model_out = ref_mod.outputs(run.model_state, cols, torch.float64,
                                torch.device(device))
    ref_all = {**cols, **model_out}
    rows = wrong = 0
    avg_gap: Optional[float] = None
    cache: Dict = {}
    for req, out in kept:
        if req.rows:
            start, count = req.rows
            ref = {k: v[start:start + count] for k, v in ref_all.items()}
        else:
            ref = ref_all
        res = ref_query.check(req.query["expect"], req.binding, ref, out,
                              float(cfg["value_tol"]),
                              None if req.rows else cache)
        rows += res["rows"]
        wrong += res["wrong"]
        if "avg_gap" in res:
            avg_gap = max(avg_gap or 0.0, res["avg_gap"])
    nums = {"mismatch_share": wrong / max(rows, 1)}
    if avg_gap is not None:
        nums["avg_rel_gap"] = avg_gap
    nums["rows_checked"] = rows
    return nums


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", scale: float = 1.0,
             log: Callable[[str], None] = lambda s: None,
             program: Any = None) -> Dict:
    """One run of cell ``name``; returns the result line's object.
    ``program`` stands in for :class:`Program` (the control, or a test's
    broken program)."""
    import torch
    man = layout.manifest()
    wl = layout.workload(man, name)
    cfg = layout.config(man, wl["config"])
    mix = layout.traffic(wl["traffic"])
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    phases = {"start": time.monotonic() - t_start}
    tables = _tables(cfg, seed, scale)
    columns = _columns(tables)
    phases["tables"] = time.monotonic() - t_start
    kind = layout.module("models", cfg["model"]["kind"])
    state = kind.build(cfg["model"], columns, seed_rng(seed, 3))
    phases["model"] = time.monotonic() - t_start
    prog = (program or Program)(cfg, mix, tables, state, device)
    phases["program"] = time.monotonic() - t_start
    info = {"ranges": {c: (a.min(), a.max()) for c, a in columns.items()},
            "anchor_rows": len(next(iter(tables[cfg["anchor"]].values()))),
            "pool_rows": len(next(iter(columns.values())))}
    _warm(prog, mix, seed, info, scale)
    gc.collect()
    phases["warm"] = time.monotonic() - t_start
    stats0 = prog.stats()
    watch = modes.Watch()
    watch.start()
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        mark = record_function(trace_mod.WINDOW_MARK)
    t0 = time.monotonic() + 0.05
    t_end = t0 + seconds
    if traced:
        mark.__enter__()
        mark_t = time.monotonic()
    records = _drive(prog, mix, seed, info, scale, t0, t_end)
    if device == "cuda":
        torch.cuda.synchronize()
    watch.stop()
    t_last = max([r.done for r in records] + [t_end])
    dtrace = None
    if traced:
        mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        dtrace = trace_mod.read(prof, mark_t, t0, t_last)
        del prof
    stats1 = prog.stats()
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit("modules of JAX or of the JAX package are loaded: "
                         + ", ".join(found))
    run = Run(name, cfg, mix, seconds, t0 - t_start, t0, t_end, records,
              stats0, stats1, state, kind, columns, dtrace)
    kind_key = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in layout.metrics_of(man, name, kind_key):
        value = layout.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device,
           "count": int(wl["chips"]), "memory_peak_bytes": peak}
    result: Dict[str, Any] = {}
    if traced:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = breakdown(run)
        result["device_seconds"] = dtrace.seconds_by_name()
    result["requests"] = [[r.req.query["name"], r.issued - t0, r.latency,
                           r.req.input_rows, r.ok] for r in records]
    result["setup_phases"] = phases
    result["mode"] = _mode(run, watch)
    # the answers to the host, the program's state freed, then the check
    kept = [(r.req, _host(r.out)) for r in records if r.out is not None]
    for r in records:
        r.out = None
        r.trace = None
    prog.close()
    del prog
    run.records = []
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    nums = _check(run, kept, device)
    log(f"check: {len(kept)} answers, {nums['rows_checked']} rows, "
        f"{time.monotonic() - t_check:.1f} s")
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in nums.items() if k in limits}
    failures = [r for r in records if not r.ok]
    correct = bool(kept) and not failures and all(
        c["value"] <= c["limit"] for c in checks.values())
    checks["failed_requests"] = {"value": len(failures), "limit": 0}
    if failures:
        log(f"first failure: {failures[0].error}")
    result.update({"correct": correct, "attempted": len(records),
                   "failed": len(failures), "metrics": metrics, "device": dev,
                   "checks": checks})
    return result


def _mode(run: Run, watch: modes.Watch) -> Dict[str, Any]:
    """The run's mode record (``modes``): CPUs, collections, the
    lane's grant order, per-shape times, the thresholds' pass shares."""
    done = run.completed
    lanes = []
    for r in done:
        lane = r.trace.find("lane_wait") if r.trace is not None else None
        if lane is not None:
            lanes.append((lane.start, lane.end))
    return {**watch.record(),
            "overtaken_share": modes.overtaken_share(lanes),
            "shapes": modes.by_shape(done, execution_of, exec_spans(done)),
            "pass_shares": modes.pass_shares(run.records, run.columns)}


def exec_spans(records: List[Record]) -> Dict[float, Any]:
    """Each request's execution: the ``execute`` span of its group, keyed
    by the group's release time (the end of every member's queue wait)."""
    by_release: Dict[float, Any] = {}
    for r in records:
        if r.trace is None:
            continue
        ex = r.trace.find("execute")
        qw = r.trace.find("queue_wait")
        if ex is not None and qw is not None:
            by_release[round(qw.end, 6)] = ex
    return by_release


def execution_of(rec: Record, by_release: Dict[float, Any]):
    """The ``execute`` span that answered ``rec`` (its own, or its group
    head's when it was coalesced), or None."""
    if rec.trace is None:
        return None
    ex = rec.trace.find("execute")
    if ex is not None:
        return ex
    qw = rec.trace.find("queue_wait")
    return None if qw is None else by_release.get(round(qw.end, 6))


def breakdown(run: Run) -> Dict[str, list]:
    """The device operations that took most time, and the window's idle
    time by the service span that was open while the device idled."""
    dt = run.device_trace
    ops = sorted(dt.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
    spans: Dict[str, list] = {}
    for r in run.records:
        if r.trace is None:
            continue
        for s in r.trace.spans():
            if s.name in SPAN_ORDER and s.end is not None and s.end > s.start:
                spans.setdefault(s.name, []).append((s.start, s.end))
    gaps = dt.gaps()
    idle: Dict[str, float] = {}
    if len(gaps):
        mids = (gaps[:, 0] + gaps[:, 1]) / 2
        names = trace_mod.open_spans(spans, mids, SPAN_ORDER)
        for name, d in zip(names, gaps[:, 1] - gaps[:, 0]):
            idle[name] = idle.get(name, 0.0) + float(d)
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
