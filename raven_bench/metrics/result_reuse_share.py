"""Share of the executions begun in the window that took a subtree from
the result cache: those with a ``result_cache_splice`` span, over those
plus the executions of a capture-compiled plan (a ``result_capture``
event), which computed the cacheable subtree again; in %.  None where
neither ran."""


def read(run):
    seen = set()
    spliced = captured = 0
    for r in run.records:
        ex = r.trace.find("execute") if r.trace is not None else None
        if ex is None or id(ex) in seen or not run.t0 <= ex.start <= run.t_end:
            continue
        seen.add(id(ex))
        names = {s.name for s in ex.walk()}
        spliced += "result_cache_splice" in names
        captured += "result_capture" in names
    total = spliced + captured
    return 100.0 * spliced / total if total else None
