"""Share of the executions begun in the window whose linear model ran as
the featurized-linear kernel, straight from the raw columns: those whose
``op.matmul_bias`` span carries ``kernel == "featurized_linear"``, over
those with an ``op.matmul_bias`` span, in %.  0 where the program never
fuses; None where no execution scored a linear model."""


def read(run):
    seen = set()
    fused = total = 0
    for r in run.records:
        ex = r.trace.find("execute") if r.trace is not None else None
        if ex is None or id(ex) in seen or not run.t0 <= ex.start <= run.t_end:
            continue
        seen.add(id(ex))
        spans = [s for s in ex.walk() if s.name == "op.matmul_bias"]
        if spans:
            total += 1
            fused += all(s.attrs.get("kernel") == "featurized_linear"
                         for s in spans)
    return 100.0 * fused / total if total else None
