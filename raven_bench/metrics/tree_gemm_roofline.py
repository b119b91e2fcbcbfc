"""``tree_gemm``'s share of its roofline: the least time of the forest work
the traced window's requests needed (the frozen ``tree_gemm_cost``, at each
tree's own reachable size, on the rows each request's filters keep) over
the profiler's device time of the ``tree_gemm`` kernel.  A request answered
from the result cache, or by another request's execution of the same
query, needed no kernel work of its own."""

from raven_bench.counts.peaks import least_seconds
from raven_bench.counts.tree_gemm_cost import forest_cost
from raven_bench.harness.work import forest_sizes, model_rows


def read(run):
    dt = run.device_trace
    if dt is None or run.cfg["model"]["kind"] != "random_forest":
        return None
    kernel_s = dt.seconds_matching("tree_gemm")
    if kernel_s <= 0:
        return None
    f, sizes, o = forest_sizes(run)
    need = 0.0
    for r in run.answered:
        names = r.trace.span_names() if r.trace is not None else []
        ran = bool(r.req.rows) or ("execute" in names
                                   and "result_cache_splice" not in names)
        if ran:
            w = forest_cost(model_rows(run, r), f, sizes, o)
            need += least_seconds(w["ops"], w["bytes"])
    return 100.0 * need / kernel_s
