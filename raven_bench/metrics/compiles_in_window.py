"""Plans compiled, shape buckets built and input signatures traced inside
the window (``ServiceStats`` deltas): 0 when the warm-up covered every
shape the traffic sends."""


def read(run):
    return (run.delta("cache_misses") + run.delta("bucket_compiles")
            + run.delta("jit_traces"))
