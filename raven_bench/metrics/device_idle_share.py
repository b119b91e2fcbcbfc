"""Share of the traced window in which no operation ran on the card: one
less the union of the profiler's device intervals over the window."""


def read(run):
    dt = run.device_trace
    if dt is None or dt.window_s <= 0:
        return None
    busy = dt.busy_s()
    return 100.0 * (1.0 - busy / dt.window_s) if busy > 0 else None
