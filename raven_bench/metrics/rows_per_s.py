"""Input rows of every request answered in the window, a second: a scan's
are its anchor table's rows, a scoring request's its own."""


def read(run):
    done = run.completed
    if not done:
        return None
    return sum(r.req.input_rows for r in done) / run.seconds
