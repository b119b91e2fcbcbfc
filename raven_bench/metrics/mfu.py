"""The whole query's share of the card's peak: the least time of every
answered request's work (``counts/work.py``: the model on the rows its
filters keep, the columns it uses read once, the answer written once, at
the data-sheet peaks), summed over the window and divided by it."""

from raven_bench.harness.work import least_seconds


def read(run):
    done = run.completed
    if not done:
        return None
    return 100.0 * sum(least_seconds(run, r) for r in done) / run.seconds
