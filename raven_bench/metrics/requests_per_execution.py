"""Requests admitted for each execution the service issued in the window
(``ServiceStats.submitted`` over ``batch_executions``)."""


def read(run):
    ex = run.delta("batch_executions")
    return run.delta("submitted") / ex if ex > 0 else None
