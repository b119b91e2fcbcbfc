"""Process start to the first timed request: imports, the card, the
tables, the model, registration, "auto"'s calibration and the warm-up."""


def read(run):
    return run.setup_s
