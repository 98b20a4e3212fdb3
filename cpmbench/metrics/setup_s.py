"""setup_s: process start to the first timed interaction (host clock)."""


def read(run):
    return run.setup_s
