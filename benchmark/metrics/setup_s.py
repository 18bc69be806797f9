"""setup_s: from the process's start to the window's start (host clock):
imports, inputs, weights, build, the first run's compile, warm-up."""


def read(run):
    return run.setup_s
