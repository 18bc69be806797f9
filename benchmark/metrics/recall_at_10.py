"""recall_at_10: over every query of the window, the share of the
reference's exact top-10 that the answer holds (computed by the benchmark
after the window)."""


def read(run):
    return run.recall
