"""device_idle_pct.batch: 100 x (1 - the union of the device's operations
over the traced slice of the window), from torch.profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
