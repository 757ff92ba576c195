"""Percent of the traced stretch of the window in which no operation
ran on the device: one minus the union of the device's activity
intervals in torch.profiler's trace over the stretch's host-clock
length."""


def read(run):
    t = run.trace
    if t is None or t.busy_s is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
