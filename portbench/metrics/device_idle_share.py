"""1 − the union of the device's kernel, copy and memset intervals over the
traced batch's span, in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
