"""The device's idle share: the part of the traced window in which no
kernel, copy or set ran, in %."""


def read(run):
    t = run.trace
    if t is None or not t.events or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
