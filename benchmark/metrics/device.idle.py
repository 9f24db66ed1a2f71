"""`device.idle`: the share of the traced window in which no device
activity ran (1 - the union of the activities' intervals over the
window), in %."""

SPANS = {}


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
