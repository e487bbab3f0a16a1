"""The device's idle share of the profiled segment: one minus the union of
every device operation's interval on the trace's timeline over the
segment's length."""


def read(t: dict):
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
