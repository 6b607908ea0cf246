"""The share of the traced training window in which no device operation
runs."""


def read(r):
    t = r.get("trace")
    if t is None or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
