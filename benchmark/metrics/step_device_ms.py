"""Device busy milliseconds a step: the union of the intervals of every
device operation in the traced window, over its steps."""


def read(r):
    t = r.get("trace")
    if t is None:
        return None
    return t.busy_us / t.steps / 1e3
