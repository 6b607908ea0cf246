"""Device busy milliseconds of one served view: the union of the
intervals of every device operation while the traced request ran."""


def read(r):
    t = r.get("trace")
    if t is None:
        return None
    return t.busy_us / t.steps / 1e3
