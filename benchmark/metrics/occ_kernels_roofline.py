"""Kernels 3-4's share of their roofline: the least time the card could
take for the background field's work a step (benchlib/work.py) over the
device time a step of the port's kernels that serve the background."""

from benchlib import trace, work


def read(r):
    t = r.get("trace")
    if t is None:
        return None
    us = trace.field_times_us(t)["occ"]
    if us <= 0:
        return None
    w = r["work"]
    return 100.0 * work.bound_s(w.bg_flops(), w.bg_bytes()) * t.steps / (
        us / 1e6)
