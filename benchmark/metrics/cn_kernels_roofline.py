"""Kernels 1-2's share of their roofline: the least time the card could
take for the category fields' work a step (benchlib/work.py: FLOPs over
67 TFLOP/s or bytes over 3.35 TB/s, the larger) over the device time a
step of the port's kernels that serve the category fields."""

from benchlib import trace, work


def read(r):
    t = r.get("trace")
    if t is None:
        return None
    us = trace.field_times_us(t)["cn"]
    if us <= 0:
        return None
    w = r["work"]
    return 100.0 * work.bound_s(w.cn_flops(), w.cn_bytes()) * t.steps / (
        us / 1e6)
