"""Device milliseconds a step in library GEMM and GEMV kernels (the
XLA-path field modules' products), by name in the traced window."""

from benchlib import trace


def read(r):
    t = r.get("trace")
    if t is None:
        return None
    us = sum(op.us for op in t.ops if trace.is_gemm(op.name))
    return us / t.steps / 1e3 if us > 0 else None
