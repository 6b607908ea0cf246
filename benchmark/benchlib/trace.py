"""The reduction of a torch.profiler trace to what the per-layer readers
take: the device's operations in the traced window, the union of their
intervals (busy time), the gaps between them and what the host was doing
in each, and the port's kernels sorted into the fields they serve.

The profiler records each kernel, copy and set of a CUDA graph's replay
with its name and its interval on the device; the window is the
`bench.window` range the harness records on the host around the traced
calls, which end in a device sync.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW = "bench.window"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    ops: list[DeviceOp]        # in start order, clipped to the window
    window_us: float
    busy_us: float
    gaps: list[tuple[str, float]]  # (what the host was doing, us)
    steps: int

    def top_ops(self, n: int = 10) -> list[list]:
        """The n device operations that took most time: [name, s]."""
        return _top(((op.name, op.us) for op in self.ops), n)

    def top_gaps(self, n: int = 10) -> list[list]:
        """The n host activities the device waited longest on: [name, s]."""
        return _top(self.gaps, n)


def _top(pairs, n: int) -> list[list]:
    by: dict[str, float] = {}
    for name, us in pairs:
        by[name] = by.get(name, 0.0) + us
    return [[name, us / 1e6]
            for name, us in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(ops: list[DeviceOp]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for op in sorted(ops, key=lambda o: o.start_us):
        if merged and op.start_us <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], op.end_us)
        else:
            merged.append([op.start_us, op.end_us])
    return [(a, b) for a, b in merged]


def reduce_profile(prof, steps: int) -> Trace | None:
    """`prof`: a finished torch.profiler.profile whose recorded window holds
    a `bench.window` range; None when it recorded no device operation."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    window = [e for e in events
              if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    w0 = min(e.time_range.start for e in window)
    w1 = max(e.time_range.end for e in window)
    ops, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name == WINDOW or getattr(e, "is_user_annotation", False):
            continue  # the host's range, mirrored on the device's timeline
        if e.device_type == DeviceType.CUDA:
            if b > w0 and a < w1:
                ops.append(DeviceOp(e.name, max(a, w0), min(b, w1)))
        elif e.device_type == DeviceType.CPU:
            host.append((a, b, e.name))
    if not ops:
        return None
    ops.sort(key=lambda o: o.start_us)
    busy = _union(ops)
    host.sort()
    starts = [h[0] for h in host]

    def doing(t: float) -> str:
        """The innermost host range open at t."""
        best = None
        i = bisect.bisect_right(starts, t)
        for a, b, name in reversed(host[max(0, i - 64):i]):
            if b >= t and (best is None or b - a < best[0]):
                best = (b - a, name)
        return best[1] if best else "python"

    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((doing(0.5 * (prev + a)), a - prev))
        prev = max(prev, b)
    return Trace(ops=ops, window_us=w1 - w0,
                 busy_us=sum(b - a for a, b in busy), gaps=gaps, steps=steps)


def is_port_kernel(name: str) -> bool:
    """The port's kernels live in the anonymous namespace of its sources
    and take plain pointers and its own structs; PyTorch's kernels there
    name at:: or c10:: types in their arguments."""
    return (name.startswith(("void (anonymous namespace)::",
                             "(anonymous namespace)::"))
            and "at::" not in name and "c10::" not in name)


def _field_of(name: str) -> str | None:
    """Which field one of the port's kernels serves, where its name says:
    "cn" (csrc/codenerf_fwd.cu, codenerf_bwd.cu) or "occ" (occupancy.cu,
    whose kernels take the run-time `Dims` or sit on the 128-wide GEMM)."""
    if "Dims" in name or "Occ<" in name or "gemm_kernel<128" in name:
        return "occ"
    if "reduce_tiles" in name:
        return None
    return "cn"


def field_times_us(trace: Trace) -> dict[str, float]:
    """Device time of the port's kernels by field. A kernel shared by both
    fields (`reduce_tiles`) belongs to the field of the port's kernel
    that ran before it."""
    out = {"cn": 0.0, "occ": 0.0}
    last = None
    for op in trace.ops:
        if not is_port_kernel(op.name):
            continue
        field = _field_of(op.name) or last
        if field is not None:
            out[field] += op.us
            last = field
    return out


def is_gemm(name: str) -> bool:
    low = name.lower()
    return not is_port_kernel(name) and ("gemm" in low or "gemv" in low)
