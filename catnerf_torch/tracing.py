"""Spans and counters of the port, on one in-memory recorder.

A span is a named interval of the host's monotonic clock
(`time.perf_counter_ns`) with the span that was open around it on its
thread (its parent), its thread, and a request id that every span of one
request shares: the id of the outermost span (`serve.request`, or one
`TrainingSession.run_fast` call). A counter is a named sum. `snapshot()`
returns the spans kept (the newest `BUFFER`; older ones are dropped), the
counters and the phase maps of the captured training steps; `reset()`
forgets them. The phase seconds (`phases`) have their own reset.

When it records: while a torch profiler records (in any thread: the
module flag `torch.autograd.profiler._is_profiler_enabled`, which a
server's handler thread sees too), or after `enable()` until `disable()`.
Otherwise a span or a counter reads that flag and records nothing. One-off
set-up is recorded always: the phases (`phase`, `phase_add`: the seconds
of a named phase of a group, which `utils.phase_timings` reads), the
graph's capture and its phase map.

While it records, every span also opens `torch.profiler.record_function`
of its name, so that a profiler's export (`utils.device_trace`) shows it
on the profiler's clock beside the device's operations. A span opened
with a CUDA `device` also records a pair of timing events on its
current stream; their elapsed time, and the device-side
counts of `count_device`, are read after the request's last sync
(`settle`), which therefore adds none: the counter `<span>.device_ns`
sums the former.

Names in use (PERF.md lists the metric each feeds):
  serve.request, serve.lock_wait, serve.png, serve.write (serve.py);
  render.stage, render.tile, render.objects, render.background,
  render.sync and the counters render.tiles, render.syncs,
  render.points, render.object_hits (the objects' box masks' true
  entries), render.object_slots (the slots of SLOT_ROWS rows the object
  ensemble runs), render.object_evals (the rows it runs: slots x
  SLOT_ROWS), render.objects.device_ns, render.background.device_ns
  (render_views.py);
  train.run_fast, step.batch, step.forward, step.backward,
  step.optimizer (train/loop.py, train/graph.py, train/step.py);
  graph.capture and the counters graph.replays, graph.launch_ns,
  graph.nodes (train/graph.py).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable

import torch
from torch.autograd import profiler as _profiler

BUFFER = 1 << 16    # spans kept
GRAPHS = 16         # phase maps kept
#: the phases of a training step, in the order they run
STEP_PHASES = ("step.batch", "step.forward", "step.backward",
               "step.optimizer")


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    request: int
    thread: int
    attrs: dict

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


_lock = threading.Lock()
_spans: collections.deque[Span] = collections.deque(maxlen=BUFFER)
_counters: dict[str, float] = {}
_graphs: collections.deque[dict] = collections.deque(maxlen=GRAPHS)
_phases: dict[str, dict[str, float]] = {}
_ids = itertools.count(1)
_enabled = False
_captures = 0       # captures in progress (capture_probe)
_forced = False     # _enabled or a capture in progress
_open: contextvars.ContextVar[_Open | None] = contextvars.ContextVar(
    "catnerf_torch.tracing.open", default=None)
# called with each span's name as it closes (a graph's capture reads its
# node counts there)
_probe: contextvars.ContextVar[Callable[[str], None] | None] = (
    contextvars.ContextVar("catnerf_torch.tracing.probe", default=None))
# device reads of this thread's request, settled after its last sync
_pending = threading.local()
_OFF = contextlib.nullcontext()


def enable() -> None:
    """Record from now on, profiler or not."""
    global _enabled, _forced
    _enabled = _forced = True


def disable() -> None:
    global _enabled, _forced
    _enabled = False
    _forced = _captures > 0


def on() -> bool:
    """Whether spans and counters record now."""
    return _forced or _profiler._is_profiler_enabled


class _Open:
    """A span while it is open."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "t0", "token",
                 "rf", "device", "ev0")

    def __init__(self, name: str, attrs: dict, traced: bool, device):
        self.name, self.attrs = name, attrs
        self.rf = (torch.profiler.record_function(name) if traced
                   else None)
        self.device = (device if traced and device is not None
                       and torch.device(device).type == "cuda" else None)

    def __enter__(self) -> _Open:
        parent = _open.get()
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.request = self.id if parent is None else parent.request
        if parent is None:
            _drop_pending()  # what a failed request left unread
        self.token = _open.set(self)
        if self.rf is not None:
            self.rf.__enter__()
        if self.device is not None:
            self.ev0 = _event(self.device)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self.device is not None:
            _pending_of_thread()["events"].append(
                (self.name, self.ev0, _event(self.device)))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.reset(self.token)
        probe = _probe.get()
        if probe is not None:
            probe(self.name)
        _spans.append(Span(self.name, self.t0, t1, self.id, self.parent,
                           self.request, threading.get_ident(), self.attrs))


def _event(device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def span(name: str, *, always: bool = False, device=None, **attrs: Any):
    """A context manager that records the block as the span `name`, with
    `attrs`, while the recorder is on (always: set-up, recorded whatever
    the recorder says). device: a CUDA device whose current stream's work
    in the block is timed too (`settle`)."""
    traced = on()
    if not (traced or always):
        return _OFF
    return _Open(name, attrs, traced, device)


def count(name: str, n: float = 1) -> None:
    """Add n to the counter `name` while the recorder is on."""
    if on():
        _add(name, n)


def gauge(name: str, value: float) -> None:
    """Set the counter `name` to `value`, always (set-up)."""
    with _lock:
        _counters[name] = value


def _add(name: str, n: float) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the device scalar t to the counter `name` at this thread's next
    `settle`, with no sync of its own (callers compute t only while the
    recorder is on)."""
    _pending_of_thread()["counts"].setdefault(name, []).append(t)


def _pending_of_thread() -> dict:
    p = getattr(_pending, "reads", None)
    if p is None:
        p = _pending.reads = {"events": [], "counts": {}}
    return p


def _drop_pending() -> None:
    _pending.reads = None


@contextlib.contextmanager
def settle():
    """Wrap the request's last sync: the device counts pending on this
    thread are copied to the host ahead of it, without waiting, and read
    after it with the timing events' elapsed times."""
    p = getattr(_pending, "reads", None)
    if not p or not (p["events"] or p["counts"]):
        yield
        return
    _drop_pending()
    names = list(p["counts"])
    host = None
    if names:
        sums = torch.stack([torch.stack(p["counts"][k]).sum().double()
                            for k in names])
        host = torch.empty(sums.shape, dtype=sums.dtype,
                           pin_memory=sums.is_cuda)
        host.copy_(sums, non_blocking=True)
    yield
    for name, ev0, ev1 in p["events"]:
        ev1.synchronize()  # already done: the last sync waited for it
        _add(f"{name}.device_ns", ev0.elapsed_time(ev1) * 1e6)
    for name, v in zip(names, host.tolist() if host is not None else ()):
        _add(name, v)


@contextlib.contextmanager
def capture_probe(fn: Callable[[str], None]):
    """Record inside the block (a capture is set-up), and call fn(name) as
    each span of this thread closes there."""
    global _captures, _forced
    token = _probe.set(fn)
    with _lock:
        _captures += 1
        _forced = True
    try:
        yield
    finally:
        _probe.reset(token)
        with _lock:
            _captures -= 1
            _forced = _enabled or _captures > 0


def add_graph(record: dict) -> None:
    """Keep a captured step's phase map (train/graph.py), always."""
    with _lock:
        _graphs.append(record)


def phase(group: str, key: str):
    """A context manager: the block is the span `group.key`, recorded
    always, and its seconds add to `key` of `group` (`phases`)."""
    return _Phase(group, key)


class _Phase:
    __slots__ = ("group", "key", "span", "t0")

    def __init__(self, group: str, key: str):
        self.group, self.key = group, key
        self.span = span(f"{group}.{key}", always=True)

    def __enter__(self) -> None:
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        phase_add(self.group, self.key, time.perf_counter() - self.t0)
        self.span.__exit__(*exc)


def phase_add(group: str, key: str, seconds: float) -> None:
    with _lock:
        g = _phases.setdefault(group, {})
        g[key] = g.get(key, 0.0) + seconds


def phases(group: str) -> dict[str, float]:
    """Seconds spent so far in each phase of `group`, by key."""
    with _lock:
        return dict(sorted(_phases.get(group, {}).items()))


def reset_phases(group: str | None = None) -> None:
    """Forget the seconds of `group`'s phases, or of every group's."""
    with _lock:
        if group is None:
            _phases.clear()
        else:
            _phases.pop(group, None)


def snapshot() -> dict:
    """{"spans": [Span] oldest first, "counters": {name: value},
    "graphs": [phase map] oldest first}."""
    with _lock:
        return {"spans": list(_spans), "counters": dict(_counters),
                "graphs": list(_graphs)}


def reset() -> None:
    """Forget the spans, the counters and the phase maps."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _graphs.clear()


#: device operations a replay may run outside its graph beyond its input
#: copies (the generators' seed and offset fills of `CUDAGraph.replay`)
MAX_PROLOGUE = 8


def _op_kind(name: str) -> str:
    """A profiled device operation's kind: a graph's copy nodes run as
    "Memcpy DtoD ..." or as CUDA's copy kernels "memcpy32_post",
    "memcpy_post"; its set nodes as "Memset (...)"."""
    low = name.lower()
    return ("memcpy" if low.startswith("memcpy") else
            "memset" if low.startswith("memset") else "kernel")


def phase_device_ms(ops: list[tuple[str, float]], steps: int,
                    graphs: list[dict] | None = None) -> dict | None:
    """Device milliseconds a step of each phase (STEP_PHASES) of a window
    of `steps` replays of a captured step: `ops` are the window's device
    operations as (name, microseconds) in start order, as a profiler
    reports them. Each replay runs the copies of its inputs and the
    generators' fills, then the graph's device nodes in capture order:
    `steps` runs of the same operations, found where the names repeat
    with that period and earliest in the window. The copies and fills
    belong to step.batch; the graph's operations to the phases by the
    phase map (train/graph.py `phase_map`), whose copies and sets must
    fall where it puts them. `graphs`: the phase maps to try, newest
    first (by default the recorder's). None when no phase map divides
    the window, or with fewer than two replays."""
    if graphs is None:
        graphs = snapshot()["graphs"][::-1]
    if steps < 2:
        return None
    ids: dict[str, int] = {}
    names = [ids.setdefault(name, len(ids)) for name, _ in ops]
    for g in graphs:
        n = g["device_nodes"]
        for pre in range(g["copies"], g["copies"] + MAX_PROLOGUE + 1):
            a = _periodic_start(names, n + pre, steps)
            if a is not None:
                out = _by_phase(ops[a:a + steps * (n + pre)], steps, pre, g)
                if out is not None:
                    return out
    return None


def _periodic_start(names: list[int], period: int, steps: int):
    """The first a at which names[a:a + steps * period] repeats with
    `period` (steps >= 2), or None."""
    if period <= 0:
        return None
    need = (steps - 1) * period  # i in [a, a + need): names[i + period]
    run = 0
    for i in range(len(names) - period):
        run = run + 1 if names[i] == names[i + period] else 0
        if run == need:
            return i - need + 1
    return None


def _by_phase(ops, steps: int, pre: int, g: dict) -> dict | None:
    bounds, at = [], pre
    for p in STEP_PHASES:
        k = g["phases"][p]
        bounds.append((p, at, at + sum(k.values())))
        at += sum(k.values())
    period = at
    first = ops[:period]
    for p, a, b in bounds:  # the map's copies and sets where it puts them
        kinds = [_op_kind(name) for name, _ in first[a:b]]
        if any(kinds.count(k) != g["phases"][p][k] for k in
               ("memcpy", "memset")):
            return None
    us = dict.fromkeys(STEP_PHASES, 0.0)
    for s in range(steps):
        chunk = ops[s * period:(s + 1) * period]
        us["step.batch"] += sum(u for _, u in chunk[:pre])
        for p, a, b in bounds:
            us[p] += sum(u for _, u in chunk[a:b])
    return {p: v / steps / 1e3 for p, v in us.items()}
