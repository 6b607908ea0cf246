"""The superstep of the training session's fast path: the port's
counterpart of the JAX package's `make_superstep` (ref:
data/device_buffer.py:248-288), where one dispatch runs `n_inner` steps,
each on a window batch drawn from the device ray store. Here the step is
captured as a CUDA graph and replayed `n_inner` times.

PyTorch's whole-network recipe (torch.cuda.graphs): a few warm-up steps
run eagerly on a side stream, then one step is captured and every later
step replays it. The warm-up steps are real steps on the caller's inputs;
the capture runs nothing. A replay issues every launch of the step
(draws, batch, forward, backward, AdamW) from one host call, so the host
no longer sets the step's pace.

What a replay needs from its body: every tensor the step reads keeps its
address (the ray store, the parameters, the optimizer's state, which a
capturable AdamW keeps on the device, and the static inputs the caller's
injected draws are copied into); random draws come from generators
registered with the graph, whose offsets each replay advances as an eager
step does; everything the step allocates (kernel workspaces, autograd's
saved tensors, the gradients) comes from the graph's private pool, and
its outputs are static tensors that each replay overwrites.

A failed capture or replay raises: nothing here falls back to the eager
step.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import time
from typing import Any, Callable, Sequence

import torch

from catnerf_torch import tracing
from catnerf_torch.data.device_buffer import (DeviceRayStore, FastDraws,
                                              check_window_pad, draw_offsets,
                                              draw_rows, sample_batch)
from catnerf_torch.kernels import fused_field
from catnerf_torch.train.step import (BackgroundBatch, CategoryBatch,
                                      StepDraws, StepMetrics)

N_WARMUP = 3
#: CUgraphNodeType values of the nodes that run as device operations
DEVICE_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


@functools.cache
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    # (stream, status, id, graph, dependencies, n dependencies)
    lib.cuStreamGetCaptureInfo_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
    for name in ("cuGraphGetNodes", "cuGraphNodeGetType",
                 "cuStreamGetCaptureInfo_v2"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: error {err}")


def graph_nodes(raw_graph: int) -> list[int]:
    """The nodes of a CUDA graph (a CUgraph handle), by libcuda's
    cuGraphGetNodes."""
    lib = _libcuda()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    return list(nodes[:n.value])


def node_kinds(raw_graph: int) -> dict[str, int]:
    """A CUDA graph's nodes that run as device operations, by kind
    (DEVICE_NODE_KINDS), and the others ("other": event, empty, host
    nodes)."""
    lib = _libcuda()
    kinds = dict.fromkeys((*DEVICE_NODE_KINDS.values(), "other"), 0)
    t = ctypes.c_int()
    for node in graph_nodes(raw_graph):
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(t)),
               "cuGraphNodeGetType")
        kinds[DEVICE_NODE_KINDS.get(t.value, "other")] += 1
    return kinds


def capturing_graph(stream: torch.cuda.Stream) -> int:
    """The graph `stream` is being captured into (a CUgraph handle), by
    libcuda's cuStreamGetCaptureInfo."""
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    _check(_libcuda().cuStreamGetCaptureInfo_v2(
        stream.cuda_stream, ctypes.byref(status), None, ctypes.byref(graph),
        None, None), "cuStreamGetCaptureInfo")
    if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("the stream is not capturing")
    return graph.value


class CapturedStep:
    """`body(*inputs)` runs one step on the device and returns its outputs
    (a tuple of tensors, or of tuples of them); `inputs` are tensors or
    None. Calls 1..N_WARMUP run it eagerly on a side stream; the last of
    them then captures one more `body()` on copies of its inputs, the
    graph's static inputs; every later call copies its inputs into those
    and replays the capture, and returns its static outputs.
    `generators`: the CUDA generators `body` draws from.

    Tracing (tracing.py): the capture is the span graph.capture, always
    recorded, with the graph's nodes (the counter graph.nodes) and its
    phase map (`phase_map`); while the recorder is on, each replay adds to
    the counters graph.replays and graph.launch_ns (the host's
    nanoseconds in `replay()`)."""

    def __init__(self, body: Callable[..., Any], device: torch.device,
                 generators: tuple[torch.Generator, ...] = ()):
        self.body = body
        self.generators = generators
        self.n_eager = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.inputs: tuple[torch.Tensor | None, ...] = ()
        self.outputs: Any = None
        self.launches: dict[str, int] = {}  # kernel launches of a replay
        self.capture_s: float | None = None
        self.pool_bytes: int | None = None
        self.phase_map: dict | None = None
        self.stream = torch.cuda.Stream(device)

    def __call__(self, *inputs: torch.Tensor | None):
        if self.graph is not None:
            for static, x in zip(self.inputs, inputs, strict=True):
                if (static is None) != (x is None):
                    raise ValueError("an input the graph captured as a "
                                     "tensor is None, or the reverse")
                if x is not None:
                    static.copy_(x)
            if tracing.on():
                t0 = time.perf_counter_ns()
                self.graph.replay()
                tracing.count("graph.launch_ns", time.perf_counter_ns() - t0)
                tracing.count("graph.replays")
            else:
                self.graph.replay()
            fused_field.count_replay(self.launches)
            return self.outputs
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            outputs = self.body(*inputs)
        current.wait_stream(self.stream)
        self.n_eager += 1
        if self.n_eager == N_WARMUP:
            self._capture(inputs)
        return outputs

    def _capture(self, inputs: tuple[torch.Tensor | None, ...]) -> None:
        """Capture one `body()`. pool_bytes: the most device memory the
        capture held beyond what was allocated before it (the graph's
        pool at its peak)."""
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(self.stream.device)
        before = torch.cuda.memory_allocated(self.stream.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            graph.register_generator_state(gen)
        self.inputs = tuple(None if x is None else x.clone() for x in inputs)
        marks = []  # (phase, the device nodes captured when it closed)

        def probe(name: str) -> None:
            if name in tracing.STEP_PHASES:
                marks.append((name, node_kinds(capturing_graph(self.stream))))

        # a graph of a dead step that the collector frees while this one
        # captures would end the capture (freeing a graph is not allowed
        # then): nothing is collected until it is done
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tracing.span("graph.capture", always=True), \
                    tracing.capture_probe(probe), \
                    fused_field.launches_captured() as launches, \
                    torch.cuda.graph(graph, stream=self.stream):
                outputs = self.body(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        self.pool_bytes = (torch.cuda.max_memory_allocated(self.stream.device)
                           - before)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.outputs, self.launches = graph, outputs, launches
        self.phase_map = phase_map(
            marks, node_kinds(graph.raw_cuda_graph()),
            sum(x is not None for x in self.inputs))
        tracing.gauge("graph.nodes", self.node_count())
        tracing.add_graph(self.phase_map)

    def node_count(self) -> int:
        """The captured graph's nodes (kernels, copies, memsets), read
        with libcuda's cuGraphGetNodes."""
        if self.graph is None:
            raise RuntimeError("nothing captured yet")
        return len(graph_nodes(self.graph.raw_cuda_graph()))

    def node_kinds(self) -> dict[str, int]:
        """The captured graph's nodes by kind (`node_kinds`)."""
        if self.graph is None:
            raise RuntimeError("nothing captured yet")
        return node_kinds(self.graph.raw_cuda_graph())


def phase_map(marks: list[tuple[str, dict[str, int]]],
              kinds: dict[str, int], copies: int) -> dict:
    """A captured step's phase map: for each phase of tracing.STEP_PHASES
    the graph's nodes that run as device operations, by kind. `marks`:
    (phase, the nodes captured by its close), in capture order; a phase
    owns the nodes captured since the mark before, the last phase those
    after the last mark too. `kinds`: the whole graph's (`node_kinds`).
    copies: the inputs `CapturedStep.__call__` copies in before each
    replay."""
    device = DEVICE_NODE_KINDS.values()
    owned = {p: dict.fromkeys(device, 0) for p in tracing.STEP_PHASES}
    prev = dict.fromkeys(device, 0)
    for i, (name, now) in enumerate(marks):
        upto = kinds if i == len(marks) - 1 else now
        for k in device:
            owned[name][k] += upto[k] - prev[k]
        prev = upto
    return {"nodes": sum(kinds.values()),
            "device_nodes": sum(kinds[k] for k in device),
            "copies": copies, "phases": owned}


# step_fn(cat, bg, draws) -> the step's metrics; `draws` is the step's
# uniforms (StepDraws) or the generator to draw them from
StepFn = Callable[[CategoryBatch, BackgroundBatch | None,
                   StepDraws | torch.Generator], StepMetrics]


class Superstep:
    """`make_superstep`'s callable: `superstep(draws, n_steps=n_inner)`
    runs n_steps optimizer steps, each on a batch drawn from the store,
    and returns the last step's metrics. `draws` is the generator to draw
    each step's offsets (or rows) and uniforms from (in that order, as the
    eager loop draws them), or a list of n_steps injected FastDraws.

    `draw(generator)` gives a step's (offsets, background offset) or
    (rows, background rows), `sample(a, b)` the batch they select.

    graph=True: the step is a CapturedStep, one for each kind of `draws`,
    the generator registered with it, injected draws its static inputs;
    the metrics returned are the graph's static outputs, which the next
    step overwrites. No host sync between the steps. graph=False: the
    steps run eagerly."""

    def __init__(self, step_fn: StepFn, store: DeviceRayStore,
                 n_inner: int, graph: bool, draw, sample):
        self.step_fn = step_fn
        self.store = store
        self.n_inner = n_inner
        self.graph = graph
        self.draw = draw
        self.sample = sample
        self.offsets = None  # the last step's (offs, boff) or rows
        self.captured: dict[str, CapturedStep] = {}  # "generator"|"injected"

    def _step(self, offs, boff, draws):
        with tracing.span("step.batch"):
            cat, bg = self.sample(offs, boff)
        return self.step_fn(cat, bg, draws), (offs, boff)

    def _drawn_step(self, gen: torch.Generator):
        with tracing.span("step.batch"):
            offs, boff = self.draw(gen)
            cat, bg = self.sample(offs, boff)
        return self.step_fn(cat, bg, gen), (offs, boff)

    def _injected_step(self, offs, boff, u_cat, u_bg):
        return self._step(offs, boff, StepDraws(u_cat, u_bg))

    def _run(self, kind: str, body, inputs, generators=()):
        if not self.graph:
            return body(*inputs)
        step = self.captured.get(kind)
        if step is None:
            step = self.captured[kind] = CapturedStep(
                body, self.store.packed.device, generators)
        if step.generators != generators:
            raise ValueError("the graph draws from the generator it was "
                             "captured with")
        return step(*inputs)

    def __call__(self, draws: torch.Generator | Sequence[FastDraws],
                 n_steps: int | None = None) -> StepMetrics:
        n_steps = self.n_inner if n_steps is None else n_steps
        drawn = isinstance(draws, torch.Generator)
        if not drawn and len(draws) != n_steps:
            raise ValueError(f"{len(draws)} draws for {n_steps} steps")
        metrics = None
        for i in range(n_steps):
            if drawn:
                metrics, self.offsets = self._run(
                    "generator", lambda: self._drawn_step(draws), (),
                    (draws,))
            else:
                d = draws[i]
                metrics, self.offsets = self._run(
                    "injected", self._injected_step,
                    (d.offs, d.boff, d.step.cat, d.step.bg))
        return metrics


def make_superstep(step_fn: StepFn, store: DeviceRayStore, n_per_cls: int,
                   n_bg: int, n_inner: int, graph: bool = False,
                   window: bool = True, draw=None, sample=None) -> Superstep:
    """The counterpart of the JAX package's `make_superstep` (ref:
    data/device_buffer.py:248-288): a callable that advances the training
    state by `n_inner` steps, each on its own batch from the store, and
    returns the last step's metrics (`Superstep`). It takes the draw
    generator, or a list of injected draws, in place of JAX's key.
    `step_fn` updates the state in place. window: each step a window
    draw (the training session's, JAX's window=True), else uniform rows
    with replacement (JAX's default). `draw` and `sample` replace the
    store's own draw and batch (a sharded step's, parallel/sharding.py).
    graph: the step as a CUDA graph, replayed (`CapturedStep`)."""
    bg_length = store.bg_length if store.bg_packed is not None else None
    if window:
        check_window_pad(store, n_per_cls, n_bg)
        draw = draw or (lambda gen: draw_offsets(store, gen))
        sample = sample or (lambda offs, boff: sample_batch(
            store, n_per_cls, n_bg, offs, boff))
    else:
        draw = draw or (lambda gen: draw_rows(
            store.lengths, bg_length, n_per_cls, n_bg, gen, store.max_length))
        sample = sample or (lambda idx, bidx: sample_batch(
            store, n_per_cls, n_bg, idx, bidx, window=False))
    if graph and store.packed.device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA session (the store is "
                         f"on {store.packed.device})")
    return Superstep(step_fn, store, n_inner, graph, draw, sample)
