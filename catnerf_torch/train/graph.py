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
import time
from typing import Any, Callable, Sequence

import torch

from catnerf_torch.data.device_buffer import (DeviceRayStore, FastDraws,
                                              check_window_pad, draw_offsets,
                                              draw_rows, sample_batch)
from catnerf_torch.kernels import fused_field
from catnerf_torch.train.step import (BackgroundBatch, CategoryBatch,
                                      StepDraws, StepMetrics)

N_WARMUP = 3


class CapturedStep:
    """`body(*inputs)` runs one step on the device and returns its outputs
    (a tuple of tensors, or of tuples of them); `inputs` are tensors or
    None. Calls 1..N_WARMUP run it eagerly on a side stream; the last of
    them then captures one more `body()` on copies of its inputs, the
    graph's static inputs; every later call copies its inputs into those
    and replays the capture, and returns its static outputs.
    `generators`: the CUDA generators `body` draws from."""

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
        self.stream = torch.cuda.Stream(device)

    def __call__(self, *inputs: torch.Tensor | None):
        if self.graph is not None:
            for static, x in zip(self.inputs, inputs, strict=True):
                if (static is None) != (x is None):
                    raise ValueError("an input the graph captured as a "
                                     "tensor is None, or the reverse")
                if x is not None:
                    static.copy_(x)
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
        with fused_field.launches_captured() as launches, \
                torch.cuda.graph(graph, stream=self.stream):
            outputs = self.body(*self.inputs)
        graph.instantiate()
        self.pool_bytes = (torch.cuda.max_memory_allocated(self.stream.device)
                           - before)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.outputs, self.launches = graph, outputs, launches

    def node_count(self) -> int:
        """The captured graph's nodes (kernels, copies, memsets), read
        with libcuda's cuGraphGetNodes."""
        if self.graph is None:
            raise RuntimeError("nothing captured yet")
        libcuda = ctypes.CDLL("libcuda.so.1")
        libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_size_t)]
        libcuda.cuGraphGetNodes.restype = ctypes.c_int
        n = ctypes.c_size_t(0)
        err = libcuda.cuGraphGetNodes(self.graph.raw_cuda_graph(), None,
                                      ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"cuGraphGetNodes: error {err}")
        return n.value


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
        cat, bg = self.sample(offs, boff)
        return self.step_fn(cat, bg, draws), (offs, boff)

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
                    "generator",
                    lambda: self._step(*self.draw(draws), draws),
                    (), (draws,))
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
