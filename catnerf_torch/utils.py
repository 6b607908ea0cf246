"""Small shared utilities: the named phase timings (the JAX package's
`phase_add`/`phase_timer` API, ref: src/scene_cateogries.py:10-22, kept
by the recorder in tracing.py), device resolution, `device_trace`, and
the reference's misc helpers (`performance_measure`, `to8b`,
`load_matrix_from_txt`, `importance_sampling_coords`, ref:
src/utils.py:322-327, 493-526)."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from catnerf_torch import tracing

def phase_add(group: str, phase: str, dt: float) -> None:
    """Add dt seconds to `phase` of `group` (tracing.phase_add)."""
    tracing.phase_add(group, phase, dt)


def phase_timings(group: str) -> dict[str, float]:
    """Seconds spent so far in each phase of `group`."""
    return tracing.phases(group)


def phase_reset(group: str) -> None:
    """Forget the seconds recorded so far in `group`."""
    tracing.reset_phases(group)


def reset_phase_timings(group: str | None = None) -> None:
    """The JAX package's name: phase_reset(group), or every group when
    `group` is None."""
    tracing.reset_phases(group)


def phase_timer(group: str, phase: str):
    """The block's seconds on the monotonic clock added to `phase` of
    `group`, and the block recorded as the span `group.phase`
    (tracing.phase)."""
    return tracing.phase(group, phase)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for no device where there is no GPU raises; the port
    never carries on silently on the CPU. Under torchrun (LOCAL_RANK set)
    `cuda`, named or by default, is the process's own card,
    cuda:LOCAL_RANK."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


@contextlib.contextmanager
def device_trace(log_dir: str, device: str | torch.device = "cpu"):
    """A torch.profiler capture of the block (the port's counterpart of the
    JAX package's `device_trace`): the host's activities on every thread
    (a server's handler threads too) with the recorder's spans
    (tracing.py) among them, and the card's on a CUDA `device`. The
    device is synchronised inside the capture before it stops, so that the
    work the block queued is in the trace; then a Chrome trace is written
    under `log_dir` (`trace_<pid>_<ns>.json`, for chrome://tracing or
    Perfetto). Yields the profiler."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def performance_measure(name: str):
    """Wall-clock timing of the block, printed in ms (ref:
    src/scene_cateogries.py:10-22); `device_trace` profiles the card."""
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        dt_ms = (time.perf_counter_ns() - t0) / 1e6
        print(f"{name} execution time: {dt_ms:.2f} ms")


def to8b(x: np.ndarray) -> np.ndarray:
    """(ref: src/utils.py:493)."""
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def load_matrix_from_txt(path: str, shape=(4, 4)) -> np.ndarray:
    """(ref: src/utils.py:322-327)."""
    return np.loadtxt(path).reshape(shape)


def importance_sampling_coords(weights: torch.Tensor, n_samples: int,
                               u: torch.Tensor | None = None):
    """Inverse-CDF importance sampling over per-bin weights [..., n_bins]
    (ref: src/utils.py:495-526). u [..., n_samples]: the uniforms (the
    JAX package draws them from its key); None takes the deterministic
    linspace(0, 1). Returns (bin indices [..., n_samples], u, cdf)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(*cdf.shape[:-1],
                                                     n_samples)
    # u >= cdf counts the bins whose cumulative mass is below u: the
    # searchsorted side='right' the JAX package computes by broadcast
    inds = torch.sum(u[..., :, None] >= cdf[..., None, :], dim=-1)
    return torch.clamp(inds, 0, cdf.shape[-1] - 1), u, cdf
