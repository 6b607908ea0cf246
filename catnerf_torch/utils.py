"""Small shared utilities: the named phase-timing registry (a copy of
`phase_add`/`phase_timer` from the JAX package's utils.py, ref:
src/scene_cateogries.py:10-22) and device resolution."""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_PHASE_TIMINGS: dict[str, dict[str, float]] = {}
_PHASE_LOCK = threading.Lock()


def phase_add(group: str, phase: str, dt: float) -> None:
    with _PHASE_LOCK:
        g = _PHASE_TIMINGS.setdefault(group, {})
        g[phase] = g.get(phase, 0.0) + dt


def phase_timings(group: str) -> dict[str, float]:
    """Seconds spent so far in each phase of `group`."""
    with _PHASE_LOCK:
        return dict(sorted(_PHASE_TIMINGS.get(group, {}).items()))


@contextlib.contextmanager
def phase_timer(group: str, phase: str):
    t0 = time.time()
    try:
        yield
    finally:
        phase_add(group, phase, time.time() - t0)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for no device where there is no GPU raises; the port
    never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)
