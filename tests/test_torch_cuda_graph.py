"""The training step as a replayed CUDA graph (train/graph.py, through
`TrainingSession.enable_fast_path(graph=True)` and `run_fast`) against the
eager loop (`graph=False`), on the card.

Marked `cuda`: they skip where there is no GPU. This file imports neither
jax nor the JAX package; tests/conftest.py imports jax, so on a machine
with only PyTorch run it without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graph.py -q

For each of the three trainers the port runs (the fused float32 one on
kernels 1-4, the strict-parity one and the default `Config()` one with bf16
storage, both on the XLA path), on the scene of tests/test_torch_step.py:
N_STEPS steps graphed against N_STEPS eager steps from the same seed, the
draws injected and drawn from the session's registered generator. Where
two eager runs are bitwise equal, the graph must equal them bitwise,
metrics and every parameter; where they are not, the graph's metrics are
held to the eager run's within the card-against-CPU step bounds of
chip_smoke.py (1e-5 relative, 1e-4 for the depth-weighted metrics, each
plus 1% of a bf16 ulp with bf16 storage). The kernel launch counts under
replay, and two replays' window offsets.
"""

from __future__ import annotations

import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.device_buffer import FastDraws, draw_offsets
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.kernels import fused_field as ff
from catnerf_torch.train.loop import TrainingSession

SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)
N_STEPS = 6
N_INNER = 4  # run_fast(N_STEPS) is a superstep and a shorter one
STEP_TOL = 1e-5
DEPTH_STEP_TOL = 1e-4
DEPTH_WEIGHTED = ("total", "cat_depth", "bg_depth")
FLIP_SHARE, BF16_ULP = 0.01, 2.0 ** -7
FUSED_KERNELS = ("codenerf_fwd", "codenerf_bwd", "occupancy_fwd",
                 "occupancy_bwd")


def fused(cfg):
    cfg.use_fused_kernels = True
    cfg.bf16_activations = False
    return cfg


def strict(cfg):
    return cfg.apply_strict_parity()


CONFIGS = {"fused": fused, "strict": strict, "default": lambda cfg: cfg}


def make_config(name: str) -> Config:
    cfg = CONFIGS[name](Config())
    cfg.net_hyperparams.latent_dim = 32
    cfg.n_per_optim_bg = 240
    return cfg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def session(name: str, graph: bool) -> TrainingSession:
    scene = make_scene(**SCENE)
    sess = TrainingSession(make_config(name), scene.inst_dict,
                           scene.sample_dict, cam=scene.cam, device="cuda")
    sess.enable_fast_path(N_INNER, graph=graph)
    return sess


def injected(sess: TrainingSession, seed: int = 11) -> list[FastDraws]:
    gen = torch.Generator("cuda").manual_seed(seed)
    return [FastDraws(*draw_offsets(sess._store, gen), sess._draws(gen))
            for _ in range(N_STEPS)]


def trajectory(name: str, graph: bool, source: str):
    sess = session(name, graph)
    draws = injected(sess) if source == "injected" else None
    m = sess.run_fast(N_STEPS, draws=draws)
    torch.cuda.synchronize()
    return ({k: v.cpu() for k, v in m._asdict().items()},
            [p.detach().cpu() for p in sess.state.params.parameters()],
            sess)


def bitwise(a, b) -> bool:
    return (all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and all(torch.equal(p, q) for p, q in zip(a[1], b[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["generator", "injected"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_matches_eager(cuda_device, name, source):
    eager = trajectory(name, False, source)
    again = trajectory(name, False, source)
    graphed = trajectory(name, True, source)
    assert graphed[2]._superstep.captured, "no graph captured"
    if bitwise(eager, again):
        assert bitwise(graphed, eager), "graph differs from the eager loop"
        return
    bf16 = make_config(name).bf16_activations
    for k, want in eager[0].items():
        tol = DEPTH_STEP_TOL if k in DEPTH_WEIGHTED else STEP_TOL
        tol += FLIP_SHARE * BF16_ULP if bf16 else 0.0
        rel = ((graphed[0][k] - want).abs()
               / want.abs().clamp_min(1e-12)).max()
        assert float(rel) <= tol, (k, float(rel), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_launch_counts(cuda_device, name):
    """Kernels 1-4 launch once a step on the fused trainer, warm-up steps
    and replays alike, and never on the others."""
    sess = session(name, True)
    ff.reset_launch_counts()
    sess.run_fast(N_STEPS)
    sess.run_fast(3)
    torch.cuda.synchronize()
    n = N_STEPS + 3 if name == "fused" else 0
    assert ff.LAUNCHES == {k: n if k in FUSED_KERNELS else 0
                           for k in ff.LAUNCHES}
    step = sess._superstep.captured["generator"]
    assert step.launches == ({k: 1 for k in FUSED_KERNELS}
                             if name == "fused" else {})
    assert step.node_count() > 0


@pytest.mark.cuda
def test_replays_draw_new_offsets(cuda_device):
    """Each replay advances the registered generator: two replays draw
    different window offsets (into the graph's static tensors), and the
    metrics returned are copies of the graph's outputs."""
    sess = session("default", True)
    sess.run_fast(N_INNER)  # the warm-up steps, the capture, a replay
    step = sess._superstep.captured["generator"]
    m1 = sess.run_fast(1)
    offs1 = [x.clone() for x in sess._superstep.offsets]
    m2 = sess.run_fast(1)
    offs2 = sess._superstep.offsets
    assert offs2[0].data_ptr() == step.outputs[1][0].data_ptr()
    assert not (torch.equal(offs1[0], offs2[0])
                and torch.equal(offs1[1], offs2[1]))
    assert m1.total.data_ptr() != step.outputs[0].total.data_ptr()
    assert not torch.equal(m1.total, m2.total)
