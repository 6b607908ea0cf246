"""Checkpoints on the card (`catnerf_torch/train/checkpoint.py`): the
capturable AdamW state of a CUDA session across devices, and restores and
imports beside a captured CUDA graph.

Marked `cuda`: they skip where there is no GPU. This file imports neither
jax nor the JAX package; tests/conftest.py imports jax, so on a machine
with only PyTorch run it without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_checkpoint.py -q
"""

from __future__ import annotations

import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.device_buffer import FastDraws, draw_offsets
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.train import checkpoint as ckpt
from catnerf_torch.train.graph import N_WARMUP
from catnerf_torch.train.loop import TrainingSession

SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; a capturable optimizer and a CUDA "
                    "graph have no CPU mode")
    return torch.device("cuda")


def _session(device) -> TrainingSession:
    cfg = Config()
    cfg.net_hyperparams.latent_dim = 32
    cfg.n_per_optim_bg = 240
    scene = make_scene(**SCENE)
    return TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device=device)


def _tensors(state, device="cpu") -> dict:
    out = {f"param/{k}": v.detach().to(device)
           for k, v in state.params.named_parameters()}
    names = {id(p): k for k, p in state.params.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"adamw/{names[id(p)]}/{k}"] = v.to(device)
    return out


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def _draws(sess, seed, n):
    gen = torch.Generator(sess.device).manual_seed(seed)
    out = []
    for _ in range(n):
        offs, boff = draw_offsets(sess._store, gen)
        out.append(FastDraws(offs, boff, sess._draws(gen)))
    return out


@pytest.mark.cuda
def test_a_cuda_checkpoint_loads_on_the_cpu_and_the_reverse(cuda_device,
                                                            tmp_path):
    """The capturable state of a CUDA session (step counts on the card)
    loads into a CPU session (step counts on the CPU, not capturable),
    and a CPU session's back onto the card (step counts there again),
    every tensor bitwise."""
    sess = _session(None)
    sess.enable_fast_path(5)
    sess.run_fast(N_WARMUP + 3)  # through the graph
    path = ckpt.save_session_checkpoint(str(tmp_path / "cuda"), sess, 6)
    cpu = _session("cpu")
    ckpt.restore_session_checkpoint(path, cpu)
    assert not any(g["capturable"] for g in cpu.state.optimizer.param_groups)
    for st in cpu.state.optimizer.state.values():
        assert st["step"].device.type == "cpu"
        assert st["step"].dtype == torch.float32
    assert _equal(_tensors(cpu.state), _tensors(sess.state))

    path = ckpt.save_session_checkpoint(str(tmp_path / "cpu"), cpu, 6)
    back = _session(None)
    ckpt.restore_session_checkpoint(path, back)
    assert all(g["capturable"] for g in back.state.optimizer.param_groups)
    for p, st in back.state.optimizer.state.items():
        assert st["step"].device == p.device and p.is_cuda
        assert st["exp_avg"].device == p.device
    assert _equal(_tensors(back.state), _tensors(sess.state))
    assert back.iteration == back.state.step == 6


@pytest.mark.cuda
def test_after_a_restore_run_fast_raises_then_replays_the_restored_state(
        cuda_device, tmp_path):
    """A graph captured before a restore reads the old moments: run_fast
    raises until enable_fast_path is called again; the new graph then
    trains the restored state bitwise as the saved session goes on."""
    sess = _session(None)
    sess.enable_fast_path(4)
    sess.run_fast(N_WARMUP + 2)
    path = ckpt.save_session_checkpoint(str(tmp_path), sess, 5)
    sess.enable_fast_path(4)
    draws = _draws(sess, seed=3, n=N_WARMUP + 2)
    want = [m.clone() for m in sess.run_fast(len(draws), draws=draws)]

    other = _session(None)
    other.enable_fast_path(4)
    other.run_fast(N_WARMUP + 2)  # a graph captured on the old state
    ckpt.restore_session_checkpoint(path, other)
    with pytest.raises(RuntimeError, match="enable_fast_path"):
        other.run_fast(1)
    other.enable_fast_path(4)
    got = other.run_fast(len(draws), draws=draws)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _equal(_tensors(other.state), _tensors(sess.state))


@pytest.mark.cuda
def test_an_import_into_a_captured_graph_trains_the_imported_weights(
        cuda_device, tmp_path):
    """The reference import copies into the parameters in place: a graph
    captured before it replays on the imported weights, bitwise as a
    graph captured after it."""
    src = _session(None)
    src.enable_fast_path(4)
    src.run_fast(3)
    ckpt.export_reference_checkpoints(src, str(tmp_path), 3)

    kept, rebuilt = _session(None), _session(None)
    for s in (kept, rebuilt):
        s.enable_fast_path(4)
        s.run_fast(N_WARMUP + 1)  # captured and replayed once
        ckpt.import_reference_checkpoints(s, str(tmp_path))
    rebuilt.enable_fast_path(4)
    draws = _draws(rebuilt, seed=9, n=N_WARMUP + 2)
    a = kept.run_fast(len(draws), draws=draws)
    b = rebuilt.run_fast(len(draws), draws=draws)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _equal(_tensors(kept.state), _tensors(rebuilt.state))
