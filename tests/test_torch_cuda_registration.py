"""The registration's device stages on the card against the CPU
(`catnerf_torch/geometry/field_pretrain.py`, `uncertainty.py`), on a
synthetic scene: a pretraining step from the same state and draws, the
captured pretraining step against the eager loop, and each trained
field's uncertainty count on the same uniforms.

Marked `cuda`: they skip where there is no GPU. This file imports neither
jax nor the JAX package; tests/conftest.py imports jax, so on a machine
with only PyTorch run it without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_registration.py -q
"""

from __future__ import annotations

import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.experimental import registration_check as rc
from catnerf_torch.geometry import field_pretrain as fp
from catnerf_torch.geometry.registration import get_all_poses

SCENE = dict(n_frames=6, width=96, height=72, n_categories=2,
             insts_per_cat=2, seed=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the card's pretraining and "
                    "scoring are held against the CPU here")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def objects():
    scene = make_scene(**SCENE)
    get_all_poses(scene.inst_dict, scene.sample_dict, scene.cam)
    objs = [(o, info["frame_info"], info["pcs"])
            for c, v in sorted(scene.inst_dict.items()) if c
            for o, info in sorted(v.items())]
    return scene, objs


def _params(t):
    return [p for _, p in rc.named_leaves(t)]


@pytest.mark.cuda
def test_pretrain_steps_on_the_card_match_the_cpu(cuda_device, objects):
    """20 steps on the card, each repeated on the CPU from the card's
    state (parameters and AdamW moments) on the card's draws, within
    experimental/registration_check.py's bounds; the loss falls."""
    scene, objs = objects
    card, cpu = (fp.ObjectFieldTrainer(objs, scene.sample_dict, scene.cam,
                                       Config(), n_rays=256, device=dev)
                 for dev in (cuda_device, "cpu"))
    check = rc.pretrain_card_vs_cpu(card, cpu, 20)
    assert not check.failures(), check.line()
    assert check.losses[-1] < check.losses[0]


def _state(t) -> list:
    return [p.detach().clone() for p in _params(t)] + [
        v.detach().clone() for st in t.optimizer.state.values()
        for v in st.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["generator", "injected"])
def test_the_captured_step_is_the_eager_loop(cuda_device, objects, kind):
    """`step()` on the card (3 eager warm-up steps, one captured, then
    replays) against `eager_step()` from the same seed and draws, 8 steps:
    every loss, parameter and AdamW moment bitwise, as two eager loops
    are."""
    scene, objs = objects
    runs = []
    for how in ("eager", "eager", "graph"):
        t = fp.ObjectFieldTrainer(objs, scene.sample_dict, scene.cam,
                                  Config(), n_rays=256, device=cuda_device)
        src = fp.ObjectFieldTrainer(objs, scene.sample_dict, scene.cam,
                                    Config(), n_rays=256,
                                    device=cuda_device)
        losses = []
        for _ in range(8):
            d = src.draw() if kind == "injected" else None
            if how == "graph":
                loss = t.step(d)
            else:
                loss = t.eager_step(*(d or (None, None)))
            losses.append(loss.clone())
        if how == "graph":
            assert t.captured[kind].graph is not None
        runs.append((torch.stack(losses), _state(t)))
    (l0, s0), (l1, s1), (lg, sg) = runs
    assert torch.equal(l0, l1) and all(map(torch.equal, s0, s1))
    assert torch.equal(lg, l0)
    assert all(map(torch.equal, sg, s0))


@pytest.mark.cuda
def test_uncertainty_counts_on_the_card_match_the_cpu(cuda_device, objects):
    """Each object's field (40 steps on the card) scored on the card and
    on the CPU on the card's uniforms: counts under the flip rule."""
    scene, objs = objects
    fields = fp.pretrain_object_fields(objs, scene.sample_dict, scene.cam,
                                       Config(), steps=40, n_rays=256,
                                       n_inner=20, device=cuda_device)
    for (obj_id, _, pcs), field in zip(objs, fields):
        r = rc.uncertainty_card_vs_cpu(field, pcs, obj_id, cuda_device)
        assert r["ok"], r
        assert 0 < r["card"] <= 10000
