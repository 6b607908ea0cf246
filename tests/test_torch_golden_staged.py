"""The JAX package's host-staged loss-curve goldens replayed by the port:
`tests/golden/loss_curve_seed0.json` (float32) and
`loss_curve_seed0_bf16.json` (the default `Config()`, bf16 activation
storage), 200 `step_once` steps each, under the golden test's config and
bounds (tests/test_loss_curve_pin.py:38-45, :60-63).

The port starts from the JAX package's initial parameters (converted),
reads its own batcher's byte-equal batches, and is handed the JAX
session's sampling uniforms (`fold_in(base_key, step)`). No JAX trainer
runs: the goldens are the JAX side.

Which bounds hold where. The golden's PSNR bounds hold over all 200 steps.
Its total-loss bounds (8% at most, 2% on average) are applied to the
checkpoints before the golden's total first rises by more than its own 8%
bound (`pre_spike`: steps 10-60 in all four goldens). From that rise on,
the depth term's weight 1/sqrt(var) makes the total chaotic: any float32
rounding change moves it by more than 8% at some later checkpoint. The
goldens come from the jitted JAX step, and the JAX package's own eager
step leaves the same bounds there too (`tests/torch_golden_spread.py`
prints both, and the port started from weights moved by 1e-7).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.train.loop import TrainingSession as JSession
from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.ops import sampling
from catnerf_torch.train import step as tstep
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import make_train_state

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_SCENE = dict(n_frames=4, width=64, height=48, n_categories=2,
                    insts_per_cat=2, seed=0)
N_STEPS = 200
EVERY = 10
# the golden tests' bounds (tests/test_loss_curve_pin.py:60-63, :98-99)
CAT_PSNR_MAX, CAT_PSNR_MEAN, BG_PSNR_MAX = 0.35, 0.1, 0.35
TOTAL_REL_MAX, TOTAL_REL_MEAN = 0.08, 0.02


def golden_config(cfg, bf16: bool):
    """tests/test_loss_curve_pin.py:38-45 (and :78-85)."""
    cfg.bf16_activations = bf16
    cfg.net_hyperparams.latent_dim = 16
    cfg.hidden_feature_size_bg = 32
    cfg.n_per_optim = 48
    cfg.n_per_optim_bg = 128
    return cfg


def load_golden(name: str) -> dict:
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        return json.load(fh)


def sessions(bf16: bool):
    """The JAX session (its initial parameters, key and draws) and the
    port's session on the CPU, started from those parameters."""
    js = jmake_scene(**GOLDEN_SCENE)
    jsess = JSession(golden_config(JConfig(), bf16), js.inst_dict,
                     js.sample_dict, cam=js.cam)
    ts = make_scene(**GOLDEN_SCENE)
    cfg = golden_config(Config(), bf16)
    tsess = TrainingSession(cfg, ts.inst_dict, ts.sample_dict, cam=ts.cam,
                            device="cpu")
    tsess.state = make_train_state(
        cfg, convert.params_from_jax(jsess.state.params))
    return jsess, tsess


def jax_uniforms(jsess, key, step: int) -> tstep.StepDraws:
    """The uniforms the JAX train step draws from `key` at `step`
    (step.py:102, :202, :244; sampling.py:123-124)."""
    cfg = jsess.cfg
    k_cat, k_bg = jax.random.split(jax.random.fold_in(key, step))
    n_u = sampling.n_uniforms(cfg.n_bins_cam2surface, cfg.n_bins)
    n_u_bg = sampling.n_uniforms(cfg.n_bins_cam2surface_bg, cfg.n_bins)
    u_cat = np.stack([
        np.asarray(jax.random.uniform(k, (jsess.n_per_cls, n_u)))
        for k in jax.random.split(k_cat, len(jsess.cls_ids))])
    u_bg = np.asarray(jax.random.uniform(k_bg, (cfg.n_per_optim_bg, n_u_bg)))
    return tstep.StepDraws(torch.tensor(u_cat), torch.tensor(u_bg))


def pre_spike(total) -> int:
    """The number of checkpoints before the curve first rises by more than
    TOTAL_REL_MAX over its previous checkpoint."""
    return next((i for i in range(1, len(total))
                 if total[i] > (1 + TOTAL_REL_MAX) * total[i - 1]),
                len(total))


def deviations(curve: dict, golden: dict) -> dict:
    """The golden test's statistics of a curve against the golden."""
    out = {}
    for k in ("cat_psnr", "bg_psnr"):
        if k in curve:
            d = np.abs(np.asarray(curve[k]) - np.asarray(golden[k]))
            out[k] = (float(d.max()), float(d.mean()))
    rel = np.abs(np.asarray(curve["total"]) / np.asarray(golden["total"])
                 - 1.0)
    n = pre_spike(golden["total"])
    out["total"] = (float(rel.max()), float(rel.mean()))
    out["total_pre_spike"] = (float(rel[:n].max()), float(rel[:n].mean()), n)
    return out


def assert_within_golden(curve: dict, golden: dict) -> dict:
    dev = deviations(curve, golden)
    assert dev["cat_psnr"][0] < CAT_PSNR_MAX, (curve["cat_psnr"],
                                               golden["cat_psnr"])
    assert dev["cat_psnr"][1] < CAT_PSNR_MEAN, dev
    if "bg_psnr" in dev:
        assert dev["bg_psnr"][0] < BG_PSNR_MAX, dev
    rel_max, rel_mean, n = dev["total_pre_spike"]
    assert n >= 5, n
    assert rel_max < TOTAL_REL_MAX and rel_mean < TOTAL_REL_MEAN, (
        dev, curve["total"][:n], golden["total"][:n])
    return dev


def replay_staged(bf16: bool, jsess=None, tsess=None) -> dict:
    """The port's 200 host-staged steps on the JAX session's draws; the
    metrics every 10 steps, as the golden records them."""
    if tsess is None:
        jsess, tsess = sessions(bf16)
    curve = {"total": [], "cat_psnr": [], "bg_psnr": []}
    for i in range(N_STEPS):
        m = tsess.step_once(draws=jax_uniforms(jsess, jsess.base_key, i))
        if (i + 1) % EVERY == 0:
            curve["total"].append(float(m.total))
            curve["cat_psnr"].append(float(m.cat_psnr.mean()))
            curve["bg_psnr"].append(float(m.bg_psnr))
    return curve


@pytest.mark.parametrize("variant,fname,bf16", [
    ("f32", "loss_curve_seed0.json", False),
    ("bf16", "loss_curve_seed0_bf16.json", True),
], ids=["f32", "bf16"])
def test_port_replays_staged_golden(variant, fname, bf16):
    dev = assert_within_golden(replay_staged(bf16), load_golden(fname))
    print(f"staged {variant}: {dev}")
