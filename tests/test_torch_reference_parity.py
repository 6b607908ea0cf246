"""The four checks of tests/test_reference_parity.py, held on the port.

That file's independent torch implementation of the reference spec
(CodeNeRF forward, UniDirsEmbed, rendering math, the full step loss and
the code-norm regulariser) is fed the same weights and ray batch as the
port's XLA-path modules (`embedding.apply`, `codenerf.apply`,
`losses.step_batch_loss`, `losses.code_reg_loss`): the CodeNeRF forward,
the step loss, every gradient and the PSNR proxy must agree, at that
file's tolerances. The weights start as that file's (JAX init,
`convert.params_from_jax`) and reach the independent implementation
through the PORT's reference-schema exporter
(`catnerf_torch.train.checkpoint._codenerf_state_dict`), so this also
locks the port's checkpoint schema.
"""

from __future__ import annotations

import numpy as np
import torch

from catnerf_torch import convert
from catnerf_torch.models import codenerf, embedding
from catnerf_torch.ops import losses
from catnerf_torch.train.checkpoint import _codenerf_state_dict
from test_reference_parity import (N_CLS, N_OBJ, REG_SCALING, SCALE,
                                   setup, torch_total_loss)  # noqa: F401

torch.set_num_threads(1)

# (module, reference state-dict prefix) of every CodeNeRF layer
LAYERS = ([("encoding_xyz", "encoding_xyz.0"), ("cat_layer", "cat_layer.0"),
           ("cat_latent_layer", "cat_latent_layer.0"),
           ("encoding_shape", "encoding_shape"), ("sigma", "sigma.0"),
           ("encoding_viewdir", "encoding_viewdir.0"), ("rgb_0", "rgb.0"),
           ("rgb_1", "rgb.2")]
          + [(f"shape_latent_layers.{j}", f"shape_latent_layer_{j + 1}.0")
             for j in range(2)]
          + [(f"shape_layers.{j}", f"shape_layer_{j + 1}.0")
             for j in range(2)]
          + [("texture_latent_layers.0", "texture_latent_layer_1.0"),
             ("texture_layers.0", "texture_layer_1.0")])


def _port_params(setup):
    fc, pe, sc, tc, _ = setup
    tree = {"cat_pe": {"B": np.asarray(pe["B"])},
            "cat_fc": {k: ([{n: np.asarray(x) for n, x in p.items()}
                            for p in v] if isinstance(v, list) else
                           {n: np.asarray(x) for n, x in v.items()})
                       for k, v in fc.items()},
            "codes": {"shape": sc, "texture": tc}}
    return convert.params_from_jax(tree)


def _reference_params(params, requires_grad=False):
    """The port's parameters -> that file's torch inputs, through the
    port's exporter: one reference state dict per category."""
    tree = convert.params_to_numpy(params)
    sds, pes = [], []
    for c in range(N_CLS):
        fc_c = {k: ([{n: x[c] for n, x in p.items()} for p in v]
                    if isinstance(v, list) else
                    {n: x[c] for n, x in v.items()})
                for k, v in tree["cat_fc"].items()}
        sd = _codenerf_state_dict(torch, fc_c)
        sds.append({k: v.clone().requires_grad_(requires_grad)
                    for k, v in sd.items()})
        pes.append(torch.tensor(tree["cat_pe"]["B"][c]).requires_grad_(
            requires_grad))
    sc = torch.tensor(tree["codes"]["shape"]).requires_grad_(requires_grad)
    tc = torch.tensor(tree["codes"]["texture"]).requires_grad_(requires_grad)
    return sds, pes, sc, tc


def _port_total_loss(params, batch):
    """The port's PE -> CodeNeRF -> step loss -> +code-reg chain (the
    step's loss_fn minus point sampling: points fed directly)."""
    pts = torch.tensor(batch["pts"])
    emb = embedding.apply(params.cat_pe, pts, scale=SCALE)
    idx = torch.tensor(batch["obj_idx"], dtype=torch.long)
    sc = torch.stack([params.codes.shape[c].index_select(0, idx[c])
                      for c in range(N_CLS)])
    tc = torch.stack([params.codes.texture[c].index_select(0, idx[c])
                      for c in range(N_CLS)])
    alpha, color = codenerf.apply(params.cat_fc, emb, sc[:, :, None, :],
                                  tc[:, :, None, :])
    breakdown = losses.step_batch_loss(
        alpha[..., 0], color, torch.tensor(batch["gt_depth"]),
        torch.tensor(batch["gt_color"]), torch.tensor(batch["sem"]),
        torch.tensor(batch["mask_depth"]), torch.tensor(batch["z_vals"]))
    obj_mask = torch.ones((N_CLS, N_OBJ), dtype=torch.bool)
    reg_s, reg_t = losses.code_reg_loss(params.codes.shape,
                                        params.codes.texture, obj_mask)
    total = breakdown.total + REG_SCALING * (reg_s + reg_t).sum()
    return total, breakdown, alpha, color


def test_codenerf_forward_matches_the_reference_spec(setup):
    params = _port_params(setup)
    batch = setup[-1]
    *_, t_alpha, t_color = torch_total_loss(*_reference_params(params), batch)
    with torch.no_grad():
        _, _, alpha, color = _port_total_loss(params, batch)
    np.testing.assert_allclose(alpha[..., 0].numpy(),
                               t_alpha.detach().numpy(), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(color.numpy(), t_color.detach().numpy(),
                               rtol=1e-4, atol=2e-5)


def test_step_loss_matches_the_reference_spec(setup):
    params = _port_params(setup)
    batch = setup[-1]
    t_total, t_d, t_c, t_o, _, _ = torch_total_loss(
        *_reference_params(params), batch)
    with torch.no_grad():
        total, breakdown, _, _ = _port_total_loss(params, batch)
    np.testing.assert_allclose(float(total), float(t_total), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(breakdown.depth.numpy(), t_d.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(breakdown.color.numpy(), t_c.detach().numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(breakdown.opacity.numpy(),
                               t_o.detach().numpy(), rtol=1e-4, atol=1e-6)


def test_step_gradients_match_the_reference_spec(setup):
    """Every gradient: the PE bases, every CodeNeRF weight and bias of
    every category (the reference's (out, in) weights transposed), and
    both code tables."""
    params = _port_params(setup)
    batch = setup[-1]
    sds, pes, sct, tct = _reference_params(params, requires_grad=True)
    t_total, *_ = torch_total_loss(sds, pes, sct, tct, batch)
    t_total.backward()
    total, *_ = _port_total_loss(params, batch)
    total.backward()

    def check(got, want, name):
        assert want is not None and got is not None, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)

    check(params.codes.shape.grad, sct.grad, "shape_codes")
    check(params.codes.texture.grad, tct.grad, "texture_codes")
    modules = dict(params.cat_fc.named_modules())
    for c in range(N_CLS):
        check(params.cat_pe.B.grad[c], pes[c].grad, f"pe.B[{c}]")
        for ours, theirs in LAYERS:
            layer = modules[ours]
            check(layer.w.grad[c].T, sds[c][f"{theirs}.weight"].grad,
                  f"fc[{c}].{ours}.w")
            check(layer.b.grad[c], sds[c][f"{theirs}.bias"].grad,
                  f"fc[{c}].{ours}.b")
    assert len(LAYERS) == sum(hasattr(m, "w") for m in modules.values())


def test_psnr_proxy_matches_the_reference_spec(setup):
    params = _port_params(setup)
    batch = setup[-1]
    _, _, t_c, _, _, _ = torch_total_loss(*_reference_params(params), batch)
    t_psnr = -10 * np.log(t_c.detach().numpy()) / np.log(10)
    with torch.no_grad():
        _, breakdown, _, _ = _port_total_loss(params, batch)
    np.testing.assert_allclose(
        losses.psnr_from_l1(breakdown.psnr_color).numpy(), t_psnr, rtol=1e-4)


def test_the_export_carries_every_layer_of_the_port(setup):
    """The exporter's state dict names each CodeNeRF layer of the port
    once (weight and bias), so the checks above see every parameter."""
    params = _port_params(setup)
    sds, *_ = _reference_params(params)
    assert sorted(sds[0]) == sorted(f"{t}.{k}" for _, t in LAYERS
                                    for k in ("weight", "bias"))
    n_port = sum(1 for n, _ in params.cat_fc.named_parameters())
    assert len(sds[0]) == n_port
