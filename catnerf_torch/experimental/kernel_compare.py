"""The field-kernel comparison path: the packed-ensemble CodeNeRF kernel
and the MLP-only kernel, each held against the XLA-path CodeNeRF and timed.

    python -m catnerf_torch.experimental.kernel_compare [--device cpu]

The port of the JAX package's `scripts/exp_kernel3.py` (packed kernel
against the XLA path, forward and forward+backward, at tiles 128, 256 and
384) and of variant C of `scripts/exp_kernel2.py` (the XLA-path PE
followed by the chain alone in a kernel), at their shapes: C=8
categories, N=2,100 points per category, latent 32, scale 2.0. Inputs come
from a seeded torch.Generator. Every output is checked against the XLA
path's: forward within 1e-5, gradients of sum(sigma^2) + sum(rgb) w.r.t.
the field's layers within 3e-4 (the bounds of the JAX package's
tests/test_fused_field.py:197-200, :227), each bound's absolute part
scaled by the output's largest entry. The packed kernel's sine arguments
are t @ (B * pi 2^f), the XLA path's 2^f (t @ B) through a polynomial: at
arguments up to ~200 the two differ by ~1e-5 of phase, which moves sigma
x10 by ~1e-5 on any point, small or large (1.1e-5 on one of 0.047 of
16,800 on an H100); the gradients sum 16,800 point-categories and reach
~1e6, where two float32 summation orders differ by ~1e-7 of it.

Times are CUDA events on a GPU (median per call of `n` calls after a
warm-up) and the host clock with `--device cpu`, where the wrappers take
their plain versions; a CPU time says nothing of the card. One line per
timing, then one JSON line with all of them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from catnerf_torch.kernels import fused_field as ff
from catnerf_torch.models import codenerf, embedding
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import EMB_SIZE1, UniDirsEmbed
from catnerf_torch.utils import resolve_device

C, N, LATENT, SCALE = 8, 2100, 32, 2.0
TILES = (128, 256, 384)
FWD_TOL = 1e-5
GRAD_TOL = 3e-4


def make_inputs(device, n_cls: int = C, n_pts: int = N, seed: int = 0):
    """The stacked CodeNeRF (latent 32), its basis at init, points [C, N, 3]
    and four ReLU'd injections [C, N, 32], drawn on the CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    fc = CodeNeRF.init(gen, n_cls, latent_dim=LATENT).to(device)
    pe = UniDirsEmbed.init((n_cls,)).to(device)
    pts = torch.randn(n_cls, n_pts, 3, generator=gen).to(device)
    zs = tuple(torch.relu(torch.randn(n_cls, n_pts, 32, generator=gen))
               .to(device) for _ in range(4))
    return fc, pe, pts, zs


def xla_forward(fc, pe, pts, zs):
    """The XLA-path CodeNeRF with the injections given per point (ref:
    exp_kernel3.py:35-53): (sigma [C, N], rgb [C, N, 3])."""
    zs0, zc, zs1, zt0 = zs
    emb = embedding.apply(pe, pts, scale=SCALE)
    # injection layout of apply_with_injections: [shape0, shape1, cat | tex0]
    sigma, rgb = codenerf.apply_with_injections(
        fc, emb, torch.cat([zs0, zs1, zc], dim=-1), zt0)
    return sigma[..., 0], rgb


def packed_forward(fc, pe, pts_p, zs_p, tile):
    """Kernels 5/6: (sigma [C, N], rgb [C, N, 3]) for comparison."""
    sg, rgb = ff.codenerf_packed_apply(fc, pe, pts_p, *zs_p, scale=SCALE,
                                       tile=tile)
    return sg.transpose(0, 1), rgb.transpose(0, 1)


def mlp_only_forward(fc, pe, pts, zs):
    """The XLA-path PE, then kernel 7 (ref: exp_kernel2.py:95-111)."""
    emb = embedding.apply(pe, pts, scale=SCALE)
    out = ff.codenerf_mlp_fwd(ff.pack(ff._cn_modules(fc)),
                              emb[..., :EMB_SIZE1].contiguous(),
                              emb[..., EMB_SIZE1:].contiguous(), zs)
    return out[..., 0], out[..., 1:]


def _loss(sigma, rgb):
    return (sigma * sigma).sum() + rgb.sum()


def _field_params(fc):
    return [p for m in ff._cn_modules(fc) for p in (m.w, m.b)]


def _grads(forward, fc):
    return torch.autograd.grad(_loss(*forward()), _field_params(fc))


def time_ms(fn, device, n: int, warmup: int = 3) -> float:
    """Median time of one call: CUDA events around each call on a GPU,
    the host clock (after the call returns) on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_err(got, want, tol, what):
    err = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: not finite")
        atol = tol * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=tol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, float((g - w).abs().max()))
    return err


def run(device=None, n_cls: int = C, n_pts: int = N, tiles=TILES,
        n: int = 20, log=print) -> list[dict]:
    """Check every variant against the XLA path, then time each. Returns
    one row per timing: name, ms, max_abs_err against the XLA path."""
    device = resolve_device(device)
    fc, pe, pts, zs = make_inputs(device, n_cls, n_pts)
    pts_p = ff.to_point_major(pts).contiguous()
    zs_p = tuple(ff.to_point_major(z).contiguous() for z in zs)
    with torch.no_grad():
        ref = xla_forward(fc, pe, pts, zs)
    ref_grads = _grads(lambda: xla_forward(fc, pe, pts, zs), fc)

    # name -> (function, the XLA-path result it is held to or None, tol,
    # whether it runs without autograd)
    xla = lambda: xla_forward(fc, pe, pts, zs)
    variants = {"xla forward": (xla, None, None, True)}
    for tile in tiles:
        variants[f"packed forward tile={tile}"] = (
            lambda tile=tile: packed_forward(fc, pe, pts_p, zs_p, tile),
            ref, FWD_TOL, True)
    variants["xla-PE + fused MLP"] = (
        lambda: mlp_only_forward(fc, pe, pts, zs), ref, FWD_TOL, True)
    variants["xla fwd+bwd"] = (lambda: _grads(xla, fc), None, None, False)
    for tile in tiles:
        variants[f"packed fwd+bwd tile={tile}"] = (
            lambda tile=tile: _grads(
                lambda: packed_forward(fc, pe, pts_p, zs_p, tile), fc),
            ref_grads, GRAD_TOL, False)

    rows = []
    for name, (fn, want, tol, no_grad) in variants.items():
        with torch.no_grad() if no_grad else contextlib.nullcontext():
            err = None if want is None else _max_err(fn(), want, tol, name)
            ms = time_ms(fn, device, n)
        rows.append(dict(name=name, ms=ms, max_abs_err=err))
        log(f"kernel_compare: {name:30s} {ms:9.4f} ms"
            + ("" if err is None else f", max abs err {err:.2e} vs xla"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: cuda)")
    args = ap.parse_args(argv)
    rows = run(args.device)
    device = resolve_device(args.device)
    print(json.dumps({"device": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                      "C": C, "N": N, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
