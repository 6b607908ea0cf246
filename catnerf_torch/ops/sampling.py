"""Ray -> 3D sample-point generation (the vMAP sampling strategy).

Parity target: the JAX package's `ops/sampling.py` (ref:
src/scene_cateogries.py:51-96, 453-546). Every ray computes all candidate
bin layouts branchlessly and selects with `torch.where`. The uniforms are
an argument, `u` [..., n_rays, n_u], so that tests can inject the JAX
package's draw; leading dims batch independent ray sets (the categories),
each with its own far bound.

Pixel-state convention (ref: src/scene_cateogries.py:141-144):
  0 = other object, 1 = this object, 2 = unknown.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

OTHER_OBJ = 0
THIS_OBJ = 1
UNKNOWN_OBJ = 2


def n_uniforms(n_bins_cam2surface: int, n_bins: int) -> int:
    """Columns of `u` that sample_3d_points reads (sampling.py:123)."""
    total_bins = n_bins_cam2surface + n_bins
    return total_bins + n_bins_cam2surface + (n_bins + 1) + n_bins


def _stratified_from_u(u: torch.Tensor, min_depth: torch.Tensor,
                       max_depth: torch.Tensor) -> torch.Tensor:
    """Stratified samples from uniforms u [..., n_rays, n_bins]; the bin
    edges are i * (1/n_bins) in float32, as jnp.linspace computes them."""
    n_bins = u.shape[-1]
    depth_range = max_depth - min_depth
    # made on the device: torch.tensor(..., device=cuda) is a host copy
    # that synchronises the stream
    step = torch.full((), 1.0 / n_bins, dtype=u.dtype, device=u.device)
    edges = torch.arange(n_bins, dtype=u.dtype, device=u.device) * step
    lower = depth_range[..., None] * edges + min_depth[..., None]
    return lower + u * (depth_range / n_bins)[..., None]


def _sorted_normal_from_u(u: torch.Tensor, depth: torch.Tensor, sigma: float,
                          delta: float) -> torch.Tensor:
    """Sorted clipped N(0, sigma^2) order statistics from uniforms
    u [..., n_rays, n_bins + 1], via the exponential-gap construction:
    sorted uniform order statistics are cumsum(E_i)/sum(E), E ~ Exp(1),
    mapped through the normal inverse CDF (monotone)."""
    e = -torch.log(torch.clamp(u, min=1e-12))
    cs = torch.cumsum(e[..., :-1], dim=-1)
    u_sorted = cs / (cs[..., -1:] + e[..., -1:])
    # f32 hazard: an edge gap tiny against the sum rounds the ratio to
    # exactly 0.0/1.0 and erfinv returns -/+inf (0*inf = NaN in the depth
    # render); clamp to the nearest interior values, ~±5 sigma, far
    # outside the +-delta (3 sigma) clip below (sampling.py:45-53).
    tiny = 2.0 ** -22
    u_sorted = torch.clamp(u_sorted, tiny, 1.0 - tiny)
    normals = math.sqrt(2.0) * torch.special.erfinv(2.0 * u_sorted - 1.0)
    bins = torch.clamp(normals * sigma, -delta, delta)
    return depth[..., None] + bins


def stratified_bins(u: torch.Tensor, min_depth: torch.Tensor,
                    max_depth: torch.Tensor) -> torch.Tensor:
    """Stratified depth samples per ray (ref: src/scene_cateogries.py:51-81;
    the JAX package's `stratified_bins`, whose uniforms u [n_rays, n_bins]
    are an argument here): one sample inside each of n_bins equal
    sub-intervals of [min_depth, max_depth] ([n_rays] each)."""
    return _stratified_from_u(u, min_depth, max_depth)


def normal_bins_sampling(u: torch.Tensor, depth: torch.Tensor,
                         delta: float) -> torch.Tensor:
    """Sorted samples of N(0, (delta/3)^2) clipped to +-delta around the
    surface depth [n_rays] (ref: src/scene_cateogries.py:84-96; the JAX
    package's `normal_bins_sampling`), from uniforms u [n_rays, n_bins + 1]
    (sort-free: the order statistics are made directly)."""
    return _sorted_normal_from_u(u, depth, delta / 3.0, delta)


class RaySamples(NamedTuple):
    gt_rgb: torch.Tensor            # [..., n_rays, 3]
    gt_depth: torch.Tensor          # [..., n_rays]
    valid_depth_mask: torch.Tensor  # [..., n_rays] bool
    obj_labels: torch.Tensor        # [..., n_rays] pixel state (0/1/2)
    input_pcs: torch.Tensor         # [..., n_rays, n_bins_total, 3]
    z_vals: torch.Tensor            # [..., n_rays, n_bins_total]


def sample_3d_points(u: torch.Tensor, rgbs: torch.Tensor,
                     states: torch.Tensor, depth: torch.Tensor,
                     origins: torch.Tensor, dirs: torch.Tensor, *,
                     n_bins_cam2surface: int, n_bins: int, min_depth: float,
                     surface_eps: float, stop_eps: float) -> RaySamples:
    """Branchless vMAP 3D sampling (ref: src/scene_cateogries.py:453-546).

    Strategy per ray:
      invalid depth (<= min_depth): all (n_bins_cam2surface + n_bins) bins
        stratified in [min_depth, max(depth in the ray set)]
      valid depth:
        first n_bins_cam2surface bins stratified in [min_depth, d - eps]
        this-object rays: n_bins sorted-normal samples around d (sigma eps/3)
        other rays:       n_bins stratified in [d - eps, d + stop_eps]

    u: [..., n, n_uniforms(...)]; rgbs [..., n, 3]; states/depth [..., n];
    origins/dirs [..., n, 3] already in the target (object/world) frame.
    """
    total_bins = n_bins_cam2surface + n_bins
    c2s = n_bins_cam2surface
    u_inv = u[..., :total_bins]
    u_c2s = u[..., total_bins:total_bins + c2s]
    u_norm = u[..., total_bins + c2s:total_bins + c2s + n_bins + 1]
    u_other = u[..., total_bins + c2s + n_bins + 1:]

    invalid = depth <= min_depth
    valid = ~invalid
    # the ray set's max depth is the far bound for invalid rays
    # (ref: src/scene_cateogries.py:486)
    max_bound = depth.amax(dim=-1, keepdim=True).expand_as(depth)
    min_d = torch.full_like(depth, min_depth)

    z_invalid = _stratified_from_u(u_inv, min_d, max_bound)
    z_c2s = _stratified_from_u(u_c2s, min_d, depth - surface_eps)
    z_surf_obj = _sorted_normal_from_u(u_norm, depth, surface_eps / 3.0,
                                       surface_eps)
    z_surf_other = _stratified_from_u(u_other, depth - surface_eps,
                                      depth + stop_eps)

    this_obj = (states == THIS_OBJ) & valid
    z_surf = torch.where(this_obj[..., None], z_surf_obj, z_surf_other)
    z_valid = torch.cat([z_c2s, z_surf], dim=-1)
    z_vals = torch.where(invalid[..., None], z_invalid, z_valid)

    input_pcs = origins[..., None, :] + dirs[..., None, :] * z_vals[..., None]
    return RaySamples(gt_rgb=rgbs, gt_depth=depth, valid_depth_mask=valid,
                      obj_labels=states, input_pcs=input_pcs, z_vals=z_vals)
