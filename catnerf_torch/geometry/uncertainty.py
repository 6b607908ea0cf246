"""Uncertainty-field template scoring (registration stage 2, the device
part): the port of the JAX package's `geometry/uncertainty.py`.

Parity target: `get_uncertainty_fields`
(ref: src/category_registration.py:58-177): cast a 100x100 spherical shell
of inward rays around each object, evaluate its pretrained vMAP occupancy
field along 96 stratified bins, compute the termination-probability entropy
per ray, map the heuristic sum(term)*exp(-entropy/2) through the
double-sigmoid reliability curve (ref: src/utils.py:553-559), and count
reliable directions -> the per-object completeness score used for template
selection.

The field evaluation (10k rays x 96 bins through the XLA-path
`models/{embedding,occupancy}.apply`, then the termination) runs on the
device, the card unless `device` names another; the entropies, the
heuristic and the count run on the host in numpy, as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from catnerf_torch import convert
from catnerf_torch.models import embedding, occupancy
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.occupancy import OccupancyMap
from catnerf_torch.ops import render as render_ops
from catnerf_torch.ops.sampling import _stratified_from_u
from catnerf_torch.utils import resolve_device

N_DIRS_PHI = 100
N_DIRS_THETA = 100
N_BINS = 96
# rays a field evaluation takes at once on the CPU (all of them on the
# card), so that 24,000 points' activations stay in cache; a ray's values
# do not depend on the chunk
CPU_CHUNK_RAYS = 250


def calculate_reliability(metric: np.ndarray, eta: float = 0.9,
                          m1: float = 0.1, m2: float = 0.15,
                          M1: float = 0.57, M2: float = 0.65) -> np.ndarray:
    """Double-sigmoid reliability band (ref: src/utils.py:553-559)."""
    alpha_m = 2 * np.log(eta / (1 - eta)) / (m2 - m1)
    beta_m = (m1 + m2) / 2
    alpha_M = 2 * np.log(eta / (1 - eta)) / (M2 - M1)
    beta_M = (M1 + M2) / 2
    return (1.0 / (1.0 + np.exp(alpha_m * (metric - beta_m)))
            + 1.0 / (1.0 + np.exp(-alpha_M * (metric - beta_M))))


def spherical_ray_grid() -> np.ndarray:
    """Unit directions over a (100, 100) phi/theta grid
    (ref: src/category_registration.py:96-104)."""
    phi = np.linspace(0, np.pi, N_DIRS_PHI)
    theta = np.linspace(0, 2 * np.pi, N_DIRS_THETA)
    phi, theta = np.meshgrid(phi, theta, indexing="xy")
    x = np.sin(phi) * np.cos(theta)
    y = np.sin(phi) * np.sin(theta)
    z = np.cos(phi)
    return np.stack([x, y, z], -1).reshape(-1, 3)


def field_modules(field_params: dict, device) -> tuple:
    """(UniDirsEmbed, OccupancyMap) on `device` from a field dict's numpy
    leaves ({'pe': {'B'}, 'fc': {...}}, the JAX pytree layout)."""
    pe = UniDirsEmbed(torch.tensor(np.asarray(field_params["pe"]["B"],
                                              np.float32), device=device))
    fc = OccupancyMap(convert.layers_from_jax(field_params["fc"], device))
    return pe, fc


@torch.no_grad()
def term_probs_field(pe: UniDirsEmbed, fc: OccupancyMap,
                     rays_o: torch.Tensor, viewdirs: torch.Tensor,
                     z_vals: torch.Tensor,
                     pe_scale: torch.Tensor) -> torch.Tensor:
    """Termination probabilities [n_rays, n_bins] (the JAX package's
    `_term_probs_field`). pe_scale is a float32 tensor, so the embedding
    divides by it on the device, as the JAX package's traced scale."""
    xyz = rays_o[:, None, :] + viewdirs[:, None, :] * z_vals[..., None]
    # the density trunk reads the low bands only (EMB_SIZE1 = 87: the
    # frequencies up to 2^3), the colour head, not run here, the rest
    emb = embedding.apply(pe, xyz, scale=pe_scale, max_deg=3)
    alpha, _ = occupancy.apply(fc, emb, do_color=False)
    # NB the reference applies sigmoid(10 * alpha) on top of the model's own
    # x10 logit scale (ref: src/category_registration.py:150) — an extra
    # sharpening unique to this stage; preserved.
    occ = torch.sigmoid(10.0 * alpha[..., 0])
    return render_ops.occupancy_to_termination(occ)


def shell_rays(field_params: dict, points: np.ndarray,
               name: str = "replica"):
    """(rays_o [n, 3] float32, viewdir [n, 3] float32, r): the inward
    spherical shell around the instance's cloud, in the field's frame."""
    pts = np.asarray(points)
    bound = np.maximum(pts.max(0) - pts.min(0), 0.10)
    r = float(1.2 * np.sqrt(np.square(bound / 2.0).sum()))

    dirs = spherical_ray_grid()
    rays_o_o = (r * dirs).astype(np.float32)
    viewdir = (-dirs).astype(np.float32)
    if name == "replica":
        center = (pts.max(0) + pts.min(0)) / 2.0
    else:  # noisy real-world clouds: mean
        center = pts.mean(0)
    rays_o = rays_o_o + center.astype(np.float32)
    # Self-pretrained fields (geometry/field_pretrain.py) live in a
    # cloud-centered frame; shift queries into it. vMAP-converted fields
    # have no 'center' (identity shift).
    if "center" in field_params:
        rays_o = rays_o - np.asarray(field_params["center"], np.float32)
    return rays_o, viewdir, r


def uncertainty_score(field_params: dict, points: np.ndarray,
                      name: str = "replica", *, seed: int = 0,
                      u: torch.Tensor | None = None, device=None):
    """Per-object reliability count (ref: src/category_registration.py:
    112-177). field_params: {'pe', 'fc', 'obj_scale'} from the converted
    vMAP checkpoint or the pretraining. points: the instance's accumulated
    cloud (world frame).

    The stratified bins' uniforms [10000, 96] come from a generator on the
    device seeded with `seed`, or are `u` (injected, e.g. the JAX
    package's draw from PRNGKey(seed)). The JAX package's
    `use_reliability=False` form (entropies as the metric) has no caller
    and is not ported.

    Returns (count, entropies, metric)."""
    device = resolve_device(device)
    rays_o, viewdir, r = shell_rays(field_params, points, name)
    n_rays = rays_o.shape[0]
    if u is None:
        gen = torch.Generator(device).manual_seed(int(seed))
        u = torch.rand(n_rays, N_BINS, generator=gen, device=device)
    u = u.to(device)
    z_vals = _stratified_from_u(
        u, torch.zeros(n_rays, device=device),
        torch.full((n_rays,), 2.0 * r, device=device))

    pe, fc = field_modules(field_params, device)
    rays_o = torch.from_numpy(rays_o).to(device)
    viewdir = torch.from_numpy(viewdir).to(device)
    scale = torch.tensor(field_params["obj_scale"], dtype=torch.float32,
                         device=device)
    chunk = n_rays if device.type == "cuda" else CPU_CHUNK_RAYS
    term = torch.cat([
        term_probs_field(pe, fc, rays_o[i:i + chunk], viewdir[i:i + chunk],
                         z_vals[i:i + chunk], scale)
        for i in range(0, n_rays, chunk)]).cpu().numpy()

    entropies = np.sum(-term * np.log(term + 1e-10), axis=-1)
    heuristic = term.sum(-1) * np.exp(-0.5 * entropies)
    metric = 1.0 - calculate_reliability(heuristic)
    return int((metric < 0.5).sum()), entropies, metric
