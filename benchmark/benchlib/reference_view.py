"""The plain reference of a served scene view: plain PyTorch operators in
float32, imports nothing of the program.

A view (ref: the JAX package's render_scene_view, src/render_rays.py):
the pinhole camera's rays from a pose, `n_bins` samples at the
midpoints of equal bins between near and far; at each sample every
object's field in its own frame (canonical through the inverse sim(3) for
a category of more instances, the world's for one), masked to its box
grown by `margin`, and the background's; the fields merged as independent
occupancies (occ = 1 - prod(1 - occ_f), colour the occupancy-weighted
mean); termination and compositing along the ray; the image quantised to
8 bits as a PNG holds it.
"""

from __future__ import annotations


import numpy as np
import torch

from benchlib import reference


def objects(inst_dict, margin: float):
    """Per object (in the categories' sorted order, each category's
    instances in order): its category index, instance slot, world-to-field
    transform (A, b), world-to-box transform (Am, bm) and box half-size."""
    out = []
    cls_ids = sorted(k for k in inst_dict if k != 0)
    for ci, cid in enumerate(cls_ids):
        insts = inst_dict[cid]
        for slot, info in enumerate(insts.values()):
            box = info["bbox3D"]
            if len(insts) > 1:
                T = np.asarray(info["T_obj"], np.float64)
                s = float(np.linalg.norm(T[:3, 0]))
                R = T[:3, :3] / s
                A = R.T / s
                b = -R.T @ T[:3, 3] / s
                half = margin * np.asarray(box.extent) / (2 * s)
                Am, bm = A, b
            else:
                A, b = np.eye(3), np.zeros(3)
                Am = np.asarray(box.R).T
                bm = -Am @ np.asarray(box.center)
                half = 0.5 * margin * np.asarray(box.extent)
            out.append((ci, slot, *(np.asarray(x, np.float32)
                                    for x in (A, b, Am, bm, half))))
    return out


def _fields(P, arch):
    return ({k[7:]: v for k, v in P.items() if k.startswith("cat_fc.")},
            {k[6:]: v for k, v in P.items() if k.startswith("bg_fc.")})


def render(P, arch, cfg, objs, cam, T, near, far, n_bins,
           p: reference.Precision = reference.F32, chunk: int = 1 << 20):
    """[W, H, 3] float32 image of the view from pose T at pinhole `cam`
    (width, height, fx, fy, cx, cy). P: the weights by name."""
    dev = P["bg_pe.B"].device
    W, H, fx, fy, cx, cy = cam
    w = (torch.arange(W, dtype=torch.float32, device=dev) - cx) / fx
    h = (torch.arange(H, dtype=torch.float32, device=dev) - cy) / fy
    dirs = torch.ones(W, H, 3, device=dev)
    dirs[..., 0], dirs[..., 1] = w[:, None], h[None, :]
    Tt = torch.as_tensor(T, device=dev)
    dirs = dirs.reshape(-1, 3) @ Tt[:3, :3].T
    near_t = torch.tensor(near, dtype=torch.float32, device=dev)
    far_t = torch.tensor(far, dtype=torch.float32, device=dev)
    edges = near_t + (far_t - near_t) * torch.linspace(0.0, 1.0, n_bins + 1,
                                                       device=dev)
    z = 0.5 * (edges[:-1] + edges[1:])
    cat_fc, bg_fc = _fields(P, arch)
    nb, nt = arch["shape_blocks"], arch["texture_blocks"]

    def inj(layers, codes):
        return torch.cat([p.store(torch.relu(reference._lin(
            P, f"cat_fc.{n}", codes, p))) for n in layers], -1)

    inj_s = inj([f"shape_latent_layers.{j}" for j in range(nb)]
                + ["cat_latent_layer"], P["codes.shape"])
    inj_t = inj([f"texture_latent_layers.{j}" for j in range(nt)],
                P["codes.texture"])
    tens = [(ci, slot, *(torch.as_tensor(x, device=dev) for x in rest))
            for ci, slot, *rest in objs]
    rays = max(1, chunk // n_bins)
    out = []
    with torch.no_grad():
        for d in dirs.split(rays):
            pts = (Tt[:3, 3] + d[:, None, :] * z[None, :, None]).reshape(-1, 3)
            one_minus = torch.ones_like(pts[:, 0])
            csum = torch.zeros_like(pts)
            wsum = torch.zeros_like(pts[:, 0])
            for ci, slot, A, b, Am, bm, half in tens:
                inside = ((pts @ Am.T + bm).abs() <= half).all(-1)
                idx = inside.nonzero().squeeze(1)
                if not idx.numel():
                    continue
                x = pts[idx] @ A.T + b
                one = {k: v[ci:ci + 1] for k, v in cat_fc.items()}
                emb = reference.embed(P["cat_pe.B"][ci:ci + 1], x[None],
                                      cfg["obj_scale"], p)
                n = idx.numel()
                sigma, rgb = reference.codenerf(
                    one, emb, inj_s[ci:ci + 1, slot:slot + 1].expand(1, n, -1),
                    inj_t[ci:ci + 1, slot:slot + 1].expand(1, n, -1), arch, p)
                occ = torch.sigmoid(sigma[0])
                one_minus[idx] = one_minus[idx] * (1.0 - occ)
                csum[idx] = csum[idx] + occ[:, None] * rgb[0]
                wsum[idx] = wsum[idx] + occ
            alpha, rgb = reference.occupancy(
                bg_fc, reference.embed(P["bg_pe.B"], pts, cfg["bg_scale"], p),
                p)
            occb = torch.sigmoid(alpha)
            occ = 1.0 - one_minus * (1.0 - occb)
            col = (csum + occb[:, None] * rgb) / torch.clamp(
                (wsum + occb)[:, None], min=1e-8)
            occ, col = occ.reshape(-1, n_bins), col.reshape(-1, n_bins, 3)
            trans = [torch.ones_like(occ[:, 0])]
            for i in range(n_bins - 1):
                trans.append(trans[-1] * (1.0 - occ[:, i] + 1e-10))
            term = occ * torch.stack(trans, -1)
            out.append((term[..., None] * col).sum(-2))
    return torch.cat(out).reshape(W, H, 3)


def quantise(img: torch.Tensor) -> np.ndarray:
    """[W, H, 3] in [0, 1] -> [H, W, 3] uint8, as the served PNG holds."""
    return (torch.clamp(img, 0, 1).permute(1, 0, 2) * 255).to(
        torch.uint8).cpu().numpy()
