"""The plain reference of a training step: plain PyTorch operators in
float32, written from the reference's equations and imports nothing of
the program.

One step (ref: train.py:98-201, src/scene_cateogries.py:453-546,
src/model.py, src/render_rays.py, src/loss.py):

1. the rays of each category are sampled along their depth (the vMAP
   strategy) from the step's uniforms;
2. the icosahedral uni-directional encoding of each point;
3. each category's CodeNeRF, conditioned on its instance's shape and
   texture codes through ReLU'd linear injections; the background's
   OccupancyMap;
4. occupancy to termination, rendered depth, colour and opacity; the
   variance-weighted depth L1, the colour and opacity L1 and the codes'
   norm regulariser;
5. AdamW with the reference's two groups (the fields, the codes).

`Precision` says how the products and stored activations round: exact
float32 for the reference, TF32 products or float8 storage for the
controls that a lower precision would read.

Also here: each category's rays as the scene gives them (`ray_sets`), for
the check of the program's ray store.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

EMB1, EMB2 = 87, 42
BANDS = 6
ICOSAHEDRON = np.array(
    [[0.8506508, 0.0, 0.5257311], [0.809017, 0.5, 0.309017],
     [0.5257311, 0.8506508, 0.0], [1.0, 0.0, 0.0],
     [0.809017, 0.5, -0.309017], [0.8506508, 0.0, -0.5257311],
     [0.309017, 0.809017, -0.5], [0.0, 0.5257311, -0.8506508],
     [0.5, 0.309017, -0.809017], [0.0, 1.0, 0.0],
     [-0.5257311, 0.8506508, 0.0], [-0.309017, 0.809017, -0.5],
     [0.0, 0.5257311, 0.8506508], [-0.309017, 0.809017, 0.5],
     [0.309017, 0.809017, 0.5], [0.5, 0.309017, 0.809017],
     [0.5, -0.309017, 0.809017], [0.0, 0.0, 1.0],
     [-0.5, 0.309017, 0.809017], [-0.809017, 0.5, 0.309017],
     [-0.809017, 0.5, -0.309017]], dtype=np.float32)
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
REG_SCALING = 5e-4
OTHER, THIS, UNKNOWN = 0, 1, 2


# --- precision ---------------------------------------------------------------
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so each product of
    the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).mT, round_tf32(a).mT @ g


@dataclasses.dataclass(frozen=True)
class Precision:
    """products: "f32" or "tf32"; storage: None, or the dtype hidden
    activations, embeddings and injections are stored in."""

    products: str = "f32"
    storage: torch.dtype | None = None

    def mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.products == "tf32" else a @ b

    def store(self, x):
        return x if self.storage is None else x.to(self.storage).float()


F32 = Precision()


# --- parameters ----------------------------------------------------------------
def codenerf_shapes(W, latent, shape_blocks, texture_blocks):
    layers = {"encoding_xyz": (EMB1, W), "cat_layer": (W + EMB1, W),
              "cat_latent_layer": (latent, W), "encoding_shape": (W, W),
              "sigma": (W, 1), "encoding_viewdir": (W + EMB2, W),
              "rgb_0": (W, W // 2), "rgb_1": (W // 2, 3)}
    for j in range(shape_blocks):
        layers[f"shape_latent_layers.{j}"] = (latent, W)
        layers[f"shape_layers.{j}"] = (W, W)
    for j in range(texture_blocks):
        layers[f"texture_latent_layers.{j}"] = (latent, W)
        layers[f"texture_layers.{j}"] = (W, W)
    return layers


def occupancy_shapes(h):
    return {"in_layer": (EMB1, h), "mid1.0": (h, h),
            "cat_layer": (h + EMB1, h), "mid2.0": (h, h),
            "out_alpha": (h, 1), "color_linear": (EMB2 + h, h),
            "out_color": (h, 3)}


def leaf_shapes(arch: dict) -> dict[str, tuple]:
    """Every trained tensor by name: the stacked category fields
    ([C, ...]), their bases, the codes [C, n_obj, latent], the background.
    arch: n_cls, n_obj (the most instances of a category), W, latent,
    shape_blocks, texture_blocks, bg_hidden."""
    C = arch["n_cls"]
    out = {"cat_pe.B": (C, 21, 3)}
    for name, (i, o) in codenerf_shapes(
            arch["W"], arch["latent"], arch["shape_blocks"],
            arch["texture_blocks"]).items():
        out[f"cat_fc.{name}.w"] = (C, i, o)
        out[f"cat_fc.{name}.b"] = (C, o)
    out["codes.shape"] = (C, arch["n_obj"], arch["latent"])
    out["codes.texture"] = (C, arch["n_obj"], arch["latent"])
    out["bg_pe.B"] = (21, 3)
    for name, (i, o) in occupancy_shapes(arch["bg_hidden"]).items():
        out[f"bg_fc.{name}.w"] = (i, o)
        out[f"bg_fc.{name}.b"] = (o,)
    return out


def init_weights(arch: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The step's starting weights from `seed`, on the device, in three
    draws: every weight xavier-normal, every bias uniform in
    +-1/sqrt(fan_in) (ref: src/model.py:4-6), every code
    N(0, 1) / sqrt(latent / 2) (ref: src/trainer.py:52-60); the bases the
    icosahedron's directions."""
    gen = torch.Generator(device).manual_seed(seed)
    shapes = leaf_shapes(arch)
    ws = {k: s for k, s in shapes.items() if k.endswith(".w")}
    bs = {k: s for k, s in shapes.items() if k.endswith(".b")}
    codes = {k: s for k, s in shapes.items() if k.startswith("codes.")}

    def draw(group, fn):
        n = sum(math.prod(s) for s in group.values())
        flat = fn(n, generator=gen, device=device)
        out, off = {}, 0
        for k, s in group.items():
            out[k] = flat[off:off + math.prod(s)].reshape(s).clone()
            off += math.prod(s)
        return out

    out = {}
    for k, w in draw(ws, torch.randn).items():
        i, o = w.shape[-2:]
        out[k] = w * math.sqrt(2.0 / (i + o))
    for k, b in draw(bs, torch.rand).items():
        i = shapes[k[:-2] + ".w"][-2]
        out[k] = (b * 2.0 - 1.0) / math.sqrt(i)
    for k, c in draw(codes, torch.randn).items():
        out[k] = c / math.sqrt(arch["latent"] / 2.0)
    dirs = torch.as_tensor(ICOSAHEDRON, device=device)
    out["cat_pe.B"] = dirs.expand(arch["n_cls"], 21, 3).clone()
    out["bg_pe.B"] = dirs.clone()
    return {k: out[k] for k in shapes}


# --- the step ------------------------------------------------------------------
def sinpi(x):
    """sin(pi x), reduced exactly to [-1/2, 1/2] first."""
    n = torch.round(x)
    s = torch.sin(math.pi * (x - n))
    return torch.where(torch.remainder(n, 2.0) >= 1.0, -s, s)


def embed(B, x, scale, p: Precision):
    """x [..., N, 3] -> [..., N, 129]: x / scale, then sin(pi 2^k B x / s)
    for k = 0..5, band-major (ref: src/embedding.py:43-92)."""
    t = x / scale
    proj = p.mm(t, B.mT)  # [..., N, 21]
    bands = 2.0 ** torch.arange(BANDS, dtype=x.dtype, device=x.device)
    xb = (proj[..., None, :] * bands[:, None]).flatten(-2)
    return p.store(torch.cat([t, sinpi(xb)], -1))


def _lin(P, name, x, p: Precision):
    return p.mm(x, P[name + ".w"]) + P[name + ".b"].unsqueeze(-2)


def codenerf(P, emb, inj_s, inj_t, arch, p: Precision):
    """The category fields on emb [C, N, 129] with per-row injections
    (shape [C, N, (blocks + 1) W] as shape_0.., cat; texture [C, N, W])."""
    W, nb = arch["W"], arch["shape_blocks"]
    x1, x2 = emb[..., :EMB1], emb[..., EMB1:]
    relu = torch.relu
    y = p.store(relu(_lin(P, "encoding_xyz", x1, p)))
    for j in range(nb):
        if j == 1:
            y = p.store(y + inj_s[..., nb * W:])
            y = p.store(relu(_lin(P, "cat_layer", torch.cat([y, x1], -1), p)))
        y = p.store(y + inj_s[..., j * W:(j + 1) * W])
        y = p.store(relu(_lin(P, f"shape_layers.{j}", y, p)))
    y = _lin(P, "encoding_shape", y, p)
    sigma = _lin(P, "sigma", y, p)[..., 0] * 10.0
    y = p.store(y)
    y = p.store(relu(_lin(P, "encoding_viewdir", torch.cat([y, x2], -1), p)))
    for j in range(arch["texture_blocks"]):
        y = p.store(y + inj_t[..., j * W:(j + 1) * W])
        y = p.store(relu(_lin(P, f"texture_layers.{j}", y, p)))
    rgb = torch.sigmoid(_lin(P, "rgb_1", relu(_lin(P, "rgb_0", y, p)), p))
    return sigma, rgb


def occupancy(P, emb, p: Precision):
    x1, x2 = emb[..., :EMB1], emb[..., EMB1:]
    relu = torch.relu
    h = p.store(relu(_lin(P, "in_layer", x1, p)))
    h = p.store(relu(_lin(P, "mid1.0", h, p)))
    h = p.store(relu(_lin(P, "cat_layer", torch.cat([h, x1], -1), p)))
    h = p.store(relu(_lin(P, "mid2.0", h, p)))
    alpha = _lin(P, "out_alpha", h, p)[..., 0] * 10.0
    hc = p.store(relu(_lin(P, "color_linear", torch.cat([h, x2], -1), p)))
    return alpha, torch.sigmoid(_lin(P, "out_color", hc, p))


def _stratified(u, lo, hi):
    n = u.shape[-1]
    edges = torch.arange(n, dtype=u.dtype, device=u.device) * (1.0 / n)
    return ((hi - lo)[..., None] * edges + lo[..., None]
            + u * ((hi - lo) / n)[..., None])


def _sorted_normal(u, depth, eps):
    """n sorted samples of N(depth, (eps/3)^2) clipped to +-eps, from n + 1
    uniforms: exponential gaps give the sorted uniforms, the normal's
    inverse CDF maps them."""
    e = -torch.log(torch.clamp(u, min=1e-12))
    cs = torch.cumsum(e[..., :-1], -1)
    us = torch.clamp(cs / (cs[..., -1:] + e[..., -1:]), 2.0 ** -22,
                     1.0 - 2.0 ** -22)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * us - 1.0)
    return depth[..., None] + torch.clamp(z * (eps / 3.0), -eps, eps)


def sample_points(u, depth, states, origins, dirs, n_c2s, n_bins, cfg):
    """The vMAP sampling (ref: src/scene_cateogries.py:453-546): a ray
    without depth takes n_c2s + n_bins stratified samples up to its set's
    deepest ray; one with depth n_c2s stratified before the surface band,
    then n_bins around the surface (normal for its own object's pixels,
    stratified past the surface for the others'). Returns (points, z)."""
    tot = n_c2s + n_bins
    u_inv, u_c2s = u[..., :tot], u[..., tot:tot + n_c2s]
    u_norm = u[..., tot + n_c2s:tot + n_c2s + n_bins + 1]
    u_other = u[..., tot + n_c2s + n_bins + 1:]
    invalid = depth <= cfg["min_depth"]
    far = depth.amax(-1, keepdim=True).expand_as(depth)
    near = torch.full_like(depth, cfg["min_depth"])
    eps = cfg["surface_eps"]
    z_inv = _stratified(u_inv, near, far)
    z_c2s = _stratified(u_c2s, near, depth - eps)
    z_obj = _sorted_normal(u_norm, depth, eps)
    z_oth = _stratified(u_other, depth - eps, depth + cfg["stop_eps"])
    own = (states == THIS) & ~invalid
    z = torch.where(invalid[..., None], z_inv,
                    torch.cat([z_c2s, torch.where(own[..., None], z_obj,
                                                  z_oth)], -1))
    return origins[..., None, :] + dirs[..., None, :] * z[..., None], z


def _masked_mean(loss, mask, weight=None):
    """Per-model mean over the masked rays; every model reads 0 when any
    model's mask is empty (ref: src/render_rays.py:66-95)."""
    if weight is not None:
        loss = loss * weight
    m = mask.float()
    n = m.sum(-1)
    mean = (loss * m).sum(-1) / (n + 1e-10)
    return torch.where((n == 0).any(), torch.zeros_like(mean), mean)


def render_loss(alpha, rgb, z, depth, states, gt_rgb, cfg):
    """[m, r, b] logits and [m, r, b, 3] colours of m models' rays ->
    (the models' summed loss, depth, colour and opacity terms [m])."""
    occ = torch.sigmoid(alpha)
    free = 1.0 - occ + 1e-10
    trans = [torch.ones_like(occ[..., 0])]
    for i in range(occ.shape[-1] - 1):
        trans.append(trans[-1] * free[..., i])
    term = occ * torch.stack(trans, -1)
    r_depth = (term * z).sum(-1)
    var = (term * (z - r_depth[..., None]) ** 2).sum(-1).detach()
    r_rgb = (term[..., None] * rgb).sum(-2)
    r_opacity = term.sum(-1)
    valid = depth > cfg["min_depth"]
    obj = states != OTHER
    known = states != UNKNOWN
    d_mask = valid & obj
    l_depth = _masked_mean((r_depth - depth).abs() * d_mask, d_mask,
                           1.0 / (torch.sqrt(var) + 1e-4))
    l_col = _masked_mean((r_rgb - gt_rgb).abs().sum(-1) * obj, obj)
    l_op = _masked_mean((r_opacity - obj.float()).abs() * known, known)
    total = (l_depth + cfg["color_scaling"] * l_col
             + cfg["opacity_scaling"] * l_op).sum()
    return total, l_depth, l_col, l_op


def loss(P, batch, arch, cfg, p: Precision):
    """The step's objective on `batch`: cat rows (origins, dirs, rgb,
    depth, state, obj) [C, R, ...], bg rows [R_bg, ...], uniforms u_cat
    [C, R, n_u], u_bg [R_bg, n_u_bg]."""
    cat, bg = batch["cat"], batch["bg"]
    C, R = cat["depth"].shape
    pts, z = sample_points(batch["u_cat"], cat["depth"], cat["state"],
                           cat["origins"], cat["dirs"], cfg["n_c2s"],
                           cfg["n_bins"], cfg)
    Bt = z.shape[-1]

    def inject(layers, codes):
        return torch.cat([p.store(torch.relu(_lin(P, f"cat_fc.{n}", codes,
                                                   p)))
                          for n in layers], -1)

    nb, nt = arch["shape_blocks"], arch["texture_blocks"]
    inj_s = inject([f"shape_latent_layers.{j}" for j in range(nb)]
                   + ["cat_latent_layer"], P["codes.shape"])
    inj_t = inject([f"texture_latent_layers.{j}" for j in range(nt)],
                   P["codes.texture"])
    ci = torch.arange(C, device=z.device)[:, None]
    obj = cat["obj"]

    def per_row(inj):  # [C, n_obj, w] -> [C, R * Bt, w]
        return inj[ci, obj].repeat_interleave(Bt, dim=1)

    fields = {k[7:]: v for k, v in P.items() if k.startswith("cat_fc.")}
    emb = embed(P["cat_pe.B"], pts.reshape(C, R * Bt, 3), cfg["obj_scale"],
                p)
    sigma, rgb = codenerf(fields, emb, per_row(inj_s), per_row(inj_t),
                          arch, p)
    total, *_ = render_loss(sigma.reshape(C, R, Bt),
                            rgb.reshape(C, R, Bt, 3), z, cat["depth"],
                            cat["state"], cat["rgb"], cfg)
    valid_obj = (torch.arange(P["codes.shape"].shape[1], device=z.device)
                 < batch["n_objs"][:, None])
    multi = (valid_obj.sum(-1) > 1).float()
    reg = sum(((torch.linalg.vector_norm(P[k], dim=-1) * valid_obj).sum(-1)
               * multi).sum() for k in ("codes.shape", "codes.texture"))
    total = total + REG_SCALING * reg
    pts_b, z_b = sample_points(batch["u_bg"], bg["depth"], bg["state"],
                               bg["origins"], bg["dirs"], cfg["n_c2s_bg"],
                               cfg["n_bins"], cfg)
    Rb, Bb = z_b.shape
    bg_fields = {k[6:]: v for k, v in P.items() if k.startswith("bg_fc.")}
    alpha, col = occupancy(bg_fields, embed(P["bg_pe.B"],
                                            pts_b.reshape(Rb * Bb, 3),
                                            cfg["bg_scale"], p), p)
    bg_total, *_ = render_loss(alpha.reshape(1, Rb, Bb),
                               col.reshape(1, Rb, Bb, 3), z_b[None],
                               bg["depth"][None], bg["state"][None],
                               bg["rgb"][None], cfg)
    return total + bg_total


def adamw(P, grads, moments, step, cfg):
    """One AdamW step in place (decoupled decay, ref: src/trainer.py:38-60):
    the codes with code_lr / code_wd, the rest with lr / wd."""
    b1, b2 = BETAS
    with torch.no_grad():
        for k, p in P.items():
            lr, wd = ((cfg["code_lr"], cfg["code_wd"]) if k.startswith("codes.")
                      else (cfg["lr"], cfg["wd"]))
            g = grads[k]
            m, v = moments.setdefault(k, (torch.zeros_like(p),
                                          torch.zeros_like(p)))
            p.mul_(1.0 - lr * wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            bc1 = 1.0 - b1 ** step
            bc2 = 1.0 - b2 ** step
            p.sub_(lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + ADAM_EPS))


def run_steps(P0, batches, arch, cfg, p: Precision = F32):
    """Follow the steps of `batches` from weights P0. Returns each step's
    loss, the first step's gradients, and the weights after each step."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    moments: dict = {}
    losses, grad1, after = [], None, []
    for t, batch in enumerate(batches, start=1):
        total = loss(P, batch, arch, cfg, p)
        grads = dict(zip(P, torch.autograd.grad(total, list(P.values()))))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(total.detach()))
        adamw(P, grads, moments, t, cfg)
        after.append({k: v.detach().clone() for k, v in P.items()})
    return losses, grad1, after


def losses_at(states, batches, arch, cfg, p: Precision = F32):
    """The loss of each batch at the weights given for it (no update)."""
    with torch.no_grad():
        return [float(loss(P, b, arch, cfg, p))
                for P, b in zip(states, batches, strict=True)]


# --- the scene's rays ---------------------------------------------------------
def ray_sets(inst_dict, sample_dict, cam, cls_ids, device):
    """Each category's rays as rows [n, 12] (origins, dirs, rgb / 255,
    depth, pixel state, instance slot), and the background's [n, 11], in
    the scene's order: every instance's 2D box over its frames (ref:
    src/scene_cateogries.py:141-260), in its object's canonical frame
    when the category has more than one instance, else in the world's."""
    dirs_cache = cam.grid(device)

    def rows(frame_info, this_id, T_inv, slot):
        out = []
        for fi in frame_info:
            s = sample_dict[fi["frame"]]
            w0, w1, h0, h1 = (int(v) for v in fi["bbox"])
            T = np.asarray(s["T"], np.float64)
            if T_inv is not None:
                T = T_inv @ T
            R = torch.as_tensor(T[:3, :3], device=device)
            t = torch.as_tensor(T[:3, 3], device=device).float()
            d = (dirs_cache[w0:w1, h0:h1].reshape(-1, 3).double() @ R.T)
            n = d.shape[0]
            mask = torch.as_tensor(s["obj_mask"][w0:w1, h0:h1],
                                   device=device).reshape(-1)
            state = torch.zeros(n, device=device)
            state[mask == this_id] = THIS
            state[mask == -1] = UNKNOWN
            cols = [t.expand(n, 3), d.float(),
                    torch.as_tensor(s["image"][w0:w1, h0:h1], device=device)
                    .reshape(-1, 3).float() / 255.0,
                    torch.as_tensor(s["depth"][w0:w1, h0:h1],
                                    device=device).reshape(-1, 1),
                    state[:, None]]
            if slot is not None:
                cols.append(torch.full((n, 1), float(slot), device=device))
            out.append(torch.cat(cols, -1))
        return torch.cat(out)

    cats = []
    for cid in cls_ids:
        insts = inst_dict[cid]
        parts = []
        for slot, (iid, info) in enumerate(insts.items()):
            T_inv = (np.linalg.inv(info["T_obj"]) if len(insts) > 1
                     else None)
            parts.append(rows(info["frame_info"], iid, T_inv, slot))
        cats.append(torch.cat(parts))
    bg = rows(inst_dict[0]["frame_info"], 0, None, None)
    return cats, bg


def fingerprint(rows: torch.Tensor) -> torch.Tensor:
    """Order-free sums of a row set [n, k] in float64: each column, its
    square, and its product with the depth column (9), and the absolute
    sums that scale each: [6, k]."""
    x = rows.double()
    d = x[:, 9:10]
    sums = torch.stack([x.sum(0), (x * x).sum(0), (x * d).sum(0)])
    scale = torch.stack([x.abs().sum(0), (x * x).sum(0),
                         (x * d).abs().sum(0)])
    return torch.cat([sums, scale])


def fingerprint_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between two fingerprints, each sum's against the
    reference's absolute sum."""
    k = ref.shape[0] // 2
    gap = (prog[:k] - ref[:k]).abs() / ref[k:].clamp(min=1e-30)
    return float(gap.max())
