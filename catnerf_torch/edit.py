"""Latent-code editing: shape/texture transfer and interpolation.

The port's counterpart of the JAX package's `edit.py`. The category field
is a CodeNeRF-style conditional MLP — geometry and appearance of an
instance live entirely in its per-instance shape and texture latent codes
(models/codes.py; ref: src/trainer.py:52-60, src/model.py:56-84). That
factorization is what makes editing possible: swapping an instance's
texture code repaints it with another instance's appearance on its own
geometry, swapping the shape code does the inverse, and interpolating
codes morphs smoothly between instances — all without touching the
trained MLP. The mean code over a category's instances renders the
learned category PRIOR (the "average shape"). The reference repo carries
compiled `editing`/`reconstruct` modules (no source shipped) whose symbol
tables show exactly these tasks; this is the capability, built on the
port's renderer and mesher, on the session's device.

Edits are only defined WITHIN a category: codes are coordinates in that
category's own latent space (each category trains its own MLP), so
transferring a code across categories is meaningless.

CLI:
  python -m catnerf_torch.edit --logdir <dir> [--synthetic | --config <json>]
      --cls <cls_id> --obj <obj_id>
      [--shape-from <obj_id>] [--texture-from <obj_id>]
      [--interp <obj_id> --t 0.5 --what shape|texture|both]
      [--mean | --zero-code] [--views N] [--mesh] [--out <dir>]
      [--device cpu]

Writes orbit renders (and optionally a mesh) of the edited object next to
the same views of the unedited one, tagged by the edit recipe.
"""

from __future__ import annotations

import os

import numpy as np

from catnerf_torch.render_views import (_save, add_scene_args,
                                        default_orbit_cam, instance_frame,
                                        instance_mask_box, orbit_frame,
                                        orbit_poses, render_view,
                                        restore_session)


def instance_codes(session, cls_id: int, obj_id: int):
    """(shape_code, texture_code) of one instance, as numpy."""
    if cls_id not in session.cls_ids:
        raise KeyError(f"category {cls_id} not in session "
                       f"(have {session.cls_ids})")
    cat = session.categories[session.cls_ids.index(cls_id)]
    if obj_id not in cat.inst_id_to_index:
        raise KeyError(f"object {obj_id} not in category {cls_id} "
                       f"(have {cat.obj_ids})")
    params = session.category_params(cls_id)
    k = cat.inst_id_to_index[obj_id]
    return (params["shape_codes"][k].cpu().numpy(),
            params["texture_codes"][k].cpu().numpy())


def edit_codes(session, cls_id: int, obj_id: int, *,
               shape_from: int | None = None,
               texture_from: int | None = None):
    """Codes for `obj_id` with its shape and/or texture code replaced by
    another instance's (same category). Returns (shape, texture)."""
    sc, tc = instance_codes(session, cls_id, obj_id)
    if shape_from is not None:
        sc, _ = instance_codes(session, cls_id, shape_from)
    if texture_from is not None:
        _, tc = instance_codes(session, cls_id, texture_from)
    return sc, tc


def interpolate_codes(session, cls_id: int, obj_a: int, obj_b: int,
                      t: float, what: str = "both"):
    """Linear interpolation (1-t)*a + t*b in latent space; `what` selects
    which code interpolates ('shape', 'texture', 'both') — the other keeps
    obj_a's value."""
    if what not in ("shape", "texture", "both"):
        raise ValueError(f"what must be shape|texture|both, got {what!r}")
    sa, ta = instance_codes(session, cls_id, obj_a)
    sb, tb = instance_codes(session, cls_id, obj_b)
    sc = (1.0 - t) * sa + t * sb if what in ("shape", "both") else sa
    tc = (1.0 - t) * ta + t * tb if what in ("texture", "both") else ta
    return sc, tc


def mean_codes(session, cls_id: int, zero: bool = False):
    """The category prior: mean (or zero) shape/texture code over the
    category's instances. Meshing/rendering it shows the average shape the
    shared MLP learned (the reference's `average_shape_or_code` /
    `use_mean_code` / `use_zero_code` tasks)."""
    cat = session.categories[session.cls_ids.index(cls_id)]
    if zero:
        D = session.cfg.net_hyperparams.latent_dim
        return np.zeros(D, np.float32), np.zeros(D, np.float32)
    codes = [instance_codes(session, cls_id, oid) for oid in cat.obj_ids]
    return (np.mean([c[0] for c in codes], axis=0),
            np.mean([c[1] for c in codes], axis=0))


def _edit_frame(session, cls_id: int, obj_ids: list[int]):
    """(extent, center) framing every involved instance (the shared recipe,
    render_views.instance_frame): editing renders in the CANONICAL category
    frame, where all instances of a category are registered, so a
    swapped-in shape is framed by the max extent of the instances it mixes
    (a donor larger than the target must not clip)."""
    fr = instance_frame(session, cls_id, obj_ids)
    if fr is None:  # degenerate hull at dataset build (see serve.py)
        raise ValueError(f"object {obj_ids[0]} has no bound; "
                         "cannot frame the edit")
    return fr


def render_edit(session, cls_id: int, obj_id: int, shape_code, texture_code,
                out_dir: str, tag: str, *, donors: list[int] | None = None,
                n_views: int = 4, width: int = 320, height: int = 240,
                n_bins: int = 96) -> list[str]:
    """Orbit renders of `obj_id`'s category field under the given codes."""
    cfg = session.cfg
    cam = default_orbit_cam(width, height)
    params = session.category_params(cls_id)
    involved = [obj_id] + list(donors or [])
    extent, center = _edit_frame(session, cls_id, involved)
    mask = instance_mask_box(session, cls_id, involved)
    radius, near, far = orbit_frame(extent)
    written = []
    for v, T in enumerate(orbit_poses(n_views, radius, center)):
        img, depth, alpha = render_view(
            params, cfg, T, cam, near=near, far=far,
            shape_code=np.asarray(shape_code),
            texture_code=np.asarray(texture_code), n_bins=n_bins,
            mask_box=mask)
        name = f"obj{obj_id}_{tag}_view{v:02d}"
        _save(out_dir, name, img, depth, alpha)
        written.append(name)
    return written


def mesh_edit(session, cls_id: int, obj_id: int, shape_code, texture_code,
              path: str, *, donors: list[int] | None = None,
              grid_dim: int | None = None) -> str | None:
    """Colored mesh of the edited object in the canonical frame (or the
    world-frame OBB for single-instance categories). Returns the written
    path, or None if the field has no iso-surface."""
    from catnerf_torch.mesher.meshing import adaptive_grid_dim, mesh_field

    cfg = session.cfg
    cat = session.categories[session.cls_ids.index(cls_id)]
    params = session.category_params(cls_id)
    if cat.n_obj > 1:
        extent, _ = _edit_frame(session, cls_id,
                                [obj_id] + list(donors or []))
        # grid resolution from the METRIC extent (live_voxel_size is
        # metric; the canonical extent is ~2 and would pin dim at the cap),
        # widest over the involved instances so a larger donor still fits
        metric_extent = np.max(np.stack(
            [np.asarray(cat.extent_dict[oid])
             for oid in [obj_id] + list(donors or [])]), axis=0)
        dim = grid_dim or adaptive_grid_dim(metric_extent,
                                            cfg.live_voxel_size,
                                            cfg.grid_dim)
        mesh = mesh_field(params, cfg, grid_dim=dim, is_background=False,
                          shape_code=shape_code, texture_code=texture_code,
                          extent=extent)
    else:
        bound = cat.bound_dict.get(obj_id)
        if bound is None:
            return None
        dim = grid_dim or adaptive_grid_dim(bound.extent, cfg.live_voxel_size,
                                            cfg.grid_dim)
        mesh = mesh_field(params, cfg, grid_dim=dim, is_background=False,
                          shape_code=shape_code, texture_code=texture_code,
                          bound=bound)
    if mesh is None:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mesh.export(path)
    return path


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m catnerf_torch.edit",
                                     description=__doc__.splitlines()[0])
    add_scene_args(parser)
    parser.add_argument("--cls", type=int, required=True)
    parser.add_argument("--obj", type=int, default=None,
                        help="instance to edit (not needed with --mean/"
                             "--zero-code)")
    parser.add_argument("--mean", action="store_true",
                        help="render/mesh the category prior: the MEAN "
                             "latent code over the category's instances")
    parser.add_argument("--zero-code", action="store_true",
                        help="render/mesh the category field at the ZERO "
                             "latent code")
    parser.add_argument("--shape-from", type=int, default=None,
                        help="take the shape code from this instance")
    parser.add_argument("--texture-from", type=int, default=None,
                        help="take the texture code from this instance")
    parser.add_argument("--interp", type=int, default=None,
                        help="interpolate codes towards this instance")
    parser.add_argument("--t", type=float, default=0.5,
                        help="interpolation weight (0=--obj, 1=--interp)")
    parser.add_argument("--what", default="both",
                        choices=("shape", "texture", "both"),
                        help="which codes --interp interpolates")
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--n-bins", type=int, default=96)
    parser.add_argument("--mesh", action="store_true",
                        help="also export the edited object's mesh")
    parser.add_argument("--out", default=None,
                        help="output dir (default <logdir>/edits)")
    args = parser.parse_args(argv)

    prior_mode = args.mean or args.zero_code
    if args.interp is not None and (args.shape_from is not None
                                    or args.texture_from is not None):
        raise SystemExit("--interp and --shape-from/--texture-from are "
                         "mutually exclusive")
    if prior_mode and (args.interp is not None or args.shape_from is not None
                       or args.texture_from is not None):
        raise SystemExit("--mean/--zero-code take no other edit flags")
    if not prior_mode and args.obj is None:
        raise SystemExit("--obj is required unless --mean/--zero-code")
    if not prior_mode and args.interp is None and args.shape_from is None \
            and args.texture_from is None:
        raise SystemExit("nothing to edit: give --shape-from, "
                         "--texture-from, --interp, --mean or --zero-code")

    session = restore_session(args)
    out = args.out or os.path.join(args.logdir, "edits")
    views = dict(n_views=args.views, width=args.width, height=args.height,
                 n_bins=args.n_bins)

    if prior_mode:
        if args.cls not in session.cls_ids:
            raise SystemExit(f"category {args.cls} not in scene "
                             f"(have {session.cls_ids})")
        cat = session.categories[session.cls_ids.index(args.cls)]
        sc, tc = mean_codes(session, args.cls, zero=args.zero_code)
        tag = "zerocode" if args.zero_code else "mean"
        # --obj anchors the output naming/framing when given (it must be
        # a category member); default: the first instance
        if args.obj is not None and args.obj not in cat.inst_id_to_index:
            raise SystemExit(f"--obj {args.obj} not in category "
                             f"{args.cls} (have {cat.obj_ids})")
        anchor = args.obj if args.obj is not None else cat.obj_ids[0]
        written = render_edit(session, args.cls, anchor, sc, tc, out,
                              f"cls{args.cls}_{tag}",
                              donors=list(cat.obj_ids), **views)
        if args.mesh:
            path = mesh_edit(
                session, args.cls, anchor, sc, tc,
                os.path.join(out, f"cls{args.cls}_{tag}.obj"),
                donors=list(cat.obj_ids))
            print(f"mesh: {path if path else 'no iso-surface'}")
        print(f"wrote {len(written)} views to {out}")
        return 0

    donors = []
    if args.interp is not None:
        sc, tc = interpolate_codes(session, args.cls, args.obj, args.interp,
                                   args.t, what=args.what)
        tag = f"interp{args.interp}_t{args.t:g}_{args.what}"
        donors = [args.interp]
    else:
        sc, tc = edit_codes(session, args.cls, args.obj,
                            shape_from=args.shape_from,
                            texture_from=args.texture_from)
        parts = []
        if args.shape_from is not None:
            parts.append(f"shape{args.shape_from}")
            donors.append(args.shape_from)
        if args.texture_from is not None:
            parts.append(f"tex{args.texture_from}")
            donors.append(args.texture_from)
        tag = "_".join(parts)

    # original next to the edit, same framing, for side-by-side comparison
    sc0, tc0 = instance_codes(session, args.cls, args.obj)
    written = render_edit(session, args.cls, args.obj, sc0, tc0, out,
                          "original", donors=donors, **views)
    written += render_edit(session, args.cls, args.obj, sc, tc, out, tag,
                           donors=donors, **views)
    if args.mesh:
        path = mesh_edit(session, args.cls, args.obj, sc, tc,
                         os.path.join(out, f"obj{args.obj}_{tag}.obj"),
                         donors=donors)
        print(f"mesh: {path if path else 'no iso-surface'}")
    print(f"wrote {len(written)} views to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
