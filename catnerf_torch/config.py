"""Scene configuration.

A copy of the JAX package's `config.py` (which uses only the stdlib), so
that the port imports nothing of that package. Parity with the reference
JSON schema (ref: src/cfg.py:6-97, configs/Replica/config_replica_room0.json)
as a typed dataclass with defaults, validation, and dict/JSON
round-tripping instead of a flat attribute bag.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class NetHyperparams:
    """CodeNeRF architecture hyperparameters (ref: src/model.py:22-34)."""

    shape_blocks: int = 2
    texture_blocks: int = 1
    W: int = 32
    latent_dim: int = 256


@dataclasses.dataclass
class Config:
    # --- dataset ---
    dataset_format: str = "Replica"
    dataset_dir: str = ""
    depth_scale: float = 1.0 / 1000.0  # raw depth units -> meters
    # Load every k-th frame. The reference requires users to pre-select
    # 1 frame per 10 on disk by hand (ref: README.md:34); set
    # frame_stride=10 to run directly on a full vMAP-prepared sequence.
    frame_stride: int = 1
    # Ray-store caps (0 = unlimited, the reference-faithful default).
    # At room_0 scale (1200x680, 100+ keyframes) the uncapped store is
    # ~30M object rays (padded to the largest category across the stacked
    # axis) + ~80M background rays. A uniform random subsample at build
    # time is statistically harmless: training draws (n_per_optim x iters)
    # total rays, far below any reasonable cap, and the store is shuffled
    # anyway.
    max_store_rays_per_cat: int = 0
    max_store_rays_bg: int = 0

    # --- trainer ---
    max_n_models: int = 100
    max_iter: int = 10001
    save_iter: int = 2000
    log_iter: int = 100

    # --- camera ---
    width: int = 1200
    height: int = 680
    fx: float = 600.0
    fy: float = 600.0
    cx: float = 599.5
    cy: float = 339.5
    mw: int = 0  # crop margin (ScanNet uses 10)
    mh: int = 0
    distortion: tuple[float, ...] | None = None

    # --- rendering / sampling ---
    min_depth: float = 0.0
    max_depth: float = 8.0
    n_bins: int = 9
    n_bins_cam2surface: int = 1
    n_bins_cam2surface_bg: int = 5
    n_per_optim: int = 120
    n_per_optim_bg: int = 1200

    # --- model ---
    n_unidir_funcs: int = 5
    obj_scale: float = 2.0
    bg_scale: float = 5.0
    color_scaling: float = 5.0
    opacity_scaling: float = 10.0
    surface_eps: float = 0.1
    stop_eps: float = 0.05  # "other_eps" in reference JSON
    hidden_feature_size: int = 32
    hidden_feature_size_bg: int = 128
    net_hyperparams: NetHyperparams = dataclasses.field(default_factory=NetHyperparams)

    # --- optimizer ---
    learning_rate: float = 1e-3
    weight_decay: float = 0.013
    code_learning_rate: float = 1e-3
    code_weight_decay: float = 0.013

    # --- vis / meshing ---
    live_voxel_size: float = 0.005
    grid_dim: int = 256
    mesh_it: int = 10000
    # Self-contained per-object field pretraining (used when
    # load_pretrained is false; the reference raises NotImplementedError
    # there). Steps/rays per object for geometry/field_pretrain.py.
    pretrain_steps: int = 1000
    pretrain_rays: int = 600
    # Fill fully enclosed interior cavities of the occupancy grid before
    # marching cubes, suppressing the spurious inner shells that
    # crust-supervised fields produce (quality improvement over the
    # reference, which extracts them).
    mesh_fill_interior: bool = True
    # Grow the mesh-eval grid when the iso-surface touches a boundary face
    # (ours; the reference clips objects whose observed-cloud OBB
    # underestimates the true extent — measured 9-24% surface loss on the
    # registered gate, scripts/diag_registration.py). Disable together with
    # mesh_fill_interior for strict-parity mesh comparisons.
    mesh_adaptive_bounds: bool = True
    # Zero out grid voxels any training view observed as free space before
    # mesh extraction (ours; removes spurious never-supervised occupancy —
    # measured up to 36% junk mesh vertices on partially observed objects).
    # Disable with the other mesh_* flags for strict-parity comparisons.
    mesh_space_carving: bool = True
    # Mesh a multi-instance category's objects over the CATEGORY-UNION
    # canonical extent (elementwise max of member canonical extents)
    # instead of each instance's own observed extent (ours; a rim-eroded
    # template's OBB under-measures its true extent — measured up to 34%
    # of the GT surface outside the eval grid on the asym-ScanNet diag —
    # while the shared canonical frame means a better-observed member's
    # extent covers the blind spot). Disable with the other mesh_* flags
    # for strict-parity comparisons.
    mesh_category_extent: bool = True
    # Iso-surface extraction: "mc" = table-driven classic marching cubes
    # (the reference's skimage vertex semantics, ref: src/vis.py:8-9;
    # fewer triangles, sharper interpolation), "tetra" = 6-tetrahedra
    # decomposition (kept for A/B).
    mesh_method: str = "mc"

    # --- registration ---
    load_registration_result: bool = True
    load_pretrained: bool = True
    weight_root: str = ""
    multi_init_pose: bool = True
    # Normalize clouds to unit half-extent before the rigid solve and carry
    # the relative scale in sim(3) T_rel (ours; rigid-only registration
    # wrongly subcategorizes same-shape different-size instances — see
    # geometry/registration.py::align_poses). Disable for strict parity.
    scale_aware_registration: bool = True
    # Appearance-aware candidate tie-break (ours; the reference scores
    # candidates by geometry-only raw Chamfer, ref:
    # src/category_registration.py:257-267, which cannot disambiguate a
    # near-symmetric shape's 180-degree flip): accept-band candidates whose
    # observed per-point RGB disagrees with the template's beyond the best
    # candidate's color score are dropped before the coverage tie-break
    # (geometry/registration.py::align_poses). Requires
    # scale_aware_registration; off under strict parity.
    appearance_tie_break: bool = True
    # Candidate sim(3) scale statistic for align_poses: "obb" (OBB max
    # half-extent ratio — rotation-invariant; r4 default) or "rms_vox"
    # (RMS radius on voxel-downsampled clouds — rotation-invariant AND
    # less sensitive to rim-eroded partial clouds; r4-end diagnosis of
    # the asym-ScanNet band suggests switching in r5 after full gate
    # validation).
    reg_candidate_scale: str = "obb"
    eta1: float = 0.06
    eta2: float = 0.15
    eta3: float = 0.12

    # --- ScanNet extras ---
    use_refined_mask: bool = False
    load_refined_mask: bool = False
    # Mark pixels whose raw foreground label the geometric refinement
    # dropped as UNKNOWN (pixel state 2) instead of the reference's hard
    # background relabel, which trains the object's field to be empty
    # exactly where the mask eroded (ours; see data/scannet.py). Disable
    # for strict parity.
    refined_mask_unknown: bool = True
    # Rounds of edge-label propagation in geometric segmentation. The
    # reference propagates a single hop from original edge pixels (9x9
    # window, max 4 px reach, ref: src/utils.py:643-671) = 1 round; each
    # extra round re-sources from the previous round's labels (order-
    # independent), growing segments ~4 px per round. Measured on the
    # ScanNet registered gate (seed 0): denser refined masks keep the TSDF
    # object clouds intact — 1.96 cm / 94.0% (1 round), 1.32 / 99.0 (2),
    # 1.10 cm / 99.99% (3 = default, the baseline band). Set 1 for strict
    # parity.
    seg_propagation_rounds: int = 3

    # --- extras with no reference equivalent ---
    seed: int = 0
    dtype: str = "float32"
    # Store inter-fusion TRAINING activations (PE embedding, ReLU outputs,
    # latent injections) in bfloat16; params, optimizer state, sigma/rgb
    # heads, render math and losses stay f32. Disable for strict parity.
    # The port runs it on the XLA-path modules; with the fused kernels it
    # raises (train/step.py::check_supported).
    bf16_activations: bool = True
    # Fused PE+MLP kernels for the training hot path, specialised for the
    # shipped hyperparams (train/step.py::fused_eligible); every other
    # config runs the XLA-path field modules.
    use_fused_kernels: bool = False

    @property
    def W_frame(self) -> int:
        """Effective frame width after margin crop (ref: src/cfg.py:32)."""
        return self.width - 2 * self.mw

    @property
    def H_frame(self) -> int:
        """Effective frame height after margin crop (ref: src/cfg.py:31)."""
        return self.height - 2 * self.mh

    @property
    def cx_eff(self) -> float:
        return self.cx - self.mw

    @property
    def cy_eff(self) -> float:
        return self.cy - self.mh

    @property
    def bins_per_ray_obj(self) -> int:
        return self.n_bins_cam2surface + self.n_bins

    @property
    def bins_per_ray_bg(self) -> int:
        return self.n_bins_cam2surface_bg + self.n_bins

    def apply_strict_parity(self) -> "Config":
        """Flip every algorithmic-improvement flag OFF for a head-to-head
        comparison against reference outputs (PARITY.md §"Deliberate
        divergences & strict-parity recipe"); one switch instead of editing
        the scene JSON. Dispatch shape is a CLI concern — pass `--parity`
        to train.py alongside this (train.py's --strict-parity implies it).
        Returns self for chaining."""
        self.mesh_fill_interior = False
        self.mesh_adaptive_bounds = False
        self.mesh_space_carving = False
        self.mesh_category_extent = False
        self.scale_aware_registration = False
        self.appearance_tie_break = False
        self.refined_mask_unknown = False
        self.seg_propagation_rounds = 1
        self.bf16_activations = False
        self.use_fused_kernels = False
        return self

    def validate(self) -> None:
        assert self.n_bins > 0 and self.n_bins_cam2surface > 0
        assert self.max_depth > self.min_depth
        assert self.net_hyperparams.W > 0
        if self.frame_stride < 1:
            raise ValueError(
                f"frame_stride must be >= 1, got {self.frame_stride}")
        if self.mesh_method not in ("mc", "tetra"):
            raise ValueError(
                f"mesh_method must be 'mc' or 'tetra', got "
                f"{self.mesh_method!r}")
        if self.reg_candidate_scale not in ("obb", "rms_vox", "trim_ext",
                                            "aabb"):
            raise ValueError(
                f"reg_candidate_scale must be 'obb', 'rms_vox', 'trim_ext' "
                f"or 'aabb', got {self.reg_candidate_scale!r}")
        if self.n_unidir_funcs != 5:
            # the CodeNeRF trunk/color split is architecturally fixed at
            # EMB_SIZE1=87 / EMB_SIZE2=42, i.e. max_deg=5 (the reference
            # hard-wires emb_size1/2 the same way, ref: src/trainer.py:
            # 20-21); any other value would crash deep inside the trace
            # with an opaque matmul shape error
            raise ValueError(
                f"n_unidir_funcs must be 5 (the 87/42 embedding split is "
                f"architectural), got {self.n_unidir_funcs}")

    @classmethod
    def from_json(cls, path: str) -> "Config":
        """Load a reference-schema JSON scene config (ref: src/cfg.py:7-97)."""
        with open(path) as f:
            raw = json.load(f)
        return cls.from_reference_dict(raw, config_dir=os.path.dirname(path))

    @classmethod
    def from_reference_dict(cls, raw: dict[str, Any], config_dir: str = "") -> "Config":
        cam = raw.get("camera", {})
        trainer = raw.get("trainer", {})
        render = raw.get("render", {})
        model = raw.get("model", {})
        optim = raw.get("optimizer", {}).get("args", {})
        vis = raw.get("vis", {})
        reg = raw.get("registration", {})
        ds = raw.get("dataset", {})

        cfg = cls()
        cfg.dataset_format = ds.get("format", cfg.dataset_format)
        cfg.dataset_dir = ds.get("path", cfg.dataset_dir)
        cfg.frame_stride = ds.get("frame_stride", cfg.frame_stride)
        cfg.max_store_rays_per_cat = ds.get(
            "max_store_rays_per_cat", cfg.max_store_rays_per_cat)
        cfg.max_store_rays_bg = ds.get(
            "max_store_rays_bg", cfg.max_store_rays_bg)
        # anchor RELATIVE dataset paths at the config file's directory, not
        # the process CWD (otherwise the ScanNet intrinsics probe below
        # silently misses and the loader can't find frames)
        if (config_dir and cfg.dataset_dir
                and not os.path.isabs(cfg.dataset_dir)
                and not os.path.exists(cfg.dataset_dir)):
            anchored = os.path.join(config_dir, cfg.dataset_dir)
            if os.path.exists(anchored):
                cfg.dataset_dir = anchored
        cfg.depth_scale = 1.0 / trainer.get("scale", 1000.0)

        cfg.max_n_models = trainer.get("n_models", cfg.max_n_models)
        cfg.max_iter = trainer.get("max_iter", cfg.max_iter)
        cfg.save_iter = trainer.get("save_iter", cfg.save_iter)
        cfg.log_iter = trainer.get("log_iter", cfg.log_iter)

        cfg.min_depth, cfg.max_depth = render.get(
            "depth_range", [cfg.min_depth, cfg.max_depth]
        )
        cfg.n_bins = render.get("n_bins", cfg.n_bins)
        cfg.n_bins_cam2surface = render.get("n_bins_cam2surface", cfg.n_bins_cam2surface)
        cfg.n_bins_cam2surface_bg = render.get(
            "n_bins_cam2surface_bg", cfg.n_bins_cam2surface_bg
        )
        cfg.n_per_optim = render.get("n_per_optim", cfg.n_per_optim)
        cfg.n_per_optim_bg = render.get("n_per_optim_bg", cfg.n_per_optim_bg)

        cfg.width = cam.get("w", cfg.width)
        cfg.height = cam.get("h", cfg.height)
        cfg.mw = cam.get("mw", cfg.mw)
        cfg.mh = cam.get("mh", cfg.mh)
        if "fx" in cam:
            cfg.fx, cfg.fy = cam["fx"], cam["fy"]
            cfg.cx, cfg.cy = cam["cx"], cam["cy"]
            # explicit intrinsics: the ScanNet loader need not find an
            # intrinsic_depth.txt (see data/scannet.py)
            cfg._intrinsics_from_config = True
        else:
            # ScanNet: intrinsics live in <dataset>/intrinsic/intrinsic_depth.txt
            # (ref: src/cfg.py:38-43). Resolved lazily by the dataset loader.
            intr_path = os.path.join(
                cfg.dataset_dir, "intrinsic", "intrinsic_depth.txt"
            )
            if os.path.exists(intr_path):
                import numpy as np

                vals = np.loadtxt(intr_path).reshape(4, 4)
                cfg.fx, cfg.fy = float(vals[0, 0]), float(vals[1, 1])
                cfg.cx, cfg.cy = float(vals[0, 2]), float(vals[1, 2])
        if "distortion" in cam:
            cfg.distortion = tuple(cam["distortion"])
        elif "k1" in cam:
            cfg.distortion = (
                cam["k1"], cam["k2"], cam["p1"], cam["p2"],
                cam["k3"], cam["k4"], cam["k5"], cam["k6"],
            )

        cfg.n_unidir_funcs = model.get("n_unidir_funcs", cfg.n_unidir_funcs)
        cfg.obj_scale = model.get("obj_scale", cfg.obj_scale)
        cfg.bg_scale = model.get("bg_scale", cfg.bg_scale)
        cfg.color_scaling = model.get("color_scaling", cfg.color_scaling)
        cfg.opacity_scaling = model.get("opacity_scaling", cfg.opacity_scaling)
        cfg.surface_eps = model.get("surface_eps", cfg.surface_eps)
        cfg.stop_eps = model.get("other_eps", cfg.stop_eps)
        cfg.hidden_feature_size = model.get(
            "hidden_feature_size", cfg.hidden_feature_size
        )
        cfg.hidden_feature_size_bg = model.get(
            "hidden_feature_size_bg", cfg.hidden_feature_size_bg
        )
        cfg.bf16_activations = model.get(
            "bf16_activations", cfg.bf16_activations)
        nh = model.get("net_hyperparams", {})
        cfg.net_hyperparams = NetHyperparams(
            shape_blocks=nh.get("shape_blocks", 2),
            texture_blocks=nh.get("texture_blocks", 1),
            W=nh.get("W", 32),
            latent_dim=nh.get("latent_dim", 256),
        )

        cfg.learning_rate = optim.get("lr", cfg.learning_rate)
        cfg.code_learning_rate = optim.get("code_lr", cfg.code_learning_rate)
        cfg.weight_decay = optim.get("weight_decay", cfg.weight_decay)
        cfg.code_weight_decay = optim.get("code_weight_decay", cfg.code_weight_decay)

        cfg.live_voxel_size = vis.get("live_voxel_size", cfg.live_voxel_size)
        cfg.grid_dim = vis.get("grid_dim", cfg.grid_dim)
        cfg.mesh_it = vis.get("mesh_it", cfg.mesh_it)
        cfg.mesh_fill_interior = vis.get(
            "mesh_fill_interior", cfg.mesh_fill_interior)
        cfg.mesh_adaptive_bounds = vis.get(
            "mesh_adaptive_bounds", cfg.mesh_adaptive_bounds)
        cfg.mesh_space_carving = vis.get(
            "mesh_space_carving", cfg.mesh_space_carving)
        cfg.mesh_category_extent = vis.get(
            "mesh_category_extent", cfg.mesh_category_extent)
        cfg.mesh_method = vis.get("mesh_method", cfg.mesh_method)

        cfg.load_registration_result = reg.get(
            "load_registration_result", cfg.load_registration_result
        )
        cfg.pretrain_steps = reg.get("pretrain_steps", cfg.pretrain_steps)
        cfg.pretrain_rays = reg.get("pretrain_rays", cfg.pretrain_rays)
        cfg.load_pretrained = reg.get("load_pretrained", cfg.load_pretrained)
        cfg.weight_root = reg.get("weight_root", cfg.weight_root)
        cfg.multi_init_pose = reg.get("multi_init_pose", cfg.multi_init_pose)
        cfg.scale_aware_registration = reg.get(
            "scale_aware_registration", cfg.scale_aware_registration)
        cfg.appearance_tie_break = reg.get(
            "appearance_tie_break", cfg.appearance_tie_break)
        cfg.reg_candidate_scale = reg.get(
            "reg_candidate_scale", cfg.reg_candidate_scale)
        cfg.eta1 = reg.get("eta1", cfg.eta1)
        cfg.eta2 = reg.get("eta2", cfg.eta2)
        cfg.eta3 = reg.get("eta3", cfg.eta3)

        if cfg.dataset_format == "ScanNet":
            cfg.use_refined_mask = ds.get("use_refined_mask", False)
            cfg.refined_mask_unknown = ds.get(
                "refined_mask_unknown", cfg.refined_mask_unknown)
            cfg.seg_propagation_rounds = ds.get(
                "seg_propagation_rounds", cfg.seg_propagation_rounds)
            cfg.load_refined_mask = (
                ds.get("load_refined_mask", False) and cfg.use_refined_mask
            )

        cfg.validate()
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
