"""The work a training step does, counted from the configuration's widths
and the rows the step trains, whatever implements the fields.

Multiply-adds count 2 FLOP; a backward counts twice its forward; work a
kernel recomputes is not counted, nor are the nonlinearities. Bytes count
what the step's inputs and outputs need once each: the sample points in,
the fields' outputs out, the per-ray latent injections in (a ray's samples
share them), the weights in and their gradients out; activations that a
kernel keeps or recomputes are not counted.

The peaks are the published ones of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s
of HBM3, at the 700 W power limit.
"""

from __future__ import annotations

import dataclasses

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

EMB1 = 87   # the density trunk's embedding: xyz + 4 bands x 21 directions
EMB2 = 42   # the colour head's: 2 bands x 21 directions
N_DIRS = 21
N_BANDS = 6
F32 = 4


def codenerf_layers(W: int, latent: int, shape_blocks: int,
                    texture_blocks: int):
    """(per-row layers, per-instance latent projections) of a CodeNeRF as
    (fan_in, fan_out) pairs (ref: src/model.py:30-54)."""
    rows = [(EMB1, W)]
    for j in range(shape_blocks):
        if j == 1:
            rows.append((W + EMB1, W))  # cat_layer
        rows.append((W, W))
    rows += [(W, W), (W, 1), (W + EMB2, W)]  # encoding_shape, sigma, viewdir
    rows += [(W, W)] * texture_blocks
    rows += [(W, W // 2), (W // 2, 3)]
    latent_proj = [(latent, W)] * (shape_blocks + 1 + texture_blocks)
    return rows, latent_proj


def occupancy_layers(h: int, hidden_blocks: int = 1):
    """The background OccupancyMap's layers (ref: src/model.py:86-155)."""
    return ([(EMB1, h)] + [(h, h)] * hidden_blocks + [(h + EMB1, h)]
            + [(h, h)] * hidden_blocks + [(h, 1), (EMB2 + h, h), (h, 3)])


def macs(layers) -> int:
    return sum(i * o for i, o in layers)


def n_params(layers) -> int:
    return sum(i * o + o for i, o in layers)


PE_MACS = N_DIRS * 3  # the embedding's projection of a point


@dataclasses.dataclass
class StepWork:
    """A training step's rows and counts."""

    n_cls: int
    n_obj: int            # instances over all categories
    rays_per_cls: int
    bins_obj: int
    rays_bg: int
    bins_bg: int
    cn_row_macs: int      # the CodeNeRF's layers, a row
    cn_latent_macs: int   # the latent projections, an instance
    cn_params: int
    bg_row_macs: int      # the background's layers, a row
    bg_params: int
    W: int

    @property
    def cn_rows(self) -> int:
        return self.n_cls * self.rays_per_cls * self.bins_obj

    @property
    def bg_rows(self) -> int:
        return self.rays_bg * self.bins_bg

    @property
    def samples(self) -> int:
        """Ray samples a step (bench.py's samples_per_step)."""
        return self.cn_rows + self.bg_rows

    def cn_flops(self) -> float:
        """Kernels 1-2's work: the CodeNeRF layers and the embedding's
        projection over every category row, forward and backward."""
        return 6.0 * self.cn_rows * (self.cn_row_macs + PE_MACS)

    def bg_flops(self) -> float:
        """Kernels 3-4's work: the same for the background."""
        return 6.0 * self.bg_rows * (self.bg_row_macs + PE_MACS)

    def step_flops(self) -> float:
        """The model's work a step: both fields and the latent
        projections, forward and backward."""
        return (self.cn_flops() + self.bg_flops()
                + 6.0 * self.n_obj * self.cn_latent_macs)

    def cn_bytes(self) -> float:
        """Kernels 1-2: points in (twice: forward and backward), sigma and
        rgb out, their gradients in, the points' gradients out, the four
        W-wide injections of each ray in and their gradients out, the
        weights and the basis in (twice) and their gradients out."""
        rays = self.n_cls * self.rays_per_cls
        per_row = (3 + 4 + 4 + 3) * F32
        per_ray = 2 * 4 * self.W * F32
        weights = 3 * self.n_cls * (self.cn_params + 3 * N_DIRS) * F32
        return self.cn_rows * per_row + rays * per_ray + weights

    def bg_bytes(self) -> float:
        """Kernels 3-4: the same rows, no injections."""
        per_row = (3 + 4 + 4 + 3) * F32
        weights = 3 * (self.bg_params + 3 * N_DIRS) * F32
        return self.bg_rows * per_row + weights


def step_work(cfg, n_objs: list[int], rays_per_cls: int) -> StepWork:
    """`cfg`: the program's Config as the cell runs it; `n_objs`: the
    instances of each trained category."""
    nh = cfg.net_hyperparams
    rows, latent = codenerf_layers(nh.W, nh.latent_dim, nh.shape_blocks,
                                   nh.texture_blocks)
    bg = occupancy_layers(cfg.hidden_feature_size_bg)
    return StepWork(
        n_cls=len(n_objs), n_obj=sum(n_objs), rays_per_cls=rays_per_cls,
        bins_obj=cfg.n_bins_cam2surface + cfg.n_bins,
        rays_bg=cfg.n_per_optim_bg,
        bins_bg=cfg.n_bins_cam2surface_bg + cfg.n_bins,
        cn_row_macs=macs(rows), cn_latent_macs=macs(latent),
        cn_params=n_params(rows), bg_row_macs=macs(bg),
        bg_params=n_params(bg), W=nh.W)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
