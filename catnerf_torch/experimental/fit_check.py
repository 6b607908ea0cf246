"""The test-time fit (`catnerf_torch/fit.py`) held step by step: one Adam
step from a given state on given draws, against a reference step from the
same state on the same draws (the JAX package's on the CPU, in
tests/test_torch_fit.py; the CPU's against the card's, in chip_smoke.py
phase 14).

The fit's loss is ill-conditioned (its depth term is weighted by
1/sqrt(var) of the rendered depth), so free runs part within a few steps
(ROADMAP.md, "How to hold an ill-conditioned loop"); each step is held
from the reference state it starts from:

- the loss within LOSS_TOL relative, the L1-PSNR within PSNR_TOL;
- each gradient within GRAD_TOL of the tensor's largest entry; the
  pose's within POSE_GRAD_TOL: its seven scalars each sum the whole ray
  batch through the depth term's 1/sqrt(var) weights, and float32 puts
  either package up to 1.8e-3 of the entry from its float64 value (the JAX
  package's eager step at step 17 of tests/test_torch_fit.py's trajectory,
  where the port's lies 3e-5 from it; 7e-4 both, at step 2);
- the updated leaves: Adam's first step moves each entry by about +-lr
  whatever the gradient's size, so an entry whose gradient lies within
  rounding of 0 may flip its sign; entries with |g| < SMALL_GRAD x max|g|
  are held within 2 lr, all others within UPDATE_TOL.

On a trained field (the card against the CPU, chip_smoke.py phase 14) the
rendered depth of many rays lies within float32 rounding of the observed
one, where the depth term's L1 changes sign under a weight of up to 1e4
(1/(sqrt(var) + 1e-4)); a ray on that kink, or with a sample on a ReLU
kink, takes or misses its whole gradient between two summation orders
(ROADMAP.md, "A ReLU pre-activation within f32 rounding of zero"). Such
rays are shifted, on both sides alike, to other rows of the instance
before the step (`shift_ties`); the count is reported.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

from catnerf_torch.fit import FitDraws, InstanceFitter
from catnerf_torch.ops import render as render_ops
from catnerf_torch.ops.sampling import OTHER_OBJ

LOSS_TOL = 1e-4
PSNR_TOL = 1e-5
GRAD_TOL = 1e-4
POSE_GRAD_TOL = 5e-3
UPDATE_TOL = 1e-6
SMALL_GRAD = 1e-3
# a ray is on a kink of the loss when |rendered - observed depth| (m) on a
# depth-supervised ray, or a ReLU pre-activation at one of its samples,
# lies within these of 0 (the card's and the CPU's rendered depths of a
# trained field part by up to 1.86e-5 m, chip_smoke.py phase 14 on an
# H100); at most SHIFT_ROUNDS redraws of such rays
DEPTH_TIE = 1e-4
RELU_TIE = 1e-5
SHIFT_ROUNDS = 8


def named_leaves(fitter: InstanceFitter) -> list[tuple[str, torch.Tensor]]:
    """[(name, tensor)] of the optimized leaves, named as the JAX
    package's fit parameters (`codes.shape`, `pose.w`)."""
    return ([(f"codes.{k}", v) for k, v in fitter.codes.items()]
            + [(f"pose.{k}", v) for k, v in fitter.pose.items()])


def set_state(fitter: InstanceFitter, values: dict, exp_avg: dict,
              exp_avg_sq: dict, step: float) -> None:
    """The fitter's leaves and Adam moments set to the given arrays (by
    leaf name), each moment's step count to `step` (0: no moments yet)."""
    opt = fitter.optimizer
    with torch.no_grad():
        for name, p in named_leaves(fitter):
            p.copy_(torch.as_tensor(np.array(values[name]),
                                    device=p.device))
            opt.state.pop(p, None)
            if step:
                def dev(x):
                    return torch.as_tensor(np.array(x), dtype=p.dtype,
                                           device=p.device)

                opt.state[p] = {
                    "step": torch.tensor(
                        float(step), dtype=torch.float32,
                        device=p.device if opt.defaults["capturable"]
                        else "cpu"),
                    "exp_avg": dev(exp_avg[name]),
                    "exp_avg_sq": dev(exp_avg_sq[name])}


def get_state(fitter: InstanceFitter):
    """(values, exp_avg, exp_avg_sq, step) of the fitter, numpy on the
    host, in `set_state`'s form."""
    values, m, v, step = {}, {}, {}, 0.0
    for name, p in named_leaves(fitter):
        values[name] = p.detach().cpu().numpy().copy()
        st = fitter.optimizer.state.get(p)
        if st:
            m[name] = st["exp_avg"].detach().cpu().numpy().copy()
            v[name] = st["exp_avg_sq"].detach().cpu().numpy().copy()
            step = float(st["step"])
    return values, m, v, step


def rendered_depth(fitter: InstanceFitter, draws: FitDraws):
    """(rendered depth [n_rays], RaySamples) of `draws` (no gradient)."""
    with torch.no_grad():
        rays, sigma, _ = fitter.forward(draws)
        term = render_ops.occupancy_to_termination(
            torch.sigmoid(sigma[..., 0]))
        return render_ops.render(term, rays.z_vals), rays


def tied_rays(fitter: InstanceFitter, draws: FitDraws) -> torch.Tensor:
    """[n_rays] bool: the rays of `draws` on a kink of `fitter`'s loss (no
    gradient): an L1 depth residual within DEPTH_TIE of 0 on a
    depth-supervised ray, or a ReLU pre-activation within RELU_TIE of 0 at
    one of its samples (the per-sample layers, [rays, samples, width])."""
    seen = []
    relu = torch.relu

    def spy(a):
        if a.dim() == 3 and a.shape[0] == fitter.n_rays:
            seen.append((a.abs() < RELU_TIE).flatten(1).any(1))
        return relu(a)

    torch.relu = spy
    try:
        depth, rays = rendered_depth(fitter, draws)
    finally:
        torch.relu = relu
    supervised = rays.valid_depth_mask & (rays.obj_labels != OTHER_OBJ)
    tied = supervised & ((depth - rays.gt_depth).abs() < DEPTH_TIE)
    for t in seen:
        tied |= t
    return tied


def shift_ties(fitter: InstanceFitter, draws: FitDraws,
               gen: torch.Generator) -> tuple[FitDraws, int]:
    """`draws` (on the fitter's device) with every ray on a kink
    (`tied_rays`) redrawn to another row of the instance from `gen` (a
    CPU generator), until none is; and the number of redraws."""
    idx, shifted = draws.idx.clone(), 0
    for _ in range(SHIFT_ROUNDS):
        tied = tied_rays(fitter, FitDraws(idx, draws.u))
        k = int(tied.sum())
        if not k:
            return FitDraws(idx, draws.u), shifted
        shifted += k
        idx[tied] = torch.randint(0, fitter.n, (k,), generator=gen).to(
            idx.device)
    raise AssertionError(f"rays still on a kink after {SHIFT_ROUNDS} "
                         f"redraws")


def grad_error(got, want) -> float:
    """|got - want| over want's largest entry (a tensor's gradient)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale > 0 else \
        float(np.abs(got).max())


def update_error(got, want, grad, lr: float) -> float:
    """The worst entry of an updated leaf against the reference's, as a
    share of its bound: 2 lr where the reference gradient is under
    SMALL_GRAD of its largest, else UPDATE_TOL (at most 1 holds)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    g = np.abs(np.asarray(grad, np.float64))
    small = g < SMALL_GRAD * g.max()
    bound = np.where(small, 2.0 * lr, UPDATE_TOL)
    return float((np.abs(got - want) / bound).max())


@dataclasses.dataclass
class FitCheck:
    """The worst of `steps` steps: loss and PSNR (relative), the codes'
    and the pose's gradients (of the tensor's largest entry), updates
    (share of their bound, at most 1); the entries held within 2 lr; the
    card's seconds for its steps (synchronised each step)."""
    steps: int = 0
    shifted: int = 0
    worst_depth: float = 0.0
    worst_loss: float = 0.0
    worst_psnr: float = 0.0
    worst_grad: float = 0.0
    worst_pose_grad: float = 0.0
    worst_update: float = 0.0
    small_entries: int = 0
    card_s: float = 0.0

    def add(self, loss, want_loss, psnr, want_psnr, grads: dict,
            want_grads: dict, new: dict, want_new: dict, lr: float) -> None:
        """One step's numbers against the reference's (dicts by leaf
        name)."""
        self.worst_loss = max(self.worst_loss,
                              abs(loss - want_loss) / abs(want_loss))
        self.worst_psnr = max(self.worst_psnr,
                              abs(psnr - want_psnr) / abs(want_psnr))
        for name, want in want_grads.items():
            err = grad_error(grads[name], want)
            if name.startswith("pose."):
                self.worst_pose_grad = max(self.worst_pose_grad, err)
            else:
                self.worst_grad = max(self.worst_grad, err)
            self.worst_update = max(self.worst_update, update_error(
                new[name], want_new[name], want, lr))
            g = np.abs(np.asarray(want))
            self.small_entries += int((g < SMALL_GRAD * g.max()).sum())

    def failures(self) -> list[str]:
        out = []
        for what, got, bound in (("loss", self.worst_loss, LOSS_TOL),
                                 ("PSNR", self.worst_psnr, PSNR_TOL),
                                 ("code gradients", self.worst_grad,
                                  GRAD_TOL),
                                 ("pose gradients", self.worst_pose_grad,
                                  POSE_GRAD_TOL),
                                 ("updates (share of bound)",
                                  self.worst_update, 1.0)):
            if not got <= bound:
                out.append(f"{what} {got:.3g} over {bound}")
        return out

    def line(self) -> str:
        return (f"{self.steps} steps each from the card's state "
                f"({self.shifted} rays on a kink shifted; rendered depths "
                f"within {self.worst_depth:.3g} m): loss "
                f"within {self.worst_loss:.3g} relative (bound {LOSS_TOL}), "
                f"PSNR {self.worst_psnr:.3g} (bound {PSNR_TOL}), code "
                f"gradients {self.worst_grad:.3g} of their largest entry "
                f"(bound {GRAD_TOL}), pose gradients "
                f"{self.worst_pose_grad:.3g} (bound {POSE_GRAD_TOL}), "
                f"updates at {self.worst_update:.3g} of their "
                f"bound ({UPDATE_TOL}, or 2 lr for the {self.small_entries} "
                f"entries of gradient under {SMALL_GRAD} of the largest)")


def cpu_twin(fitter: InstanceFitter, arrays: dict) -> InstanceFitter:
    """A fitter of the same instance (its ray arrays `arrays`) and frozen
    field on the CPU, its leaves and moments at `fitter`'s."""
    twin = InstanceFitter(
        copy.deepcopy(fitter.pe).to("cpu"),
        copy.deepcopy(fitter.fc).to("cpu"), fitter.cfg, arrays,
        fitter.codes["shape"].detach().cpu().numpy(),
        fitter.codes["texture"].detach().cpu().numpy(),
        n_rays=fitter.n_rays, lr=fitter.optimizer.defaults["lr"],
        optimize_pose=fitter.optimize_pose, device="cpu")
    set_state(twin, *get_state(fitter))
    return twin


def grads_of(fitter: InstanceFitter) -> dict:
    """The leaves' gradients of the last step, numpy by name."""
    return {name: p.grad.detach().cpu().numpy().copy()
            for name, p in named_leaves(fitter)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_card_vs_cpu(card: InstanceFitter, cpu: InstanceFitter,
                    n_steps: int, lr: float) -> FitCheck:
    """n_steps eager steps of `card`, each repeated on `cpu` (the same
    instance on the CPU) from the card's state before it, on the card's
    draws with the rays on a kink shifted (`shift_ties`, found on the
    CPU)."""
    out = FitCheck(steps=n_steps)
    gen = torch.Generator().manual_seed(0)
    for _ in range(n_steps):
        set_state(cpu, *get_state(card))
        d = card.draw()
        d_cpu, k = shift_ties(cpu, FitDraws(d.idx.cpu(), d.u.cpu()), gen)
        out.shifted += k
        d = FitDraws(d_cpu.idx.to(card.device), d.u)
        out.worst_depth = max(out.worst_depth, float(
            (rendered_depth(card, d)[0].cpu()
             - rendered_depth(cpu, d_cpu)[0]).abs().max()))
        _sync(card.device)
        t0 = time.perf_counter()
        loss, psnr = card.eager_step(*d)
        _sync(card.device)
        out.card_s += time.perf_counter() - t0
        want_loss, want_psnr = cpu.eager_step(*d_cpu)
        out.add(float(loss), float(want_loss), float(psnr),
                float(want_psnr), grads_of(card), grads_of(cpu),
                get_state(card)[0], get_state(cpu)[0], lr)
    return out

