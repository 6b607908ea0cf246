"""The registration's device stages on the card held against the CPU:
pretraining steps (`geometry/field_pretrain.py`) from the same state on
the same draws, and a field's uncertainty metric (`geometry/uncertainty.py`)
on the same uniforms, under the ReLU-kink and flip rules of ROADMAP.md
("How to hold a float32 backward").

chip_smoke.py (phase 11) and tests/test_torch_cuda_registration.py hold
the card through `pretrain_card_vs_cpu` and `uncertainty_card_vs_cpu`;
tests/test_torch_registration.py finds the tied units of the port's CPU
steps against the JAX package's with `relu_tied_units`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from catnerf_torch.geometry.field_pretrain import ObjectFieldTrainer, \
    PretrainDraws
from catnerf_torch.geometry.uncertainty import N_BINS, uncertainty_score

# the field's ReLU layers in the order occupancy.apply runs them
RELU_LAYERS = ("in_layer", "mid1.0", "cat_layer", "mid2.0", "color_linear")
# a ReLU pre-activation this close to zero may fall on either side of it
# in two float32 evaluations, and then its unit's incoming weights take
# or miss that sample's whole gradient (tests/test_torch_step.py)
RELU_TIE = 1e-5
# a step's colour and opacity terms, relative to the CPU's
TERM_TOL = 1e-5
# a step's leaves in units of the leaf's largest entry: the entries no
# tie touches (5.1e-5 seen at phase 11 on the H100), and the incoming
# weights and biases of tied units (7.6e-5 seen there; the port's CPU
# steps against the JAX package's hold it too,
# tests/test_torch_registration.py), below one Adam step gone astray (lr
# = 1e-3 over a leaf's largest entry, which the fields' initialisation
# puts under 1)
LEAF_TOL = 1e-4
TIED_LEAF_TOL = 5e-4
# the share of a leaf that tied units may take: 13.02% seen at phase 11's
# 36,000 samples a step on the H100, with half again as margin
TIED_SHARE = 0.2
# the uncertainty metric of a direction that the two sides put on either
# side of the 0.5 threshold lies this close to it
METRIC_FLIP = 1e-3


def relu_tied_units(trainer: ObjectFieldTrainer, draws: PretrainDraws,
                    tie: float = RELU_TIE):
    """({layer: [n_obj, width] bool}, the forward's loss terms): the units
    of each ReLU layer with a pre-activation within `tie` of zero for some
    sample of `draws` in the trainer's forward (no gradient)."""
    seen = []
    relu = torch.relu

    def spy(a):
        n_obj, width = a.shape[0], a.shape[-1]
        seen.append((a.abs() < tie).reshape(n_obj, -1, width).any(1).cpu())
        return relu(a)

    torch.relu = spy
    try:
        with torch.no_grad():
            terms = trainer.loss(draws)
    finally:
        torch.relu = relu
    if len(seen) != len(RELU_LAYERS):
        raise AssertionError(f"the field ran {len(seen)} ReLU layers, not "
                             f"the {len(RELU_LAYERS)} of {RELU_LAYERS}")
    return dict(zip(RELU_LAYERS, seen)), terms


def tied_mask(name: str, tied: dict, shape) -> torch.Tensor:
    """The entries of leaf `name` (`in_layer.w`, `mid1.0.b`, `B`) that a
    tie touches: the tied units' columns of `w` and entries of `b`."""
    layer, _, kind = name.rpartition(".")
    mask = torch.zeros(shape, dtype=torch.bool)
    if layer in tied:
        units = tied[layer]  # [n_obj, width]
        mask |= units[:, None, :] if kind == "w" else units
    return mask


def named_leaves(trainer: ObjectFieldTrainer) -> list:
    """[(name, parameter)]: the embedding's B, then the field's leaves."""
    return [("B", trainer.pe.B)] + list(trainer.fc.named_parameters())


def copy_state(src: ObjectFieldTrainer, dst: ObjectFieldTrainer) -> None:
    """dst's parameters and AdamW moments set to src's."""
    with torch.no_grad():
        for (_, a), (_, b) in zip(named_leaves(src), named_leaves(dst)):
            b.copy_(a.to(b.device))
            st = src.optimizer.state.get(a)
            if st:
                dst.optimizer.state[b] = {
                    k: v.detach().to(b.device).clone().reshape(())
                    if k == "step" else v.detach().to(b.device).clone()
                    for k, v in st.items()}


@dataclasses.dataclass
class PretrainCheck:
    """The worst of `steps` steps: loss terms (relative), untied and tied
    leaf entries (of the leaf's largest entry), the tied share of a leaf;
    the card's seconds for its steps (synchronised each step) and each
    step's loss on the card."""
    steps: int = 0
    worst_term: float = 0.0
    worst_leaf: float = 0.0
    worst_tied_leaf: float = 0.0
    tied_share: float = 0.0
    card_s: float = 0.0
    losses: list = dataclasses.field(default_factory=list)

    def failures(self) -> list[str]:
        out = []
        for what, got, bound in (
                ("colour/opacity terms", self.worst_term, TERM_TOL),
                ("untied leaf entries", self.worst_leaf, LEAF_TOL),
                ("tied leaf entries", self.worst_tied_leaf, TIED_LEAF_TOL),
                ("tied share of a leaf", self.tied_share, TIED_SHARE)):
            if not got <= bound:
                out.append(f"{what} {got:.3g} over {bound}")
        return out

    def line(self) -> str:
        return (f"{self.steps} steps each from the card's state: "
                f"colour/opacity terms within {self.worst_term:.3g} "
                f"relative (bound {TERM_TOL}), leaves within "
                f"{self.worst_leaf:.3g} of their largest entry (bound "
                f"{LEAF_TOL}), ReLU-tied units' entries within "
                f"{self.worst_tied_leaf:.3g} (bound {TIED_LEAF_TOL}), at "
                f"most {100 * self.tied_share:.2f}% of a leaf (bound "
                f"{100 * TIED_SHARE:.0f}%)")


def pretrain_card_vs_cpu(card: ObjectFieldTrainer, cpu: ObjectFieldTrainer,
                         n_steps: int) -> PretrainCheck:
    """n_steps of `card`'s `step`, each repeated on `cpu` (the same
    objects on the CPU) from the card's state before it, on the card's
    draws."""
    out = PretrainCheck(steps=n_steps)
    for _ in range(n_steps):
        d = card.draw()
        copy_state(card, cpu)
        d_cpu = PretrainDraws(d.idx.cpu(), d.u.cpu())
        tied, lt = relu_tied_units(cpu, d_cpu)
        with torch.no_grad():
            lc = card.loss(d)
        for a, b in ((lc.color, lt.color), (lc.opacity, lt.opacity)):
            out.worst_term = max(out.worst_term, float(
                ((a.cpu() - b).abs() / b.abs()).max()))
        torch.cuda.synchronize(card.device)
        t0 = time.perf_counter()
        loss = card.step(d)
        torch.cuda.synchronize(card.device)
        out.card_s += time.perf_counter() - t0
        out.losses.append(float(loss))
        cpu.step(d_cpu)
        for (name, a), (_, b) in zip(named_leaves(card), named_leaves(cpu)):
            b = b.detach()
            err = (a.detach().cpu() - b).abs() / b.abs().max()
            hit = tied_mask(name, tied, b.shape)
            out.tied_share = max(out.tied_share, float(hit.float().mean()))
            if not hit.all():
                out.worst_leaf = max(out.worst_leaf,
                                     float(err[~hit].max()))
            if hit.any():
                out.worst_tied_leaf = max(out.worst_tied_leaf,
                                          float(err[hit].max()))
    return out


def uncertainty_card_vs_cpu(field: dict, pcs: np.ndarray, obj_id: int,
                            device) -> dict:
    """A field's uncertainty score on the card (its generator seeded with
    the object id) and on the CPU on the card's uniforms: the two counts,
    the directions on either side of the threshold (`flips`) and those of
    them whose CPU metric lies METRIC_FLIP or further from it
    (`far_flips`), the largest entropy difference, the card's seconds;
    `ok` where no flip is far and the counts part by no more than the
    flips."""
    gen = torch.Generator(device).manual_seed(obj_id)
    u = torch.rand(10000, N_BINS, generator=gen, device=device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    cc, ce, cm = uncertainty_score(field, pcs, seed=obj_id, device=device)
    card_s = time.perf_counter() - t0
    tc, te, tm = uncertainty_score(field, pcs, u=u.cpu(), device="cpu")
    flipped = (cm < 0.5) != (tm < 0.5)
    far = int((np.abs(tm[flipped] - 0.5) >= METRIC_FLIP).sum())
    flips = int(flipped.sum())
    return {"card": cc, "cpu": tc, "flips": flips, "far_flips": far,
            "entropy": float(np.abs(ce - te).max()), "card_s": card_s,
            "ok": far == 0 and abs(cc - tc) <= flips}
