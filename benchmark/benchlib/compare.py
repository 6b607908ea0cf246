"""The numbers that decide `correct`, each against its limit.

A training cell compares the program's first steps with the plain
reference's on the same rows and draws:

- `store_rows`: categories whose ray store holds another number of rows
  than the scene gives (exact: limit 0);
- `store_gap`: the widest gap between the store's order-free sums and the
  scene's rays' (reference.fingerprint_gap);
- `loss1_gap`: the relative gap between the first step's losses, both
  from the benchmark's weights;
- `step_loss_gap`: the widest relative gap, over steps 2-6, between the
  program's loss and the reference's at the program's own weights before
  that step (the replays among them);
- `grad1_gap`, `delta3_gap`: by the worst leaf, the gap between the
  norms of the first step's gradient (as AdamW holds it), and of the
  weights' change after three steps, each side following its own steps
  from the benchmark's weights, against the reference's norm of that leaf
  or the median leaf's, whichever is larger;
- `delta6_gap`: the same gap of the change after six steps (the replays'
  updates among them), the median leaf's: by step 6 the worst leaf's
  reading is the noise of the later steps (Adam turns a rounding-sized
  gradient into a full step).

A leaf whose first gradient in the reference is under a thousandth of
the median leaf's moves by round-off alone: the changes leave it out.

A view cell holds each served view of a sample drawn from the seed to
the reference's render of its pose, both as the PNG's 8-bit pixels:

- `view_mean_lsb`: the mean gap of a pixel's channel, in steps of 1/255,
  the widest of the views. (The widest single gap is 1 step in sound
  views, where rounding straddles a step, and 2 under TF32: it separates
  nothing, so it is not compared.)

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math
import statistics
import sys

CHECKS = ("store_rows", "store_gap", "loss1_gap", "step_loss_gap",
          "grad1_gap", "delta3_gap", "delta6_gap", "view_mean_lsb")
ROUND_OFF_LEAF = 1e-3


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref,
                                                              strict=True))


def leaf_gaps(prog: dict[str, float], ref: dict[str, float],
              leaves=None) -> list[float]:
    """Per leaf, |prog - ref| / max(ref, the median leaf's ref)."""
    keys = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def worst_leaf(prog, ref, leaves=None) -> float:
    return max(leaf_gaps(prog, ref, leaves))


def median_leaf(prog, ref, leaves=None) -> float:
    return statistics.median(leaf_gaps(prog, ref, leaves))


def moved_leaves(grad1_ref: dict[str, float]) -> list[str]:
    med = statistics.median(grad1_ref.values())
    return [k for k, v in grad1_ref.items() if v >= ROUND_OFF_LEAF * med]


def judge(values: dict[str, float], limits: dict[str, float]):
    """(correct, {name: {"value", "limit"}}), each number beside its limit;
    a missing or non-finite value fails."""
    out, ok = {}, True
    for name in CHECKS:
        if name not in limits:
            continue
        v = values.get(name, math.nan)
        passed = math.isfinite(v) and v <= limits[name]
        ok &= passed
        out[name] = {"value": v, "limit": limits[name]}
    return ok, out


def print_checks(checks: dict, stream=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=stream, flush=True)
