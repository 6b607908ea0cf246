"""The whole step's share of the card's float32 peak: the model's FLOPs a
step (benchlib/work.py: both fields and the latent projections, forward
and backward, no recompute) times the traced steps, over the traced
window, over 67 TFLOP/s."""

from benchlib import work


def read(r):
    t = r.get("trace")
    if t is None or t.window_us <= 0:
        return None
    rate = r["work"].step_flops() * t.steps / (t.window_us / 1e6)
    return 100.0 * rate / work.FP32_FLOPS
