"""The share of the object ensemble's evaluations in a served view that
land inside the evaluated object's own box: the ensemble runs every
object on each point inside some box (render.object_evals), of which
only the box mask's true entries count (render.object_hits), the
program's counters over the traced `GET /scene` (catnerf_torch.tracing)."""


def read(r):
    try:
        from catnerf_torch import tracing
    except ImportError:
        return None
    c = tracing.snapshot()["counters"]
    evals = c.get("render.object_evals", 0)
    if evals <= 0 or "render.object_hits" not in c:
        return None
    return 100.0 * c["render.object_hits"] / evals
