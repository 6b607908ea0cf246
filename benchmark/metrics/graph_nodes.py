"""The captured step's CUDA graph nodes (`CapturedStep.node_count()`),
as the program's counter graph.nodes holds it from the capture
(catnerf_torch.tracing)."""


def read(r):
    try:
        from catnerf_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()["counters"].get("graph.nodes")
