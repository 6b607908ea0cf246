"""Host microseconds a replay spends in `CUDAGraph.replay()` (the
captured step's launch), over the traced call: the program's counters
graph.launch_ns over graph.replays (catnerf_torch.tracing), which count
while the profiler records."""


def read(r):
    try:
        from catnerf_torch import tracing
    except ImportError:
        return None
    c = tracing.snapshot()["counters"]
    n = c.get("graph.replays", 0)
    return c["graph.launch_ns"] / n / 1e3 if n > 0 else None
