"""Device milliseconds a served view spends in the object ensemble's tiles
(the box test, its `nonzero`, the stacked CodeNeRF fields): the CUDA
timing events the span render.objects records on the render's stream,
summed after the request's last sync (the counter
render.objects.device_ns), over the traced `GET /scene` requests
(catnerf_torch.tracing)."""

COUNTER = "render.objects.device_ns"


def read(r):
    try:
        from catnerf_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    views = sum(1 for s in snap["spans"] if s.name == "serve.request"
                and s.attrs.get("path") == "/scene")
    ns = snap["counters"].get(COUNTER)
    return ns / views / 1e6 if views and ns is not None else None
