"""Host milliseconds a served view spends encoding the PNG (the span
serve.png), summed over the spans of each traced `GET /scene`
(serve.request) and taken over their number (catnerf_torch.tracing)."""

SPAN = "serve.png"


def read(r):
    try:
        from catnerf_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    views = {s.id for s in spans if s.name == "serve.request"
             and s.attrs.get("path") == "/scene"}
    if not views:
        return None
    ns = sum(s.ns for s in spans if s.name == SPAN and s.request in views)
    return ns / len(views) / 1e6
