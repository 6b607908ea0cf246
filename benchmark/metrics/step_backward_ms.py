"""Device milliseconds a step in the training step's backward phase
(`step.backward`: the backward of the loss): the traced window's device
operations mapped through the captured step's phase map, the graph's
device nodes counted at each phase's end while it was captured
(catnerf_torch.tracing `phase_device_ms`). Nothing where the program
keeps no phase map or the window's operations do not divide into it."""

PHASE = "step.backward"


def read(r):
    t = r.get("trace")
    if t is None:
        return None
    try:
        from catnerf_torch import tracing
    except ImportError:
        return None
    ms = tracing.phase_device_ms([(op.name, op.us) for op in t.ops],
                                 t.steps)
    return None if ms is None else ms[PHASE]
