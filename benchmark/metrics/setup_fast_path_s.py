"""Seconds from `TrainingSession.enable_fast_path` (the device ray store
built, packed and uploaded) to the end of the third step, the last eager
warm-up step of the captured step, after which the graph is captured, on
the host clock."""


def read(r):
    return r.get("setup_fast_path_s")
