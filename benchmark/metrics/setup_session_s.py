"""Seconds of the session's build on the host clock
(`train/loop.py` `TrainingSession.__init__`: the ray buffers, their
shuffle and the initial state)."""


def read(r):
    return r.get("setup_session_s")
