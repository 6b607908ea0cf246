"""Metric logging: the port of the JAX package's `train/logging.py`.

`MetricsWriter(log_dir)` appends one JSON row per logged step to
`<log_dir>/metrics.jsonl` (`TrainingSession.metrics_to_dict` and the
iteration), the JAX package's scalar log, with the reference's scalar
names (cls_<id>/{depth,color,opacity,reg_shape,reg_texture,psnr},
background/*; ref: src/loss.py:76-102, train.py:26-28, 187-192). The
JAX package also writes TensorBoard events where tensorboardX is
installed; the port does not (the GPU machine has no tensorboardX).
"""

from __future__ import annotations

import json
import os


class MetricsWriter:
    """write=False (a sharded run's other ranks) makes the rows and writes
    nothing."""

    def __init__(self, log_dir: str, write: bool = True):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._scalar_log = None
        if write:
            os.makedirs(log_dir, exist_ok=True)
            self._scalar_log = open(self.path, "a")

    def log_step(self, session, metrics, iteration: int) -> dict:
        """Append the step's row; returns it."""
        d = session.metrics_to_dict(metrics)
        d["iteration"] = iteration
        if self._scalar_log is not None:
            self._scalar_log.write(json.dumps(d) + "\n")
            self._scalar_log.flush()
        return d

    def close(self) -> None:
        if self._scalar_log is not None:
            self._scalar_log.close()
