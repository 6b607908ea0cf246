"""The port's training CLI, `python -m catnerf_torch.train`, on the CPU."""

from __future__ import annotations

import json
import math

import pytest
import torch

from catnerf_torch.train import __main__ as cli
from catnerf_torch.train.__main__ import main

torch.set_num_threads(1)


@pytest.mark.parametrize("extra", [[], ["--strict-parity"]],
                         ids=["default", "strict_parity"])
def test_synthetic_run_prints_one_json_line_per_log_step(capsys,
                                                        monkeypatch, extra):
    """The default trains `Config()` (bf16 storage on the XLA path), as the
    JAX package's `train.py --synthetic`, through the fast path;
    --strict-parity its float32 strict-parity configuration on host-staged
    batches (`step_once`)."""
    sessions = []
    session = cli.TrainingSession

    def spy(cfg, *args, **kw):
        sessions.append(session(cfg, *args, **kw))
        return sessions[-1]

    monkeypatch.setattr(cli, "TrainingSession", spy)
    assert main(["--synthetic", "--max-iter", "2", "--log-iter", "1",
                 "--device", "cpu", *extra]) == 0
    (sess,) = sessions
    cfg = sess.cfg
    assert not cfg.use_fused_kernels
    assert cfg.bf16_activations == (not extra)
    assert (sess._superstep is None) == bool(extra)
    assert cfg.net_hyperparams.latent_dim == 32
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2]
    for r in rows:
        assert r["device"] == "cpu"
        assert {"total", "bg_psnr", "background/depth"} <= r.keys()
        assert sum(k.endswith("/psnr") for k in r) == 3  # 3 categories
        assert all(math.isfinite(v) for k, v in r.items()
                   if k != "device")


def test_without_synthetic_it_exits_with_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--max-iter", "1", "--device", "cpu"])
    assert e.value.code == 2
    assert "only --synthetic" in capsys.readouterr().err


def test_fast_path_logs_each_chunk_and_the_rest(capsys):
    """--log-iter steps a run_fast call, the last call the rest."""
    assert main(["--synthetic", "--max-iter", "3", "--log-iter", "2",
                 "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["iteration"] for r in rows] == [2, 3]
