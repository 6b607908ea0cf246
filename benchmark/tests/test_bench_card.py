"""On the card (marker `cuda`; skips without one): a tiny cell's run is
correct and its control is not, through the captured step's replays and
kernels 1-4."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import tiny_cell
from benchlib import compare, train_cell, view_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["room0_train", "room0_train_bf16"])
def test_tiny_cell_on_the_card(card, name):
    cell = tiny_cell(name)
    r = train_cell.run(cell, 2**31 + 41, 0.5, True, card, 0.0)
    ok, checks = compare.judge(r["values"], cell.limits)
    assert ok, checks
    assert r["trace"] is not None and r["trace"].busy_us > 0
    r = train_cell.run(cell, 2**31 + 43, 0.2, False, card, 0.0,
                       control=True)
    assert not compare.judge(r["values"], cell.limits)[0]


@pytest.mark.cuda
def test_tiny_view_on_the_card(card):
    cell = tiny_cell("room0_view")
    r = view_cell.run(cell, 2**31 + 47, 0.5, True, card, 0.0)
    ok, checks = compare.judge(r["values"], cell.limits)
    assert ok, checks
    assert r["trace"] is not None and r["trace"].busy_us > 0
