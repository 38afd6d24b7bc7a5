"""On the card: each cell at its own size for a short window comes out
correct, with positive metrics, and its traced run reads its per-layer
metrics within their range."""

from __future__ import annotations

import time

import pytest

from posebench.harness import device as D
from posebench.run import run_cell

from conftest import CHECKOUT

CELLS = ["small-lora-224-b128", "large-unfreeze4-224-b128", "large-serve-504-b1to8",
         "large-unfreeze4-504-b32"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_on_the_card(cells, card, name, traced):
    run_dir = D.use_checkout_caches(CHECKOUT)
    out = run_cell(cells[name], 2**31 + 101, 2.0, traced, card, run_dir, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    for name_, metric in out["metrics"].items():
        assert metric["value"] >= 0, name_
        if metric["unit"] == "%":
            assert metric["value"] <= 105, name_
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
