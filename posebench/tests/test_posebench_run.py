"""Runs of the harness on the CPU at the tiny size: each cell's path end to
end, the command's refusal without a card, and ``correct`` coming out false
with the timed path broken underneath and with the control in the
program's place."""

from __future__ import annotations

import json

import pytest

import posebench.run as RUN
from posebench import control
from posebench.harness import compare

from conftest import tiny

SEED = 2**31 + 11
CELLS = ["small-lora-224-b128", "large-unfreeze4-224-b128", "large-serve-504-b1to8",
         "large-unfreeze4-504-b32"]


def run(cell, cpu, tmp_path, traced=False, fault=None) -> dict:
    import time

    return RUN.run_cell(cell, SEED, 0.5, traced, cpu, tmp_path, time.perf_counter(), fault)


@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end(cells, cpu, tmp_path, name):
    cell = tiny(cells[name])
    out = run(cell, cpu, tmp_path)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


@pytest.mark.parametrize("name", ["small-lora-224-b128", "large-serve-504-b1to8"])
def test_traced_run_writes_and_reads_a_trace(cells, cpu, tmp_path, name):
    out = run(tiny(cells[name]), cpu, tmp_path, traced=True)
    assert (tmp_path / "traces").is_dir()
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert set(out["metrics"]) <= {m["name"] for m in cells[name].per_layer}


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        RUN.main(["--workload", "small-lora-224-b128", "--seed", "1", "--seconds", "1"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,fault", [
    ("small-lora-224-b128", "unchanged_state"), ("small-lora-224-b128", "half_batch"),
    ("large-unfreeze4-224-b128", "unchanged_state"), ("large-unfreeze4-224-b128", "half_batch"),
    ("large-unfreeze4-504-b32", "unchanged_state"), ("large-unfreeze4-504-b32", "half_batch"),
    ("large-serve-504-b1to8", "altered_answer")])
def test_planted_fault_is_not_correct(cells, cpu, tmp_path, name, fault):
    out = run(tiny(cells[name]), cpu, tmp_path, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cells, cpu, name):
    """The reference with fp8 operands in the program's place fails a limit."""
    cell = tiny(cells[name])
    numbers = control.readings(cell, SEED, "control", cpu, 0.5)
    ok, checks = compare.verdict(numbers, cell.workload["limits"])
    assert not ok, checks
