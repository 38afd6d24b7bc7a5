"""BENCHMARK.json keeps the benchmark's rules for names and keys, and every cell resolves."""

from __future__ import annotations

import json

import pytest

from posebench.harness import compare
from posebench.harness import manifest as M
from posebench.reference.spec import ModelShape

from conftest import CHECKOUT


def test_names_units_and_keys(manifest):
    assert M.check_names(manifest) == []
    assert manifest["command"] == ["python3", "posebench/run.py"]
    assert manifest["paths"] == ["posebench"]
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["name"].split(".")[0].endswith(("_roofline", "mfu"))
    assert len(json.dumps(manifest)) < 64 * 1024


def test_a_pair_of_configuration_and_traffic_is_given_once(manifest):
    twice = json.loads(json.dumps(manifest))
    first = twice["workloads"][0]
    twice["workloads"].append(dict(first, name=first["name"] + "-again"))
    errs = M.check_names(twice)
    assert errs == [f"configuration and traffic {(first['config'], first['traffic'])} "
                    "given more than once"]


@pytest.mark.parametrize("name", [
    "small-lora-224-b128", "large-unfreeze4-224-b128", "large-serve-504-b1to8",
    "large-unfreeze4-504-b32"])
def test_every_cell_resolves(cells, name):
    cell = cells[name]
    assert M.traffic_module(cell.kind).Session
    for m in cell.per_layer:
        assert callable(M.metric_reader(m["name"]))
    numbers = compare.TRAIN_NUMBERS if cell.kind == "train_steps" else compare.SERVE_NUMBERS
    assert set(cell.workload["limits"]) == set(numbers)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("conf", ["dinov2-small", "dinov2-large"])
def test_config_files_hold_the_published_widths(manifest, conf):
    entry = next(c for c in manifest["configs"] if c["name"] == conf)
    config = json.loads((CHECKOUT / entry["file"]).read_text())
    assert entry["reduced"] == config["reduced"] == []
    shape = ModelShape.from_config(config)
    published = {"dinov2-small": (384, 12, 6), "dinov2-large": (1024, 24, 16)}[conf]
    assert (shape.hidden, shape.layers, shape.heads) == published
    assert (shape.mlp_ratio, shape.patch, shape.pos_grid) == (4, 14, 37)
    assert config["source"] == entry["source"]
