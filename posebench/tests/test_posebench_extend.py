"""A configuration, a cell and a per-layer metric are added as new files
and new entries in BENCHMARK.json, with no file of the harness edited."""

from __future__ import annotations

import json
import shutil
import time

from posebench.harness import manifest as M
from posebench.run import run_cell

from conftest import CHECKOUT, tiny


def test_new_files_are_found(tmp_path, cpu):
    root = tmp_path / "checkout"
    shutil.copytree(CHECKOUT / "posebench", root / "posebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "posebench").rglob("*") if p.is_file()}
    manifest = json.loads((CHECKOUT / "BENCHMARK.json").read_text())

    config = json.loads((root / "posebench/configs/dinov2-small.json").read_text())
    config["name"] = "dinov2-small-copy"
    (root / "posebench/configs/dinov2-small-copy.json").write_text(json.dumps(config))
    manifest["configs"].append({"name": "dinov2-small-copy", "source": config["source"],
                                "file": "posebench/configs/dinov2-small-copy.json",
                                "reduced": [], "why": "a throwaway copy"})
    mix = json.loads((root / "posebench/mixes/lora-224-b128.json").read_text())
    mix["batch_size"] = 2
    (root / "posebench/mixes/lora-224-b2.json").write_text(json.dumps(mix))
    cell = json.loads((root / "posebench/workloads/small-lora-224-b128.json").read_text())
    cell.update(name="copy-lora-224-b2", config="dinov2-small-copy", traffic="lora-224-b2")
    (root / "posebench/workloads/copy-lora-224-b2.json").write_text(json.dumps(cell))
    manifest["workloads"].append({"name": "copy-lora-224-b2", "config": "dinov2-small-copy",
                                  "traffic": "lora-224-b2", "chips": 1, "why": "a throwaway cell"})
    (root / "posebench/metrics/steps_traced.train.py").write_text(
        "def read(summary):\n    return float(len(summary['items']))\n")
    manifest["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                                  "source": "device_trace", "layer": "train step",
                                  "moves": "train_img_per_s", "workloads": ["copy-lora-224-b2"]})
    for m in manifest["end_to_end"]:
        if "workloads" in m and m["name"] == "train_img_per_s":
            m["workloads"].append("copy-lora-224-b2")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    assert M.check_names(manifest) == []

    found = M.load_cell("copy-lora-224-b2", root)
    assert found.config["name"] == "dinov2-small-copy"
    assert found.traffic == mix and found.kind == "train_steps"
    assert [m["name"] for m in found.per_layer] == ["steps_traced.train"]
    assert M.metric_reader("steps_traced.train", root / "posebench")({"items": [2, 2]}) == 2.0
    out = run_cell(tiny(found), 5, 0.3, False, cpu, tmp_path, time.perf_counter())
    assert out["correct"] and set(out["metrics"]) == {"train_img_per_s", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
