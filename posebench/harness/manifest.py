"""Finds every piece of a cell by name, as ``BENCHMARK.json`` names it.

- a cell: ``workloads/<cell>.json`` (its configuration, traffic mix,
  correctness limits and ``why``);
- a configuration: ``configs/<config>.json`` (the file ``BENCHMARK.json``
  gives it);
- a traffic mix: ``mixes/<traffic>.json`` (its kind and parameters), which
  cells of several configurations may share;
- a traffic kind: ``traffic/<kind>.py``, the generator of every mix of that
  kind;
- a per-layer metric: ``metrics/<metric>.py``, whose ``read(summary)``
  returns the metric's value or None.

A new cell, configuration or metric is new files and new entries in
``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent.parent   # the benchmark's folder
CHECKOUT = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    workload: dict          # workloads/<cell>.json
    traffic: dict           # mixes/<traffic>.json
    end_to_end: list        # the manifest's end-to-end metrics this cell reports
    per_layer: list         # the manifest's per-layer metrics this cell reports
    chips: int

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_manifest(checkout: pathlib.Path = CHECKOUT) -> dict:
    with open(checkout / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, checkout: pathlib.Path = CHECKOUT, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, with its files read."""
    manifest = manifest or load_manifest(checkout)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(checkout / conf["file"]) as f:
        config = json.load(f)
    bench_dir = checkout / pathlib.Path(conf["file"]).parts[0]
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    if workload["config"] != entry["config"] or workload["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json on its "
                         "configuration or traffic")
    if not NAME.match(entry["traffic"]):
        raise ValueError(f"bad traffic name {entry['traffic']!r}")
    with open(bench_dir / "mixes" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name)]
    return Cell(name, entry["config"], config, workload, traffic, e2e, per_layer,
                int(entry["chips"]))


def _load_file(path: pathlib.Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_module(kind: str, root: pathlib.Path = ROOT):
    if not NAME.match(kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    return _load_file(root / "traffic" / f"{kind}.py", f"posebench_traffic_{kind}")


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """``read(summary) -> float | None`` of the per-layer metric ``name``."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    module = _load_file(root / "metrics" / f"{name}.py", "posebench_metric_" + name.replace(".", "_"))
    return module.read


def check_names(manifest: dict) -> list[str]:
    """What in the manifest breaks the benchmark's rules for names, units,
    keys and cross-references (empty when nothing does)."""
    errs = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(manifest) != keys:
        errs.append(f"top-level keys {sorted(manifest)}")
    seen = set()
    configs = {c["name"] for c in manifest["configs"]}
    if len(configs) != len(manifest["configs"]):
        errs.append("two configurations share a name")
    if len({w["name"] for w in manifest["workloads"]}) != len(manifest["workloads"]):
        errs.append("two cells share a name")
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    for pair in sorted({p for p in pairs if pairs.count(p) > 1}):
        errs.append(f"configuration and traffic {pair} given more than once")
    for c in manifest["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            errs.append(f"config {c.get('name')}: keys {sorted(c)}")
        for key in [c["name"], *c["reduced"]]:
            if not NAME.match(key):
                errs.append(f"config name {key!r}")
    for w in manifest["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            errs.append(f"workload {w.get('name')}: keys {sorted(w)}")
        for key in (w["name"], w["config"], w["traffic"]):
            if not NAME.match(key):
                errs.append(f"workload name {key!r}")
        if w["config"] not in configs:
            errs.append(f"workload {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            errs.append(f"workload {w['name']}: chips {w['chips']}")
        if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"] or "\t" in w["why"]:
            errs.append(f"workload {w['name']}: why")
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in manifest["end_to_end"] else {"layer", "moves"}
        required = allowed - {"workloads"}
        if not required <= set(m) <= allowed:
            errs.append(f"metric {m.get('name')}: keys {sorted(m)}")
        if not NAME.match(m["name"]) or m["name"] in seen:
            errs.append(f"metric name {m['name']!r}")
        seen.add(m["name"])
        if not UNIT.match(m["unit"]):
            errs.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"metric {m['name']}: better")
        if not set(m.get("workloads", [])) <= cells:
            errs.append(f"metric {m['name']}: unknown cells")
        if "moves" in m and m["moves"] not in e2e:
            errs.append(f"metric {m['name']}: moves {m['moves']}")
    return errs
