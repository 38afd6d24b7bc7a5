"""Run one cell of the benchmark of the PyTorch and CUDA pose port.

    python3 posebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``dino_pose_tpu_torch``), on a machine with the cards the cell
asks for. It builds the cell's program and data from the seed, warms up the
cell's own shapes (set-up), measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a profiled stretch of the window), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
and its limit, also printed last on standard error.

Without a CUDA card, or with fewer than the cell needs, it exits non-zero
and prints no result. So it does where the program or a file of the cell
is missing, and where a JAX module was loaded.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from posebench.harness import compare, device as D, manifest as M  # noqa: E402


def run_cell(cell: M.Cell, seed: int, seconds: float, traced: bool, dev, run_dir: pathlib.Path,
             started: float, fault: str | None = None) -> dict:
    """One run of ``cell`` on ``dev``; returns the result line's object."""
    import torch

    from posebench.harness.trace import program_kernels

    session = M.traffic_module(cell.kind).Session(cell, seed, dev, fault)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    setup_s = time.perf_counter() - started
    trace_path = run_dir / "traces" / f"{cell.name}.{seed}.json" if traced else None
    win = session.window(seconds, trace_path)
    peak = max(setup_peak, win["peak_window_bytes"])
    device = D.describe(dev, cell.chips, peak)
    session.release()
    ok, checks = compare.verdict(session.check(), cell.workload["limits"])
    result = {"correct": bool(ok and win["failed"] == 0), "attempted": win["attempted"],
              "failed": win["failed"]}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if traced:
        summary = win["summary"]
        summary["program_kernels"] = program_kernels(
            CHECKOUT / "dino_pose_tpu_torch" / "ops" / "csrc")
        values = {m["name"]: M.metric_reader(m["name"])(summary) for m in cell.per_layer}
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["metrics"] = {n: {"value": v, "unit": units[n]} for n, v in values.items()
                             if v is not None}
        result["device"] = device
        result["breakdown"] = summary["breakdown"]
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = min(_STARTED, time.perf_counter() - D.process_age_s())
    run_dir = D.use_checkout_caches(CHECKOUT)
    cell = M.load_cell(args.workload)
    dev = D.require_cards(cell.chips)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, run_dir, started)
    found = D.forbidden_modules()
    if found:
        print(f"posebench: JAX modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
