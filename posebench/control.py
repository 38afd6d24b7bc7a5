"""Readings for the limits that decide ``correct``, many seeds in one process.

    python3 posebench/control.py --workload <cell> --seeds 1,2,3 --side program
    python3 posebench/control.py --workload <cell> --seeds 1,2,3 --side control
    python3 posebench/control.py --workload <cell> --seeds 1,2,3 --side fault:half_batch

``program``: the numbers of sound runs (the lower readings). ``control``:
the reference computed with every product's operands in fp8, one step below
the bfloat16 the configurations state, put in the program's place (the
upper readings). ``fault:<name>``: the program with a fault planted in its
timed path (``half_batch``, ``unchanged_state`` for training;
``altered_answer`` for serving). A training cell needs no window; a serving
cell runs a short one (``--seconds``) at the cell's own load. One JSON line
a seed. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from posebench.harness import compare, device as D, manifest as M  # noqa: E402


def readings(cell: M.Cell, seed: int, side: str, dev, seconds: float) -> dict:
    """The numbers of one seed, as ``side`` gives them."""
    fault = side.split(":", 1)[1] if side.startswith("fault:") else None
    session = M.traffic_module(cell.kind).Session(cell, seed, dev, fault)
    if session.kind == "serve":
        session.window(seconds)
    session.release()
    if session.kind == "serve":
        got = session.served() if side != "control" else session.reference("fp8")
        return compare.serve_gaps(got, session.reference("f32"), session.size)
    got = session.readings if side != "control" else session.reference("fp8")
    return compare.train_gaps(got, session.reference("f32"))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--side", default="program")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    D.use_checkout_caches(CHECKOUT)
    cell = M.load_cell(args.workload)
    dev = D.require_cards(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = readings(cell, seed, args.side, dev, args.seconds)
        print(json.dumps({"cell": cell.name, "side": args.side, "seed": seed, **numbers}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
