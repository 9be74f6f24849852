"""The readings that the limits of `correct` are set from, in one
process: the compared numbers of the program on each of --seeds and of
each control on each of --control-seeds, at the cell's own size, each a
short window. The controls: --controls (core.Control's modes, comma
separated), by default the configuration's own (the reference in the
precision below the configuration's).

    python3 benchmark/tools/readings.py --workload <name>
        --seeds 1,2,... --control-seeds 7,8,9 [--controls int4,float]
        --seconds 3 --out <dir>/readings.<name>.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    from benchmark import core
    _, _, config, _, _ = core.load_cell(args.workload)
    rows = []
    controls = [c for c in args.controls.split(",") if c] or \
        [config["control"]]
    runs = [(int(s), None) for s in args.seeds.split(",") if s] + \
        [(int(s), c) for c in controls
         for s in args.control_seeds.split(",") if s]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for seed, control in runs:
        t = time.perf_counter()
        r = core.run_cell(args.workload, seed, args.seconds, False,
                          control=control,
                          log=lambda m: print(m, file=sys.stderr))
        row = dict(seed=seed, control=control, correct=r["correct"],
                   wall_s=time.perf_counter() - t,
                   checks={k: v["value"] for k, v in r["checks"].items()},
                   readings=r["readings"],
                   metrics={k: v["value"] for k, v in r["metrics"].items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
