"""The sweep that fixes an open-loop cell's rate: the cell at each offered
tick rate (and closed, as fast as it goes), in one process, each a short
window; the completed rate, the tail and how late the generator ran.

    python3 benchmark/tools/sweep.py --workload f32-ext.r64.tick
        --rates 0,20,24,26,28,30 --seconds 15 --out <dir>/sweep.json

Rate 0 is the closed loop.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 4242)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    from benchmark import core
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        r = core.run_cell(args.workload, args.seed, args.seconds, False,
                          overrides={"traffic": {"rate_hz": rate or None}},
                          log=lambda m: print(m, file=sys.stderr))
        row = dict(rate_hz=rate, correct=r["correct"],
                   metrics={k: v["value"] for k, v in r["metrics"].items()},
                   late_ms_max=r["readings"].get("late_ms_max"))
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
