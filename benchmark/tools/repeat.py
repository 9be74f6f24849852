"""Run one cell several times, each run a process of its own, one seed a
run, and keep each run's result line and the end of its standard error.

    python3 benchmark/tools/repeat.py --workload <name> --seeds 11,12,13
        --seconds 10 --trace 0 --out <dir>

Writes <out>/<workload>.t<trace>.<seed>.json (rc, wall seconds, the
result line, the stderr tail) and prints a line a run; the card's name,
power limit and clocks beside the runs in <out>/card.txt.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card(out: str) -> None:
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        line = r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        line = f"nvidia-smi: {e}"
    with open(os.path.join(out, "card.txt"), "a") as f:
        f.write(f"{time.strftime('%H:%M:%S')} {line}\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="10")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for seed in args.seeds.split(","):
        card(args.out)
        t = time.perf_counter()
        try:
            r = subprocess.run(
                [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                 "--workload", args.workload, "--seed", seed, "--seconds",
                 args.seconds, "--trace", args.trace], cwd=ROOT,
                capture_output=True, text=True, timeout=args.timeout)
            rc, stdout, stderr = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
            stdout = stdout if isinstance(stdout, str) else stdout.decode()
            stderr = stderr if isinstance(stderr, str) else stderr.decode()
        wall = time.perf_counter() - t
        lines = stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = dict(workload=args.workload, seed=int(seed),
                   trace=int(args.trace), rc=rc, wall_s=wall, result=result,
                   stderr_tail=stderr[-6000:])
        path = os.path.join(args.out,
                            f"{args.workload}.t{args.trace}.{seed}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        m = {k: v["value"] for k, v in (result or {}).get("metrics",
                                                          {}).items()}
        print(json.dumps(dict(seed=int(seed), rc=rc, wall_s=round(wall, 1),
                              correct=(result or {}).get("correct"),
                              metrics=m)), flush=True)
    card(args.out)


if __name__ == "__main__":
    main()
