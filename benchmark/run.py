"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The
result is the last line of standard output, one JSON object (correct,
attempted, failed, metrics, device; with --trace 1 breakdown; the
compared numbers and their limits under "checks", last); the same numbers
are the last lines of standard error. Without a card, with too few, or
with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", _sub)
sys.path.insert(0, ROOT)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import core
    import torch
    _, cell, _, _, _ = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), log=log)
    except RuntimeError as e:
        log(f"run failed: {e}")
        return 3
    # last, once the judge and every metric reader have run
    found = core.forbidden_modules(sys.modules)
    if found:
        log(f"forbidden modules loaded: {found}; no result")
        return 3
    for name, c in result["checks"].items():
        bound = (f"limit {c['limit']!r}" if "limit" in c
                 else f"at least {c['min']!r}")
        log(f"check {name} {c['value']!r} {bound}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
