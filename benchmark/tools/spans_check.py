"""Hold the program's gv.sync spans to the syncs torch reports, and weigh
the span recorder's cost, on one cell's configuration and pool.

    python3 benchmark/tools/spans_check.py --workload <name> [--seed N]
        [--ticks 8] [--pairs 8] [--out FILE]

On the card. syncs: --ticks fleet ticks, each under
torch.cuda.set_sync_debug_mode("warn") and the recorder, every warning
kept with the stack it came from; the count of warnings against the
gv.sync calls, each warning's site, whether a gv.sync span was open around
it and whether it came inside the fleet call (else from the switches of
the mode around it), and the gv.sync spans inside which no warning came.
cost: segments of the cell's loop with the recorder on and off in turn
(on, off, off, on, ...), host.dispatch_ms of each; and the host time of
one span entered and left, on and off, times the spans a tick. One JSON
object to standard output and to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402


def sync_check(torch, stats, system, pool, traffic, gen, states, n_ticks):
    real_span = stats.span
    open_syncs, spans_seen = [], []

    class Tracked:
        def __init__(self, name):
            self.name, self.inner = name, real_span(name)

        def __enter__(self):
            if self.name == "sync":
                open_syncs.append(0)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            if self.name == "sync":
                spans_seen.append(open_syncs.pop())
            return self.inner.__exit__(*exc)

    found, in_step = [], [False]

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        if open_syncs:
            open_syncs[-1] += 1
        frames = traceback.extract_stack()[:-1]
        stack = [f for f in frames if f.filename.startswith(ROOT)
                 and "benchmark" not in f.filename]
        site = (f"{os.path.relpath(stack[-1].filename, ROOT)}:"
                f"{stack[-1].lineno} {stack[-1].name}" if stack else
                " < ".join(f"{os.path.basename(f.filename)}:{f.lineno} "
                           f"{f.name}" for f in frames[::-1][:4]))
        found.append((site, bool(open_syncs), in_step[0]))

    draws = core.draw(torch, gen, n_ticks, traffic["rigs"], pool.image.device)
    stats.span = Tracked
    stats.reset()
    try:
        with warnings.catch_warnings(), stats.tracing():
            warnings.simplefilter("always")
            warnings.showwarning = show
            for t in range(n_ticks):
                obs = core.perturbed(pool, draws[0][t], draws[1][t])
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
                in_step[0] = True
                try:
                    states, _ = system.step(states, obs)
                finally:
                    in_step[0] = False
                    torch.cuda.set_sync_debug_mode(0)
    finally:
        stats.span = real_span
    snap = stats.snapshot()
    stats.reset()
    sites = {}
    for site, inside, stepping in found:
        row = sites.setdefault(site, {"warnings": 0, "in_gv_sync": 0,
                                      "in_step": 0})
        row["warnings"] += 1
        row["in_gv_sync"] += int(inside)
        row["in_step"] += int(stepping)
    return states, dict(
        ticks=n_ticks, warnings=len(found),
        warnings_in_step=sum(f[2] for f in found),
        warnings_in_gv_sync=sum(f[1] for f in found),
        gv_sync_calls=snap.get("sync", (0, 0.0))[0],
        gv_sync_spans_without_warning=sum(1 for n in spans_seen if n == 0),
        spans_a_tick={k: v[0] / n_ticks for k, v in snap.items()},
        sites=sites)


def cost_check(torch, stats, system, pool, traffic, gen, states, pairs):
    n = traffic["chunk"] * max(1, 24 // traffic["chunk"])
    runs = {True: [], False: []}
    order = [k % 4 in (0, 3) for k in range(2 * pairs)]
    for on in order:
        held = []
        stats.reset()
        with stats.tracing(on):
            states, ticks, _ = core.drive(
                torch, system, pool, states, traffic, gen, pool.image.device,
                torch.cuda.synchronize, lambda s: len(held) >= n, hold=held)
        runs[on].append(statistics.mean(t["dispatch_s"] for t in ticks)
                        * 1e3)
    spans_a_tick = sum(v[0] for v in stats.snapshot().values()) / n
    stats.reset()
    each = {}
    for on in (True, False):
        k = 200000
        with stats.tracing(on):
            t0 = time.perf_counter()
            for _ in range(k):
                with stats.span("cost"):
                    pass
            each[on] = (time.perf_counter() - t0) / k
    stats.reset()
    on_ms, off_ms = statistics.median(runs[True]), statistics.median(
        runs[False])
    return dict(
        ticks_a_segment=n, order=order,
        dispatch_ms_on=runs[True], dispatch_ms_off=runs[False],
        dispatch_ms_on_median=on_ms, dispatch_ms_off_median=off_ms,
        on_over_off_pct=100.0 * (on_ms / off_ms - 1.0),
        spans_a_tick=spans_a_tick, span_us_on=each[True] * 1e6,
        span_us_off=each[False] * 1e6,
        recorder_ms_a_tick=(each[True] - each[False]) * spans_a_tick * 1e3,
        recorder_pct_of_dispatch=100.0 * (each[True] - each[False])
        * spans_a_tick * 1e3 / off_ms)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    from grid_vision_tpu_torch.utils import stats
    _, _, config, traffic, _ = core.load_cell(args.workload)
    torch.set_num_threads(1)
    dev = "cuda"
    pool, _ = core.build_pool(torch, config, traffic, args.seed, dev)
    system = core.Program(torch, config, traffic["rigs"], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(core._seed32(args.seed, 6))
    states, _, _ = core.drive(torch, system, pool,
                              system.init_states(traffic["rigs"]), traffic,
                              gen, dev, torch.cuda.synchronize,
                              lambda s: True)
    states, syncs = sync_check(torch, stats, system, pool, traffic, gen,
                               states, args.ticks)
    cost = cost_check(torch, stats, system, pool, traffic, gen, states,
                      args.pairs)
    q = "name,power.limit"
    try:
        card = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        card = f"nvidia-smi: {e}"
    res = dict(workload=args.workload, seed=args.seed, card=card,
               torch=torch.__version__, syncs=syncs, cost=cost)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
