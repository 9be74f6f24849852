"""The span segment of a --trace 1 run: the program's own spans
(grid_vision_tpu_torch.utils.stats: gv.step, gv.detect, gv.pose,
gv.static, gv.grid, gv.sync) read after the run's traced segment, on a
Program built anew for it, the run's pool and seed, with the recorder on.
The traced segment of trace.py runs with the recorder off: under kineto
each record_function that encloses device work also yields a device-side
user annotation, which its counts would take for a device operation.

  host   ticks in the traffic's loop for HOST_SECONDS, host clock only (no
         profiler): gv.sync calls and seconds a tick (host.syncs,
         host.sync_ms)
  spans  the traffic's trace_ticks ticks under torch.profiler: each device
         operation put down to the gv. spans open on the host at its launch
         (the runtime call that shares its correlation id, or the host op
         its linked correlation id names), device seconds and launches by
         span; the window's idle gaps split by whether their middle falls
         inside a gv.step host span; the device seconds linked to no
         launch

The readers get only the run's record, which holds neither the pool, the
seed nor the device: segment() takes them from core.run_cell's frame, the
caller of every reader. Where the program has no recorder (no
stats.tracing), nothing runs and every reader of a span returns None.
"""

from __future__ import annotations

import bisect
import collections
import sys
import time
import types

from . import core

HOST_SECONDS = 1.5
PREFIX = "gv."
LAYERS = ("detect", "pose", "static", "grid")
NO_SPAN = "(no span)"
# the CUDA runtime and driver calls that launch device work
RUNTIME = "cu"


def segment(rec):
    """The span readings of this run (measured once, at the first reader
    that asks, and kept on rec), or None."""
    if not hasattr(rec, "spans"):
        rec.spans = _measure(rec)
    return rec.spans


def _recorder():
    try:
        from grid_vision_tpu_torch.utils import stats
    except ImportError:
        return None
    return stats if hasattr(stats, "tracing") else None


def _run_locals():
    """The locals of core.run_cell up the stack, or None."""
    f = sys._getframe(1)
    while f is not None:
        if (f.f_code.co_name == "run_cell"
                and f.f_globals.get("__name__") == core.__name__):
            return dict(f.f_locals)
        f = f.f_back
    return None


def _measure(rec):
    stats = _recorder()
    run = _run_locals()
    if stats is None or run is None or run.get("control") is not None:
        return None
    import torch
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return round(clock[-1] - clock[-2], 3)

    config, traffic = run["config"], run["traffic"]
    pool, device, sync = run["pool"], run["device"], run["sync"]
    system = core.Program(torch, config, traffic["rigs"], device)
    gen = torch.Generator(device=device)
    gen.manual_seed(core._seed32(run["seed"], 5))

    def ticks(states, stop, hold=None):
        return core.drive(torch, system, pool, states, traffic, gen, device,
                          sync, stop, hold=hold)

    took = {"build": lap()}
    states, _, _ = ticks(system.init_states(traffic["rigs"]),
                         lambda s: True)
    sync()
    took["warm"] = lap()
    stats.reset()
    with stats.tracing():
        states, host_ticks, _ = ticks(states, lambda s: s >= HOST_SECONDS)
    host = stats.snapshot()
    stats.reset()
    took["host"] = lap()
    held = []
    n_traced = traffic["trace_ticks"]
    with stats.tracing():
        spans = profile_spans(lambda: ticks(states, lambda s: len(held)
                                            >= n_traced, hold=held), sync)
    stats.reset()
    took["spans"] = lap()
    del held, system
    out = types.SimpleNamespace(host=host, host_ticks=len(host_ticks),
                                dispatch_s=sum(t["dispatch_s"]
                                               for t in host_ticks),
                                **vars(spans))
    _log(out, took)
    return out


def _log(s, took: dict) -> None:
    n = max(s.ticks, 1)
    dev = {k: round(v[0] / n * 1e3, 4) for k, v in s.by_span.items()}
    print(f"[bench] spans: device ms a tick by span {dev}; "
          f"layers' share of gv.step {_share(s):.4f}; unlinked "
          f"{s.unlinked_s:.6f} of {s.device_s:.6f} device s; idle in / out "
          f"of gv.step {s.idle_in_step_s:.6f} / {s.idle_out_step_s:.6f} s "
          f"of {s.window_s:.6f} s, {s.ticks} ticks", file=sys.stderr)
    h = max(s.host_ticks, 1)
    host = {k: (v[0] / h, round(v[1] / h * 1e3, 4))
            for k, v in s.host.items()}
    print(f"[bench] spans: host segment {s.host_ticks} ticks, dispatch "
          f"{s.dispatch_s / h * 1e3:.4f} ms a tick; calls and ms a tick by "
          f"span {host}; seconds by phase {took}", file=sys.stderr)


def _share(s) -> float:
    step = s.by_span.get("step", (0.0, 0))[0]
    layers = sum(s.by_span.get(k, (0.0, 0))[0] for k in LAYERS)
    return layers / step if step else 0.0


# one profiler event: host (a CPU-side event) or a device operation, its
# start and end in microseconds, its correlation id and linked correlation
# id, whether it is a user annotation
Event = collections.namedtuple(
    "Event", "name host start end corr linked annotation")


def profile_spans(fn, sync):
    """Run fn() under torch.profiler (CPU and, where supported, CUDA
    activities), the device synchronized on both ends, and reduce its
    events with by_span()."""
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    return by_span(events(prof), window_s)


def events(prof) -> list:
    """The profile's raw kineto events as Events: read straight from the
    profiler's results, without the FunctionEvent list and its tree, which
    take seconds to build for the ~10^5 events of 16 fleet ticks."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    # clock readings near 1e18 ns: subtract the first in integers, or a
    # float64 keeps a quarter of a microsecond
    base = min((k.start_ns() for k in raw), default=0)
    return [Event(k.name(), k.device_type() == DeviceType.CPU,
                  (k.start_ns() - base) * 1e-3, (k.end_ns() - base) * 1e-3,
                  k.correlation_id(), k.linked_correlation_id(),
                  k.is_user_annotation()) for k in raw]


def by_span(evs, window_s: float):
    """A namespace of: window_s; ticks (gv.step host spans); seen (the gv.
    span names on the host); device_s, launches and busy_s (the union of
    the device operations' intervals), the gv. spans' device-side user
    annotations left out; by_span {span: [device seconds, launches]}, each
    operation counted under every gv. span open on the host when it was
    launched, NO_SPAN for one launched under none; unlinked_s and
    unlinked_launches (no launch found); idle_in_step_s and
    idle_out_step_s, the gaps between device operations by whether their
    middle falls inside a gv.step.

    An operation's launch: the runtime call that shares its correlation id
    (cudaLaunchKernel, cudaMemcpyAsync, ...), else the host op its linked
    correlation id names; the spans open then are those whose host
    interval holds the launch's start."""
    host = [e for e in evs if e.host]
    dev = [e for e in evs if not e.host and not e.annotation
           and not e.name.startswith(PREFIX)]
    runtime = {e.corr: e for e in host if e.name.startswith(RUNTIME)}
    ops = {e.corr: e for e in host
           if e.linked == 0 and not e.name.startswith(RUNTIME)}
    open_at = {}
    for e in host:
        if e.name.startswith(PREFIX):
            open_at.setdefault(e.name[len(PREFIX):], []).append(
                (e.start, e.end))
    for v in open_at.values():
        v.sort()

    def spans_at(t):
        names = []
        for name, iv in open_at.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][1] >= t:
                names.append(name)
        return names or [NO_SPAN]

    spans = {}
    unlinked_s, unlinked_n, device_s = 0.0, 0, 0.0
    for d in dev:
        t = (d.end - d.start) * 1e-6
        device_s += t
        h = runtime.get(d.corr) or (ops.get(d.linked) if d.linked > 0
                                    else None)
        if h is None:
            unlinked_s += t
            unlinked_n += 1
            continue
        for name in spans_at(h.start):
            row = spans.setdefault(name, [0.0, 0])
            row[0] += t
            row[1] += 1
    steps = open_at.get("step", [])
    starts = [s for s, _ in steps]
    busy, gaps, end = 0.0, [], None
    for s, t in sorted((d.start, d.end) for d in dev):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    idle_in = idle_out = 0.0
    for s, t in gaps:
        mid = 0.5 * (s + t)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and steps[i][1] >= mid:
            idle_in += (t - s) * 1e-6
        else:
            idle_out += (t - s) * 1e-6
    return types.SimpleNamespace(
        window_s=window_s, ticks=len(steps), seen=sorted(open_at),
        device_s=device_s, launches=len(dev), busy_s=busy * 1e-6,
        by_span=spans, unlinked_s=unlinked_s, unlinked_launches=unlinked_n,
        idle_in_step_s=idle_in, idle_out_step_s=idle_out)


def device_ms(rec, name: str):
    """Device ms a tick of the operations launched under gv.<name> in the
    span segment; None without a segment, a device operation in it, or a
    gv.<name> span on the host."""
    s = segment(rec)
    if s is None or not s.launches or not s.ticks or name not in s.seen:
        return None
    return s.by_span.get(name, (0.0, 0))[0] / s.ticks * 1e3


def host_per_tick(rec, name: str, i: int, scale: float = 1.0):
    """Column i (0 calls, 1 seconds) of the host segment's gv.<name> totals
    a tick, times scale; None without a segment or its gv.step spans."""
    s = segment(rec)
    if s is None or not s.host_ticks or "step" not in s.host:
        return None
    return s.host.get(name, (0, 0.0))[i] / s.host_ticks * scale
