"""The traced segment: torch.profiler over a few ticks after the measured
window, reduced to what the per-layer metrics read: device time and
launches by kernel name, the device's busy time (the union of its
operations' intervals) and idle gaps, each gap put down to the host
operation that was running while the device waited (the innermost one
that spans the gap's middle)."""

from __future__ import annotations

import time
import types


def profile(fn, sync):
    """Run fn() under torch.profiler (CPU and CUDA activities), the device
    synchronized on both ends. Returns a summary namespace: window_s
    (host clock), busy_s, by_name {kernel: [seconds, launches]}, launches,
    gaps {host op: seconds}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile
    sync()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        (host if e.device_type == DeviceType.CPU else dev).append(span)
    by_name = {}
    for s, t, name in dev:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += (t - s) * 1e-6
        row[1] += 1
    dev.sort()
    busy, gaps, end = 0.0, [], None
    for s, t, _ in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return types.SimpleNamespace(
        window_s=window_s, busy_s=busy * 1e-6, by_name=by_name,
        launches=len(dev), gaps=_attribute(gaps, host))


def _attribute(gaps, host):
    """{host op name: idle seconds}: each gap to the innermost host op
    (the latest started) that spans its middle."""
    host.sort()
    out, active, k = {}, [], 0
    for s, t in gaps:
        mid = 0.5 * (s + t)
        while k < len(host) and host[k][0] <= mid:
            active.append(host[k])
            k += 1
        active = [h for h in active if h[1] >= mid]
        name = max(active)[2] if active else "(no host op)"
        out[name] = out.get(name, 0.0) + (t - s) * 1e-6
    return out


def breakdown(summary) -> dict:
    """The result line's breakdown: the 10 device operations that took
    most time and the 10 largest idle shares by host op, [name, s]."""
    ops = sorted(((n[:160], v[0]) for n, v in summary.by_name.items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(((n[:160], v) for n, v in summary.gaps.items()),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(x) for x in ops],
            "idle_gaps": [list(x) for x in gaps]}
