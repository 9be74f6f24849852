"""The span readers (benchmark/spans.py and its seven metrics): each on a
hand-built record; by_span on a CPU profile of a spanned function, with
device operations laid over its host ops (attribution through the
profiler's correlation to the launch and the gv. spans open at it, the
user annotations left out, the idle split by gv.step); and a CPU run of
the f32 cell at 4 rigs, with the program's recorder and without it (as
the parent commit has none)."""

import functools
import types

import pytest
import torch

from benchmark import core, spans
from grid_vision_tpu_torch.utils import stats

NEW = ("detect.device_ms", "pose.device_ms", "static.device_ms",
       "grid.device_ms", "device.idle_in_step_pct", "host.syncs",
       "host.sync_ms")


def _rec(**kw):
    seg = dict(window_s=0.5, ticks=16, seen=["detect", "grid", "pose",
                                             "static", "step", "sync"],
               device_s=0.3, launches=1000, busy_s=0.3,
               by_span={"step": [0.29, 990], "detect": [0.08, 500],
                        "pose": [0.032, 200], "static": [0.16, 250],
                        "grid": [0.016, 30], "sync": [0.0016, 40]},
               unlinked_s=0.0, unlinked_launches=0, idle_in_step_s=0.1,
               idle_out_step_s=0.1, host={"step": (10, 0.4),
                                          "sync": (50, 0.15)},
               host_ticks=10, dispatch_s=0.4)
    seg.update(kw)
    return types.SimpleNamespace(spans=types.SimpleNamespace(**seg))


def test_readers_on_a_record():
    rec = _rec()
    read = {n: core.reader(n)(rec) for n in NEW}
    assert read["detect.device_ms"] == pytest.approx(5.0)
    assert read["pose.device_ms"] == pytest.approx(2.0)
    assert read["static.device_ms"] == pytest.approx(10.0)
    assert read["grid.device_ms"] == pytest.approx(1.0)
    assert read["device.idle_in_step_pct"] == pytest.approx(20.0)
    assert read["host.syncs"] == pytest.approx(5.0)
    assert read["host.sync_ms"] == pytest.approx(15.0)


def test_readers_find_nothing():
    # no segment (no recorder in the program)
    none = types.SimpleNamespace(spans=None)
    assert all(core.reader(n)(none) is None for n in NEW)
    # no device operation (a CPU run): the host readings stay
    rec = _rec(launches=0, by_span={})
    assert [n for n in NEW if core.reader(n)(rec) is not None] == \
        ["host.syncs", "host.sync_ms"]
    # a span the program does not open reads None, one with no device
    # operation under it 0; no sync on the host reads 0 syncs
    rec = _rec(seen=["detect", "step"], by_span={"step": [0.1, 9],
                                                 "detect": [0.1, 9]},
               host={"step": (10, 0.4)})
    assert core.reader("pose.device_ms")(rec) is None
    assert core.reader("host.syncs")(rec) == 0.0


def _device(name, start, end, linked=0, corr=10 ** 9, annotation=False):
    return spans.Event(name, False, start, end, corr, linked, annotation)


def test_by_span_on_a_cpu_profile():
    def tick():
        with stats.span("step"):
            with stats.span("detect"):
                a = torch.ones(64).mul(2.0)
                with stats.span("sync"):
                    torch.equal(a, a)
            with stats.span("grid"):
                a.add(1.0)
        torch.zeros(8).sum()                # after the step, no span

    with stats.tracing():
        got = spans.profile_spans(tick, lambda: None)
    assert got.ticks == 1 and got.launches == 0
    assert set(got.seen) == {"step", "detect", "sync", "grid"}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stats.tracing():
            tick()
    stats.reset()
    host = [e for e in spans.events(prof) if e.host]

    def first(name):
        return next(e for e in host if e.name == name)

    step, mul, eq = first("gv.step"), first("aten::mul"), first(
        "aten::equal")
    add, out, grid = first("aten::add"), first("aten::sum"), first("gv.grid")
    s0, s1 = step.start, step.end
    span = s1 - s0
    # device ops: mul's, equal's and add's kernels inside the step with a
    # gap between the first two (its middle inside gv.step), the sum's
    # after the step with a gap before it (middle outside), a kernel linked
    # to nothing, and the user annotations of gv.step (one marked, one
    # known by its name alone), left out
    dev = [_device("k_mul", s0 + 0.1 * span, s0 + 0.2 * span, mul.corr),
           _device("k_eq", s0 + 0.4 * span, s0 + 0.5 * span, eq.corr),
           _device("k_add", s0 + 0.5 * span, s0 + 0.6 * span, add.corr),
           _device("k_sum", s1 + 2 * span, s1 + 2.5 * span, out.corr),
           _device("k_lost", s1 + 2.5 * span, s1 + 2.6 * span, 0),
           _device("gv.step", s0, s1, step.corr, annotation=True),
           _device("gv.grid", s0, s1, 0)]
    # a kernel found through its runtime call (the same correlation id),
    # launched inside gv.grid; its device time inside the add's
    t = grid.start + 1e-3
    launch = spans.Event("cudaLaunchKernel", True, t, t + 1e-3, 777,
                         add.corr, False)
    dev.append(_device("k_ctypes", s0 + 0.55 * span, s0 + 0.6 * span,
                       corr=777))
    got = spans.by_span(host + [launch] + dev, 1.0)
    us = span * 1e-6
    assert got.launches == 6
    assert got.by_span["step"][1] == 4
    assert got.by_span["detect"] == [pytest.approx(0.2 * us), 2]
    assert got.by_span["sync"] == [pytest.approx(0.1 * us), 1]
    assert got.by_span["grid"] == [pytest.approx(0.15 * us), 2]
    assert got.by_span[spans.NO_SPAN] == [pytest.approx(0.5 * us), 1]
    assert got.unlinked_launches == 1
    assert got.unlinked_s == pytest.approx(0.1 * us)
    assert got.idle_in_step_s == pytest.approx(0.2 * us)
    assert got.idle_out_step_s == pytest.approx((s1 + 2 * span - (
        s0 + 0.6 * span)) * 1e-6)
    assert got.busy_s == pytest.approx(0.9 * us)


PLAIN = {"detector_stem_backend": "xla", "orientation_stem_backend": "xla",
         "grid_backend": "xla", "knn_backend": "xla"}
SMALL = {"rigs": 4, "check_ticks": 2, "chunk": 2, "trace_ticks": 2}


def _cpu_run():
    return core.run_cell("f32-ext.r64.tick", 2 ** 31 + 9, 0.5, True,
                         device="cpu", overrides={"engine": PLAIN,
                                                  "traffic": SMALL},
                         log=lambda m: None)


def test_cpu_run_with_and_without_the_recorder(monkeypatch):
    monkeypatch.setattr(spans, "HOST_SECONDS", 0.2)
    torch.set_num_threads(2)
    with_rec = set(_cpu_run()["metrics"])
    # no device operation on the CPU: only the host readings of the spans
    assert {"host.syncs", "host.sync_ms"} <= with_rec
    monkeypatch.delattr(stats, "tracing")
    monkeypatch.setattr(spans, "profile_spans", functools.partial(
        pytest.fail, "the span segment ran without a recorder"))
    without = set(_cpu_run()["metrics"])
    assert not without & set(NEW)
    assert without == with_rec - set(NEW)
