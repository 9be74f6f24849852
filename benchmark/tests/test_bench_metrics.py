"""The end-to-end metrics are taken over all ticks (a stalled tick moves
both), and the yardstick's counts reproduce the port's records from the
shapes alone."""

import types

import numpy as np
import pytest

from benchmark import core, counts


def _rec(lat_s):
    ticks = [{"dispatch_s": t * 0.8, "readback_s": t * 0.2, "latency_s": t,
              "counts": np.array([8, 3, 0])} for t in lat_s]
    return types.SimpleNamespace(ticks=ticks, window_s=float(sum(lat_s)),
                                 frames=64 * len(lat_s))


def test_stalled_tick_moves_rate_and_tail():
    steady = [0.035] * 200
    stalled = list(steady)
    stalled[-11:] = [0.2] * 11
    fps, p95 = core.reader("frames_per_s"), core.reader("tick_ms_p95")
    assert fps(_rec(steady)) == pytest.approx(64 / 0.035)
    assert p95(_rec(steady)) == pytest.approx(35.0)
    assert fps(_rec(stalled)) < fps(_rec(steady)) * 0.9
    assert p95(_rec(stalled)) == pytest.approx(200.0)
    one = list(steady)
    one[0] = 0.5
    assert fps(_rec(one)) < fps(_rec(steady))


def test_host_means():
    rec = _rec([0.03, 0.05])
    assert core.reader("host.dispatch_ms")(rec) == pytest.approx(32.0)
    assert core.reader("tick.readback_ms")(rec) == pytest.approx(8.0)
    assert core.reader("pose.crops")(rec) == 3.0
    assert core.reader("pose.dropped_pct")(rec) == 0.0


def test_detector_ops():
    # the 19 convs at one frame (phase int8's "ops")
    assert counts.detector_conv_ops(416) == 6_775_488_512


def test_kernel_bounds():
    # the bf16 stem's byte bound at 64 frames (PERF.md, row 1 of the bf16
    # forms: 0.0617 ms, bytes) and the CSP stage's operation bound (row 6:
    # 0.0831 ms, operations; bytes 0.0397)
    t, by = counts.bound_s(*counts.stem_work(64, 480, 640, 416, 2),
                           counts.PEAKS["bf16_flops_per_s"])
    assert by == "bytes" and t * 1e3 == pytest.approx(0.0617, abs=5e-5)
    b, ops = counts.csp_work(64, 416, 2)
    t, by = counts.bound_s(b, ops, counts.PEAKS["bf16_flops_per_s"])
    assert by == "operations" and t * 1e3 == pytest.approx(0.0831, abs=5e-5)
    assert b / counts.PEAKS["hbm_bytes_per_s"] * 1e3 == pytest.approx(
        0.0397, abs=5e-5)


def test_orientation_and_taps():
    assert counts.orientation_ops(224, 32) > 0
    # a box's taps: rows and columns of nonzero weight, each pixel once
    xyxy = np.array([[10.0, 20.0, 110.0, 70.0], [10.0, 20.0, 110.0, 70.0]])
    one = counts.tapped_pixels(xyxy[:1], np.array([0]), 480, 640, 224)
    assert one == counts.tapped_pixels(xyxy, np.array([0, 0]), 480, 640, 224)
    assert 2 * one == counts.tapped_pixels(xyxy, np.array([0, 1]), 480, 640,
                                           224)
    assert one <= 100 * 50


def test_mfu_counts_frames_and_crops():
    rec = _rec([0.035] * 10)
    rec.config = {"engine": {"detection_network_input_size": 416,
                             "network_height": 224,
                             "orientation_width": 32}}
    rec.peak_ops = counts.PEAKS["bf16_flops_per_s"]
    want = (640 * counts.detector_ops(416)
            + 30 * counts.orientation_ops(224, 32)) / 0.35 / 989e12 * 100
    assert core.reader("step.mfu")(rec) == pytest.approx(want)


def test_int8_conv_work():
    # the int8 conv at 64 frames (PERF.md, row 8 of the port's kernels:
    # 1.96 GB, 433.6 GOP, bound 0.585 ms by bytes)
    n_bytes, ops = counts.int8_conv_work(64, 416)
    assert n_bytes / 1e9 == pytest.approx(1.96, abs=0.005)
    assert ops / 1e9 == pytest.approx(433.6, abs=0.05)
    t, by = counts.bound_s(n_bytes, ops, counts.PEAKS["int8_ops_per_s"])
    assert by == "bytes" and t * 1e3 == pytest.approx(0.585, abs=5e-4)


def test_int8_conv_roofline_reads_its_kernel():
    rec = types.SimpleNamespace(
        config={"engine": {"detection_network_input_size": 416}},
        work={"ticks": 2, "frames": 128},
        trace=types.SimpleNamespace(by_name={
            "void gv_int8_conv_kernel<signed char, 256, 1>(Conv)": [2e-3, 38],
            "void gv_orient_kernel(...)": [1.0, 2]}),
        peak_ops=counts.PEAKS["tf32_flops_per_s"])
    read = core.reader("int8_conv_roofline")
    bound, _ = counts.bound_s(*counts.int8_conv_work(128, 416),
                              counts.PEAKS["int8_ops_per_s"])
    assert read(rec) == pytest.approx(100.0 * bound / 2e-3)
    rec.trace.by_name.pop(next(iter(rec.trace.by_name)))
    assert read(rec) is None
