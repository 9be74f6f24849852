"""YOLOv4's plain reference (benchmark/detectors/yolov4.py) and the cell's
readers:

  - the controls: "leaky" is the same net with leaky 0.1 in Mish's place
    (its confidences move far), "fp8" the same detector in fp8 rounding;
  - detector_ops and detector_work count the 110 convs as the cfg has
    them;
  - the four new readers (detect.backbone_ms, detect.neck_ms,
    detect.heads_ms, yolov4_roofline) read a synthetic record, and return
    None where its spans or a detector_work are missing;
  - the module imports nothing of the program (the manifest's
    test_detector_modules_import_nothing_of_the_program covers every
    module under detectors/, this one included).
"""

import os
import types

import pytest
import torch

from benchmark import core, counts, reference as ref
from benchmark.detectors import yolov4 as y4

CELL = "yolov4-bf16.r128.ahead"
RECIPE = os.path.join(core.ROOT, "weights", "yolov4_seeded.npz")


def _nets(mode="f32"):
    ref.ieee()
    return ref.Nets(RECIPE, os.path.join(core.ROOT, "weights",
                                         "orientation.npz"), "cpu", mode)


def test_controls():
    assert y4.control("fp8") == (y4.detect_dense, "fp8")
    leaky, mode = y4.control("leaky")
    assert mode == "f32" and leaky.keywords == {"use_mish": False}
    g = torch.Generator().manual_seed(5)
    frames = torch.rand((2, 60, 80, 3), generator=g) * 255
    boxes, confs = y4.detect_dense(_nets(), frames, 64)
    assert boxes.shape == (2, 3 * (64 + 16 + 4), 4)
    _, leaky_c = leaky(_nets(), frames, 64)
    _, fp8_c = y4.detect_dense(_nets("fp8"), frames, 64)
    assert (leaky_c - confs).abs().max() > 0.1
    assert (fp8_c - confs).abs().max() > 1e-3


def test_counts():
    assert len(y4.convs()) == 110
    assert y4.detector_ops(416) == 59_595_986_944
    assert y4.detector_ops(416, 80) == 60_104_771_584
    work = y4.detector_work(416)
    names = [n for n, _, _ in work]
    assert sum(n.startswith("ConvBN_") for n in names) == 107
    assert sum(n.startswith("head_") for n in names) == 3
    assert sum(n.startswith("decode_") for n in names) == 3
    # ConvBN_0: 3 -> 32 at 416, 3x3: 2 * 416^2 * 32 * 27 operations, the
    # frame in, the weights and bias, the output out, in bf16
    assert work[0] == ("ConvBN_0", 2 * 416 * 416 * 32 * 27,
                       (416 * 416 * 3 + 32 * 27 + 32 + 416 * 416 * 32) * 2)
    # the least time of a 128-frame tick at the bf16 peak
    t = y4.bound_s(416, 128, counts.PEAKS["bf16_flops_per_s"],
                   counts.PEAKS["hbm_bytes_per_s"])
    assert 0.0155 < t < 0.0185


def _rec(workload=CELL, by_span=None, seen=None):
    _, _, config, traffic, _ = core.load_cell(workload)
    rec = types.SimpleNamespace(config=config, traffic=traffic,
                                peak_ops=counts.PEAKS[config["peak"]])
    by_span = by_span if by_span is not None else {
        "detect_backbone": [0.09, 300], "detect_neck": [0.024, 90],
        "detect_heads": [0.002, 12]}
    rec.spans = types.SimpleNamespace(
        launches=500, ticks=2, seen=seen if seen is not None else
        ["step", "detect", *by_span], by_span=by_span)
    return rec


def test_readers_on_a_record():
    rec = _rec()
    assert core.reader("detect.backbone_ms")(rec) == pytest.approx(45.0)
    assert core.reader("detect.neck_ms")(rec) == pytest.approx(12.0)
    assert core.reader("detect.heads_ms")(rec) == pytest.approx(1.0)
    bound = y4.bound_s(416, 128, counts.PEAKS["bf16_flops_per_s"],
                       counts.PEAKS["hbm_bytes_per_s"])
    assert core.reader("yolov4_roofline")(rec) == pytest.approx(
        100.0 * bound / 0.058)


def test_readers_find_nothing():
    # the parent's program: no gv.detect_* spans
    rec = _rec(by_span={"detect": [0.1, 300]}, seen=["step", "detect"])
    for name in ("detect.backbone_ms", "detect.neck_ms", "detect.heads_ms",
                 "yolov4_roofline"):
        assert core.reader(name)(rec) is None, name
    # a configuration whose detector has no detector_work
    rec = _rec("bf16-fleet.r128.ahead")
    assert core.reader("yolov4_roofline")(rec) is None
    # no span segment at all
    rec = _rec()
    rec.spans = None
    assert core.reader("yolov4_roofline")(rec) is None
