"""Shared arithmetic of the metric readers (metrics/<name>.py): means over
the window's ticks, and kernels' times and roofline shares from the
traced segment. A reader that finds nothing to read returns None."""

from __future__ import annotations

import sys

import numpy as np

from . import counts

# cuDNN / cuBLAS conv and GEMM kernels, by name
LIBRARY_WORDS = ("conv", "fprop", "implicit", "cudnn", "gemm", "xmma",
                 "cutlass", "wgrad", "dgrad")


def mean_ms(rec, key: str):
    vals = [t[key] for t in rec.ticks if key in t]
    return float(np.mean(vals)) * 1e3 if vals else None


def counted(rec, i: int) -> np.ndarray:
    """Column i of the ticks' counters (0 boxes, 1 crops run, 2 crops
    dropped by the budget), summed over the rigs, one entry a tick."""
    return np.array([t["counts"][i] for t in rec.ticks], np.float64)


def kernel_s(rec, include, exclude=()):
    """Device seconds of the traced kernels whose name holds a word of
    `include` and none of `exclude`; None when none ran."""
    if rec.trace is None:
        return None
    hit = [v[0] for n, v in rec.trace.by_name.items()
           if any(w in n for w in include) and not any(w in n for w in
                                                       exclude)]
    return sum(hit) if hit else None


def roofline(rec, name: str, include, exclude, work,
             peak: str | None = None) -> float | None:
    """100 x the least time the traced ticks' work (bytes, ops) could take
    over the named kernels' device time, the operations at the peak named
    (peaks.json; the configuration's without); the bound that limits it
    goes to standard error."""
    t = kernel_s(rec, include, exclude)
    if t is None or not rec.work or not rec.work["ticks"]:
        return None
    n_bytes, ops = work(rec)
    bound, by = counts.bound_s(n_bytes, ops, rec.peak_ops if peak is None
                               else counts.PEAKS[peak])
    print(f"[bench] {name}: bound by {by}", file=sys.stderr)
    return 100.0 * bound / t


def engine(rec):
    return rec.config["engine"]


def elem(rec) -> int:
    """The kernels' element size: 2 in bfloat16, 4 in float32."""
    return 2 if engine(rec)["compute_dtype"] == "bfloat16" else 4


def stem(rec):
    e = engine(rec)
    return counts.stem_work(rec.work["frames"], e["camera_image_height"],
                            e["camera_image_width"],
                            e["detection_network_input_size"], elem(rec))


def csp(rec):
    return counts.csp_work(rec.work["frames"],
                           engine(rec)["detection_network_input_size"],
                           elem(rec))


def orient(rec):
    e = engine(rec)
    return counts.orient_work(rec.work["crops"],
                              rec.work["tapped_pixels"] * 3 * elem(rec),
                              e["network_height"], e["orientation_width"],
                              elem(rec))


def int8_conv(rec):
    return counts.int8_conv_work(rec.work["frames"],
                                 engine(rec)["detection_network_input_size"])
