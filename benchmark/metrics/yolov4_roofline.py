"""The share of its roofline of YOLOv4's forward (the backbone, the neck
and the heads with their dense decode): the least time the span segment's
frames could take, per layer the larger of its operations at the
configuration's peak and its bytes at the HBM rate (the detector module's
detector_work, in the configuration's element size), over the device time
under the gv.detect_backbone, gv.detect_neck and gv.detect_heads spans. It
shows how far cuDNN's convs and the elementwise passes stand from the chip
on these shapes. None without those spans or a detector_work."""

import sys

from benchmark import core, counts
from benchmark.readers import elem, engine
from benchmark.spans import device_ms

SPANS = ("detect_backbone", "detect_neck", "detect_heads")


def read(rec):
    det = core.detector(rec.config)
    ms = [device_ms(rec, name) for name in SPANS]
    if not hasattr(det, "bound_s") or None in ms or sum(ms) <= 0:
        return None
    size = engine(rec)["detection_network_input_size"]
    hbm = counts.PEAKS["hbm_bytes_per_s"]
    work = det.detector_work(size, elem(rec))
    n_ops = sum(1 for _, ops, n in work if ops / rec.peak_ops >= n / hbm)
    print(f"[bench] yolov4_roofline: {n_ops} of {len(work)} layers bound "
          f"by operations, the rest by bytes", file=sys.stderr)
    bound = det.bound_s(size, rec.traffic["rigs"], rec.peak_ops, hbm,
                        elem(rec))
    return 100.0 * bound / (sum(ms) * 1e-3)
