"""Model operations of the window over its wall time, as a share of the
configuration's peak: the detector on every frame (its module's
detector_ops, core.detector: YOLOv4-tiny's 19 convs and two heads unless
the configuration names another) and the orientation net on the valid
crops only, counted from the shapes by counts.py."""

from benchmark import core, counts
from benchmark.readers import counted, engine


def read(rec):
    e = engine(rec)
    ops = rec.frames * core.detector(rec.config).detector_ops(
        e["detection_network_input_size"])
    ops += counted(rec, 1).sum() * counts.orientation_ops(
        e["network_height"], e["orientation_width"])
    return 100.0 * ops / rec.window_s / rec.peak_ops
