"""Model operations of the window over its wall time, as a share of the
configuration's peak: the detector's 19 convs and two heads on every
frame and the orientation net on the valid crops only, counted from the
shapes by counts.py."""

from benchmark import counts
from benchmark.readers import counted, engine


def read(rec):
    e = engine(rec)
    ops = rec.frames * counts.detector_ops(e["detection_network_input_size"])
    ops += counted(rec, 1).sum() * counts.orientation_ops(
        e["network_height"], e["orientation_width"])
    return 100.0 * ops / rec.window_s / rec.peak_ops
