"""Device time a tick of the operations launched under the program's
gv.detect span in the span segment (benchmark/spans.py): the detector (the
stem and CSP kernels, the cuDNN convs, the heads), decode and NMS."""

from benchmark.spans import device_ms


def read(rec):
    return device_ms(rec, "detect")
