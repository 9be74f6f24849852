"""Device time a tick of the operations launched under the program's
gv.static span in the span segment (benchmark/spans.py): the static branch
(the cloud to the camera frame, projection, the kNN, the static points)."""

from benchmark.spans import device_ms


def read(rec):
    return device_ms(rec, "static")
