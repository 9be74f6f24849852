"""Device time a tick of the operations launched under the program's
gv.detect_backbone span in the span segment (benchmark/spans.py): YOLOv4's
CSPDarknet53: the 72 Mish convs, the residual adds and the routes
(models/yolov4.py). None where the program opens no such span (YOLOv4-tiny,
or a program without YOLOv4)."""

from benchmark.spans import device_ms


def read(rec):
    return device_ms(rec, "detect_backbone")
