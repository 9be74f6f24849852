"""Device time a tick of the operations launched under the program's
gv.detect_heads span in the span segment (benchmark/spans.py): YOLOv4's
three 1x1 heads and their dense decode (models/yolov4.py). None where the
program opens no such span (YOLOv4-tiny, or a program without YOLOv4)."""

from benchmark.spans import device_ms


def read(rec):
    return device_ms(rec, "detect_heads")
