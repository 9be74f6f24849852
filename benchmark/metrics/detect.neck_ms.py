"""Device time a tick of the operations launched under the program's
gv.detect_neck span in the span segment (benchmark/spans.py): YOLOv4's SPP
(max pools 5, 9, 13) and PANet: the 35 leaky convs, the upsamples and the
routes (models/yolov4.py). None where the program opens no such span
(YOLOv4-tiny, or a program without YOLOv4)."""

from benchmark.spans import device_ms


def read(rec):
    return device_ms(rec, "detect_neck")
