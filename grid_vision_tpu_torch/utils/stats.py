"""Per-step observability (counterpart of grid_vision_tpu/utils/stats.py;
the reference's only tracing was three wall timers logged at INFO,
src/grid_vision_node.cpp:125-135, 192-224): structured stats for every
step, and a span recorder that says which layer of the tick ran when.

The tick opens named spans where its layers run (pipeline.py: "step",
"detect", "pose", "static", "grid"; inside "detect" YOLOv4's
"detect_backbone", "detect_neck" and "detect_heads", models/yolov4.py) and
a "sync" around each call that makes the host wait for the device: an NMS
sweep's test (ops/nms.py) and each copy of host data to the device (torch.tensor or torch.as_tensor
with a device, an index held on the host), which on a card waits for the
queue ahead of it. The recorder is off by default: span() then returns
one shared no-op and costs one bool test. Switched on with tracing(), each
span adds its host-clock seconds and its calls to a total by name
(snapshot(), reset()); under an active torch.profiler session it also
enters record_function("gv.<name>"), so the span lands in the profiler's
timeline beside the device kernels it launched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Dict, Optional, Tuple

import torch

logger = logging.getLogger("grid_vision_tpu_torch")


@dataclasses.dataclass
class StepStats:
    step: int
    dispatch_s: float = 0.0
    boxes_kept: Optional[int] = None
    poses_valid: Optional[int] = None
    cells_occupied: Optional[int] = None
    # Host-side ingest saturation: finite cloud points dropped by the
    # capacity subsample (device-side counters live in
    # types.SaturationStats, carried by StepOutput).
    cloud_points_dropped: int = 0


_on = False
_clock = time.perf_counter
# name -> [calls, seconds]
_totals: Dict[str, list] = {}


class _Off:
    """The span of a recorder that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(
                "gv." + self.name)
            self.annotation.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        row = _totals.get(self.name)
        if row is None:
            _totals[self.name] = [1, dt]
        else:
            row[0] += 1
            row[1] += dt
        return False


def span(name: str):
    """A context manager around one layer of the tick: the shared no-op
    while the recorder is off, else a timed span named `name`."""
    return _Span(name) if _on else _OFF


@contextlib.contextmanager
def tracing(on: bool = True):
    """Switch the span recorder on (or off) inside the block; the setting
    before it comes back after it. The totals are kept: reset() clears
    them."""
    global _on
    before, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = before


def snapshot() -> Dict[str, Tuple[int, float]]:
    """{span name: (calls, host seconds)} since the last reset()."""
    return {k: (v[0], v[1]) for k, v in _totals.items()}


def reset() -> None:
    _totals.clear()
