"""The 10-class object taxonomy and its static/dynamic split (reference
object_detection.hpp:12-25, grid_vision_node.cpp:384-403,
occupancy_grid.cpp:185-196, vision_orientation.hpp:57-69)."""

from __future__ import annotations

import enum

import numpy as np
import torch

from .utils import stats


class ObjectClass(enum.IntEnum):
    BIKE = 0
    MOTORBIKE = 1
    PERSON = 2
    TRAFFIC_LIGHT_GREEN = 3
    TRAFFIC_LIGHT_ORANGE = 4
    TRAFFIC_LIGHT_RED = 5
    TRAFFIC_SIGN_30 = 6
    TRAFFIC_SIGN_60 = 7
    TRAFFIC_SIGN_90 = 8
    VEHICLE = 9
    UNKNOWN = 10


NUM_CLASSES = 10

CLASS_NAMES = {
    ObjectClass.BIKE: "Bike",
    ObjectClass.MOTORBIKE: "Motorbike",
    ObjectClass.PERSON: "Person",
    ObjectClass.TRAFFIC_LIGHT_GREEN: "Light Green",
    ObjectClass.TRAFFIC_LIGHT_ORANGE: "Light Orange",
    ObjectClass.TRAFFIC_LIGHT_RED: "Light Red",
    ObjectClass.TRAFFIC_SIGN_30: "Sign 30",
    ObjectClass.TRAFFIC_SIGN_60: "Sign 60",
    ObjectClass.TRAFFIC_SIGN_90: "Sign 90",
    ObjectClass.VEHICLE: "Vehicle",
    ObjectClass.UNKNOWN: "Unknown",
}


def class_name(label: int) -> str:
    try:
        return CLASS_NAMES[ObjectClass(int(label))]
    except ValueError:
        return "Unknown"


_DYNAMIC = (ObjectClass.VEHICLE, ObjectClass.BIKE, ObjectClass.MOTORBIKE,
            ObjectClass.PERSON)

DYNAMIC_LUT = np.zeros(11, dtype=bool)
for _c in _DYNAMIC:
    DYNAMIC_LUT[int(_c)] = True

ESTIMATED_DEPTH_LUT = np.full(11, -1.0, dtype=np.float32)
ESTIMATED_DEPTH_LUT[int(ObjectClass.VEHICLE)] = 3.5
ESTIMATED_DEPTH_LUT[int(ObjectClass.PERSON)] = 0.6
ESTIMATED_DEPTH_LUT[int(ObjectClass.BIKE)] = 2.5
ESTIMATED_DEPTH_LUT[int(ObjectClass.MOTORBIKE)] = 2.5

AVG_DIMS_LUT = np.zeros((11, 3), dtype=np.float32)
AVG_DIMS_LUT[int(ObjectClass.VEHICLE)] = (3.884, 1.629, 1.526)
AVG_DIMS_LUT[int(ObjectClass.BIKE)] = (1.763, 0.597, 1.737)
AVG_DIMS_LUT[int(ObjectClass.MOTORBIKE)] = (2.2, 0.8, 1.5)
AVG_DIMS_LUT[int(ObjectClass.PERSON)] = (0.842, 0.660, 1.761)


def _lookup(lut: np.ndarray, labels: torch.Tensor) -> torch.Tensor:
    with stats.span("sync"):
        table = torch.as_tensor(lut, device=labels.device)
    return table[labels.long().clamp(0, 10)]


def is_dynamic(labels: torch.Tensor) -> torch.Tensor:
    """Vectorized dynamic/static split of int class ids (DYNAMIC_LUT),
    compared against the class ids on the labels' device: no table is
    copied there, so the card's host does not wait on a copy."""
    labels = labels.clamp(0, 10)
    out = labels == int(_DYNAMIC[0])
    for c in _DYNAMIC[1:]:
        out = out | (labels == int(c))
    return out


def estimated_depth(labels: torch.Tensor) -> torch.Tensor:
    return _lookup(ESTIMATED_DEPTH_LUT, labels)


def avg_dims(labels: torch.Tensor) -> torch.Tensor:
    """(N,) int labels -> (N, 3) average (length, width, height)."""
    return _lookup(AVG_DIMS_LUT, labels)
