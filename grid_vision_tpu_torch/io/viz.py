"""Headless visualization, the RViz replacement (counterpart of
grid_vision_tpu/io/viz.py).

The reference publishes three visual surfaces (grid_vision_node.cpp:52-54):
an annotated detection image (draw_bboxes, object_detection.cpp:213-224),
a nav_msgs OccupancyGrid rendered by RViz, and a MarkerArray of spheres/
text/cubes (publishObjectVisualizations, grid_vision_node.cpp:405-523).
Headless equivalents: numpy box overlay -> PPM, grid -> PGM/PPM, markers
-> a structured dict list (JSON-serializable) mirroring the marker
content (colored spheres for lights, speed-limit text for signs, sized
cubes for L-shape objects). Everything runs on the host: StepOutput
tensors are read back first (one copy each, wherever they live).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..taxonomy import ObjectClass, class_name
from ..types import Boxes, StepOutput


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_boxes(image: np.ndarray, boxes: Boxes,
               color=(0, 255, 0), thickness: int = 2,
               labels: bool = True) -> np.ndarray:
    """Green 2px rectangles + "Label (conf)" text above each box — the
    draw_bboxes overlay (object_detection.cpp:213-224), rendered with a
    builtin bitmap font (no cv2)."""
    from .font import GLYPH_H, draw_text

    img = np.array(_host(image), np.float32, copy=True)
    h, w = img.shape[:2]
    xyxy = _host(boxes.xyxy)
    valid = _host(boxes.valid)
    confs = _host(boxes.confidence)
    lbls = _host(boxes.label)
    col = np.asarray(color, np.float32)
    for i in range(xyxy.shape[0]):
        if not valid[i]:
            continue
        x0, y0, x1, y1 = (int(v) for v in xyxy[i])
        x0, x1 = np.clip([x0, x1], 0, w - 1)
        y0, y1 = np.clip([y0, y1], 0, h - 1)
        t = thickness
        img[y0:y0 + t, x0:x1 + 1] = col
        img[max(y1 - t + 1, 0):y1 + 1, x0:x1 + 1] = col
        img[y0:y1 + 1, x0:x0 + t] = col
        img[y0:y1 + 1, max(x1 - t + 1, 0):x1 + 1] = col
        if labels:
            text = f"{class_name(int(lbls[i]))} ({confs[i]:.2f})"
            draw_text(img, text, x0, y0 - GLYPH_H - 2, color)
    return img


def markers_from_output(out: StepOutput) -> List[dict]:
    """The MarkerArray contents as plain dicts (grid_vision_node.cpp:
    405-523): traffic lights -> colored spheres (0.3 m, 0.2 s lifetime),
    speed signs -> text, dynamic objects -> blue cubes (0.1 s)."""
    markers: List[dict] = []
    mid = 0

    static_valid = _host(out.static_boxes.valid)
    static_labels = _host(out.static_boxes.label)
    static_pos = _host(out.static_points)
    light_colors = {
        int(ObjectClass.TRAFFIC_LIGHT_RED): (1.0, 0.0, 0.0),
        int(ObjectClass.TRAFFIC_LIGHT_ORANGE): (1.0, 1.0, 0.0),
        int(ObjectClass.TRAFFIC_LIGHT_GREEN): (0.0, 1.0, 0.0),
    }
    sign_text = {
        int(ObjectClass.TRAFFIC_SIGN_30): "SPEED LIMIT: 30 KMPH",
        int(ObjectClass.TRAFFIC_SIGN_60): "SPEED LIMIT: 60 KMPH",
        int(ObjectClass.TRAFFIC_SIGN_90): "SPEED LIMIT: 90 KMPH",
    }
    for i in range(static_valid.shape[0]):
        if not static_valid[i]:
            continue
        label = int(static_labels[i])
        pos = static_pos[i].tolist()
        if label in light_colors:
            markers.append({
                "ns": "traffic_light", "id": mid, "type": "sphere",
                "position": pos, "scale": [0.3, 0.3, 0.3],
                "color": light_colors[label], "lifetime_s": 0.2,
                "label": class_name(label),
            })
            mid += 1
        elif label in sign_text:
            markers.append({
                "ns": "traffic_sign", "id": mid, "type": "text",
                "position": [pos[0], pos[1], pos[2] + 1.0],
                "text": sign_text[label], "scale_z": 0.5,
                "color": (1.0, 1.0, 1.0), "lifetime_s": 0.2,
            })
            mid += 1

    poses_valid = _host(out.poses.valid)
    pos = _host(out.poses.position)
    quat = _host(out.poses.quat)
    length = _host(out.poses.length)
    width = _host(out.poses.width)
    height = _host(out.poses.height)
    for i in range(poses_valid.shape[0]):
        if not poses_valid[i]:
            continue
        markers.append({
            "ns": "lshape_bbox", "id": mid, "type": "cube",
            "position": pos[i].tolist(), "orientation": quat[i].tolist(),
            "scale": [float(length[i]), float(width[i]), float(height[i])],
            "color": (0.0, 0.5, 1.0), "lifetime_s": 0.1,
        })
        mid += 1
    return markers


def track_markers(tracks, tcfg) -> List[dict]:
    """Marker dicts for the confirmed tracks (ops/tracking.py; no
    reference counterpart: its markers are anonymous and regenerated every
    tick). Each renders as a green cube "track" whose marker id is the
    STABLE track id, plus a "track_velocity" arrow (base frame) where 3D
    state is live and the ground speed exceeds 0.05 m/s."""
    out: List[dict] = []
    conf = _host(tracks.confirmed(tcfg))
    pos = _host(tracks.position)
    vel = _host(tracks.velocity)
    hasp = _host(tracks.has_pose)
    ids = _host(tracks.id)
    labels = _host(tracks.label)
    dims = np.stack([_host(tracks.length), _host(tracks.width),
                     _host(tracks.height)], -1)
    quat = _host(tracks.quat)
    for i in range(conf.shape[0]):
        if not conf[i]:
            continue
        tid = int(ids[i])
        speed = float(np.linalg.norm(vel[i][:2]))
        out.append({
            "ns": "track", "id": tid, "type": "cube",
            "position": pos[i].tolist(), "orientation": quat[i].tolist(),
            "scale": [max(float(d), 0.2) for d in dims[i]],
            "color": (0.1, 0.9, 0.2), "lifetime_s": 0.2,
            "label": f"#{tid} {class_name(int(labels[i]))}",
            "track_id": tid,
            "velocity": vel[i].tolist() if hasp[i] else None,
            "speed_mps": speed if hasp[i] else None,
        })
        if hasp[i] and speed > 0.05:
            out.append({
                "ns": "track_velocity", "id": tid, "type": "arrow",
                "position": pos[i].tolist(),
                "direction": vel[i].tolist(),
                "scale": [float(np.linalg.norm(vel[i])), 0.1, 0.1],
                "color": (1.0, 0.6, 0.0), "lifetime_s": 0.2,
                "track_id": tid,
            })
    return out


def write_ppm(path: str, image: np.ndarray) -> None:
    img = np.clip(_host(image), 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def grid_to_rgb(occupancy_i8: np.ndarray) -> np.ndarray:
    """int8 grid -> RGB heat image (white free, black occupied, robot-
    forward is up)."""
    g = _host(occupancy_i8).astype(np.int32)
    v = np.where(g < 0, 127, 255 - (g * 255) // 100).astype(np.uint8)
    return np.stack([v, v, v], axis=-1)
