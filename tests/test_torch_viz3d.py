"""The port's 3D operator view (io/viz3d.py, numpy) against the JAX
package's: render_scene of the same grid, markers and cloud gives the same
pixels, for the saved RViz orbit camera and others (one looking straight
down, one close in, no grid, no robot); the camera's eye is the same."""

import numpy as np
import pytest
import torch

from grid_vision_tpu.io import viz as jviz
from grid_vision_tpu.io import viz3d as jviz3d
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io import viz, viz3d

from .test_torch_viewer import SMALL, jax_output, output_arrays, port_output

torch.set_num_threads(1)

CAMERAS = {
    "rviz": {},
    "top_down": dict(pitch=np.pi / 2, yaw=0.0, distance=30.0),
    "close": dict(distance=8.0, pitch=0.3, yaw=2.5, focal=(6.0, 1.0, 0.5),
                  fov_deg=70.0),
}


@pytest.fixture(scope="module")
def scene():
    cfg = GridVisionConfig(**SMALL)
    a = output_arrays(cfg, seed=3)
    markers = viz.markers_from_output(port_output(a))
    assert markers == jviz.markers_from_output(jax_output(a))
    meta = {"resolution": cfg.resolution, "center": list(cfg.grid_center),
            "length": [cfg.grid_x, cfg.grid_y]}
    return a, markers, meta


@pytest.mark.parametrize("cam", list(CAMERAS))
def test_render_scene_equal_to_jax(scene, cam):
    a, markers, meta = scene
    kw = CAMERAS[cam]
    np.testing.assert_array_equal(viz3d.OrbitCamera(**kw).eye(),
                                  jviz3d.OrbitCamera(**kw).eye())
    got = viz3d.render_scene(a["grid"], meta, markers, width=200,
                             height=150, cam=viz3d.OrbitCamera(**kw),
                             cloud=a["cloud"])
    ref = jviz3d.render_scene(a["grid"], meta, markers, width=200,
                              height=150, cam=jviz3d.OrbitCamera(**kw),
                              cloud=a["cloud"])
    assert got.shape == (150, 200, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 10


def test_render_scene_without_grid_or_robot(scene):
    _, markers, _ = scene
    for kw in (dict(robot=False), dict(cloud=None)):
        got = viz3d.render_scene(None, None, markers, width=96, height=72,
                                 **kw)
        ref = jviz3d.render_scene(None, None, markers, width=96, height=72,
                                  **kw)
        np.testing.assert_array_equal(got, ref)
