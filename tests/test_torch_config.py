"""The torch port's config mirrors the JAX package's key for key: field
names, defaults, validate() and the ROS-YAML loader. The port's own keys
(tcfg.PORT_ONLY: detector_arch, whose default is the JAX package's only
detector) are checked apart."""

import dataclasses

import pytest
import torch

from grid_vision_tpu import config as jcfg
from grid_vision_tpu_torch import config as tcfg

torch.set_num_threads(1)

YAML = "config/grid_vision_cfg.yaml"


def test_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.GridVisionConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.GridVisionConfig)
          if f.name not in tcfg.PORT_ONLY]
    assert tf == jf                      # same names, order and defaults
    own = {f.name: f.default for f in dataclasses.fields(tcfg.GridVisionConfig)
           if f.name in tcfg.PORT_ONLY}
    assert own == {"detector_arch": "yolov4-tiny"}
    assert tcfg.shared_dict(tcfg.GridVisionConfig()) == dataclasses.asdict(
        jcfg.GridVisionConfig())
    j, t = jcfg.GridVisionConfig(), tcfg.GridVisionConfig()
    assert (t.grid_size, t.grid_center, t.resize) == \
        (j.grid_size, j.grid_center, j.resize)


@pytest.mark.parametrize("overrides", [
    {},
    {"resolution": 0.0},
    {"confidence_threshold": 1.5},
    {"iou_threshold": -0.1},
    {"max_candidates": 8, "max_detections": 64},
    {"raycast_free_space": True},
    {"raycast_free_space": True, "compat": False},
    {"detector_stem_backend": "bogus"},
    {"detector_stem_backend": "pallas", "detector_precision": "int8",
     "compat": False},
    {"orientation_compute": "half"},
    {"orientation_arch": "vit"},
    {"orientation_stem_backend": "pallas", "orientation_s2d_fold": False},
    {"orientation_stem_backend": "pallas", "network_height": 100},
    {"wire_image_codec": "yuv420", "camera_image_height": 481},
    {"k_near": 0},
    {"max_static_depth": -1},
])
def test_validate_matches(overrides):
    def outcome(mod):
        try:
            mod.GridVisionConfig(**overrides).validate()
            return None
        except ValueError as e:
            return str(e)
    assert outcome(tcfg) == outcome(jcfg)


def test_load_config_yaml_matches():
    assert tcfg.load_config(YAML) == tcfg.GridVisionConfig(
        **dataclasses.asdict(jcfg.load_config(YAML)))


def test_load_config_rejects_unknown_keys(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("/**:\n  ros__parameters:\n    not_a_key: 1\n")
    with pytest.raises(KeyError, match="not_a_key"):
        tcfg.load_config(str(p))
