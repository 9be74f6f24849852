"""The port's `.onnx` detector weights (models/onnx_import.py and the
`.onnx` branch of weights.load_all), on the CPU, against the JAX package.

The reference node loads its detector from an ONNX file
(object_detection.cpp:41-58). The files here are written by the JAX
package's own exporter (grid_vision_tpu/models/onnx_import.py) from the
shipped weights/detector.npz, in both of its styles: "flax" (tensors in
execution order) and "pytorch" (darknet-indexed names, shuffled
initializers, the neck branches serialized out of darknet order, a decode
subgraph). Loaded through the port they must give the detector the npz
file gives, bit for bit, through an absolute path and through one relative
to base_dir, and one pipeline step configured with either file must give
the same outputs. The port's exporter writes the JAX one's bytes; the
reader passes the JAX test's hand-encoded protobuf bytes and raises with
its messages.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from grid_vision_tpu.models import onnx_import as jonnx
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.models import onnx_import, weights, yolov4_tiny
from grid_vision_tpu_torch.runtime.stream import obs_from_scene
from grid_vision_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "weights", "detector.npz")
STYLES = ("flax", "pytorch")


def _tree():
    return checkpoint.load_npz_tree(NPZ)


def _write(tmp_path, style, name=None):
    path = str(tmp_path / (name or f"yolov4_{style}.onnx"))
    jonnx.export_yolov4_tiny(_tree(), path, style=style)
    return path


def _detector(path, base_dir=ROOT):
    cfg = GridVisionConfig(detection_weights_file=path)
    return weights.load_all(cfg, base_dir=base_dir, device="cpu")["detector"]


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("style", STYLES)
def test_onnx_loads_bit_equal_to_npz(tmp_path, style):
    """An absolute .onnx path and one relative to base_dir (the YAML's
    leading '/' convention) give the npz file's detector."""
    ref = _detector(NPZ)
    path = _write(tmp_path, style)
    _assert_same_state(_detector(path), ref)
    rel = "/" + os.path.basename(path)
    _assert_same_state(_detector(rel, base_dir=str(tmp_path)), ref)


@pytest.mark.parametrize("style", STYLES)
def test_export_writes_the_jax_bytes(tmp_path, style):
    """The port's exporter, fed the port's own module as a flax tree,
    writes the JAX exporter's bytes; the reader gives back every leaf."""
    mine = str(tmp_path / "port.onnx")
    onnx_import.export_yolov4_tiny(weights.flax_tree(_detector(NPZ)), mine,
                                   style=style)
    theirs = _write(tmp_path, style)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    tmpl = weights.flax_tree(yolov4_tiny.YoloV4Tiny(yolov4_tiny.YoloConfig()))
    got = checkpoint.tree_to_flat(onnx_import.import_yolov4_tiny(mine, tmpl))
    want = checkpoint.tree_to_flat(_tree())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flax_tree_inverts_params_from_jax():
    tree = _tree()
    det = yolov4_tiny.YoloV4Tiny(yolov4_tiny.YoloConfig())
    weights.load_module(det, tree)
    got = checkpoint.tree_to_flat(weights.flax_tree(det))
    want = checkpoint.tree_to_flat(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_missing_onnx_warns_and_inits_randomly(tmp_path, caplog):
    """As the JAX package's load_all: a configured .onnx file that is not
    there warns and the detector gets the random init (the one an empty
    configuration gives)."""
    missing = str(tmp_path / "yolov4_absent.onnx")
    with caplog.at_level(logging.WARNING, "grid_vision_tpu_torch.weights"):
        det = _detector(missing, base_dir=str(tmp_path))
    assert any("not found" in r.getMessage() and "yolov4_absent.onnx"
               in r.getMessage() for r in caplog.records)
    _assert_same_state(det, _detector(""))


def test_wire_format_reader_against_hand_encoded_bytes():
    """The JAX test's hand-encoded TensorProto, NodeProto and varint
    (tests/test_onnx_import.py), through the port's reader."""
    floats = np.arange(6, dtype="<f4")
    tensor = bytes([0x08, 0x02, 0x08, 0x03, 0x10, 0x01, 0x42, 0x01,
                    ord("t"), 0x4A, 24]) + floats.tobytes()
    name, arr = onnx_import._parse_tensor(tensor)
    assert name == "t" and arr.shape == (2, 3)
    np.testing.assert_array_equal(arr, floats.reshape(2, 3))
    node = bytes([0x0A, 0x01, ord("a"), 0x0A, 0x01, ord("w"), 0x12, 0x01,
                  ord("y"), 0x1A, 0x01, ord("n"), 0x22, 0x04]) + b"Conv"
    assert onnx_import._parse_node(node) == {
        "inputs": ["a", "w"], "outputs": ["y"], "name": "n",
        "op_type": "Conv"}
    val, pos = onnx_import._read_varint(bytes([0xAC, 0x02]), 0)
    assert val == 300 and pos == 2


def _five_classes():
    return weights.flax_tree(yolov4_tiny.YoloV4Tiny(
        yolov4_tiny.YoloConfig(num_classes=5)))


@pytest.mark.parametrize("style,match", [("flax", "shape"),
                                         ("pytorch", "first unmatched node")])
def test_wrong_shapes_raise_naming_the_node(tmp_path, style, match):
    """Imported into a 5-class model the heads do not fit: the error names
    the first unmatched node and both shapes, as the JAX importer's."""
    path = _write(tmp_path, style)
    with pytest.raises(ValueError, match=match) as got:
        onnx_import.import_yolov4_tiny(path, _five_classes())
    with pytest.raises(ValueError) as want:
        jonnx.import_yolov4_tiny(path, _five_classes())
    assert str(got.value) == str(want.value)


def test_wrong_conv_count_lists_convs(tmp_path):
    path = _write(tmp_path, "flax")
    nodes, inits = onnx_import.load_graph(path)
    body = b""
    for n in nodes[:5]:
        body += onnx_import._len_field(1, onnx_import._node_bytes(
            n["op_type"], n["name"], n["inputs"], n["outputs"]))
    for name, arr in inits.items():
        body += onnx_import._len_field(5, onnx_import._tensor_bytes(name,
                                                                    arr))
    bad = str(tmp_path / "short.onnx")
    with open(bad, "wb") as f:
        f.write(onnx_import._tag(1, 0) + onnx_import._write_varint(8)
                + onnx_import._len_field(7, body))
    tmpl = weights.flax_tree(yolov4_tiny.YoloV4Tiny(yolov4_tiny.YoloConfig()))
    with pytest.raises(ValueError, match="expected 21 Conv") as got:
        onnx_import.import_yolov4_tiny(bad, tmpl)
    with pytest.raises(ValueError) as want:
        jonnx.import_yolov4_tiny(bad, _tree())
    assert str(got.value) == str(want.value)


# a reduced single-rig tick (as tests/test_torch_pipeline.py's), the shipped
# detector from either file (the orientation net's random init is the same
# in both runs)
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, detector_stem_backend="pallas",
             grid_backend="pallas", knn_backend="pallas")


def test_step_with_onnx_equals_step_with_npz(tmp_path):
    path = _write(tmp_path, "pytorch")
    outs = []
    for det_file in ("weights/detector.npz", path):
        cfg = GridVisionConfig(**SMALL, detection_weights_file=det_file)
        eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                              device="cpu", base_dir=ROOT)
        scene = SyntheticScene(cfg, seed=3, n_ground=600)
        scene.add_default_traffic()
        scene.add_default_statics()
        state = eng.init_state()
        ticks = []
        for i in range(2):
            state, out = eng(state, obs_from_scene(scene, i / 10.0, cfg,
                                                   "cpu"))
            ticks.append(out)
        outs.append((state, ticks))
    (sa, ta), (sb, tb) = outs
    assert torch.equal(sa.log_odds, sb.log_odds)
    for a, b in zip(ta, tb):
        for f in ("xyxy", "confidence", "label", "valid"):
            assert torch.equal(getattr(a.boxes, f), getattr(b.boxes, f)), f
        assert torch.equal(a.occupancy_i8, b.occupancy_i8)
        assert torch.equal(a.poses.valid, b.poses.valid)
        assert a.poses.valid.any()                # the run has a pose
        assert torch.allclose(a.poses.position, b.poses.position, rtol=0,
                              atol=0, equal_nan=True)  # invalid slots: NaN


def test_import_pulls_in_no_jax():
    code = ("import sys, grid_vision_tpu_torch.models.onnx_import,"
            " grid_vision_tpu_torch.models.weights; bad = [m for m in"
            " sys.modules if m in ('jax', 'flax', 'grid_vision_tpu') or"
            " m.startswith(('jax.', 'flax.', 'grid_vision_tpu.'))];"
            " print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
