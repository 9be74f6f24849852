"""YOLOv4 (models/yolov4.py, detector_arch="yolov4") on the CPU, against
darknet's cfg/yolov4.cfg and the benchmark's plain reference
(benchmark/detectors/yolov4.py, which imports nothing of the program):

- the layer list: 162 layers, 110 convs (72 Mish, 35 leaky, 3 heads), the
  routes' and shortcuts' sources; the reference's table conv for conv;
- at 416 (on the meta device: shapes only) three heads of 52, 26 and 13
  squared x 45 and 10647 anchors; the parameter count, derived layer by
  layer below, at 10 and at 80 classes (80: darknet's 64,363,101);
- the forward at input 96, batch 2, in f32 on the shipped recipe
  (weights/yolov4_seeded.npz), BatchNorms folded as the engine serves,
  against the reference's unfolded forward: boxes and confidences to 2e-4
  (the fold rounds each layer's scale and shift once in f32, about an ulp
  a layer; over 107 layers and the heads' logit gain of 8 the largest
  difference reads ~1e-5 on these frames);
- both expansions of the recipe bit-equal at full size;
- the three-head decode against an anchor of each head by hand;
- Engine.fleet at 4 rigs and input 128 against reference.fleet_tick with
  the module's detect_dense, through the benchmark's judge, held to the
  f32 cell's limits;
- validate refuses the tiny's stem kernels, detector_s2d_stem and int8
  with YOLOv4; the default configuration is still YOLOv4-tiny.
"""

import math
import os
import types

import numpy as np
import pytest
import torch

from benchmark import core, judge, reference as ref
from benchmark.detectors import yolov4 as plain
from grid_vision_tpu_torch import pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights, yolov4, yolov4_tiny
from grid_vision_tpu_torch.utils import checkpoint, stats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "weights", "yolov4_seeded.npz")
# the shipped recipe's seed and gains with an objectness bias that puts
# boxes above 0.6 on the pool's frames at input 128
TEST_RECIPE = dict(seed=4170416, mish_gain=1.55, leaky_gain=1.45,
                   bn_spread=0.1, res_scale=0.3, box_gain=0.3,
                   logit_gain=8.0, obj_bias=[-4.0] * 3,
                   cls_bias=[2.0, 2.0, 2.0] + [0.0] * 6 + [2.0])


def _recipe(path, values):
    np.savez(path, **{f"['params']/['recipe']/['{k}']":
                      np.asarray(v, np.float32) for k, v in values.items()})
    return path


def test_layer_list_matches_cfg():
    layers = yolov4.darknet_layers()
    kinds = [l.kind for l in layers]
    assert len(layers) == 162
    assert kinds.count("conv") + kinds.count("head") == 110
    assert [l.act for l in layers if l.kind == "conv"].count("mish") == 72
    assert [l.act for l in layers if l.kind == "conv"].count("leaky") == 35
    assert [i for i, k in enumerate(kinds) if k == "head"] == [138, 149, 160]
    assert [i for i, k in enumerate(kinds) if k == "yolo"] == [139, 150, 161]
    assert kinds.count("shortcut") == 1 + 2 + 8 + 8 + 4
    assert all(l.src == (i - 3,) for i, l in enumerate(layers)
               if l.kind == "shortcut")
    routes = {i: l.src for i, l in enumerate(layers) if l.kind == "route"}
    assert routes == {3: (1,), 9: (8, 2), 13: (11,), 22: (21, 12),
                      26: (24,), 53: (52, 25), 57: (55,), 84: (83, 56),
                      88: (86,), 103: (102, 87), 109: (107,), 111: (107,),
                      113: (112, 110, 108, 107), 119: (85,),
                      121: (120, 118), 129: (54,), 131: (130, 128),
                      140: (136,), 142: (141, 126), 151: (147,),
                      153: (152, 116)}
    assert [l.size for l in layers if l.kind == "maxpool"] == [5, 9, 13]
    assert [i for i, l in enumerate(layers) if l.kind == "conv"
            and l.stride == 2] == [1, 11, 24, 55, 86, 141, 152]
    chans = yolov4.out_channels(layers)
    assert [chans[i] for i in (23, 54, 85, 104, 113, 137, 148, 159)] == \
        [128, 256, 512, 1024, 2048, 256, 512, 1024]
    # the reference's own table, conv for conv
    mine = [(n, ci, co, k, s, a) for n, ci, co, k, s, a, _ in
            yolov4.conv_specs()]
    theirs = [(n, ci, co, k, s, a) for n, ci, co, k, s, a, _ in
              plain.convs()]
    assert mine == theirs
    assert yolov4.residual_ends() == tuple(
        n for n, *_, ends in plain.convs() if ends)


def test_heads_and_anchors_at_416():
    with torch.device("meta"):
        model = yolov4.YoloV4(yolov4.YoloV4Config(input_size=416))
        heads = model(torch.empty(1, 416, 416, 3))
        boxes, confs = yolov4.decode(model, heads)
    assert [tuple(h.shape) for h in heads] == [(1, 52, 52, 45),
                                              (1, 26, 26, 45),
                                              (1, 13, 13, 45)]
    assert boxes.shape == (1, 10647, 4) and confs.shape == (1, 10647, 10)
    assert 3 * (52 * 52 + 26 * 26 + 13 * 13) == 10647


def _count(classes: int) -> int:
    """yolov4.cfg's parameters, layer by layer: a k x k conv from c to f
    channels has k k c f weights and, with its BatchNorm, f scales and f
    biases (the running statistics are not parameters); a head has its
    weights and f biases."""
    def conv(c, f, k):
        return k * k * c * f + 2 * f

    n = conv(3, 32, 3)                                   # layer 0
    # stage 0: 1, 2, 4, residual 5-6, 8, 10
    n += conv(32, 64, 3) + conv(64, 64, 1) + conv(64, 64, 1) + \
        conv(64, 32, 1) + conv(32, 64, 3) + conv(64, 64, 1) + \
        conv(128, 64, 1)
    for c, blocks in ((128, 2), (256, 8), (512, 8), (1024, 4)):
        h = c // 2          # down, two parts, blocks, the end, transition
        n += conv(c // 2, c, 3) + conv(c, h, 1) + conv(c, h, 1) + \
            blocks * (conv(h, h, 1) + conv(h, h, 3)) + conv(h, h, 1) + \
            conv(c, c, 1)
    n += conv(1024, 512, 1) + conv(512, 1024, 3) + conv(1024, 512, 1)
    n += conv(2048, 512, 1) + conv(512, 1024, 3) + conv(1024, 512, 1)
    n += conv(512, 256, 1) + conv(512, 256, 1)           # 117, 120
    n += conv(512, 256, 1) + 2 * (conv(256, 512, 3) + conv(512, 256, 1))
    n += conv(256, 128, 1) + conv(256, 128, 1)           # 127, 130
    n += conv(256, 128, 1) + 2 * (conv(128, 256, 3) + conv(256, 128, 1))
    out = 3 * (5 + classes)
    n += conv(128, 256, 3) + 256 * out + out             # 137, head 52
    n += conv(128, 256, 3) + conv(512, 256, 1) + \
        2 * (conv(256, 512, 3) + conv(512, 256, 1)) + conv(256, 512, 3)
    n += 512 * out + out                                 # head 26
    n += conv(256, 512, 3) + conv(1024, 512, 1) + \
        2 * (conv(512, 1024, 3) + conv(1024, 512, 1)) + conv(512, 1024, 3)
    n += 1024 * out + out                                # head 13
    return n


@pytest.mark.parametrize("classes,count", [(10, 63986151), (80, 64363101)])
def test_parameter_count(classes, count):
    assert _count(classes) == count
    with torch.device("meta"):
        model = yolov4.YoloV4(yolov4.YoloV4Config(num_classes=classes))
    assert sum(p.numel() for p in model.parameters()) == count


def _nets(path, device="cpu"):
    return ref.Nets(path, os.path.join(REPO, "weights", "orientation.npz"),
                    device)


def _frames(seed, n, h=120, w=160):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 256, (n, h, w, 3))
                           .astype(np.float32))


@pytest.mark.parametrize("which", ["shipped", "test"])
def test_forward_matches_reference(which, tmp_path):
    path = RECIPE if which == "shipped" else _recipe(
        str(tmp_path / "y4.npz"), TEST_RECIPE)
    model = weights.load_module(
        yolov4.YoloV4(yolov4.YoloV4Config(input_size=96)),
        weights.expand_yolov4_recipe(
            checkpoint.load_npz_tree(path)["params"]["recipe"])).eval()
    ref.ieee()
    frames = _frames(0, 2)
    want_b, want_c = plain.detect_dense(_nets(path), frames, 96)
    x = plain.resize(frames, 96).permute(0, 2, 3, 1)
    with torch.no_grad():
        got_b, got_c = yolov4.forward(model, x, folded=yolov4.fold(model))
        unf_b, unf_c = yolov4.forward(model, x)
    assert got_b.shape == want_b.shape == (2, 3 * (144 + 36 + 9), 4)
    for got, want in ((got_b, want_b), (got_c, want_c), (unf_b, want_b),
                      (unf_c, want_c)):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    if which == "test":
        # confidences on both sides of the threshold: the comparison sees
        # the sigmoids' steep part too
        best = want_c.max(-1).values
        assert (best > 0.6).any() and (best < 0.1).any()


def test_recipe_expansions_bit_equal():
    recipe = checkpoint.load_npz_tree(RECIPE)["params"]["recipe"]
    tree = weights.expand_yolov4_recipe(recipe)
    theirs = plain.expand(recipe, "cpu")
    mine = {}
    for name, node in tree["params"].items():
        if "kernel" in node:
            mine[f"{name}/kernel"] = node["kernel"].transpose(3, 2, 0, 1)
            mine[f"{name}/bias"] = node["bias"]
            continue
        mine[f"{name}/Conv_0/kernel"] = \
            node["Conv_0"]["kernel"].transpose(3, 2, 0, 1)
        for k in ("scale", "bias"):
            mine[f"{name}/BatchNorm_0/{k}"] = node["BatchNorm_0"][k]
        for k in ("mean", "var"):
            mine[f"{name}/BatchNorm_0/{k}"] = \
                tree["batch_stats"][name]["BatchNorm_0"][k]
    assert mine.keys() == theirs.keys()
    assert len([k for k in mine if k.endswith("kernel")]) == 110
    for k, v in mine.items():
        assert v.dtype == np.float32, k
        assert np.array_equal(v, theirs[k].numpy()), k
    # the statistics are not the identity, so a fault in the fold shows
    bn = tree["batch_stats"]["ConvBN_5"]["BatchNorm_0"]
    assert np.abs(bn["mean"]).max() > 0.05 and \
        np.abs(bn["var"] - 1).max() > 0.05


def test_decode_one_anchor_per_head():
    """Anchor a of each head at cell (y, x): tx = ln 3 (sigmoid 3/4), ty =
    0 (1/2), tw = ln 2, th = 0, objectness and class 7 at +inf-like 20;
    the box by hand: center ((3/4) s - (s - 1) / 2 + x) / W, size the
    anchor over the input, doubled in width."""
    size = 96
    model = yolov4.YoloV4(yolov4.YoloV4Config(input_size=size))
    grids = [size // 8, size // 16, size // 32]
    raws = [torch.full((1, g, g, 45), -20.0) for g in grids]
    picks = [(1, 5, 7), (2, 0, 3), (0, 2, 1)]          # (anchor, y, x)
    for raw, (a, y, x) in zip(raws, picks):
        raw[0, y, x, a * 15:(a + 1) * 15] = torch.tensor(
            [math.log(3.0), 0.0, math.log(2.0), 0.0, 20.0] + [-20.0] * 7 +
            [20.0] + [-20.0] * 2)
    boxes, confs = yolov4.decode(model, raws)
    assert boxes.shape[1] == sum(3 * g * g for g in grids)
    offset = 0
    for (mask, s, _, _), g, (a, y, x) in zip(yolov4.HEADS, grids, picks):
        i = offset + a * g * g + y * g + x
        aw, ah = yolov4.ANCHORS[mask[a]]
        cx = (0.75 * s - 0.5 * (s - 1.0) + x) / g
        cy = (0.5 * s - 0.5 * (s - 1.0) + y) / g
        want = [cx - aw / size, cy - ah / size / 2, cx + aw / size,
                cy + ah / size / 2]
        torch.testing.assert_close(boxes[0, i], torch.tensor(want),
                                   rtol=1e-6, atol=1e-6)
        assert confs[0, i].argmax() == 7 and confs[0, i, 7] > 0.999
        offset += 3 * g * g
    assert int((confs[0].max(-1).values > 0.5).sum()) == 3


@pytest.fixture(scope="module")
def fleet_case(tmp_path_factory):
    """One Engine.fleet tick of the cell's configuration at 4 rigs, input
    128, in f32 on the plain path, and the benchmark's judge of it."""
    path = _recipe(str(tmp_path_factory.mktemp("recipe") / "y4.npz"),
                   TEST_RECIPE)
    _, _, config, traffic, _ = core.load_cell("yolov4-bf16.r128.ahead")
    c = dict(config["engine"], detection_weights_file=path,
             detection_network_input_size=128, compute_dtype="float32",
             orientation_stem_backend="xla")
    config = dict(config, engine=c, image_dtype="float32")
    traffic = dict(traffic, rigs=4)
    pool, _ = core.build_pool(torch, config, traffic, 2 ** 31 + 5, "cpu")
    prog = core.Program(torch, config, 4, "cpu")
    assert isinstance(prog.engine.params["detector"], yolov4.YoloV4)
    states = prog.init_states(4)
    bright, jitter = core.draw(torch, torch.Generator().manual_seed(3), 1, 4,
                               "cpu")
    obs = core.perturbed(pool, bright[0], jitter[0])
    new, out = prog.step(states, obs)
    ref.ieee()
    nets = core.weights(config, "cpu")
    budget = config["orientation_budget_per_rig"] * 4
    eye = torch.eye(4)
    sample = types.SimpleNamespace(obs=obs, pre=states, post=new, out=out)
    rigs, gaps = judge.judge(nets, sample, c, budget, eye, eye,
                             plain.detect_dense)
    return types.SimpleNamespace(c=c, nets=nets, obs=obs, states=states,
                                 out=out, rigs=rigs, gaps=gaps,
                                 budget=budget)


def test_engine_fleet_matches_reference(fleet_case):
    f = fleet_case
    assert int(f.out.boxes.valid.sum()) >= 4        # the tick has boxes
    assert int(f.out.poses.valid.sum()) >= 1        # and poses
    _, _, _, _, limits = core.load_cell("f32-ext.r64.tick")
    for k, v in f.rigs.items():
        if k in limits:
            assert float(v.max()) <= limits[k], (k, v)
    assert float(f.gaps.median()) <= limits["pose_gap"]
    # the reference's whole tick, its own detector on the frames
    eye = torch.eye(4)
    with torch.no_grad():
        _, want = ref.fleet_tick(f.nets, f.states, f.obs, f.c, f.budget,
                                 eye, eye, plain.detect_dense)
    assert torch.equal(want.boxes.valid, f.out.boxes.valid)
    assert torch.equal(want.boxes.label, f.out.boxes.label)
    torch.testing.assert_close(want.boxes.confidence,
                               f.out.boxes.confidence, rtol=0, atol=2e-4)


def test_spans_inside_detect(tmp_path):
    """The backbone, the neck and the heads each open one span a tick."""
    path = _recipe(str(tmp_path / "y4.npz"), TEST_RECIPE)
    cfg = GridVisionConfig(detector_arch="yolov4", detection_weights_file=path,
                           detection_network_input_size=64)
    params = weights.load_all(cfg, device="cpu")
    images = torch.rand(1, 48, 64, 3) * 255
    stats.reset()
    with stats.tracing():
        pipeline.detect_batch(params, images, cfg)
    seen = stats.snapshot()
    stats.reset()
    for name in ("detect", "detect_backbone", "detect_neck", "detect_heads"):
        assert seen[name][0] == 1, name


@pytest.mark.parametrize("bad", [
    {"detector_stem_backend": "pallas2"},
    {"detector_stem_backend": "im2col"},
    {"detector_s2d_stem": True},
    {"detector_precision": "int8", "compat": False},
])
def test_validate_refuses_tiny_only_options(bad):
    with pytest.raises(ValueError, match="yolov4"):
        GridVisionConfig(detector_arch="yolov4", **bad).validate()
    GridVisionConfig(detector_arch="yolov4").validate()
    with pytest.raises(ValueError, match="detector_arch"):
        GridVisionConfig(detector_arch="yolov5").validate()


def test_default_is_the_tiny_net():
    cfg = GridVisionConfig()
    assert cfg.detector_arch == "yolov4-tiny"
    assert isinstance(weights.detector_model(cfg), yolov4_tiny.YoloV4Tiny)
    assert isinstance(weights.detector_config(cfg), yolov4_tiny.YoloConfig)
    params = weights.load_all(cfg, device="cpu")
    assert isinstance(params["detector"], yolov4_tiny.YoloV4Tiny)
    assert not any(k.startswith("detector_folded")
                   for k in pipeline.Engine(cfg, device="cpu").params)


def test_onnx_is_for_the_tiny_only(tmp_path):
    path = tmp_path / "y4.onnx"
    path.write_bytes(b"")
    cfg = GridVisionConfig(detector_arch="yolov4",
                           detection_weights_file=str(path))
    with pytest.raises(ValueError, match="onnx"):
        weights.load_all(cfg, device="cpu")
