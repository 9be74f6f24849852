"""The extension-mode functions of the port (compat=False) against the JAX
package: the yaw-aware rasterizer, point_bbox_update, yaw_from_quat,
class-aware NMS and the depth refine of fuse. Inputs come from numpy seeds.

Tolerances. lshape_update_oriented: a cell is hit when its centre lies
inside the rotated rectangle, and the two packages round the rotation
(c * rx + s * ry; XLA fuses it into a multiply-add) an ulp apart, so a
centre within an ulp of a rectangle edge may flip: log-odds are equal on
all but a share of <= 1e-4 of the cells, each of those one hit apart.
point_bbox_update: exact. yaw_from_quat: atol 1e-6 (atan2 of two
libraries). NMS: order and keep decisions exactly equal. Depth refine:
poses rtol = atol = 1e-4, the bar of the tick tests."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu import pipeline as jpipe
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.ops import decode as jdecode
from grid_vision_tpu.ops import nms as jnms
from grid_vision_tpu.ops import rasterize as jras
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu.types import Extrinsics as JaxExtrinsics
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu.types import LShapePoses as JaxPoses
from grid_vision_tpu.types import Obs as JaxObs
from grid_vision_tpu.types import PointCloud as JaxCloud
from grid_vision_tpu_torch import pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.geometry import (grid_index_from_position,
                                            grid_position_from_index)
from grid_vision_tpu_torch.ops import decode, nms, rasterize
from grid_vision_tpu_torch.types import (Boxes, Extrinsics, GridState,
                                         LShapePoses, Obs, PointCloud, stack)

torch.set_num_threads(1)

EXT = dict(compat=False, yaw_aware_rasterization=True)
JCFG, CFG = JaxConfig(**EXT), GridVisionConfig(**EXT)
HIT = CFG.log_odds_hit
POSE_FIELDS = ("position", "quat", "length", "width", "height", "label",
               "valid")


def random_poses(seed, cap=8, n=6):
    """numpy pose fields with yaws: on-map, overlapping and off-map."""
    rng = np.random.default_rng(seed)
    f = dict(position=np.zeros((cap, 3), np.float32),
             quat=np.tile(np.array([0, 0, 0, 1], np.float32), (cap, 1)),
             length=np.zeros(cap, np.float32), width=np.zeros(cap, np.float32),
             height=np.zeros(cap, np.float32),
             label=np.full(cap, 10, np.int32), valid=np.zeros(cap, bool))
    for i in range(n):
        yaw = rng.uniform(-np.pi, np.pi)
        f["position"][i] = (rng.uniform(-12, 45), rng.uniform(-11, 11), 0.0)
        f["quat"][i] = (0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2))
        f["length"][i] = rng.uniform(0.5, 6.0)
        f["width"][i] = rng.uniform(0.5, 3.0)
        f["valid"][i] = True
    if n > 1:
        f["position"][1] = f["position"][0] + np.float32(0.3)   # overlap
    return f


def both(cls_j, cls_t, fields):
    return (cls_j(**{k: jnp.asarray(v) for k, v in fields.items()}),
            cls_t(**{k: torch.as_tensor(v) for k, v in fields.items()}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oriented_update_matches_jax(seed):
    fields = random_poses(seed)
    jp, tp = both(JaxPoses, LShapePoses, fields)
    lo0 = np.random.default_rng(seed).uniform(
        -2, 3.6, CFG.grid_size).astype(np.float32)
    ref_lo, ref_occ = jax.jit(lambda lo, p: jras.lshape_update_oriented(
        lo, p, JCFG))(jnp.asarray(lo0), jp)
    got_lo, got_occ = rasterize.lshape_update_oriented(torch.as_tensor(lo0),
                                                       tp, CFG)
    ref_lo, got = np.asarray(ref_lo), got_lo.numpy()
    assert (got > lo0 + 0.5).sum() > 100               # footprints landed
    diff = got != ref_lo
    assert diff.mean() <= 1e-4, diff.mean()
    if diff.any():
        assert np.abs(got - ref_lo)[diff].max() <= HIT + 1e-5
    same = ~diff
    np.testing.assert_allclose(got_occ.numpy()[same],
                               np.asarray(ref_occ)[same], rtol=0,
                               atol=2.5e-7)


def test_oriented_update_rig_batched_equals_a_loop():
    tps = [both(JaxPoses, LShapePoses, random_poses(s))[1]
           for s in (3, 4, 5)]
    lo = torch.as_tensor(np.random.default_rng(3).uniform(
        -2, 3.6, (3,) + CFG.grid_size).astype(np.float32))
    got_lo, got_occ = rasterize.lshape_update_oriented(lo, stack(tps), CFG)
    for r, tp in enumerate(tps):
        one_lo, one_occ = rasterize.lshape_update_oriented(lo[r], tp, CFG)
        assert torch.equal(one_lo, got_lo[r])
        assert torch.equal(one_occ, got_occ[r])


def _idx(x, y):
    i, ok = grid_index_from_position(
        torch.tensor([x, y]), CFG.grid_center,
        (float(CFG.grid_x), float(CFG.grid_y)), CFG.resolution)
    assert bool(ok)
    return int(i[0]), int(i[1])


def _one_pose(px, py, length, width, yaw, cap=8):
    p = LShapePoses.empty(cap)
    p.position[0] = torch.tensor([px, py, 0.0])
    p.quat[0] = torch.tensor([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    p.length[0], p.width[0], p.valid[0] = length, width, True
    return p


def test_yaw_aware_rasterization_and_zero_yaw():
    state = GridState.create(CFG)
    # a long thin box rotated 45 degrees at (16, 0)
    poses = _one_pose(16.0, 0.0, 6.0, 1.0, np.pi / 4)
    lo, _ = rasterize.lshape_update_oriented(state.log_odds, poses, CFG)
    hits = lo.numpy() > 0
    d = 6.0 / 2 / np.sqrt(2) * 0.9
    assert hits[_idx(16.0, 0.0)]
    assert hits[_idx(16.0 + d, 0.0 + d)] and hits[_idx(16.0 - d, 0.0 - d)]
    assert not hits[_idx(16.0 + d, 0.0 - d)]
    assert not hits[_idx(16.0 - d, 0.0 + d)]
    lo_aa, _ = rasterize.lshape_update(state.log_odds, poses, CFG)
    assert lo_aa.numpy()[_idx(16.0 + 2.9, 0.0)] > 0        # in the AA block
    assert not hits[_idx(16.0 + 2.9, 0.0)]                 # not in the rect
    # zero yaw: the oriented cells are a subset of the axis-aligned block
    # (centre-inside against the inclusive corner cells), nearly all of it
    poses = _one_pose(16.0, 2.0, 4.0, 2.0, 0.0)
    lo_o, _ = rasterize.lshape_update_oriented(state.log_odds, poses, CFG)
    lo_a, _ = rasterize.lshape_update(state.log_odds, poses, CFG)
    o_hits, a_hits = lo_o.numpy() > 0, lo_a.numpy() > 0
    assert (o_hits & ~a_hits).sum() == 0
    assert o_hits.sum() >= 0.9 * a_hits.sum()


def test_yaw_from_quat_and_cell_centers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 50, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        rasterize.yaw_from_quat(torch.as_tensor(q)).numpy(),
        np.asarray(jras.yaw_from_quat(jnp.asarray(q))), rtol=0, atol=1e-6)
    h, w = CFG.grid_size
    rows, cols = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    ref = np.asarray(jras._cell_centers(rows, cols, JCFG))
    got = rasterize._cell_centers(h, w, CFG)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)
    # a cell's centre indexes back to the cell
    idx, ok = grid_index_from_position(
        got, CFG.grid_center, (float(CFG.grid_x), float(CFG.grid_y)),
        CFG.resolution)
    assert bool(ok.all()) and idx[7, 9].tolist() == [7, 9]
    assert grid_position_from_index(
        torch.tensor([0, 0]), CFG.grid_center,
        (float(CFG.grid_x), float(CFG.grid_y)), CFG.resolution
    ).tolist() == pytest.approx([40.95, 9.95])


@pytest.mark.parametrize("seed", [0, 1])
def test_point_bbox_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    d = 12
    pts = np.stack([rng.uniform(-10, 40, d), rng.uniform(-10, 10, d),
                    np.zeros(d)], -1).astype(np.float32)
    fields = dict(xyxy=np.zeros((d, 4), np.float32),
                  confidence=np.ones(d, np.float32),
                  label=rng.integers(0, 11, d).astype(np.int32),
                  valid=rng.random(d) < 0.8)
    jb, tb = both(JaxBoxes, Boxes, fields)
    lo0 = rng.uniform(-2, 3.6, CFG.grid_size).astype(np.float32)
    ref_lo, ref_occ = jax.jit(lambda lo, p, b: jras.point_bbox_update(
        lo, p, b, JCFG))(jnp.asarray(lo0), jnp.asarray(pts), jb)
    got_lo, got_occ = rasterize.point_bbox_update(
        torch.as_tensor(lo0), torch.as_tensor(pts), tb, CFG)
    assert (got_lo.numpy() > lo0 + 0.5).sum() > 50
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(ref_lo))
    np.testing.assert_allclose(got_occ.numpy(), np.asarray(ref_occ), rtol=0,
                               atol=2.5e-7)
    # a leading rig axis
    two_lo, _ = rasterize.point_bbox_update(
        torch.as_tensor(np.stack([lo0, lo0])),
        torch.as_tensor(np.stack([pts, pts])), stack([tb, tb]), CFG)
    assert torch.equal(two_lo[0], got_lo) and torch.equal(two_lo[1], got_lo)


def _crowd(rng, n):
    """n boxes in a few tight clusters with mixed labels: many overlaps
    above the threshold between and within classes."""
    centres = rng.uniform(0.2, 0.8, (5, 2))
    c = centres[rng.integers(0, 5, n)] + rng.normal(0, 0.02, (n, 2))
    half = rng.uniform(0.05, 0.09, (n, 2))
    xyxy = np.concatenate([c - half, c + half], -1).astype(np.float32)
    conf = rng.uniform(0.1, 1.0, n).astype(np.float32)
    conf[::7] = conf[0]                                   # ties
    return xyxy, conf, rng.integers(0, 3, n).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_aware_nms_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 96
    xyxy, conf, labels = _crowd(rng, n)
    valid = rng.random(n) < 0.85
    j_order, j_keep = jnms.greedy_nms_keep(
        jnp.asarray(xyxy), jnp.asarray(conf), jnp.asarray(valid), 0.45,
        labels=jnp.asarray(labels))
    order, keep = nms.greedy_nms_keep(
        torch.as_tensor(xyxy), torch.as_tensor(conf), torch.as_tensor(valid),
        0.45, labels=torch.as_tensor(labels))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    _, agnostic = nms.greedy_nms_keep(
        torch.as_tensor(xyxy), torch.as_tensor(conf), torch.as_tensor(valid),
        0.45)
    assert int(keep.sum()) > int(agnostic.sum())          # classes mattered
    # rigs on a leading axis, each with its own labels
    other = np.roll(labels, 5)
    b_order, b_keep = nms.greedy_nms_keep(
        torch.as_tensor(np.stack([xyxy, xyxy])),
        torch.as_tensor(np.stack([conf, conf])),
        torch.as_tensor(np.stack([valid, valid])), 0.45,
        labels=torch.as_tensor(np.stack([labels, other])))
    _, keep_other = nms.greedy_nms_keep(
        torch.as_tensor(xyxy), torch.as_tensor(conf), torch.as_tensor(valid),
        0.45, labels=torch.as_tensor(other))
    assert torch.equal(b_order[0], order) and torch.equal(b_keep[0], keep)
    assert torch.equal(b_keep[1], keep_other)


@pytest.mark.parametrize("seed", [0, 1])
def test_class_aware_extract_boxes_equals_jax(seed):
    ext = dict(compat=False, class_aware_nms=True)
    jcfg, cfg = JaxConfig(**ext), GridVisionConfig(**ext)
    rng = np.random.default_rng(seed)
    a = 2535
    boxes = np.zeros((a, 4), np.float32)
    confs = (rng.random((a, 10)) * 0.3).astype(np.float32)
    xyxy, conf, labels = _crowd(rng, 80)
    slots = rng.choice(a, 80, replace=False)
    boxes[slots] = xyxy
    confs[slots, labels + 7] = np.maximum(conf, 0.61)
    ref = jdecode.extract_boxes(jnp.asarray(boxes), jnp.asarray(confs), jcfg)
    got = decode.extract_boxes(torch.as_tensor(boxes), torch.as_tensor(confs),
                               cfg)
    agnostic = decode.extract_boxes(
        torch.as_tensor(boxes), torch.as_tensor(confs), GridVisionConfig())
    assert int(got.valid.sum()) > int(agnostic.valid.sum())
    for f in ("xyxy", "confidence", "label", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


def test_class_aware_nms_keeps_other_class():
    cfg = GridVisionConfig(compat=False, class_aware_nms=True)
    boxes = np.zeros((2535, 4), np.float32)
    confs = np.zeros((2535, 10), np.float32)
    boxes[0] = [0.1, 0.1, 0.4, 0.4]
    boxes[1] = [0.11, 0.11, 0.41, 0.41]           # IoU ~0.87 with box 0
    confs[0, 9], confs[1, 2] = 0.95, 0.90         # vehicle, person
    got = decode.extract_boxes(torch.as_tensor(boxes), torch.as_tensor(confs),
                               cfg)
    assert int(got.valid.sum()) == 2              # the other class survives
    confs[1] = 0.0
    confs[1, 9] = 0.90
    got = decode.extract_boxes(torch.as_tensor(boxes), torch.as_tensor(confs),
                               cfg)
    assert int(got.valid.sum()) == 1              # same class: suppressed


# ---- the depth refine of fuse, with injected boxes and poses

REFINE = dict(compat=False, vision_depth_refine=True, max_points=2048,
              max_static_depth=4, knn_backend="pallas")


def _refine_case(seed, cfg):
    """Boxes (dynamic and static), camera-frame poses in the compacted
    dynamic slots and a cloud with a surface in front of some boxes and
    none in front of others."""
    rng = np.random.default_rng(seed)
    d, cap = cfg.max_detections, cfg.max_orientation_batch
    n = 14
    bf = dict(xyxy=np.zeros((d, 4), np.float32),
              confidence=np.zeros(d, np.float32),
              label=np.full(d, 10, np.int32), valid=np.zeros(d, bool))
    x0 = rng.uniform(20, 500, n)
    y0 = rng.uniform(100, 300, n)
    bf["xyxy"][:n] = np.trunc(np.stack(
        [x0, y0, x0 + rng.uniform(20, 120, n), y0 + rng.uniform(3, 140, n)],
        -1))
    bf["confidence"][:n] = np.sort(rng.uniform(0.6, 1.0, n))[::-1]
    bf["label"][:n] = rng.choice([9, 0, 1, 2, 5, 7], n)
    bf["label"][:3] = (9, 0, 9)                    # dynamic boxes for sure
    bf["valid"][:n] = True
    pf = random_poses(seed, cap=cap, n=0)
    n_dyn = min(cap, int(np.isin(bf["label"][:n], (9, 0, 1)).sum()))
    for i in range(n_dyn):
        yaw = rng.uniform(-np.pi, np.pi)
        pf["position"][i] = (rng.uniform(-6, 6), rng.uniform(-1, 1),
                             rng.uniform(0.2, 30))   # some z below 0.5
        pf["quat"][i] = (0.0, np.sin(-yaw / 2), 0.0, np.cos(-yaw / 2))
        pf["length"][i] = rng.uniform(1, 5)
        pf["width"][i] = rng.uniform(0.5, 2.5)
        pf["height"][i] = rng.uniform(1, 2)
        pf["valid"][i] = rng.random() < 0.9
    # a cloud: walls at depths 4..25 m behind the left half of the image
    p = 1500
    z = rng.uniform(4, 25, p)
    u = rng.uniform(0, 320, p)
    v = rng.uniform(0, 480, p)
    xyz = np.stack([(u - cfg.cx) / cfg.fx * z, (v - cfg.cy) / cfg.fy * z, z],
                   -1).astype(np.float32)
    return bf, pf, xyz


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_refine_matches_jax_fuse(seed):
    jcfg, cfg = JaxConfig(**REFINE), GridVisionConfig(**REFINE)
    bf, pf, xyz = _refine_case(seed, cfg)
    jb, tb = both(JaxBoxes, Boxes, bf)
    jp, tp = both(JaxPoses, LShapePoses, pf)
    image = np.zeros((cfg.camera_image_height, cfg.camera_image_width, 3),
                     np.float32)
    cloud = PointCloud.from_numpy(xyz, None, cfg.max_points)
    obs = Obs.create(cfg, image=image, cloud=cloud)
    jobs = JaxObs(image=jnp.asarray(image),
                  cloud=JaxCloud(xyz=jnp.asarray(cloud.xyz.numpy()),
                                 intensity=jnp.asarray(
                                     cloud.intensity.numpy()),
                                 count=jnp.asarray(cloud.count.numpy())),
                  has_image=jnp.asarray(True), has_cloud=jnp.asarray(True))
    jfuse = jax.jit(functools.partial(jpipe.fuse, cfg=jcfg))
    _, jout = jfuse({}, JaxState.create(jcfg), jobs, jb,
                    JaxExtrinsics.identity(), poses_cam=jp)
    zero = torch.zeros((1,), dtype=torch.int32)
    _, out = pipeline._fuse_rigs(
        stack([GridState.create(cfg)]), stack([obs]), stack([tb]),
        Extrinsics.identity(), cfg, stack([tp]), zero, zero)
    out = out.select(0)
    pv = np.asarray(jout.poses.valid)
    assert pv.sum() >= 2
    np.testing.assert_array_equal(out.poses.valid.numpy(), pv)
    np.testing.assert_allclose(out.poses.position.numpy()[pv],
                               np.asarray(jout.poses.position)[pv],
                               rtol=1e-4, atol=1e-4)
    # the refine moved poses, by the cloud depth for some and the height
    # cue for others, and it kept the full-capacity kNN query
    # (max_static_depth = 4 would have clamped the static depths)
    moved = np.abs(out.poses.position.numpy()[pv] - pf["position"][pv]).max(
        axis=-1) > 1e-3
    assert moved.sum() >= 2
    np.testing.assert_allclose(out.static_depths.numpy(),
                               np.asarray(jout.static_depths), rtol=1e-4,
                               atol=1e-4)
    assert int(out.saturation.static_depth_clamped) == 0
    assert int(jout.saturation.static_depth_clamped) == 0
    assert (out.static_depths.numpy() > 0).sum() > 4
    # without the refine the poses pass through unscaled
    plain = dataclasses.replace(cfg, vision_depth_refine=False)
    _, out0 = pipeline._fuse_rigs(
        stack([GridState.create(cfg)]), stack([obs]), stack([tb]),
        Extrinsics.identity(), plain, stack([tp]), zero, zero)
    np.testing.assert_allclose(out0.poses.position[0].numpy()[pv],
                               pf["position"][pv], rtol=0, atol=1e-6)
