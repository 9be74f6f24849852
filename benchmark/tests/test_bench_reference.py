"""The reference (plain torch, nothing of the program) agrees with the
program's plain ("xla") path on the CPU at a small size, stage by stage:
the detector's anchors, decode and NMS, the kNN depths and static points,
the crops and the orientation net, MultiBin and the depth refine, the
grid and the carve. The reference is what `correct` trusts; this test is
what keeps it honest."""

import types

import pytest
import torch

from benchmark import core, reference as ref
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import orientation_net, yolov4_tiny
from grid_vision_tpu_torch.ops import decode, preprocess, rasterize, raycast
from grid_vision_tpu_torch.types import Boxes

PLAIN = {"detector_stem_backend": "xla", "orientation_stem_backend": "xla",
         "grid_backend": "xla", "knn_backend": "xla"}


@pytest.fixture(scope="module")
def case():
    _, _, config, traffic, _ = core.load_cell("f32-ext.r64.tick")
    c = dict(config["engine"], **PLAIN)
    config = dict(config, engine=c)
    traffic = dict(traffic, rigs=4)
    pool, _ = core.build_pool(torch, config, traffic, 2 ** 32 + 9, "cpu")
    prog = core.Program(torch, config, 4, "cpu")
    states = prog.init_states(4)
    gen = torch.Generator().manual_seed(3)
    bright, jitter = core.draw(torch, gen, 1, 4, "cpu")
    obs = core.perturbed(pool, bright[0], jitter[0])
    new, out = prog.step(states, obs)
    nets = core.weights(config, "cpu")
    return types.SimpleNamespace(c=c, cfg=GridVisionConfig(**c), obs=obs,
                                 states=states, new=new, out=out, nets=nets,
                                 params=prog.engine.params)


def test_detector(case):
    bn, cn = ref.detect_dense(case.nets, case.obs.image, 416)
    net_in = torch.stack([preprocess.preprocess_detector_image(im, 416)
                          for im in case.obs.image])
    pb, pc = yolov4_tiny.forward(case.params["detector"], net_in)
    assert torch.allclose(bn, pb, atol=1e-5) and torch.allclose(cn, pc,
                                                                atol=1e-5)
    boxes, ovf = ref.extract_boxes(pb, pc, case.c)
    want, want_ovf = decode.extract_boxes(pb, pc, case.cfg,
                                          with_overflow=True)
    for k in ("xyxy", "confidence", "label", "valid"):
        assert torch.equal(getattr(boxes, k), getattr(want, k))
    assert torch.equal(ovf, want_ovf)
    assert torch.equal(boxes.valid, case.out.boxes.valid)


def test_static_branch(case):
    K, K_inv = ref.intrinsics(case.c, "cpu")
    depths, points, _ = ref.static_branch(case.out.boxes, case.obs.xyz,
                                          case.obs.count, case.c, K, K_inv,
                                          torch.eye(4))
    valid = case.out.boxes.valid
    assert torch.equal(depths[valid], case.out.static_depths[valid])
    assert torch.equal(points, case.out.static_points)


def test_poses(case):
    c, out = case.c, case.out
    K, K_inv = ref.intrinsics(c, "cpu")
    order, slot_valid = ref.dynamic_slots(out.boxes, 8)
    kept = ref.budget_keep(out.boxes, order, slot_valid, 20)
    assert torch.equal(kept, out.poses.valid)
    r, j = kept.nonzero(as_tuple=True)
    b = order[r, j]
    xyxy = out.boxes.xyxy[r, b]
    x, std = ref.crops(case.obs.image, xyxy, r, 224)
    # a flat crop's standardized values are rounding, amplified
    ok = std >= 1.0
    assert ok.any()
    one = [preprocess.crop_resize_standardize(case.obs.image[ri], Boxes(
        xyxy=xyxy[k:k + 1], confidence=xyxy[k:k + 1, 0],
        label=out.boxes.label[r[k:k + 1], b[k:k + 1]],
        valid=torch.ones(1, dtype=torch.bool)), 224)
        for k, ri in enumerate(r.tolist())]
    assert torch.allclose(x[ok], torch.cat(one)[ok], atol=1e-3)
    o, cf, dm = ref.orientation(case.nets, x)
    po, pcf, pdm = orientation_net.forward(case.params["orientation"], x)
    for a, w in ((o, po), (cf, pcf), (dm, pdm)):
        assert torch.allclose(a, w, atol=1e-4)
    depths, _, _ = ref.static_branch(out.boxes, case.obs.xyz, case.obs.count,
                                     c, K, K_inv, torch.eye(4))
    cand = ref.multibin_candidates(o, cf, dm, xyxy, out.boxes.label[r, b], c,
                                   K)
    locs = ref.refine(cand, depths[r, b], torch.ones((), dtype=torch.bool),
                      K)
    n = torch.arange(len(r))
    kb = cf.argmax(-1)
    best = cand.err[n, kb].argmin(-1)
    assert torch.allclose(locs[n, kb, best][ok],
                          out.poses.position[r, j][ok], atol=1e-3)
    assert torch.allclose(ref.quat_from_pitch(cand.yaw[n, kb])[ok],
                          out.poses.quat[r, j][ok], atol=1e-5)


@pytest.mark.parametrize("carve", [False, True])
def test_grid(case, carve):
    c, out = case.c, case.out
    g = torch.Generator().manual_seed(5)
    lo0 = torch.rand(case.states.log_odds.shape, generator=g) * 4 - 2
    occ0 = 1.0 / (1.0 + torch.exp(-lo0))
    lo, occ, i8 = ref.grid_update(lo0, occ0, out.poses, case.obs.xyz,
                                  case.obs.count, c, carve)
    cfg = case.cfg
    if carve:
        valid = torch.arange(case.obs.xyz.shape[1]) < case.obs.count[:, None]
        want = raycast.lshape_update_with_carving(
            lo0, out.poses, torch.zeros(2), case.obs.xyz[..., :2], valid, cfg)
    else:
        want = rasterize.lshape_update(lo0, out.poses, cfg)
    want = rasterize.gate_and_export(*want, torch.ones(4, dtype=torch.bool),
                                     lo0, occ0)
    for a, w in zip((lo, occ, i8), want):
        assert torch.equal(a, w)


def test_tick_state(case):
    lo, _, i8 = ref.grid_update(case.states.log_odds, case.states.occupancy,
                                case.out.poses, case.obs.xyz, case.obs.count,
                                case.c, True)
    assert torch.equal(lo, case.new.log_odds)
    assert torch.equal(i8, case.out.occupancy_i8)
