"""The port's tick on the card at full width: the single-rig Engine and the
fleet, f32 and bf16, extension mode, the PCA pose branch, the five knobs,
the int8 detector and YOLOv4's conv epilogue, each against the same tick on
the plain torch backends (or the JAX package's fixture), with every
kernel's launches counted.

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
Imports neither JAX nor the JAX package. The whole card suite:

    python -m pytest tests/test_torch_cuda*.py --noconftest -q

The helpers below (counted, run_fleet, compare_outputs, bf16_stats,
meets_bf16_bars) are shared by the other card files and by
tools/torch_train_recipe.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from grid_vision_tpu_torch import pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.ops import (cuda_csp, cuda_epilogue, cuda_grid,
                                       cuda_int8, cuda_knn, cuda_orient,
                                       cuda_raycast, cuda_stem)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RIGS = 64
BUDGET = 5 * N_RIGS               # the bench's orientation budget
ENGINE_TICKS = 20
FLEET_TICKS = 10
PLAIN = dict(detector_stem_backend="xla", orientation_stem_backend="xla",
             grid_backend="xla", knn_backend="xla")
EXT = dict(compat=False, raycast_free_space=True, vision_depth_refine=True,
           class_aware_nms=True)
KERNELS = {"detector_stem": cuda_stem, "grid_update": cuda_grid,
           "knn_median_depth": cuda_knn, "detector_csp": cuda_csp,
           "orient_front": cuda_orient, "carve_update": cuda_raycast,
           "int8_conv": cuda_int8, "conv_epilogue": cuda_epilogue}
FORMS = {"detector_stem_bf16": cuda_stem, "detector_csp_bf16": cuda_csp,
         "orient_front_bf16": cuda_orient}
FLEET_KERNELS = ("detector_stem", "detector_csp", "orient_front",
                 "grid_update", "knn_median_depth")
BF16_KERNELS = ("detector_stem_bf16", "detector_csp_bf16",
                "orient_front_bf16", "grid_update", "knn_median_depth")
BOX_BAND = 0.02     # band about the decode's thresholds (bf16_stats)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from grid_vision_tpu_torch.ops import cuda_build
    cuda_build.build_all()          # one nvcc a source, all at once
    return torch.device("cuda", 0)


def path_configs():
    """The single-rig path at full width (shipped weights, stem / grid /
    kNN kernels) and the fleet configuration of bench.py in f32 (stem
    "pallas2", orientation "pallas", 8192 points, static compaction to
    16)."""
    cfg = GridVisionConfig(
        detection_weights_file="weights/detector.npz",
        vision_weights_file="weights/orientation.npz",
        detector_stem_backend="pallas", grid_backend="pallas",
        knn_backend="pallas")
    fleet_cfg = dataclasses.replace(
        cfg, max_points=8192, max_static_depth=16,
        detector_stem_backend="pallas2", orientation_stem_backend="pallas")
    return cfg, fleet_cfg


@dataclasses.dataclass
class Paths:
    cfg: GridVisionConfig
    fleet_cfg: GridVisionConfig
    engine: pipeline.Engine
    nets: dict
    obs_seq: list               # ENGINE_TICKS of the seed-0 scene
    pool: object                # the fleet's FleetPool of N_RIGS rigs
    fleet_obs: list             # FLEET_TICKS of the pool

    def engine_of(self, cfg, params=None):
        """An Engine of `cfg` on the path's extrinsics, on the nets unless
        `params` are given."""
        return pipeline.Engine(cfg, extrinsics=self.engine.extrinsics,
                               params=self.nets if params is None else params,
                               device=self.engine.device)


@pytest.fixture(scope="module")
def paths(cuda_device):
    from grid_vision_tpu_torch.demo import default_extrinsics
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.runtime.stream import FleetPool, obs_from_scene
    cfg, fleet_cfg = path_configs()
    engine = pipeline.Engine(cfg, extrinsics=default_extrinsics(cuda_device),
                             device=cuda_device, base_dir=ROOT)
    scene = SyntheticScene(cfg, seed=0, n_ground=15000)
    scene.add_default_traffic()
    scene.add_default_statics()
    pool = FleetPool(fleet_cfg, N_RIGS, device=cuda_device)
    return Paths(cfg, fleet_cfg, engine,
                 {k: engine.params[k] for k in ("detector", "orientation")},
                 [obs_from_scene(scene, i / 10.0, cfg, cuda_device)
                  for i in range(ENGINE_TICKS)],
                 pool, [pool.obs(i) for i in range(FLEET_TICKS)])


# -- shared helpers ---------------------------------------------------------

def counted(run, want):
    """run() with every launch counter set to 0 just before it; asserts the
    counts read after it equal `want` (unnamed kernels 0). Returns run's
    result."""
    for m in KERNELS.values():
        m.launches = 0
    for m in FORMS.values():
        m.launches_bf16 = 0
    result = run()
    torch.cuda.synchronize()
    got = {name: m.launches for name, m in KERNELS.items()}
    got.update({name: m.launches_bf16 for name, m in FORMS.items()})
    assert got == dict({name: 0 for name in got}, **want)
    return result


def run_ticks(engine, obs_seq):
    """The single-rig ticks' outputs from a fresh state."""
    state, outs = engine.init_state(), []
    for obs in obs_seq:
        state, out = engine(state, obs)
        outs.append(out)
    return outs


def run_fleet(engine, obs_seq, budget):
    """The fleet ticks' outputs from fresh states of the Obs' rigs."""
    states = engine.init_states(int(obs_seq[0].image.shape[0]))
    outs = []
    for obs in obs_seq:
        states, out = engine.fleet(states, obs, budget)
        outs.append(out)
    return outs


def compare_outputs(cfg, outs, plain_outs, per_rig: bool):
    """occupancy_i8 agreement >= 99.9 % (per rig with per_rig), identical
    box counts (and pose validity per rig), finite valid slots; returns
    (min agreement, box counts, pose counts)."""
    agree, n_boxes, n_poses = [], [], []
    for o, p in zip(outs, plain_outs):
        assert tuple(o.occupancy_i8.shape[-2:]) == tuple(cfg.grid_size)
        for t in (o.static_points, o.static_depths,
                  o.boxes.xyxy[o.boxes.valid],
                  o.poses.position[o.poses.valid]):
            assert torch.isfinite(t).all()
        eq = (o.occupancy_i8 == p.occupancy_i8).float()
        agree.append(eq.mean(dim=(-2, -1)).min().item() if per_rig
                     else eq.mean().item())
        nb = o.boxes.valid.sum(-1)
        assert torch.equal(nb, p.boxes.valid.sum(-1))
        if per_rig:
            assert torch.equal(o.poses.valid, p.poses.valid)
        n_boxes.append(int(nb.sum()))
        n_poses.append(int(o.poses.valid.sum()))
    assert min(agree) >= 0.999, agree
    return min(agree), n_boxes, n_poses


def same_ticks(outs, refs):
    """occupancy_i8 bit-equal and box counts equal, tick by tick."""
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert torch.equal(o.boxes.valid.sum(-1), r.boxes.valid.sum(-1)), i
        assert torch.equal(o.occupancy_i8, r.occupancy_i8), i


def marginal_boxes(cfg, boxes, band: float):
    """The valid boxes within `band` of one of the decode's thresholds: a
    confidence below confidence_threshold + band, or an IoU with a box kept
    before it (the rows are in NMS order) of iou_threshold - band or more.
    A bf16 rounding may move such a box across the threshold on either
    path."""
    xyxy, valid = boxes.xyxy.float(), boxes.valid
    n = valid.shape[-1]
    lo = torch.maximum(xyxy[..., :, None, :2], xyxy[..., None, :, :2])
    hi = torch.minimum(xyxy[..., :, None, 2:], xyxy[..., None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    area = (xyxy[..., 2:] - xyxy[..., :2]).clamp(min=0).prod(-1)
    iou = inter / (area[..., :, None] + area[..., None, :] - inter
                   ).clamp(min=1e-9)
    before = torch.ones(n, n, dtype=torch.bool, device=valid.device).tril(-1)
    near_nms = ((iou >= cfg.iou_threshold - band) & before
                & valid[..., None, :]).any(-1)
    near_conf = boxes.confidence < cfg.confidence_threshold + band
    return valid & (near_conf | near_nms)


def bf16_stats(cfg, outs, plain_outs, band: float = BOX_BAND):
    """The kernel backends against the plain ones in bf16, per rig per
    tick; asserts the valid slots finite.

    Box counts agree where they differ by marginal boxes only: each path's
    other boxes are no more than the other path's boxes (a rounding that
    moves a box across a threshold changes no box clear of both). A rig is
    clean while its two paths have given the same boxes, or equal counts
    and no marginal box, on every tick so far (a box moved across a
    threshold changes the grid from then on): occupancy_i8 agreement is
    reported on the mean over all rig-ticks and at the least over the
    clean ones."""
    same, agree, clean_agree = [], [], []
    clean = None
    for o, p in zip(outs, plain_outs):
        assert tuple(o.occupancy_i8.shape[-2:]) == tuple(cfg.grid_size)
        for t in (o.static_points, o.boxes.xyxy[o.boxes.valid],
                  o.poses.position[o.poses.valid]):
            assert torch.isfinite(t).all()
        (na, nm), (pa, pm) = (
            (b.valid.sum(-1), marginal_boxes(cfg, b, band).sum(-1))
            for b in (o.boxes, p.boxes))
        same += ((na - nm <= pa) & (pa - pm <= na)).reshape(-1).tolist()
        ob, pb = o.boxes, p.boxes
        identical = ((ob.xyxy == pb.xyxy).all(-1) & (ob.label == pb.label)
                     & (ob.confidence == pb.confidence)
                     & (ob.valid == pb.valid)).all(-1)
        now = identical | ((na == pa) & (nm == 0) & (pm == 0))
        clean = now if clean is None else clean & now
        eq = (o.occupancy_i8 == p.occupancy_i8).float().mean(dim=(-2, -1))
        agree += eq.reshape(-1).tolist()
        clean_agree += eq[clean].reshape(-1).tolist()
    return dict(equal_box_count_share=sum(same) / len(same),
                mean_occupancy_i8_agreement=sum(agree) / len(agree),
                min_occupancy_i8_agreement=min(agree),
                clean_rig_ticks=len(clean_agree),
                min_clean_occupancy_i8_agreement=(
                    min(clean_agree) if clean_agree else None))


def meets_bf16_bars(out) -> bool:
    """root PERF.md §2's bf16 bars on bf16_stats: box counts agreeing (but
    for marginal boxes) on >= 99 % of rig-ticks; occupancy_i8 agreement
    >= 99 % on the mean, and >= 97.5 % at the least over the clean
    rig-ticks (PARITY.json per_step_min_agreement of the JAX package's
    bf16 against f32)."""
    return (out["equal_box_count_share"] >= 0.99
            and out["mean_occupancy_i8_agreement"] >= 0.99
            and (out["min_clean_occupancy_i8_agreement"] or 1.0) >= 0.975)


def assert_bf16_bars(cfg, outs, plain_outs):
    out = bf16_stats(cfg, outs, plain_outs)
    assert meets_bf16_bars(out), out
    return out


def to_bf16(obs_seq):
    return [dataclasses.replace(o, image=o.image.to(torch.bfloat16))
            for o in obs_seq]


def carved_share(cfg, obs, extrinsics):
    """The share of grid cells the Obs' scan carves (the mean over rigs)."""
    from grid_vision_tpu_torch.geometry import transform_points
    from grid_vision_tpu_torch.ops import raycast
    cam = transform_points(extrinsics.lidar_to_camera, obs.cloud.xyz)
    base = transform_points(extrinsics.camera_to_base, cam)
    valid = obs.cloud.mask() & obs.has_cloud[..., None]
    return raycast.carve_mask(extrinsics.camera_to_base[:2, 3],
                              base[..., :2].contiguous(), valid,
                              cfg).float().mean().item()


def sync_free(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a host sync
    raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


# -- the single rig and the fleet, f32 and bf16 ------------------------------

@pytest.mark.cuda
def test_engine_launches_its_kernels_once_a_tick_and_agrees_with_plain(paths):
    """ENGINE_TICKS single-rig ticks: the stem, grid and kNN kernels once a
    tick, nothing else; compare_outputs against the plain backends."""
    t = ENGINE_TICKS
    outs = counted(lambda: run_ticks(paths.engine, paths.obs_seq),
                   dict(detector_stem=t, grid_update=t, knn_median_depth=t))
    plain = paths.engine_of(dataclasses.replace(paths.cfg, **PLAIN),
                            params=paths.engine.params)
    compare_outputs(paths.cfg, outs, run_ticks(plain, paths.obs_seq),
                    per_rig=False)


@pytest.mark.cuda
def test_fleet_launches_five_kernels_once_a_tick_and_agrees_with_plain(paths):
    """FLEET_TICKS fleet ticks of N_RIGS rigs, budget BUDGET: each of the
    five kernels once a tick; compare_outputs per rig against the plain
    backends; a "pallas3" tick equals the "pallas2" one exactly."""
    fleet = paths.engine_of(paths.fleet_cfg)
    outs = counted(lambda: run_fleet(fleet, paths.fleet_obs, BUDGET),
                   {k: FLEET_TICKS for k in FLEET_KERNELS})
    plain = paths.engine_of(dataclasses.replace(paths.fleet_cfg, **PLAIN),
                            params=fleet.params)
    compare_outputs(paths.fleet_cfg, outs,
                    run_fleet(plain, paths.fleet_obs, BUDGET), per_rig=True)
    p3 = paths.engine_of(dataclasses.replace(
        paths.fleet_cfg, detector_stem_backend="pallas3"),
        params=fleet.params)
    _, out3 = p3.fleet(fleet.init_states(N_RIGS), paths.fleet_obs[0], BUDGET)
    out2 = outs[0]
    for a, b in ((out3.occupancy_i8, out2.occupancy_i8),
                 (out3.boxes.xyxy, out2.boxes.xyxy),
                 (out3.boxes.valid, out2.boxes.valid),
                 (out3.poses.valid, out2.poses.valid),
                 (out3.poses.position[out3.poses.valid],
                  out2.poses.position[out2.poses.valid]),
                 (out3.static_depths, out2.static_depths)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["engine", "fleet"])
def test_bf16_tick_meets_the_bf16_bars(paths, path):
    """compute_dtype="bfloat16": 10 ticks of the single rig and of the
    fleet (its frames in bf16) on the kernel backends against the same
    configuration on the plain ones, held to the bf16 bars; the bf16 forms
    launch once a tick and the f32 forms never. The bf16 pool's frames are
    the f32 pool's."""
    from grid_vision_tpu_torch.runtime.stream import FleetPool
    ticks = 10
    base = paths.cfg if path == "engine" else paths.fleet_cfg
    c = dataclasses.replace(base, compute_dtype="bfloat16")
    kern, plain = (paths.engine_of(c),
                   paths.engine_of(dataclasses.replace(c, **PLAIN)))
    if path == "engine":
        obs = paths.obs_seq[:ticks]
        outs = counted(lambda: run_ticks(kern, obs),
                       dict(detector_stem_bf16=ticks, grid_update=ticks,
                            knn_median_depth=ticks))
        assert_bf16_bars(c, outs, run_ticks(plain, obs))
        return
    first = FleetPool(paths.fleet_cfg, N_RIGS, device=paths.engine.device,
                      image_dtype=torch.bfloat16).obs(0)
    assert first.image.dtype == torch.bfloat16
    assert torch.equal(first.image,
                       paths.fleet_obs[0].image.to(torch.bfloat16))
    obs = to_bf16(paths.fleet_obs[:ticks])
    outs = counted(lambda: run_fleet(kern, obs, BUDGET),
                   {k: ticks for k in BF16_KERNELS})
    assert_bf16_bars(c, outs, run_fleet(plain, obs, BUDGET))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["engine", "fleet"])
def test_extension_tick_carves_and_agrees_with_plain(paths, path):
    """The extension tick (compat=False: free-space carving, depth refine,
    class-aware NMS), 20 single-rig ticks and 10 fleet ticks: the carve
    kernel once a tick and the hit-only grid kernel never (the refine
    overrides the static compaction, so the kNN query keeps all 64 slots);
    the scans carve; compare_outputs against the plain backends."""
    base = paths.cfg if path == "engine" else paths.fleet_cfg
    c = dataclasses.replace(base, **EXT)
    kern, plain = (paths.engine_of(c),
                   paths.engine_of(dataclasses.replace(c, **PLAIN)))
    if path == "engine":
        obs, t = paths.obs_seq, ENGINE_TICKS
        outs = counted(lambda: run_ticks(kern, obs),
                       dict(detector_stem=t, knn_median_depth=t,
                            carve_update=t))
        plain_outs = run_ticks(plain, obs)
    else:
        obs, t = paths.fleet_obs, FLEET_TICKS
        outs = counted(lambda: run_fleet(kern, obs, BUDGET),
                       dict({k: t for k in FLEET_KERNELS}, grid_update=0,
                            carve_update=t))
        plain_outs = run_fleet(plain, obs, BUDGET)
    compare_outputs(c, outs, plain_outs, per_rig=path == "fleet")
    assert max(carved_share(c, o, paths.engine.extrinsics)
               for o in obs) > 0.0


@pytest.mark.cuda
def test_yaw_aware_ticks_run_on_the_card(paths):
    """yaw_aware_rasterization (plain torch on every backend) in the
    carve's place: two single-rig and two fleet ticks, finite poses."""
    yaw = dict(compat=False, yaw_aware_rasterization=True)
    outs = run_ticks(paths.engine_of(dataclasses.replace(paths.cfg, **yaw)),
                     paths.obs_seq[:2])
    outs += run_fleet(paths.engine_of(dataclasses.replace(paths.fleet_cfg,
                                                          **yaw)),
                      paths.fleet_obs[:2], BUDGET)
    for o in outs:
        assert torch.isfinite(o.poses.position[o.poses.valid]).all()


# -- the PCA pose branch (use_vision_orientation=False) ---------------------

PCA = dict(use_vision_orientation=False)
PCA_PEAK_GB = 40.0              # half the card


def pca_stage_sync_free(engine, states, obs):
    """The PCA pose branch (plane, association, L-shape) of one tick on the
    boxes the engine's detector gives, run once more with host syncs
    raising."""
    from grid_vision_tpu_torch.geometry import intrinsic_matrix
    from grid_vision_tpu_torch.utils import prng
    cfg = engine.cfg
    with torch.no_grad():
        boxes, _ = pipeline.detect_batch(engine.params, obs.image, cfg)
    boxes = dataclasses.replace(boxes,
                                valid=boxes.valid & obs.has_image[:, None])
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                         device=boxes.xyxy.device)
    rng = prng.split(states.rng)[..., 0, :]

    def call():
        return pipeline.pose_branch(engine.params, obs, boxes, K, rng,
                                    engine.extrinsics, cfg)

    call()
    sync_free(call)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["engine", "fleet", "fleet_bf16",
                                  "extension"])
def test_pca_branch_agrees_with_plain(paths, path):
    """The PCA pose branch on the kernel backends against the plain ones,
    counters from zero, the orientation kernel never: the single rig (10
    ticks, compare_outputs, equal pose counts, its stage free of host
    syncs, no orientation constants folded), the fleet in f32 (5 ticks,
    compare_outputs per rig, peak memory under PCA_PEAK_GB, the stage free
    of host syncs) and bf16 (5 ticks, the bf16 bars), and the extension
    tick (2 ticks, the carve kernel; the scans carve)."""
    from grid_vision_tpu_torch.types import stack
    base = paths.cfg if path in ("engine", "extension") else paths.fleet_cfg
    flags = dict(PCA, **(dict(compat=False, raycast_free_space=True)
                         if path == "extension" else
                         dict(compute_dtype="bfloat16")
                         if path == "fleet_bf16" else {}))
    c = dataclasses.replace(base, **flags)
    kern, plain = (paths.engine_of(c),
                   paths.engine_of(dataclasses.replace(c, **PLAIN)))
    if path in ("engine", "extension"):
        t = 10 if path == "engine" else 2
        obs = paths.obs_seq[:t]
        grid = "grid_update" if path == "engine" else "carve_update"
        outs = counted(lambda: run_ticks(kern, obs),
                       {"detector_stem": t, grid: t, "knn_median_depth": t})
        plain_outs = run_ticks(plain, obs)
        compare_outputs(c, outs, plain_outs, per_rig=False)
        assert ([int(o.poses.valid.sum()) for o in outs]
                == [int(o.poses.valid.sum()) for o in plain_outs])
        if path == "engine":
            assert not any(k.startswith("orientation_stem")
                           for k in kern.params)
            pca_stage_sync_free(kern, stack([kern.init_state()]),
                                stack([obs[0]]))
        else:
            assert max(carved_share(c, o, paths.engine.extrinsics)
                       for o in obs) > 0.0
        return
    t = 5
    if path == "fleet_bf16":
        obs = to_bf16(paths.fleet_obs[:t])
        outs = counted(lambda: run_fleet(kern, obs, BUDGET),
                       dict(detector_stem_bf16=t, detector_csp_bf16=t,
                            grid_update=t, knn_median_depth=t))
        assert_bf16_bars(c, outs, run_fleet(plain, obs, BUDGET))
        return
    obs = paths.fleet_obs[:t]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    outs = counted(lambda: run_fleet(kern, obs, BUDGET),
                   dict(detector_stem=t, detector_csp=t, grid_update=t,
                        knn_median_depth=t))
    assert torch.cuda.max_memory_allocated() <= PCA_PEAK_GB * 2 ** 30
    compare_outputs(c, outs, run_fleet(plain, obs, BUDGET), per_rig=True)
    pca_stage_sync_free(kern, kern.init_states(N_RIGS), obs[0])


@pytest.mark.cuda
def test_kernel_path_against_the_jax_fixture(paths):
    """The kernel path at full width against the JAX package's outputs
    (tests/fixtures/full_width_jax.npz, tools/jax_full_width_fixture.py):
    the same scene, weights and ticks in each mode. f32: occupancy_i8
    agreement >= 99 % (BASELINE.md's bar) and equal box counts every tick.
    bf16 (the JAX package's XLA chain rounds elsewhere than the Pallas
    kernels the port's follow): the bars of the JAX package's own bf16
    against its f32 (PARITY.json production_vs_compat_vision), equal box
    counts on >= 99 % of ticks, agreement >= 97.5 % every tick and >=
    98.5 % on the mean. The PCA modes: bf16 held to >= 99 % every tick
    too (the poses come from the f32 cloud), f32 to equal pose counts as
    well."""
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.runtime.stream import obs_from_scene
    dev = paths.engine.device
    ref = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "full_width_jax.npz"))
    meta = json.loads(str(ref["meta"]))
    off = torch.zeros((), dtype=torch.bool, device=dev)
    for mode, flags in meta["modes"].items():
        mcfg = dataclasses.replace(paths.cfg, **flags)
        bf16 = mcfg.compute_dtype == "bfloat16"
        pca = not mcfg.use_vision_orientation
        eng = paths.engine_of(mcfg)
        scene = SyntheticScene(mcfg, **meta["scene"])
        scene.add_default_traffic()
        scene.add_default_statics()
        state = eng.init_state()
        agree, same = [], []
        for i in range(meta["ticks"]):
            obs = obs_from_scene(scene, i / 10.0, mcfg, dev)
            if i == meta["gated_off_tick"]:
                obs = dataclasses.replace(obs, has_image=off, has_cloud=off)
            state, o = eng(state, obs)
            key = f"{mode}/{i}/"
            n_box = int(o.boxes.valid.sum())
            same.append(n_box == int(ref[key + "boxes_valid"].sum()))
            assert same[-1] or bf16, (mode, i)
            agree.append(float((o.occupancy_i8.cpu().numpy()
                                == ref[key + "occupancy_i8"]).mean()))
            if pca and not bf16:
                assert (int(o.poses.valid.sum())
                        == int(ref[key + "poses_valid"].sum())), (mode, i)
        if pca or not bf16:
            assert min(agree) >= 0.99, (mode, agree)
        if bf16:
            assert sum(same) / len(same) >= 0.99, (mode, same)
            assert sum(agree) / len(agree) >= 0.985, (mode, agree)
            assert min(agree) >= 0.975, (mode, agree)


# -- the five knobs ----------------------------------------------------------

KNOB_TICKS = 2


@pytest.mark.cuda
def test_knob_stems_give_the_xla_stems_activation(paths):
    """detector_s2d_stem and the "im2col" stem: the detector's input
    activation (post-ConvBN_1) of the fleet's frames within 1e-4 + 1e-4
    |ref| of the "xla" stem's."""
    from grid_vision_tpu_torch.device import ieee_convs
    from grid_vision_tpu_torch.ops import preprocess, stem_im2col
    det, frames = paths.nets["detector"], paths.fleet_obs[0].image
    with torch.no_grad(), ieee_convs():
        x = preprocess.preprocess_detector_image(
            frames, paths.cfg.resize).permute(0, 3, 1, 2)
        ref = det.ConvBN_1(det.ConvBN_0(x)).permute(0, 2, 3, 1)
        s2d = det.ConvBN_1(det.ConvBN_0(x, s2d=True), s2d=True).permute(
            0, 2, 3, 1)
        im2col = stem_im2col.detector_stem_im2col(
            frames, stem_im2col.prepare_im2col_constants(det),
            paths.cfg.resize)
    for act in (s2d, im2col):
        assert bool(((act - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["s2d_stem", "im2col_stem", "approx_knn",
                                  "unfolded_orientation", "resnet"])
def test_knob_fleet_tick_agrees_with_its_default(paths, knob):
    """Each knob in the fleet tick (N_RIGS rigs, KNOB_TICKS ticks, budget
    BUDGET) against its default counterpart, counters from zero,
    compare_outputs per rig: detector_s2d_stem (stem "xla") and the
    "im2col" stem against the "xla" stem; knn_backend="approx" against
    "xla" (static depths and the grid equal too); orientation_s2d_fold=
    False against the folded stem; orientation_arch="resnet" (the
    flax-exact init at seed 7, width 32; no resnet checkpoint ships) on
    the kernels against the same tick all plain."""
    from grid_vision_tpu_torch.models import orientation_net
    from grid_vision_tpu_torch.utils import prng
    t, fc = KNOB_TICKS, paths.fleet_cfg
    obs = paths.fleet_obs[:t]
    xla_stem = dataclasses.replace(fc, detector_stem_backend="xla")
    folded = dataclasses.replace(fc, orientation_stem_backend="xla")
    rest = dict(grid_update=t, knn_median_depth=t)
    nets = paths.nets
    if knob == "s2d_stem":
        kcfg = dataclasses.replace(xla_stem, detector_s2d_stem=True)
        rcfg, want = xla_stem, dict(rest, orient_front=t)
    elif knob == "im2col_stem":
        kcfg = dataclasses.replace(fc, detector_stem_backend="im2col")
        rcfg, want = xla_stem, dict(rest, orient_front=t)
    elif knob == "approx_knn":
        kcfg = dataclasses.replace(fc, knn_backend="approx")
        rcfg = dataclasses.replace(fc, knn_backend="xla")
        want = dict(detector_stem=t, detector_csp=t, orient_front=t,
                    grid_update=t)
    elif knob == "unfolded_orientation":
        kcfg = dataclasses.replace(folded, orientation_s2d_fold=False)
        rcfg, want = folded, dict(rest, detector_stem=t, detector_csp=t)
    else:
        kcfg = dataclasses.replace(folded, orientation_arch="resnet")
        rcfg = dataclasses.replace(fc, **PLAIN, orientation_arch="resnet")
        want = dict(rest, detector_stem=t, detector_csp=t)
        nets = dict(nets, orientation=orientation_net.init_params(
            prng.prng_key(7, device=paths.engine.device),
            orientation_net.OrientationConfig(
                input_size=fc.network_height, width=fc.orientation_width,
                arch="resnet")).eval())
    kern = paths.engine_of(kcfg, params=nets)
    other = paths.engine_of(rcfg, params=nets)
    outs = counted(lambda: run_fleet(kern, obs, BUDGET), want)
    refs = run_fleet(other, obs, BUDGET)
    compare_outputs(fc, outs, refs, per_rig=True)
    if knob == "approx_knn":
        for o, r in zip(outs, refs):
            assert torch.equal(o.static_depths, r.static_depths)
            assert torch.equal(o.occupancy_i8, r.occupancy_i8)


@pytest.mark.cuda
def test_unfolded_orientation_net_within_the_folded_ones_bars(paths):
    """orientation_net.forward without the s2d fold against the folded
    stem on BUDGET random crops: tests/test_models.py's bars (1e-4 on the
    orientation, 1e-3 on the confidence and dims)."""
    from grid_vision_tpu_torch.models import orientation_net
    size = paths.fleet_cfg.network_height
    crops = torch.randn((BUDGET, size, size, 3), device=paths.engine.device,
                        generator=torch.Generator(
                            device=paths.engine.device).manual_seed(3))
    with torch.no_grad():
        a = orientation_net.forward(paths.nets["orientation"], crops,
                                    s2d_fold=False)
        b = orientation_net.forward(paths.nets["orientation"], crops,
                                    s2d_fold=True)
    for u, v, tol in zip(a, b, (1e-4, 1e-3, 1e-3)):
        torch.testing.assert_close(u, v, rtol=tol, atol=tol)


# -- the int8 detector (detector_precision="int8") ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["engine", "fleet"])
def test_int8_extension_ticks_equal_the_plain_int8_conv(paths, path,
                                                        monkeypatch):
    """The int8 extension tick (stem "xla", as validate() ties int8 to it):
    5 single-rig and 3 fleet ticks, counters from zero (the carve and kNN
    kernels once a tick, the fleet's orientation front once a tick, the
    int8 conv kernel 19 times a tick), against the same ticks with the
    int8 conv's plain version: occupancy_i8 bit-equal, box counts equal."""
    from grid_vision_tpu_torch.models import yolov4_int8
    ext = dict(EXT, detector_precision="int8", detector_stem_backend="xla")
    n = len(yolov4_int8.LAYERS)
    params = dict(paths.nets, detector_q=yolov4_int8.quantize_detector(
        paths.nets["detector"]))
    if path == "engine":
        eng = paths.engine_of(dataclasses.replace(paths.cfg, **ext),
                              params=params)
        t, seq = 5, paths.obs_seq[:5]

        def run():
            return run_ticks(eng, seq)
        want = dict(knn_median_depth=t, carve_update=t, int8_conv=n * t)
    else:
        eng = paths.engine_of(dataclasses.replace(paths.fleet_cfg, **ext),
                              params=params)
        t, seq = 3, paths.fleet_obs[:3]

        def run():
            return run_fleet(eng, seq, BUDGET)
        want = dict(knn_median_depth=t, carve_update=t, orient_front=t,
                    int8_conv=n * t)
    yolov4_int8.launches = 0
    outs = counted(run, want)
    assert yolov4_int8.launches == n * t
    monkeypatch.setattr(yolov4_int8, "int8_conv_requant",
                        cuda_int8.int8_conv_requant_plain)
    same_ticks(outs, run())


# -- YOLOv4's conv epilogue on the main path ---------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,frames", [(torch.bfloat16, 2 * N_RIGS),
                                          (torch.float32, 16)])
def test_yolov4_epilogue_per_conv_and_once_a_conv_a_tick(paths, dtype,
                                                         frames,
                                                         monkeypatch):
    """The detector_arch="yolov4" Engine on the seeded recipe at the
    fleet's input size: its folded forward on the pool's frames, each of
    the 107 ConvBN convs' output through the epilogue kernel bit-equal to
    bias_act_plain on the same cuDNN output, and the three raw heads
    bit-equal to those of the conv with its bias and the activation after;
    then two fleet ticks of N_RIGS rigs launch the kernel 107 times a
    tick."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.device import ieee_convs
    from grid_vision_tpu_torch.models import yolov4
    from grid_vision_tpu_torch.ops import preprocess
    ycfg = dataclasses.replace(
        paths.fleet_cfg, detector_arch="yolov4", detector_stem_backend="xla",
        compute_dtype=("bfloat16" if dtype == torch.bfloat16
                       else "float32"),
        detection_weights_file="weights/yolov4_seeded.npz")
    eng = pipeline.Engine(ycfg, extrinsics=paths.engine.extrinsics,
                          device=paths.engine.device, base_dir=ROOT)
    model = eng.params["detector"]
    folded = eng.params[pipeline._consts_key("detector_folded", dtype)]
    images = torch.cat([o.image for o in paths.fleet_obs])[:frames]
    x = torch.stack([preprocess.preprocess_detector_image(
        im, ycfg.resize, dtype) for im in images])
    del images
    seen, unequal = [], []

    def checked_conv(self, l, x, folded):
        w, b = folded[l.name]
        y = F.conv2d(x, w, None, l.stride, l.size // 2)
        want = cuda_epilogue.bias_act_plain(y.clone(), b, l.act)
        got = cuda_epilogue.bias_act(y, b, l.act)
        seen.append(l.name)
        if not torch.equal(got, want):
            unequal.append(l.name)
        return got

    def chain_conv(self, l, x, folded):
        w, b = folded[l.name]
        y = F.conv2d(x, w, b, l.stride, l.size // 2)
        return F.mish(y) if l.act == "mish" else F.leaky_relu(y, 0.1)

    heads = []
    for conv in (checked_conv, chain_conv):
        with monkeypatch.context() as m:
            m.setattr(yolov4.YoloV4, "_conv", conv)
            with torch.no_grad(), ieee_convs():
                heads.append(model.heads(model.features(x, folded), folded))
    torch.cuda.synchronize()
    assert len(seen) == 107 and not unequal, unequal
    for g, w in zip(*heads):
        assert torch.equal(g, w)
    del x, heads
    states = eng.init_states(N_RIGS)
    cuda_epilogue.launches = 0
    with torch.no_grad():
        for o in paths.fleet_obs[:2]:
            states, _ = eng.fleet(states, o, BUDGET)
    torch.cuda.synchronize()
    assert cuda_epilogue.launches == 107 * 2
