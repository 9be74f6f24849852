"""The port's multi-object tracker (grid_vision_tpu_torch/ops/tracking.py)
against the JAX package's (grid_vision_tpu/ops/tracking.py), jitted on the
CPU as its own tests run it, on the same seeded numpy inputs.

Every scenario of tests/test_tracking.py runs step by step through both:
the class gate, coast and kill, re-acquisition and its class / radius gate,
the purgatory expiry, the depth disambiguation of a crossing, the
occlusion-coast reporting gate, spawn overflow and priority; then seeded
random sequences (T = 32 slots, 64 detection slots, the vision and PCA
alignments, other capacities and gains). Bars on every step: the integer
and boolean fields (id, valid, hits, misses, age, label, has_pose,
next_id), confirmed() and every TrackStats counter equal; the float fields
within 1e-5 (bit-equal in these runs: the port rounds XLA's fused
multiply-adds once, ops/tracking._fma). cross_iou alone is held to 8
ulps (and 95 % bit-equal): whether XLA contracts the union's products
depends on the shape of the loop it fuses them into (a standalone 40x64
call contracts nothing, a scalar remainder loop nothing either; inside
update_tracks it contracts one area, which the port follows), and the
union's rounding moves the IoU by at most ~4 ulps of the union plus the
division's. Inside update_tracks the match scores are bit-equal but
where the 3D attenuation's exp differs by an ulp. greedy_match is
bit-equal, with tied and all-negative scores. forecast_occupancy within
1e-6 on a 60x40 grid at the served horizons 0.5, 1 and 2 s (sigmoid, cos,
sin and atan2 differ by an ulp between XLA and torch), 5e-6 at h = 0 (see
the case). The rig-batched tracker and forecast equal a per-rig loop exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.io import viz as jviz
from grid_vision_tpu.ops import tracking as jtr
from grid_vision_tpu import types as jtypes
from torch.utils._python_dispatch import TorchDispatchMode

from grid_vision_tpu_torch import types
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io import viz
from grid_vision_tpu_torch.ops import tracking

torch.set_num_threads(1)

INT_FIELDS = ("label", "id", "hits", "misses", "age", "valid", "has_pose",
              "next_id")
STATS = ("matched", "spawned", "killed", "spawn_dropped", "reacquired")
PCA = dict(use_vision_orientation=False)


# ---------------------------------------------------------------------------
# inputs: one numpy frame, both packages' StepOutput
# ---------------------------------------------------------------------------

def frame(rows, positions=None, static_valid=None, capacity=16,
          pose_capacity=None, pose_valid=None, dims=(4.0, 1.8, 1.4),
          quat=(0.0, 0.0, 0.0, 1.0), static_points=None):
    """rows: (xyxy, conf, label) per box slot. positions: base-frame poses
    of the first slots (valid where the boxes are, or pose_valid)."""
    pcap = capacity if pose_capacity is None else pose_capacity
    f = dict(xyxy=np.zeros((capacity, 4), np.float32),
             conf=np.zeros((capacity,), np.float32),
             label=np.full((capacity,), 10, np.int32),
             valid=np.zeros((capacity,), bool),
             pos=np.zeros((pcap, 3), np.float32),
             quat=np.tile(np.float32(quat), (pcap, 1)),
             dims=np.tile(np.float32(dims), (pcap, 1)))
    for i, (bb, c, lb) in enumerate(rows):
        f["xyxy"][i], f["conf"][i], f["label"][i] = bb, c, lb
        f["valid"][i] = True
    if positions is None:
        f["pvalid"] = np.zeros((pcap,), bool)
    else:
        f["pos"][:len(positions)] = positions
        f["pvalid"] = (f["valid"][:pcap].copy() if pose_valid is None
                       else np.asarray(pose_valid, bool))
    f["static"] = (np.zeros((capacity,), bool) if static_valid is None
                   else np.asarray(static_valid, bool))
    f["sdep"] = np.where(f["static"], 5.0, -1.0).astype(np.float32)
    f["spts"] = (np.zeros((capacity, 3), np.float32)
                 if static_points is None
                 else np.asarray(static_points, np.float32))
    return f


def jax_output(f):
    b = jtypes.Boxes(xyxy=jnp.asarray(f["xyxy"]),
                     confidence=jnp.asarray(f["conf"]),
                     label=jnp.asarray(f["label"]),
                     valid=jnp.asarray(f["valid"]))
    pcap = f["pos"].shape[0]
    p = jtypes.LShapePoses(
        position=jnp.asarray(f["pos"]), quat=jnp.asarray(f["quat"]),
        length=jnp.asarray(f["dims"][:, 0]),
        width=jnp.asarray(f["dims"][:, 1]),
        height=jnp.asarray(f["dims"][:, 2]),
        label=jnp.asarray(f["label"][:pcap]),
        valid=jnp.asarray(f["pvalid"]))
    return jtypes.StepOutput(
        boxes=b, poses=p, static_points=jnp.asarray(f["spts"]),
        static_depths=jnp.asarray(f["sdep"]),
        static_boxes=dataclasses.replace(b, valid=jnp.asarray(f["static"])),
        occupancy_i8=jnp.zeros((8, 8), jnp.int8),
        saturation=jtypes.SaturationStats.zeros())


def port_output(f):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    b = types.Boxes(xyxy=t(f["xyxy"]), confidence=t(f["conf"]),
                    label=t(f["label"]), valid=t(f["valid"]))
    pcap = f["pos"].shape[0]
    p = types.LShapePoses(
        position=t(f["pos"]), quat=t(f["quat"]), length=t(f["dims"][:, 0]),
        width=t(f["dims"][:, 1]), height=t(f["dims"][:, 2]),
        label=t(f["label"][:pcap]), valid=t(f["pvalid"]))
    z = torch.zeros((), dtype=torch.int32)
    return types.StepOutput(
        boxes=b, poses=p, static_points=t(f["spts"]),
        static_depths=t(f["sdep"]),
        static_boxes=dataclasses.replace(b, valid=t(f["static"])),
        occupancy_i8=torch.zeros((8, 8), dtype=torch.int8),
        saturation=types.SaturationStats(z, z, z, z, z))


def state_numpy(tracks):
    return {f.name: np.asarray(getattr(tracks, f.name))
            for f in dataclasses.fields(tracks)}


def assert_tracks_equal(got, ref, what, tol=1e-5):
    for name, want in state_numpy(ref).items():
        have = getattr(got, name).numpy()
        if name in INT_FIELDS:
            np.testing.assert_array_equal(have, want, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(have, want, rtol=0, atol=tol,
                                       err_msg=f"{what} {name}")


def run_both(frames, dt=1.0, tcfg_kw=None, cfg_kw=PCA):
    """Both trackers over the frames, held to each other on every step.
    Returns (port TrackState, JAX TrackState, port TrackStats per step,
    port TrackConfig)."""
    tcfg_kw = tcfg_kw or {}
    jtc, tc = jtr.TrackConfig(**tcfg_kw), tracking.TrackConfig(**tcfg_kw)
    jcfg, cfg = JaxConfig(**cfg_kw), GridVisionConfig(**cfg_kw)
    upd = jax.jit(functools.partial(jtr.update_tracks, cfg=jcfg, tcfg=jtc))
    conf = jax.jit(lambda s: s.confirmed(jtc))
    jtracks = jtr.TrackState.create(jtc)
    tracks = tracking.TrackState.create(tc)
    all_stats = []
    for i, f in enumerate(frames):
        jtracks, jstats = upd(jtracks, jax_output(f), dt)
        tracks, stats = tracking.update_tracks(tracks, port_output(f), dt,
                                               cfg, tc)
        assert_tracks_equal(tracks, jtracks, f"step {i}")
        for name in STATS:
            assert int(getattr(stats, name)) == int(getattr(jstats, name)), (
                i, name)
        np.testing.assert_array_equal(tracks.confirmed(tc).numpy(),
                                      np.asarray(conf(jtracks)))
        all_stats.append(stats)
    return tracks, jtracks, all_stats, tc


def _valid_slot(tracks):
    return int(np.asarray(tracks.valid).argmax())


# ---------------------------------------------------------------------------
# cross_iou, greedy_match, per_box_pose
# ---------------------------------------------------------------------------

def _random_boxes(rng, n):
    xy = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    wh = rng.uniform(5, 200, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_iou_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _random_boxes(rng, 40), _random_boxes(rng, 64)
    b[:30] = a[:30] + rng.normal(0, 5, (30, 4)).astype(np.float32)
    b[30] = a[31]                                   # identical boxes
    b[31] = [5, 5, 5, 40]                           # zero area
    ref = np.asarray(jax.jit(jtr.cross_iou)(a, b))
    got = tracking.cross_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_max_ulp(got.numpy(), ref, maxulp=8)
    assert (got.numpy() == ref).mean() > 0.95
    # a leading rig axis: each rig its own pairs
    both = tracking.cross_iou(torch.from_numpy(np.stack([a, a[::-1]])),
                              torch.from_numpy(np.stack([b, b])))
    assert torch.equal(both[0], got)
    assert torch.equal(both[1], tracking.cross_iou(
        torch.from_numpy(a[::-1].copy()), torch.from_numpy(b)))


def _match_cases():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(12):
        t, d = int(rng.integers(1, 12)), int(rng.integers(1, 20))
        cases.append(rng.uniform(-1, 1, (t, d)).astype(np.float32))
    # ties: scores on a coarse lattice, many equal maxima
    for _ in range(6):
        t, d = int(rng.integers(2, 10)), int(rng.integers(2, 16))
        cases.append((rng.integers(-2, 4, (t, d)) / 4.0).astype(np.float32))
    cases.append(np.full((5, 7), 0.5, np.float32))          # all tied
    cases.append(-rng.uniform(0, 1, (6, 9)).astype(np.float32))  # none > 0
    cases.append(np.zeros((4, 4), np.float32))              # 0 is not > 0
    cases.append(rng.uniform(0, 1, (32, 64)).astype(np.float32))
    return cases


@pytest.mark.parametrize("case", range(len(_match_cases())))
def test_greedy_match_matches_jax(case):
    score = _match_cases()[case]
    tm_ref, dm_ref = jax.jit(jtr.greedy_match)(jnp.asarray(score))
    tm, dm = tracking.greedy_match(torch.from_numpy(score))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(tm_ref))
    np.testing.assert_array_equal(dm.numpy(), np.asarray(dm_ref))


def test_greedy_match_batched_equals_per_rig():
    cases = [c for c in _match_cases() if c.shape == (4, 4)] + [
        np.random.default_rng(r).uniform(-1, 1, (4, 4)).astype(np.float32)
        for r in range(3)]
    s = torch.from_numpy(np.stack(cases))
    tm, dm = tracking.greedy_match(s)
    for r in range(len(cases)):
        tm_r, dm_r = tracking.greedy_match(s[r])
        assert torch.equal(tm[r], tm_r) and torch.equal(dm[r], dm_r)


def _vision_output(rigs=False):
    cap, pcap = 8, 4
    f = frame([([0, 0, 10, 10], 0.9, 5),       # static (light)
               ([20, 0, 30, 10], 0.8, 9),      # dynamic
               ([40, 0, 50, 10], 0.7, 2),      # dynamic
               ([60, 0, 70, 10], 0.6, 0)],     # dynamic, beyond the poses
              positions=[[1, 2, 3], [4, 5, 6], [7, 8, 9]], capacity=cap,
              pose_capacity=pcap, pose_valid=[True, True, False, False],
              static_valid=[True] + [False] * (cap - 1),
              static_points=[[7, 8, 9]] + [[0, 0, 0]] * (cap - 1))
    f["dims"] = np.arange(pcap * 3, dtype=np.float32).reshape(pcap, 3)
    return f


@pytest.mark.parametrize("vision", [True, False])
def test_per_box_pose_matches_jax(vision):
    f = _vision_output() if vision else frame(
        [([0, 0, 10, 10], 0.9, 5), ([20, 0, 30, 10], 0.8, 9)],
        positions=[[1, 2, 3], [4, 5, 6]], capacity=8,
        static_valid=[True] + [False] * 7,
        static_points=[[7, 8, 9]] + [[0, 0, 0]] * 7)
    kw = dict(use_vision_orientation=vision)
    ref = jax.jit(functools.partial(jtr.per_box_pose,
                                    cfg=JaxConfig(**kw)))(jax_output(f))
    got = tracking.per_box_pose(port_output(f), GridVisionConfig(**kw))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if vision:     # tests/test_tracking.py::test_per_box_pose_vision_...
        np.testing.assert_array_equal(got[0].numpy()[:3],
                                      [[7, 8, 9], [1, 2, 3], [4, 5, 6]])
        assert list(got[3].numpy()[:4]) == [True, True, True, False]
    # with a rig axis: each rig's own alignment
    out2 = types.stack([port_output(f), port_output(f)])
    got2 = tracking.per_box_pose(out2, GridVisionConfig(**kw))
    for g, g2 in zip(got, got2):
        assert torch.equal(g2[0], g) and torch.equal(g2[1], g)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_tracking.py, step by step through both
# ---------------------------------------------------------------------------

def test_class_gate():
    tracks, _, stats, _ = run_both([
        frame([([10, 10, 50, 50], 0.9, 9)], positions=[[5, 0, 0]]),
        frame([([10, 10, 50, 50], 0.9, 2)], positions=[[5, 0, 0]])],
        dt=0.1, tcfg_kw=dict(capacity=4))
    assert int(stats[1].matched) == 0 and int(stats[1].spawned) == 1
    assert int(tracks.valid.sum()) == 2


def test_coast_and_kill():
    moving = [frame([([10 + 20 * k, 10, 50 + 20 * k, 50], 0.9, 9)],
                    positions=[[5 + k, 0, 0]]) for k in range(2)]
    empty = frame([])
    frames = moving + [empty] * 4 + [frame([([10, 10, 50, 50], 0.9, 9)])]
    tracks, _, stats, _ = run_both(
        frames, tcfg_kw=dict(capacity=4, max_misses=3, min_hits=1,
                             purgatory=0))
    assert [int(s.killed) for s in stats] == [0, 0, 0, 0, 0, 1, 0]
    assert int(tracks.valid.sum()) == 1
    assert int(tracks.id[_valid_slot(tracks)]) == 1     # a fresh id


def test_reacquisition_keeps_id():
    tcfg_kw = dict(capacity=4, max_misses=2, min_hits=1, purgatory=10)
    frames = [frame([([10, 10, 50, 50], 0.9, 9)], positions=[[5.0 + k, 0, 0]])
              for k in range(2)]
    frames += [frame([])] * 5
    frames.append(frame([([300, 10, 340, 50], 0.9, 9)],
                        positions=[[11.5, 0, 0]]))
    tracks, _, stats, tc = run_both(frames, tcfg_kw=tcfg_kw)
    assert int(stats[-1].reacquired) == 1 and int(stats[-1].spawned) == 0
    i = _valid_slot(tracks)
    assert int(tracks.id[i]) == 0 and int(tracks.misses[i]) == 0
    assert bool(tracks.confirmed(tc)[i])
    np.testing.assert_allclose(tracks.xyxy[i].numpy(), [300, 10, 340, 50])


@pytest.mark.parametrize("label,x", [(2, 5.0), (9, 8.0)])
def test_reacquisition_class_and_radius_gated(label, x):
    frames = [frame([([10, 10, 50, 50], 0.9, 9)], positions=[[5.0, 0, 0]])
              ] * 2 + [frame([])] * 3
    frames.append(frame([([10, 10, 50, 50], 0.9, label)],
                        positions=[[x, 0, 0]]))
    _, _, stats, _ = run_both(frames, tcfg_kw=dict(
        capacity=4, max_misses=1, min_hits=1, purgatory=10,
        reacq_radius=1.0, reacq_radius_rate=0.0))
    assert int(stats[-1].reacquired) == 0 and int(stats[-1].spawned) == 1


def test_purgatory_expiry_kills():
    frames = [frame([([10, 10, 50, 50], 0.9, 9)], positions=[[5.0, 0, 0]])]
    frames += [frame([])] * 5
    tracks, _, stats, _ = run_both(frames, tcfg_kw=dict(
        capacity=4, max_misses=1, min_hits=1, purgatory=3))
    assert [int(s.killed) for s in stats] == [0, 0, 0, 0, 0, 1]
    assert int(tracks.valid.sum()) == 0


def test_match_depth_disambiguates_crossing():
    frames = [frame([([10, 10, 50, 50], 0.9, 9), ([12, 10, 52, 50], 0.9, 9)],
                    positions=[[5.0, 0, 0], [15.0, 0, 0]]),
              frame([([12, 10, 52, 50], 0.9, 9), ([10, 10, 50, 50], 0.9, 9)],
                    positions=[[15.2, 0, 0], [5.1, 0, 0]])]
    tracks, _, stats, _ = run_both(frames, tcfg_kw=dict(
        capacity=4, min_hits=1, iou_min=0.1))
    assert int(stats[1].matched) == 2
    pos, ids = tracks.position.numpy(), tracks.id.numpy()
    assert abs(pos[int(np.flatnonzero(ids == 0)[0]), 0] - 5.1) < 1.0
    assert abs(pos[int(np.flatnonzero(ids == 1)[0]), 0] - 15.2) < 1.0


def test_occl_coast_reporting_gate():
    tcfg_kw = dict(capacity=4, max_misses=1, min_hits=1, purgatory=10,
                   occl_coast_iou=0.25, iou_min=0.1)
    first = frame([([10, 10, 50, 50], 0.9, 9), ([8, 8, 52, 52], 0.9, 9)],
                  positions=[[20.0, 0, 0], [6.0, 0, 0]])
    occ = frame([([8, 8, 52, 52], 0.9, 9)], positions=[[6.0, 0, 0]])
    tracks, _, _, tc = run_both([first] + [occ] * 3, tcfg_kw=tcfg_kw)
    far = int(tracks.position[:, 0].argmax())
    assert int(tracks.misses[far]) > tc.max_misses
    assert bool(tracks.confirmed(tc)[far])               # occluded: kept
    off = tracking.TrackConfig(**dict(tcfg_kw, occl_coast_iou=0.0))
    assert not bool(tracks.confirmed(off)[far])
    moved = [frame([([x0, 8, x0 + 44, 52], 0.9, 9)], positions=[[6.0, 0.5, 0]])
             for x0 in (30, 60, 110)]
    tracks, _, stats, tc = run_both([first] + [occ] * 3 + moved,
                                    tcfg_kw=tcfg_kw)
    assert [int(s.matched) for s in stats[-3:]] == [1, 1, 1]
    assert not bool(tracks.confirmed(tc)[far])


def test_spawn_overflow_and_priority():
    rows = [([10 + 60 * i, 10, 50 + 60 * i, 50], 0.9 - 0.1 * i, 9)
            for i in range(6)]
    tracks, _, stats, _ = run_both([frame(rows)], dt=0.1,
                                   tcfg_kw=dict(capacity=4))
    assert int(stats[0].spawned) == 4 and int(stats[0].spawn_dropped) == 2
    confs = sorted(float(c) for c in tracks.confidence[tracks.valid])
    np.testing.assert_allclose(confs, [0.6, 0.7, 0.8, 0.9], atol=1e-6)
    assert int(tracks.next_id) == 4


def test_spawn_ties_keep_slot_order():
    """Equal confidences spawn in box-slot order (a stable sort)."""
    rows = [([10 + 60 * i, 10, 50 + 60 * i, 50], 0.8, 9) for i in range(6)]
    tracks, _, _, _ = run_both([frame(rows)], tcfg_kw=dict(capacity=4))
    np.testing.assert_array_equal(tracks.xyxy[:, 0].numpy(),
                                  [10, 70, 130, 190])


# ---------------------------------------------------------------------------
# seeded random sequences
# ---------------------------------------------------------------------------

def random_frames(seed, n, capacity=64, n_obj=12, pose_capacity=None):
    """n frames of n_obj objects moving in pixels and in 3D, with box
    jitter, dropouts, a false positive now and then, poses missing at
    random, static boxes (label 0) with and without a measured depth."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform([-5, -10, 0], [40, 10, 1], (n_obj, 3))
    v = rng.uniform(-3, 3, (n_obj, 3))
    v[:, 2] = 0
    px0 = rng.uniform(0, 500, (n_obj, 2))
    pv = rng.uniform(-20, 20, (n_obj, 2))
    size = rng.uniform(20, 120, (n_obj, 2))
    label = rng.choice([0, 2, 9], n_obj)
    pcap = capacity if pose_capacity is None else pose_capacity
    out = []
    for t in range(n):
        rows, pos = [], []
        for o in range(n_obj):
            if rng.uniform() < 0.15:
                continue
            c = px0[o] + pv[o] * t * 0.1 + rng.normal(0, 1.5, 2)
            rows.append(([c[0], c[1], c[0] + size[o, 0], c[1] + size[o, 1]],
                         rng.uniform(0.5, 0.95), int(label[o])))
            pos.append(p0[o] + v[o] * t * 0.1 + rng.normal(0, 0.15, 3))
        if rng.uniform() < 0.3:
            c = rng.uniform(0, 500, 2)
            rows.append(([c[0], c[1], c[0] + 50, c[1] + 40], 0.6, 9))
            pos.append(rng.uniform(0, 30, 3))
        order = np.argsort([-r[1] for r in rows], kind="stable")
        rows = [rows[k] for k in order][:capacity]
        pos = np.asarray(pos, np.float32)[order][:pcap]
        f = frame(rows, positions=pos, capacity=capacity,
                  pose_capacity=pcap,
                  quat=(0.0, 0.0, 0.0998, 0.995), dims=(4.0, 1.8, 1.5))
        f["pvalid"] &= rng.uniform(size=pcap) < 0.9
        f["static"] = f["valid"] & (f["label"] == 0)
        f["sdep"] = np.where(f["static"] & (rng.uniform(size=capacity) < 0.8),
                             5.0, -1.0).astype(np.float32)
        f["spts"] = np.zeros((capacity, 3), np.float32)
        f["spts"][:pcap] = pos.tolist() + [[0, 0, 0]] * (pcap - len(pos))
        f["spts"] += np.float32(0.3)
        out.append(f)
    return out


@pytest.mark.parametrize("case", [
    dict(seed=0),
    dict(seed=1, cfg_kw=dict(use_vision_orientation=True), pose_capacity=8),
    dict(seed=2, capacity=16, tcfg_kw=dict(capacity=4)),
    dict(seed=3, capacity=24, n_obj=20, tcfg_kw=dict(
        capacity=12, reacq_radius_rate=1.7)),
    dict(seed=4, tcfg_kw=dict(occl_coast_iou=0.25, match_depth_scale=3.0,
                              box_vel_alpha=0.3, vel_gain=0.13)),
])
def test_random_sequences_match_jax(case):
    case = dict(case)
    kw = {k: case.pop(k) for k in ("cfg_kw", "tcfg_kw") if k in case}
    frames = random_frames(case.pop("seed"), 40, **case)
    tracks, _, stats, tc = run_both(frames, dt=0.1, **kw)
    # the sequence exercises the tracker: matches, spawns and kills
    assert sum(int(s.matched) for s in stats) > 40
    assert int(tracks.next_id) > 1
    assert bool(tracks.confirmed(tc).any())


# ---------------------------------------------------------------------------
# forecast, rig batching, markers
# ---------------------------------------------------------------------------

SMALL_GRID = dict(grid_x=15, grid_y=10, resolution=0.25)      # 60 x 40


def random_state(seed, tcfg, center):
    rng = np.random.default_rng(seed)
    t = tcfg.capacity
    d = state_numpy(jtr.TrackState.create(tcfg))
    d["position"] = np.concatenate(
        [rng.uniform(np.subtract(center, [8, 4]), np.add(center, [8, 4]),
                     (t, 2)), rng.uniform(0, 1, (t, 1))], 1).astype(np.float32)
    d["velocity"] = rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, t)
    d["quat"] = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2),
                          np.cos(yaw / 2)], 1).astype(np.float32)
    d["length"] = rng.uniform(0.1, 5, t).astype(np.float32)
    d["width"] = rng.uniform(0.1, 2.5, t).astype(np.float32)
    d["valid"] = rng.uniform(size=t) < 0.7
    d["has_pose"] = rng.uniform(size=t) < 0.8
    d["hits"] = rng.integers(0, 5, t).astype(np.int32)
    d["misses"] = rng.integers(0, 8, t).astype(np.int32)
    d["xyxy"] = _random_boxes(rng, t)
    return d


@pytest.mark.parametrize("horizons,tol", [
    ((0.5, 1.0, 2.0), 1e-6),
    # h = 0: sigma 0.2 m, the steepest roll-off (5 per meter); XLA's atan2
    # differs from torch's by an ulp on part of the inputs, which moves a
    # footprint's rotated coordinate by up to ~1e-6 m at 8 m
    ((0.0,), 5e-6)])
@pytest.mark.parametrize("tcfg_kw", [{}, dict(occl_coast_iou=0.25)])
def test_forecast_occupancy_matches_jax(tcfg_kw, horizons, tol):
    jtc, tc = jtr.TrackConfig(**tcfg_kw), tracking.TrackConfig(**tcfg_kw)
    jcfg, cfg = JaxConfig(**SMALL_GRID), GridVisionConfig(**SMALL_GRID)
    d = random_state(0, jtc, jcfg.grid_center)
    jstate = jtr.TrackState(**{k: jnp.asarray(v) for k, v in d.items()})
    ref = np.asarray(jax.jit(functools.partial(
        jtr.forecast_occupancy, horizons=horizons, cfg=jcfg,
        tcfg=jtc))(jstate))
    state = tracking.track_state_from_numpy(d)
    got = tracking.forecast_occupancy(state, horizons, cfg, tc)
    assert got.shape == ref.shape == (len(horizons), 60, 40)
    assert ref.max() > 0.5                     # footprints on the raster
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_array_equal(state.confirmed(tc).numpy(),
                                  np.asarray(jstate.confirmed(jtc)))
    empty = tracking.forecast_occupancy(tracking.TrackState.create(tc),
                                        (1.0,), cfg, tc)
    assert float(empty.max()) == 0.0


def test_rig_batched_tracker_equals_per_rig_loop():
    cfg, tc = GridVisionConfig(**PCA), tracking.TrackConfig(capacity=8)
    rigs = [random_frames(seed, 12, capacity=16, n_obj=6)
            for seed in (5, 6, 7)]
    batched = tracking.TrackState.create(tc, rigs=3)
    single = [tracking.TrackState.create(tc) for _ in range(3)]
    for t in range(12):
        outs = [port_output(rigs[r][t]) for r in range(3)]
        batched, bstats = tracking.update_tracks(batched, types.stack(outs),
                                                 0.1, cfg, tc)
        for r in range(3):
            single[r], stats = tracking.update_tracks(single[r], outs[r],
                                                      0.1, cfg, tc)
            for f in dataclasses.fields(batched):
                assert torch.equal(getattr(batched, f.name)[r],
                                   getattr(single[r], f.name)), (t, r, f.name)
            for name in STATS:
                assert torch.equal(getattr(bstats, name)[r],
                                   getattr(stats, name))
    assert int(batched.next_id.min()) > 0
    fc = tracking.forecast_occupancy(batched, (0.5, 1.0), cfg, tc)
    for r in range(3):
        assert torch.equal(fc[r], tracking.forecast_occupancy(
            single[r], (0.5, 1.0), cfg, tc))


def test_track_markers_match_jax():
    tcfg_kw = dict(capacity=8)
    frames = random_frames(8, 6, capacity=16, n_obj=5)
    tracks, jtracks, _, tc = run_both(frames, dt=0.1, tcfg_kw=tcfg_kw)
    got = viz.track_markers(tracks, tc)
    ref = jviz.track_markers(jtracks, jtr.TrackConfig(**tcfg_kw))
    assert [m["ns"] for m in got] == [m["ns"] for m in ref]
    assert {m["ns"] for m in got} == {"track", "track_velocity"}
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if isinstance(g[k], (list, tuple)) and g[k] and \
                    isinstance(g[k][0], float):
                np.testing.assert_allclose(g[k], r[k], atol=1e-5)
            elif isinstance(g[k], float):
                assert abs(g[k] - r[k]) < 1e-5
            else:
                assert g[k] == r[k], k


class _OpCount(TorchDispatchMode):
    """Counts the torch ops a call dispatches, views aside: on the card
    each is about one kernel launch."""

    VIEWS = {"view", "_unsafe_view", "expand", "unsqueeze", "select",
             "slice", "t", "transpose", "permute", "reshape", "as_strided",
             "alias", "squeeze", "detach", "lift_fresh", "unbind", "split"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in self.VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _OpCount() as c:
        fn()
    return c.n


def test_tracker_dispatch_counts():
    """The tracker's launch cost, counted on the CPU: the greedy matcher
    is six ops a pass over min(T, D) fixed passes, and neither
    update_tracks nor the forecast dispatches more ops for more rigs
    (PERF.md quotes these counts beside the card's launches)."""
    fixed = set()
    for t, d in ((32, 64), (8, 5)):
        score = torch.rand(3, t, d)
        fixed.add(_ops(lambda: tracking.greedy_match(score)) - 6 * min(t, d))
    assert len(fixed) == 1 and fixed.pop() <= 16
    cfg, tc = GridVisionConfig(), tracking.TrackConfig()
    outs = [port_output(f) for f in random_frames(0, 3, capacity=64)]
    counts = {}
    for rigs in (1, 4):
        out = types.stack([outs[2]] * rigs)
        tracks = tracking.TrackState.create(tc, rigs=rigs)
        tracks, _ = tracking.update_tracks(tracks, out, 0.1, cfg, tc)
        counts[rigs] = (
            _ops(lambda: tracking.update_tracks(tracks, out, 0.1, cfg, tc)),
            _ops(lambda: tracking.forecast_occupancy(
                tracks, (0.5, 1.0, 2.0), cfg, tc)))
    assert counts[1] == counts[4], counts
    update, forecast = counts[1]
    assert 2 * 6 * 32 < update <= 760, counts
    assert forecast <= 150, counts
