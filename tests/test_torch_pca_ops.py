"""The ops of the PCA pose branch (use_vision_orientation=False) against the
JAX package's, on the same inputs made from a seed with numpy:

- utils/prng.uniform against jax.random.uniform: bit-equal, one key and a
  batch of rig keys;
- ops/plane.segment_ground_plane against JAX's jitted one (each rig's own
  key, and vmapped over rigs): the non-ground mask and `ok` equal (no
  point flips on these seeds; a flip would be an ulp on the 0.04 m edge),
  the plane within 1e-4 up to its sign; degenerate clouds (fewer than 3
  valid points, collinear, empty) give ok=False and an all-False mask;
  the closed-form smallest eigenvector against numpy's eigh;
- ops/association.assign_points_to_boxes, gather_box_clouds and
  count_assigned exactly equal, with overlapping boxes, points on box
  edges and truncated sub-clouds;
- ops/lshape.radius_outlier_mask exactly equal (also chunked);
  pca_lshape_poses within 1e-4 (position, length, width, quat), valid
  equal, except boxes whose 2x2 covariance is nearly isotropic (eigenvalue
  gap under 5 % of the trace: the axis, and with quirk Q4 the quaternion,
  is ill-conditioned there), which are held to finiteness (one box of the
  four seeds, seed 0's round one, falls under the rule; it agrees to 1e-6
  all the same); and the port against the NumPy oracle as
  tests/test_lshape.py holds the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.ops import association as jassoc
from grid_vision_tpu.ops import lshape as jlshape
from grid_vision_tpu.ops import plane as jplane
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu_torch.ops import association, lshape, plane
from grid_vision_tpu_torch.types import Boxes
from grid_vision_tpu_torch.utils import prng

from .oracle.reference_oracle import pca_lshape, radius_outlier_removal

torch.set_num_threads(1)

K_NP = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]],
                np.float32)
ITERS, THRESHOLD = 32, 0.04
SENTINEL = 1.0e8
POSE_TOL = dict(rtol=1e-4, atol=1e-4)


def _key(jkey) -> torch.Tensor:
    return torch.tensor(np.asarray(jkey).astype(np.int64)).to(torch.uint32)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 33 + 5])
def test_uniform_bit_equal_to_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.uniform(jkey, (ITERS, 3)))
    got = prng.uniform(_key(jkey), (ITERS, 3)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_uniform_batch_of_rig_keys_bit_equal_to_jax():
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (128, 3)))(
        keys))
    got = prng.uniform(_key(keys), (128, 3)).numpy()
    assert got.shape == (5, 128, 3)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


def _ground_scene(seed, n_ground=1500, n_obj=300, capacity=2048):
    """A camera-frame cloud (y down): a noisy ground plane 1.8 m below the
    camera and a box of object points, packed valid-first."""
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-10, 10, n_ground),
                       1.8 + rng.normal(0, 0.02, n_ground),
                       rng.uniform(1, 50, n_ground)], 1)
    obj = np.stack([rng.uniform(-2, 2, n_obj), rng.uniform(-0.5, 1.4, n_obj),
                    rng.uniform(8, 12, n_obj)], 1)
    xyz = np.concatenate([ground, obj]).astype(np.float32)
    rng.shuffle(xyz)
    out = np.full((capacity, 3), SENTINEL, np.float32)
    out[:len(xyz)] = xyz
    return out, np.arange(capacity) < len(xyz)


@pytest.fixture(scope="module")
def ground_runs():
    """Four rigs (seeds 0-3) through JAX's jitted plane fit, each with its
    own key; the port's batched fit over the four."""
    xyz, valid = zip(*(_ground_scene(s) for s in range(4)))
    xyz, valid = np.stack(xyz), np.stack(valid)
    keys = jnp.stack([jax.random.split(jax.random.PRNGKey(s))[0]
                      for s in range(4)])
    fit = jax.jit(lambda x, v, k: jplane.segment_ground_plane(
        x, v, k, ITERS, THRESHOLD))
    ref = [tuple(np.asarray(a) for a in fit(xyz[i], valid[i], keys[i]))
           for i in range(4)]
    vref = [np.asarray(a) for a in jax.jit(jax.vmap(fit))(xyz, valid, keys)]
    got = plane.segment_ground_plane(torch.tensor(xyz), torch.tensor(valid),
                                     _key(keys), ITERS, THRESHOLD)
    return ref, vref, [g.numpy() for g in got]


@pytest.mark.parametrize("rig", [0, 1, 2, 3])
def test_segment_ground_plane_matches_jax(ground_runs, rig):
    ref, vref, (non_ground, coeffs, ok) = ground_runs
    r_ng, r_plane, r_ok = ref[rig]
    flipped = int((non_ground[rig] != r_ng).sum())
    assert flipped == 0, f"{flipped} points on the other side of the edge"
    np.testing.assert_array_equal(non_ground[rig], vref[0][rig])
    assert bool(ok[rig]) == bool(r_ok) and bool(r_ok)
    sign = np.sign(coeffs[rig][1] * r_plane[1])
    np.testing.assert_allclose(coeffs[rig] * sign, r_plane, **POSE_TOL)
    # the ground went, the object stayed
    assert 250 <= non_ground[rig].sum() <= 400


@pytest.mark.parametrize("case", ["two_points", "collinear", "empty"])
def test_segment_ground_plane_degenerate(case):
    cap = 64
    xyz = np.full((cap, 3), SENTINEL, np.float32)
    n = {"two_points": 2, "collinear": 40, "empty": 0}[case]
    # on a line with integer coordinates: every cross product is exactly 0
    t = np.arange(n, dtype=np.float32)
    xyz[:n] = np.stack([t, 2.0 * t, 3.0 * t + 2.0], 1)
    valid = np.arange(cap) < n
    jkey = jax.random.PRNGKey(3)
    r_ng, _, r_ok = jplane.segment_ground_plane(
        jnp.asarray(xyz), jnp.asarray(valid), jkey, ITERS, THRESHOLD)
    ng, coeffs, ok = plane.segment_ground_plane(
        torch.tensor(xyz)[None], torch.tensor(valid)[None], _key(jkey)[None],
        ITERS, THRESHOLD)
    assert not bool(r_ok) and not bool(ok[0])
    assert not np.asarray(r_ng).any() and not ng.any()
    assert torch.isfinite(coeffs).all()


def test_smallest_eigenvector_matches_numpy():
    rng = np.random.default_rng(5)
    mats = []
    for scales in ([1, 1, 1], [100, 50, 1e-4], [30, 1e-3, 1e-3],
                   [1e-6, 1e-6, 1e-6], [0, 0, 0]):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        mats.append((q * np.asarray(scales, float)) @ q.T)
    for _ in range(50):
        a = rng.normal(size=(3, 6))
        mats.append(a @ a.T)
    mats = np.stack(mats)
    got = plane.smallest_eigenvector(torch.tensor(mats)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-12)
    w, v = np.linalg.eigh(mats)
    ref = v[..., 0]
    distinct = (w[:, 1] - w[:, 0]) > 1e-6 * np.maximum(w[:, 2], 1e-30)
    align = np.abs(np.sum(got * ref, axis=-1))
    assert distinct.sum() >= 50
    np.testing.assert_allclose(align[distinct], 1.0, atol=1e-9)
    # where the smallest eigenvalue repeats, the vector lies in its space
    resid = np.linalg.norm(np.einsum("nij,nj->ni", mats, got)
                           - w[:, :1] * got, axis=-1)
    assert (resid <= 1e-9 * np.maximum(w[:, 2], 1.0)).all()


BOXES = [[100, 100, 250, 280], [220, 90, 400, 300],      # overlap
         [500, 350, 630, 470], [-50, -50, 30, 40],        # partly off image
         [300, 200, 300, 200], [0, 0, 639, 479]]          # a point; all


def _box_case(seed, n=1500, capacity=2048, n_rigs=2):
    """R rigs of random camera-frame points (some behind the camera, some
    projecting exactly onto box edges) and the BOXES, one slot left
    invalid, rig 1's boxes shifted."""
    rng = np.random.default_rng(seed)
    xyz = np.full((n_rigs, capacity, 3), SENTINEL, np.float32)
    valid = np.zeros((n_rigs, capacity), bool)
    boxes = np.zeros((n_rigs, 8, 4), np.float32)
    bvalid = np.zeros((n_rigs, 8), bool)
    for r in range(n_rigs):
        pts = rng.uniform([-10, -3, -2], [10, 3, 60], size=(n, 3))
        # points on edges: pixel (u, v) at depth d projects exactly
        d = rng.uniform(2, 30, 40)
        u = np.array(BOXES[:4])[rng.integers(0, 4, 40), rng.choice([0, 2],
                                                                     40)]
        v = rng.uniform(100, 280, 40).round()
        pts[:40] = np.stack([(u - 320) / 320 * d, (v - 240) / 320 * d, d], 1)
        xyz[r, :n] = pts
        valid[r, :n] = rng.uniform(size=n) > 0.05
        boxes[r, :len(BOXES)] = np.asarray(BOXES) + 7 * r
        bvalid[r, :len(BOXES)] = True
        bvalid[r, 2] = r == 0
    return xyz, valid, boxes, bvalid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("capacity", [64, 1024])
def test_association_matches_jax(seed, capacity):
    xyz, valid, boxes, bvalid = _box_case(seed)
    d = boxes.shape[1]
    t_boxes = Boxes(xyxy=torch.tensor(boxes),
                    confidence=torch.zeros(bvalid.shape),
                    label=torch.full(bvalid.shape, 9, dtype=torch.int32),
                    valid=torch.tensor(bvalid))
    assign, u, v = association.assign_points_to_boxes(
        torch.tensor(xyz), torch.tensor(valid), torch.tensor(K_NP), t_boxes,
        640, 480)
    counts = association.count_assigned(assign, d)
    pts, pvalid, trunc = association.gather_box_clouds(
        torch.tensor(xyz), assign, d, capacity)

    def jax_side(x, m, xyxy, bv):
        jb = JaxBoxes(xyxy=xyxy, confidence=jnp.zeros(d),
                      label=jnp.full(d, 9), valid=bv)
        ja, ju, _ = jassoc.assign_points_to_boxes(x, m, jnp.asarray(K_NP),
                                                  jb, 640, 480)
        return (ja, ju, jassoc.count_assigned(ja, d))  + \
            jassoc.gather_box_clouds(x, ja, d, capacity)

    ref = [np.asarray(a) for a in jax.jit(jax.vmap(jax_side))(
        xyz, valid, boxes, bvalid)]
    for name, g, r in zip(("assignment", "u", "counts", "points", "valid",
                           "truncated"),
                          (assign, u, counts, pts, pvalid, trunc), ref):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    # the case covers what it should: overlaps go to the first box, edge
    # points are inside, small capacities truncate
    assert (counts[:, 1] > 0).all() and (counts[:, 5] > 0).all()
    assert bool(trunc.any()) == (capacity == 64)
    assert int((assign[:, :40] >= 0).sum()) >= 40


def _clusters(seed, n_boxes=6, k=128):
    """Sub-clouds of n_boxes boxes: an elongated car-like cluster in the
    (z, x) plane, a few outliers, a random fill level (one box empty, one
    nearly round)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((n_boxes, k, 3), np.float32)
    valid = np.zeros((n_boxes, k), bool)
    for b in range(n_boxes):
        n = 0 if b == 0 else int(rng.integers(k // 3, k + 1))
        extent = (0.6, 0.6) if b == 1 else (rng.uniform(1.0, 2.0),
                                            rng.uniform(0.2, 0.5))
        local = np.stack([rng.uniform(-1, 1, n) * extent[0],
                          rng.uniform(-1, 1, n) * extent[1]], 1)
        ang = rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]])
        zx = local @ rot.T + np.array([rng.uniform(5, 40),
                                       rng.uniform(-8, 8)])
        y = rng.uniform(0.5, 0.8, n)
        cloud = np.stack([zx[:, 1], y, zx[:, 0]], 1)
        n_out = min(4, n)
        cloud[:n_out] += rng.uniform(-3, 3, (n_out, 3))
        pts[b, :n] = cloud
        valid[b, :n] = True
    return pts, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radius_outlier_mask_matches_jax(seed, monkeypatch):
    pts, valid = _clusters(seed)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda p, v: jlshape.radius_outlier_mask(p, v, 0.4, 10)))(pts, valid))
    got = lshape.radius_outlier_mask(torch.tensor(pts), torch.tensor(valid),
                                     0.4, 10)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0 and (~ref & valid).sum() > 0
    # two rigs of three boxes, the valid points packed to the most a rig
    # holds, counted 7 points a chunk (the fleet's chunked count): the
    # same mask
    k = pts.shape[1]
    monkeypatch.setattr(lshape, "_MAX_PAIRS", 2 * k * 7)
    rigs = torch.tensor(valid).reshape(2, 3, k)
    chunked = lshape.radius_outlier_mask(
        torch.tensor(pts).reshape(2, 3, k, 3), rigs, 0.4, 10,
        max_valid=int(rigs.sum(dim=(1, 2)).max()))
    np.testing.assert_array_equal(chunked.reshape(ref.shape).numpy(), ref)


def _well_conditioned(pts, kept):
    """Boxes whose (z, x) covariance has an eigenvalue gap of >= 5 % of its
    trace (the PCA axis is determined)."""
    out = []
    for p, k in zip(pts, kept):
        if not k.any():
            out.append(True)
            continue
        zx = p[k][:, [2, 0]].astype(np.float64)
        c = np.cov(zx.T, bias=True)
        gap = np.sqrt((c[0, 0] - c[1, 1]) ** 2 + 4 * c[0, 1] ** 2)
        out.append(gap >= 0.05 * (c[0, 0] + c[1, 1]))
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pca_lshape_poses_match_jax(seed):
    pts, valid = _clusters(seed)
    labels = np.arange(len(pts), dtype=np.int32) % 11
    ref = jax.jit(lambda p, v, l: jlshape.pca_lshape_poses(
        p, v, l, 0.4, 10))(pts, valid, labels)
    got = lshape.pca_lshape_poses(torch.tensor(pts), torch.tensor(valid),
                                  torch.tensor(labels), 0.4, 10)
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), rv)
    np.testing.assert_array_equal(got.label.numpy(), labels)
    assert not rv[0] and rv.sum() >= 4
    kept = np.asarray(jax.vmap(lambda p, v: jlshape.radius_outlier_mask(
        p, v, 0.4, 10))(pts, valid))
    cond = _well_conditioned(pts, kept)
    for f in ("position", "quat", "length", "width", "height"):
        g = getattr(got, f).numpy()
        assert np.isfinite(g).all(), f
        np.testing.assert_allclose(g[cond], np.asarray(getattr(ref, f))[cond],
                                   **POSE_TOL, err_msg=f)
    assert (got.height.numpy() == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pca_pose_matches_oracle(seed):
    """tests/test_lshape.py's oracle case on the port."""
    rng = np.random.default_rng(seed)
    n = 200
    local = np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-0.3, 0.3, n)],
                     axis=1)
    ang = rng.uniform(-np.pi / 2, np.pi / 2)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    zw = local @ rot.T + np.array([12.0, 1.0])
    y = rng.uniform(0.2, 0.8, n)
    pts = np.stack([zw[:, 1], y, zw[:, 0]], axis=1).astype(np.float32)
    ref = pca_lshape(radius_outlier_removal(pts, 0.4, 10))
    padded = np.zeros((256, 3), np.float32)
    padded[:n] = pts
    valid = np.arange(256) < n
    kept = lshape.radius_outlier_mask(torch.tensor(padded)[None],
                                      torch.tensor(valid)[None], 0.4, 10)[0]
    np.testing.assert_array_equal(
        np.sort(padded[kept.numpy()], axis=0),
        np.sort(radius_outlier_removal(pts, 0.4, 10), axis=0))
    poses = lshape.pca_lshape_poses(torch.tensor(padded)[None],
                                    torch.tensor(valid)[None],
                                    torch.tensor([9], dtype=torch.int32),
                                    0.4, 10)
    assert bool(poses.valid[0])
    pos = poses.position[0].numpy()
    np.testing.assert_allclose(pos, [ref["px"], ref["py"], ref["pz"]],
                               atol=1e-3)
    np.testing.assert_allclose(poses.length[0].item(), ref["length"],
                               rtol=1e-3)
    np.testing.assert_allclose(poses.width[0].item(), ref["width"],
                               rtol=1e-3)
    np.testing.assert_allclose(poses.quat[0].numpy(), ref["quat"], atol=2e-3)
