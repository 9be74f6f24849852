"""The raycast carve of the port (ops/raycast.py and the carve kernel's
plain twin, ops/cuda_raycast.py) against the JAX package's raycast.py, its
jitted carve_update_from_maps and its fused Pallas kernel (interpret mode
on the CPU). Inputs come from numpy seeds, as tests/test_pallas_raycast.py
makes them.

Tolerances. Given the SAME range profile and polar maps (computed once by
the JAX functions, handed over as numpy): log-odds exactly equal (the twin
keeps the JAX op order: one f32 subtraction for the threshold, an exact
free * carve product, the decay add on its own, the hit add a fused
multiply-add as XLA compiles it); occupancy atol 2.5e-7 (the exp of two
libraries may differ by up to two ulps of the sigmoid near 1, as
tests/test_torch_grid.py states for random log-odds). The maps themselves:
cr and the range table rtol 1e-6; atan2 and sqrt of two libraries differ by
an ulp, and an ulp moves a point or a cell centre that sits on a bin edge
into the next bin, so the angle bins and the table are held to a share: at
most 1e-3 of the cells differ, each by one bin, and at most 1e-3 of the
table's bins hold another point's range. Each package computing its
own maps: >= 99.9 % of the cells equal, every other cell a flip of the
carve, |delta| <= |free| + 1e-5 (the bar of tests/test_pallas_raycast.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.ops import pallas_raycast, raycast as jray
from grid_vision_tpu.types import LShapePoses as JaxPoses
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.geometry import grid_index_from_position
from grid_vision_tpu_torch.ops import cuda_grid, cuda_raycast, rasterize, raycast
from grid_vision_tpu_torch.types import GridState, LShapePoses

torch.set_num_threads(1)

JCFG = JaxConfig(compat=False, raycast_free_space=True)
CFG = GridVisionConfig(compat=False, raycast_free_space=True)
FREE = 0.4
XLA_FROM_MAPS = jax.jit(lambda lo, poses, ranges, cbin, cr:
                        jray.carve_update_from_maps(lo, poses, ranges, cbin,
                                                    cr, JCFG))
XLA_CARVING = jax.jit(lambda lo, poses, origin, pts, valid:
                      jray.lshape_update_with_carving(lo, poses, origin, pts,
                                                      valid, JCFG))


def random_case(seed, n_pts=600, n_boxes=6, cap=8):
    """numpy inputs: log-odds, pose fields, origin, endpoints, validity."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(0, 1.5, CFG.grid_size).astype(np.float32)
    origin = np.array([0.0, 0.0], np.float32)
    pts = np.stack([rng.uniform(-20, 45, n_pts),
                    rng.uniform(-9, 9, n_pts)], -1).astype(np.float32)
    valid = rng.random(n_pts) < 0.9
    pos = np.zeros((cap, 3), np.float32)
    length = np.zeros((cap,), np.float32)
    width = np.zeros((cap,), np.float32)
    ok = np.zeros((cap,), bool)
    for i in range(n_boxes):
        pos[i] = (rng.uniform(-5, 35), rng.uniform(-8, 8), 0.0)
        length[i] = rng.uniform(1, 5)
        width[i] = rng.uniform(1, 3)
        ok[i] = True
    return lo, (pos, length, width, ok), origin, pts, valid


def both_poses(fields):
    pos, length, width, ok = fields
    je, te = JaxPoses.empty(len(ok)), LShapePoses.empty(len(ok))
    jp = JaxPoses(position=jnp.asarray(pos), quat=je.quat,
                  length=jnp.asarray(length), width=jnp.asarray(width),
                  height=je.height, label=je.label, valid=jnp.asarray(ok))
    tp = LShapePoses(position=torch.as_tensor(pos), quat=te.quat,
                     length=torch.as_tensor(length),
                     width=torch.as_tensor(width), height=te.height,
                     label=te.label, valid=torch.as_tensor(ok))
    return jp, tp


def jax_maps(origin, pts, valid):
    ranges = np.asarray(jray.range_profile(jnp.asarray(origin),
                                           jnp.asarray(pts),
                                           jnp.asarray(valid)))
    cbin, cr = jray.cell_polar_maps(jnp.asarray(origin), JCFG)
    return ranges, np.asarray(cbin), np.asarray(cr)


def stack_poses(poses):
    return LShapePoses(**{f: torch.stack([getattr(p, f) for p in poses])
                          for f in ("position", "quat", "length", "width",
                                    "height", "label", "valid")})


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_twin_and_plain_chain_equal_jax_given_the_same_maps(seed):
    lo, fields, origin, pts, valid = random_case(seed)
    jp, tp = both_poses(fields)
    ranges, cbin, cr = jax_maps(origin, pts, valid)
    jargs = [jnp.asarray(a) for a in (ranges, cbin, cr)]
    xla_lo, xla_occ = XLA_FROM_MAPS(jnp.asarray(lo), jp, *jargs)
    pal_lo, pal_occ = pallas_raycast.fused_carve_update(
        jnp.asarray(lo), jp, *jargs, JCFG)
    targs = [torch.as_tensor(a.copy()) for a in (ranges, cbin, cr)]
    twin = cuda_raycast.fused_carve_update_cuda(
        torch.as_tensor(lo), cuda_grid.box_index_ranges(tp, CFG), *targs,
        CFG)
    chain = raycast.carve_update_from_maps(torch.as_tensor(lo), tp, *targs,
                                           CFG)
    assert (np.asarray(xla_lo) < lo - 0.5).mean() > 0.05    # it carved
    for got_lo, got_occ in (twin, chain):
        for ref_lo, ref_occ in ((xla_lo, xla_occ), (pal_lo, pal_occ)):
            np.testing.assert_array_equal(got_lo.numpy(), np.asarray(ref_lo))
            np.testing.assert_allclose(got_occ.numpy(), np.asarray(ref_occ),
                                       rtol=0, atol=2.5e-7)


def test_rig_batched_twin_and_chain_equal_a_loop_over_rigs():
    cases = [random_case(seed) for seed in (4, 5, 6)]
    _, _, origin, _, _ = cases[0]
    cbin, cr = raycast.cell_polar_maps(torch.as_tensor(origin), CFG)
    lo = torch.as_tensor(np.stack([c[0] for c in cases]))
    tps = [both_poses(c[1])[1] for c in cases]
    pts = torch.as_tensor(np.stack([c[3] for c in cases]))
    valid = torch.as_tensor(np.stack([c[4] for c in cases]))
    ranges = raycast.range_profile(torch.as_tensor(origin), pts, valid)
    assert ranges.shape == (3, raycast.N_BINS)
    poses = stack_poses(tps)
    twin_lo, twin_occ = cuda_raycast.fused_carve_update_cuda(
        lo, cuda_grid.box_index_ranges(poses, CFG), ranges, cbin, cr, CFG)
    chain_lo, chain_occ = raycast.carve_update_from_maps(lo, poses, ranges,
                                                         cbin, cr, CFG)
    # the drop-in, through the dispatch of lshape_update_with_carving
    for backend in ("pallas", "xla"):
        cfg = GridVisionConfig(compat=False, raycast_free_space=True,
                               grid_backend=backend)
        d_lo, d_occ = raycast.lshape_update_with_carving(
            lo, poses, torch.as_tensor(origin), pts, valid, cfg)
        assert torch.equal(d_lo, twin_lo) and torch.equal(d_occ, twin_occ)
    assert torch.equal(twin_lo, chain_lo) and torch.equal(twin_occ, chain_occ)
    for r, tp in enumerate(tps):
        np.testing.assert_array_equal(
            ranges[r].numpy(),
            raycast.range_profile(torch.as_tensor(origin), pts[r],
                                  valid[r]).numpy())
        one_lo, one_occ = cuda_raycast.fused_carve_update_cuda(
            lo[r], cuda_grid.box_index_ranges(tp, CFG), ranges[r], cbin, cr,
            CFG)
        assert torch.equal(one_lo, twin_lo[r])
        assert torch.equal(one_occ, twin_occ[r])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_range_profile_and_polar_maps_match_jax(seed):
    _, _, _, pts, valid = random_case(seed, n_pts=4000)
    origin = np.array([1.5 + seed, 0.25 * seed], np.float32)
    j_ranges, j_cbin, j_cr = jax_maps(origin, pts, valid)
    ranges = raycast.range_profile(torch.as_tensor(origin),
                                   torch.as_tensor(pts),
                                   torch.as_tensor(valid)).numpy()
    cbin, cr = raycast.cell_polar_maps(torch.as_tensor(origin), CFG)
    assert cbin.dtype == torch.int32 and cr.dtype == torch.float32
    assert 0 <= int(cbin.min()) and int(cbin.max()) < raycast.N_BINS
    np.testing.assert_allclose(cr.numpy(), j_cr, rtol=1e-6, atol=0)
    moved = cbin.numpy() != j_cbin
    assert moved.mean() <= 1e-3, moved.mean()
    assert np.abs(cbin.numpy() - j_cbin).max() <= 1
    # a range is the sqrt of a sum of squares: an ulp apart (XLA fuses the
    # sum into a multiply-add); a bin holds another point's range only
    # where a point moved across a bin edge
    differ = np.abs(ranges - j_ranges) > 1e-6 * j_ranges
    assert differ.mean() <= 1e-3, differ.mean()
    np.testing.assert_array_equal(
            raycast.cell_range_map(torch.as_tensor(j_ranges.copy()),
                               torch.as_tensor(origin), CFG).numpy()[~moved],
        np.asarray(jray.cell_range_map(jnp.asarray(j_ranges),
                                       jnp.asarray(origin), JCFG))[~moved])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_own_maps_agree_on_all_but_carve_boundary_cells(seed):
    lo, fields, origin, pts, valid = random_case(seed)
    jp, tp = both_poses(fields)
    ref, _ = XLA_CARVING(jnp.asarray(lo), jp, jnp.asarray(origin),
                         jnp.asarray(pts), jnp.asarray(valid))
    ref = np.asarray(ref)
    for backend in ("pallas", "xla"):
        cfg = GridVisionConfig(compat=False, raycast_free_space=True,
                               grid_backend=backend)
        got, _ = raycast.lshape_update_with_carving(
            torch.as_tensor(lo), tp, torch.as_tensor(origin),
            torch.as_tensor(pts), torch.as_tensor(valid), cfg)
        diff = ref != got.numpy()
        assert diff.mean() <= 1e-3, diff.mean()
        if diff.any():
            assert np.abs(ref - got.numpy())[diff].max() <= FREE + 1e-5


def test_no_valid_points_is_exactly_decay_plus_hits():
    lo, fields, origin, pts, valid = random_case(7)
    jp, tp = both_poses(fields)
    none = np.zeros_like(valid)
    ref, _ = XLA_CARVING(jnp.asarray(lo), jp, jnp.asarray(origin),
                         jnp.asarray(pts), jnp.asarray(none))
    hits_lo, hits_occ = cuda_grid.lshape_update_cuda(torch.as_tensor(lo), tp,
                                                     CFG)
    for backend in ("pallas", "xla"):
        cfg = GridVisionConfig(compat=False, raycast_free_space=True,
                               grid_backend=backend)
        got_lo, got_occ = raycast.lshape_update_with_carving(
            torch.as_tensor(lo), tp, torch.as_tensor(origin),
            torch.as_tensor(pts), torch.as_tensor(none), cfg)
        np.testing.assert_array_equal(got_lo.numpy(), np.asarray(ref))
        assert torch.equal(got_lo, hits_lo) and torch.equal(got_occ, hits_occ)


def test_bin_outside_the_table_never_carves():
    """The twin's (and the kernel's) rule for a bin index outside
    [0, n_bins): range 0, so the cell is never carved."""
    lo, fields, origin, pts, valid = random_case(8)
    _, tp = both_poses(fields)
    ranges = raycast.range_profile(torch.as_tensor(origin),
                                   torch.as_tensor(pts),
                                   torch.as_tensor(valid))
    cbin, cr = raycast.cell_polar_maps(torch.as_tensor(origin), CFG)
    bad = cbin.clone()
    bad[:250] = -1
    bad[250:] = raycast.N_BINS
    got, _ = cuda_raycast.carve_update_plain(
        torch.as_tensor(lo), cuda_grid.box_index_ranges(tp, CFG), ranges,
        bad, cr, CFG)
    hits, _ = cuda_grid.lshape_update_cuda(torch.as_tensor(lo), tp, CFG)
    assert torch.equal(got, hits)


def test_wrapper_rejects_other_devices():
    lo = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_raycast.fused_carve_update_cuda(
            lo, torch.zeros((1, 4), dtype=torch.int32), torch.zeros(16),
            torch.zeros((4, 4), dtype=torch.int32), torch.zeros((4, 4)), CFG)


# ---- the polar model against the per-ray semantics, as tests/test_raycast.py
# holds the JAX pair


def cell_of(x, y):
    idx, ok = grid_index_from_position(
        torch.tensor([x, y]), CFG.grid_center,
        (float(CFG.grid_x), float(CFG.grid_y)), CFG.resolution)
    assert bool(ok)
    return int(idx[0]), int(idx[1])


def fan_endpoints(r=20.0, n=720):
    ang = np.linspace(-np.pi / 2, np.pi / 2, n)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)


def test_sampled_line_carve_exact_and_equal_to_jax():
    origin = np.zeros(2, np.float32)
    pts = np.array([[20.0, 0.0], [12.0, 7.0], [60.0, 3.0]], np.float32)
    valid = np.array([True, True, False])
    mask = raycast.carve_mask_sampled(
        torch.as_tensor(origin), torch.as_tensor(pts[:1]),
        torch.as_tensor(valid[:1]), CFG, n_samples=256).numpy()
    assert mask[cell_of(10.0, 0.0)] == 1.0      # on the ray
    assert mask[cell_of(20.0, 0.0)] == 0.0      # endpoint cell protected
    assert mask[cell_of(10.0, 5.0)] == 0.0      # off the ray
    assert 150 <= mask.sum() <= 300
    assert raycast.default_samples(CFG) == jray.default_samples(JCFG)
    got = raycast.carve_mask_sampled(torch.as_tensor(origin),
                                     torch.as_tensor(pts),
                                     torch.as_tensor(valid), CFG).numpy()
    ref = np.asarray(jray.carve_mask_sampled(
        jnp.asarray(origin), jnp.asarray(pts), jnp.asarray(valid), JCFG))
    # a sample within an ulp of a cell edge may land in the next cell
    assert (got != ref).sum() <= 2
    # rig-batched == per rig
    both = raycast.carve_mask_sampled(
        torch.as_tensor(origin), torch.as_tensor(np.stack([pts, pts[::-1]])),
        torch.as_tensor(np.stack([valid, valid[::-1]])), CFG).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], got)


def test_polar_beam_carve_and_per_bin_range():
    origin = torch.zeros(2)
    pts = fan_endpoints(r=20.0)
    mask = raycast.carve_mask(origin, torch.as_tensor(pts),
                              torch.ones(len(pts), dtype=torch.bool),
                              CFG).numpy()
    assert mask[cell_of(10.0, 0.0)] == 1.0
    assert mask[cell_of(10.0, 5.0)] == 1.0      # inside the wedge too
    assert mask[cell_of(5.0, -5.0)] == 1.0
    assert mask[cell_of(20.0, 0.0)] == 0.0      # at the measured range
    assert mask[cell_of(25.0, 0.0)] == 0.0      # beyond it
    assert mask[cell_of(-5.0, 0.0)] == 0.0      # behind the sensor
    assert set(np.unique(mask)) <= {0.0, 1.0}
    ref = np.asarray(jray.carve_mask(jnp.zeros(2), jnp.asarray(pts),
                                     jnp.ones(len(pts), bool), JCFG))
    assert (mask != ref).mean() <= 1e-3
    # a short return must not carve past itself
    mid = len(pts) // 2
    for off in range(-2, 3):
        ang = off * 0.02
        pts[mid + off] = [8.0 * np.cos(ang), 8.0 * np.sin(ang)]
    mask = raycast.carve_mask(origin, torch.as_tensor(pts),
                              torch.ones(len(pts), dtype=torch.bool),
                              CFG).numpy()
    assert mask[cell_of(5.0, 0.0)] == 1.0       # before the short return
    assert mask[cell_of(12.0, 0.0)] == 0.0      # shadow behind it


def test_polar_carve_against_sampled_carve_on_a_dense_fan():
    """The polar beam model against the exact per-ray carve on an angularly
    dense scan (what the model is for). Every cell the polar model carves,
    the rays do cross; the cells the rays cross and the polar model leaves
    are the ring within three cells of the endpoints (its margin) and the
    cells on the fan's edge whose centres lie behind the sensor; the polar
    model never carves at or beyond the endpoints."""
    origin = torch.zeros(2)
    pts = torch.as_tensor(fan_endpoints(r=20.0, n=2880))
    ok = torch.ones(len(pts), dtype=torch.bool)
    polar = raycast.carve_mask(origin, pts, ok, CFG).numpy() > 0
    sampled = raycast.carve_mask_sampled(origin, pts, ok, CFG).numpy() > 0
    _, cr = raycast.cell_polar_maps(origin, CFG)
    cr = cr.numpy()
    ahead = rasterize._cell_centers(*CFG.grid_size, CFG).numpy()[..., 0] > 0
    assert polar.sum() > 30000
    assert (polar & ~sampled).sum() == 0
    inner = cr < 20.0 - 3 * CFG.resolution
    assert (sampled & inner & ahead & ~polar).sum() == 0
    assert not polar[cr >= 20.0].any()


def test_carving_update_lowers_free_cells():
    state = GridState.create(CFG)
    pts = torch.as_tensor(fan_endpoints(r=20.0))
    for backend in ("pallas", "xla"):
        cfg = GridVisionConfig(compat=False, raycast_free_space=True,
                               grid_backend=backend)
        lo, occ = raycast.lshape_update_with_carving(
            state.log_odds, LShapePoses.empty(4), torch.zeros(2), pts,
            torch.ones(len(pts), dtype=torch.bool), cfg)
        np.testing.assert_allclose(lo[cell_of(10.0, 0.0)], -0.6, atol=1e-6)
        np.testing.assert_allclose(lo[cell_of(25.0, 0.0)], -0.2, atol=1e-6)
        assert rasterize.export_occupancy_i8(occ)[cell_of(10.0, 0.0)] == 35
