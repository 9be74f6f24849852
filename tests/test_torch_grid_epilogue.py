"""The grid and carve updates with their epilogue: the run gate (quirk Q1)
and the int8 export that the grid and carve kernels fuse into their pass
(ops/cuda_grid.grid_update_gated, ops/cuda_raycast.fused_carve_update_gated;
on the CPU their plain twins, then rasterize.gate_and_export), against the
JAX package: its jitted rasterize.lshape_update or raycast.
carve_update_from_maps (given the same maps), then the two jnp.where of its
pipeline's run gate, then its export_occupancy_i8, under vmap over rigs as
its fleet path runs them. Inputs from numpy seeds.

Tolerances: log-odds and occupancy_i8 exactly equal; occupancy atol
2.5e-7, the bar of tests/test_torch_grid.py for random log-odds: the exp of
the two libraries differs by up to two ulps of the sigmoid above 0.5
(1.2e-7). The card holds each kernel to its twin at 1e-7
(tests/test_torch_cuda.py).
Also: a compat and an extension fleet_step give the same grids and
occupancy_i8 on the kernel backend ("pallas": the fused entry points) as
on the plain one ("xla": the update, then the gate and the export).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.ops import rasterize as jras, raycast as jray
from grid_vision_tpu.types import LShapePoses as JaxPoses
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.ops import cuda_grid, cuda_raycast, raycast
from grid_vision_tpu_torch.runtime.stream import FleetPool
from grid_vision_tpu_torch.types import LShapePoses

from .test_torch_extension_tick import CARVE, FLEET, R, _params

torch.set_num_threads(1)

CAP = 8
# probabilities on a half of the export's unit: round half to even gives
# 12, 38, 62, 88 (half up would give 13, 38, 63, 88)
HALVES = np.array([0.125, 0.375, 0.625, 0.875], np.float32)
# (grid geometry, rigs (None: one (H, W) grid), run gate, footprints)
CASES = {
    "gate_mix": ({}, 4, [1, 0, 1, 0], "random"),
    "all_gated_off": ({}, 3, [0, 0, 0], "random"),
    "no_valid_pose": ({}, 2, [1, 1], "none"),
    "eight_overlapping": ({}, 2, [1, 0], "overlap"),
    "single_grid": ({}, None, 1, "random"),
    # (150, 50): W % 4 != 0, rows straddle the kernel's 16-byte vectors
    "w_not_multiple_of_4": (dict(grid_x=30, grid_y=10, resolution=0.2), 3,
                            [1, 0, 1], "random"),
    # (103, 33): H * W % 4 != 0, the kernel's scalar path
    "hw_not_multiple_of_4": (dict(grid_x=31, grid_y=10, resolution=0.3), 3,
                             [0, 1, 1], "overlap"),
}


def _jax_gated(update):
    """One rig: JAX's update, its pipeline's run gate, its export."""
    def fn(lo, prev, gate, *args):
        new_lo, new_occ = update(lo, *args)
        new_lo = jnp.where(gate, new_lo, lo)
        new_occ = jnp.where(gate, new_occ, prev)
        return new_lo, new_occ, jras.export_occupancy_i8(new_occ)
    return fn


def _poses(rng, lead, kind, cfg):
    """numpy pose fields (lead + (CAP,)): random footprints (some off the
    map, the first twice more), none valid, or all eight on one cell."""
    shape = lead + (CAP,)
    gx, gy = cfg.grid_x, cfg.grid_y
    cx = cfg.grid_center[0]
    pos = np.zeros(shape + (3,), np.float32)
    pos[..., 0] = rng.uniform(cx - 0.6 * gx, cx + 0.6 * gx, shape)
    pos[..., 1] = rng.uniform(-0.6 * gy, 0.6 * gy, shape)
    length = rng.uniform(0.3, 6.0, shape).astype(np.float32)
    width = rng.uniform(0.3, 3.0, shape).astype(np.float32)
    valid = rng.random(shape) < 0.85
    pos[..., 1:3, :] = pos[..., :1, :]
    if kind == "overlap":
        pos[...] = pos[..., :1, :]
        pos[..., 0] = cx
        valid[...] = True
    elif kind == "none":
        valid[...] = False
    return pos, length, width, valid


def _both_poses(fields):
    pos, length, width, valid = fields
    quat = np.zeros(pos.shape[:-1] + (4,), np.float32)
    quat[..., 3] = 1.0
    zeros = np.zeros(valid.shape, np.float32)
    label = np.zeros(valid.shape, np.int32)
    jp = JaxPoses(position=jnp.asarray(pos), quat=jnp.asarray(quat),
                  length=jnp.asarray(length), width=jnp.asarray(width),
                  height=jnp.asarray(zeros), label=jnp.asarray(label),
                  valid=jnp.asarray(valid))
    tp = LShapePoses(position=torch.as_tensor(pos),
                     quat=torch.as_tensor(quat),
                     length=torch.as_tensor(length),
                     width=torch.as_tensor(width),
                     height=torch.as_tensor(zeros),
                     label=torch.as_tensor(label),
                     valid=torch.as_tensor(valid))
    return jp, tp


@pytest.mark.parametrize("path", ["grid", "carve"])
@pytest.mark.parametrize("case", list(CASES))
def test_gated_update_matches_jax(case, path):
    geometry, rigs, gate_bits, kind = CASES[case]
    cfg = GridVisionConfig(**geometry)
    jcfg = JaxConfig(**geometry)
    rng = np.random.default_rng(sorted(CASES).index(case))
    lead = () if rigs is None else (rigs,)
    lo = rng.normal(0.0, 1.5, lead + cfg.grid_size).astype(np.float32)
    prev = rng.random(lead + cfg.grid_size).astype(np.float32)
    prev.reshape(-1)[:4] = HALVES
    gate = np.asarray(gate_bits, bool).reshape(lead)
    jp, tp = _both_poses(_poses(rng, lead, kind, cfg))
    t = torch.as_tensor
    if path == "grid":
        got = cuda_grid.lshape_update_gated_cuda(t(lo), tp, t(gate),
                                                 t(prev), cfg)
        update = _jax_gated(lambda lo, p: jras.lshape_update(lo, p, jcfg))
        extra = (jp,)
    else:
        origin = torch.tensor([1.5, 0.0])
        pts = np.stack([rng.uniform(-10, 40, lead + (800,)),
                        rng.uniform(-9, 9, lead + (800,))], -1)
        valid = rng.random(lead + (800,)) < 0.9
        ranges = raycast.range_profile(origin, t(pts.astype(np.float32)),
                                       t(valid))
        cbin, cr = raycast.cell_polar_maps(origin, cfg)
        got = cuda_raycast.fused_carve_update_gated(
            t(lo), cuda_grid.box_index_ranges(tp, cfg), ranges, cbin, cr,
            t(gate), t(prev), cfg)
        update = _jax_gated(lambda lo, p, rg: jray.carve_update_from_maps(
            lo, p, rg, jnp.asarray(cbin.numpy()), jnp.asarray(cr.numpy()),
            jcfg))
        extra = (jp, jnp.asarray(ranges.numpy()))
    if rigs is not None:
        update = jax.vmap(update)
    ref = jax.jit(update)(jnp.asarray(lo), jnp.asarray(prev),
                          jnp.asarray(gate), *extra)
    lo_t, occ_t, i8_t = got
    assert i8_t.dtype == torch.int8
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(occ_t.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=2.5e-7)
    np.testing.assert_array_equal(i8_t.numpy(), np.asarray(ref[2]))
    off = ~np.broadcast_to(gate[..., None, None], lo.shape)
    np.testing.assert_array_equal(lo_t.numpy()[off], lo[off])
    if not gate.reshape(-1)[0]:
        # a gated-off first rig exports its previous occupancy, halves to
        # even
        np.testing.assert_array_equal(i8_t.numpy().reshape(-1)[:4],
                                      [12, 38, 62, 88])


@pytest.mark.parametrize("mode", ["compat", "extension"])
def test_fleet_step_kernel_backend_equals_the_plain_grid(mode):
    """The fused entry points (grid_backend="pallas"; their twins on the
    CPU) against the unfused update, gate and export (grid_backend="xla"),
    the rest of the tick the same: grids and occupancy_i8 bit-equal over
    three ticks, one rig with neither input on the second."""
    flags = (dict(compat=True, raycast_free_space=False,
                  vision_depth_refine=False, class_aware_nms=False)
             if mode == "compat" else CARVE)
    kw = dict(FLEET, **flags)
    _, nets = _params(kw, 1)
    pool = FleetPool(GridVisionConfig(**kw), R, device="cpu")
    runs = {}
    for grid_backend in ("pallas", "xla"):
        cfg = GridVisionConfig(**dict(kw, grid_backend=grid_backend))
        eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                              params=nets, device="cpu")
        states, outs = eng.init_states(R), []
        for i in range(3):
            obs = pool.obs(i)
            if i == 1:
                off = torch.tensor([True, False, True])
                obs = dataclasses.replace(obs, has_image=off, has_cloud=off)
            states, out = eng.fleet(states, obs)
            outs.append((states.log_odds, states.occupancy,
                         out.occupancy_i8, out.poses.valid))
        runs[grid_backend] = outs
    n_poses = 0
    for fused, plain in zip(runs["pallas"], runs["xla"]):
        for a, b in zip(fused, plain):
            assert torch.equal(a, b)
        n_poses += int(fused[3].sum())
    assert n_poses > 0
