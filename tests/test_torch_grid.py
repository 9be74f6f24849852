"""The grid kernel's plain twin (ops/cuda_grid.py) and the port's
rasterize.lshape_update against the JAX package's Pallas grid kernel
(interpret mode on the CPU), its XLA rasterizer and the NumPy oracle.

Tolerances: log-odds exact (the twin keeps the JAX op order, the hit add
a fused multiply-add as XLA compiles it); occupancy
atol 1e-7 (the exp of two libraries may differ by an ulp, the bar of
tests/test_pallas_grid.py); the int8 export exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.ops import pallas_grid, rasterize as jras
from grid_vision_tpu.types import LShapePoses as JaxPoses
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.ops import cuda_grid, rasterize
from grid_vision_tpu_torch.types import GridState, LShapePoses

from .oracle.reference_oracle import GridOracle

torch.set_num_threads(1)

JCFG, CFG = JaxConfig(), GridVisionConfig()
# jitted as pipeline.step runs it: XLA then fuses the hit add into an FMA
# (op-by-op dispatch rounds the product separately, an ulp apart at >= 3
# overlapping boxes)
XLA_UPDATE = jax.jit(lambda lo, poses: jras.lshape_update(lo, poses, JCFG))


def random_entries(rng, n):
    """On-map, off-map, boundary-straddling and (by chance) overlapping
    boxes, plus exact duplicates of the first box."""
    out = [{"px": float(rng.uniform(-15, 50)),
            "py": float(rng.uniform(-15, 15)),
            "length": float(rng.uniform(0.3, 6.0)),
            "width": float(rng.uniform(0.3, 3.0))} for _ in range(n)]
    if out:
        out += [dict(out[0])] * int(rng.integers(0, 3))
    return out


def both_poses(entries, capacity=8):
    """The same poses as the JAX package's and the port's LShapePoses."""
    pos = np.zeros((capacity, 3), np.float32)
    length = np.zeros((capacity,), np.float32)
    width = np.zeros((capacity,), np.float32)
    valid = np.zeros((capacity,), bool)
    for i, e in enumerate(entries[:capacity]):
        pos[i] = (e["px"], e["py"], 0.0)
        length[i], width[i], valid[i] = e["length"], e["width"], True
    je = JaxPoses.empty(capacity)
    jp = JaxPoses(position=jnp.asarray(pos), quat=je.quat,
                  length=jnp.asarray(length), width=jnp.asarray(width),
                  height=je.height, label=je.label, valid=jnp.asarray(valid))
    te = LShapePoses.empty(capacity)
    tp = LShapePoses(position=torch.as_tensor(pos), quat=te.quat,
                     length=torch.as_tensor(length),
                     width=torch.as_tensor(width), height=te.height,
                     label=te.label, valid=torch.as_tensor(valid))
    return jp, tp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_twin_matches_pallas_xla_and_oracle(seed):
    rng = np.random.default_rng(seed)
    oracle = GridOracle()
    lo_pal = jnp.zeros(JCFG.grid_size, jnp.float32)
    lo_xla = lo_pal
    lo_t = GridState.create(CFG).log_odds
    lo_r = lo_t
    for _ in range(4):
        entries = random_entries(rng, int(rng.integers(0, 6)))
        jp, tp = both_poses(entries)
        oracle.update_lshape(entries[:8])
        lo_pal, occ_pal = pallas_grid.lshape_update_pallas(lo_pal, jp, JCFG)
        lo_xla, occ_xla = XLA_UPDATE(lo_xla, jp)
        np.testing.assert_array_equal(
            cuda_grid.box_index_ranges(tp, CFG).numpy(),
            np.stack(pallas_grid._box_index_ranges(jp, JCFG), -1))
        lo_t, occ_t = cuda_grid.lshape_update_cuda(lo_t, tp, CFG)
        lo_r, occ_r = rasterize.lshape_update(lo_r, tp, CFG)
        for lo, occ in ((lo_t, occ_t), (lo_r, occ_r)):
            np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_pal))
            np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_xla))
            np.testing.assert_allclose(occ.numpy(), np.asarray(occ_pal),
                                       rtol=0, atol=1e-7)
            np.testing.assert_array_equal(
                rasterize.export_occupancy_i8(occ).numpy(),
                np.asarray(jras.export_occupancy_i8(occ_xla)))
    np.testing.assert_allclose(lo_t.numpy(), oracle.log_odds, atol=1e-5)
    np.testing.assert_array_equal(
        rasterize.export_occupancy_i8(occ_t).numpy(), oracle.export_i8())


def test_empty_poses_is_decay_and_clamps():
    lo = GridState.create(CFG).log_odds
    empty = LShapePoses.empty(8)
    for _ in range(15):
        lo, occ = cuda_grid.lshape_update_cuda(lo, empty, CFG)
    np.testing.assert_array_equal(lo.numpy(), np.float32(CFG.min_log_odds))
    np.testing.assert_array_equal(
        rasterize.export_occupancy_i8(occ).numpy(), 12)


def test_wrapper_rejects_other_devices():
    lo = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_grid.grid_update(lo, torch.zeros((1, 4), dtype=torch.int32),
                              CFG)



@pytest.mark.parametrize("seed", [3, 4])
def test_batched_twin_matches_vmapped_pallas(seed):
    """The rig-batched twin ((R, H, W) grids, (R, D) poses) against the
    JAX Pallas kernel under vmap, as the JAX fleet path runs it: log-odds
    bit-equal per rig, the int8 export exact, occupancy within two f32
    ulps near 1 (atol 2.5e-7: random log-odds reach 3.6, where the two
    libraries' exp differ by up to two ulps of the sigmoid)."""
    rng = np.random.default_rng(seed)
    pairs = [both_poses(random_entries(rng, int(rng.integers(0, 8))))
             for _ in range(3)]
    jp = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                *[p[0] for p in pairs])
    tp = LShapePoses(**{f: torch.stack([getattr(p[1], f) for p in pairs])
                        for f in ("position", "quat", "length", "width",
                                  "height", "label", "valid")})
    lo0 = rng.uniform(-2, 3.6, (3,) + JCFG.grid_size).astype(np.float32)
    jlo, jocc = jax.jit(jax.vmap(
        lambda lo, p: pallas_grid.lshape_update_pallas(lo, p, JCFG)))(
        jnp.asarray(lo0), jp)
    lo, occ = cuda_grid.lshape_update_cuda(torch.as_tensor(lo0), tp, CFG)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                               atol=2.5e-7)
    np.testing.assert_array_equal(
        rasterize.export_occupancy_i8(occ).numpy(),
        np.asarray(jras.export_occupancy_i8(jocc)))
    lo_r, _ = rasterize.lshape_update(torch.as_tensor(lo0), tp, CFG)
    np.testing.assert_array_equal(lo_r.numpy(), np.asarray(jlo))
