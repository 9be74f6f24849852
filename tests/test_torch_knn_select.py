"""The plain kNN's row selection (association.knn_select_nearest) and the
median depth built on it, on the CPU.

The selection has to give, row for row, the first k indices of
torch.sort(d2, stable=True): ascending d2, equal d2 to the lower point
index, NaN (of either sign) after +inf. Rows here: tie groups that
straddle position k, all +inf, fewer finite points than k, P below k,
P not a power of two, NaN, leading rig axes; k = 1, 4, 8. The medians of
knn_median_depth_centers equal, bit for bit, those of the stable sort of
every row it replaced (kept below as the reference), and those of the JAX
package's association.knn_median_depth on a heavily tied three-rig input.
`association.selections` counts one selection a call: once a tick in a
fleet or single-rig tick of an "xla" or "approx" configuration, never in a
"pallas" one (its kernel does the search)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.ops import association as jassoc
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.ops import association, cuda_knn
from grid_vision_tpu_torch.runtime.stream import FleetPool
from grid_vision_tpu_torch.types import PointCloud

torch.set_num_threads(1)

NEG_NAN = torch.tensor([-0x400000], dtype=torch.int32).view(torch.float32)
ODD_NAN = torch.tensor([0x7FA00001], dtype=torch.int32).view(torch.float32)


def stable_first_k(d2, k):
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def median_by_sort(uvd, valid, centers, k):
    """knn_median_depth_centers as a stable sort of every row computed it
    (the reference the selection replaces)."""
    d2 = association.knn_sq_distances(uvd, valid, centers)
    k_eff = min(k, d2.shape[-1])
    order = stable_first_k(d2, k_eff)
    d2_sel = torch.gather(d2, -1, order)
    z_sel = torch.gather(uvd[..., None, :, 2].expand(d2.shape), -1, order)
    if k_eff < k:
        pad = torch.full(d2.shape[:-1] + (k - k_eff,), float("inf"))
        d2_sel = torch.cat([d2_sel, pad], dim=-1)
        z_sel = torch.cat([z_sel, pad], dim=-1)
    return association.median_of_selected(d2_sel, z_sel, k)


def _ties(rng, shape, levels=3):
    return torch.as_tensor(rng.integers(0, levels, shape).astype(np.float32))


def _straddle(rng):
    # rows of 0s, 1s and 2s: the group tied at the k-th value runs on past
    # position k, so the lowest indices of the group have to be taken
    d2 = _ties(rng, (6, 40))
    d2[0] = 1.0                                 # one tie group, whole row
    d2[1, :7] = 0.0                             # the k-th value's group
    d2[1, 7:] = 1.0                             # starts at 7, runs to 40
    return d2


def _infinite(rng):
    d2 = _ties(rng, (5, 64))
    d2[0] = float("inf")                        # no valid point
    d2[1] = float("inf")
    d2[1, [50, 3]] = 2.0                        # two finite, fewer than k
    d2[2, ::2] = float("inf")
    d2[3, :60] = float("inf")                   # four finite at the end
    return d2


def _p_below_k(rng):
    d2 = _ties(rng, (4, 3))
    d2[0, 1] = float("inf")
    return d2


def _p_odd(rng):
    d2 = _ties(rng, (3, 2049), levels=6)
    d2[:, 1000:] = float("inf")
    return torch.cat([d2[:, :1000], d2], -1)    # P = 3049, 1000 ties twice


def _nan(rng):
    d2 = _ties(rng, (6, 300))
    d2[rng.random((6, 300)) < 0.3] = float("nan")
    d2[1, ::3] = NEG_NAN                        # the x86 default NaN
    d2[2, 5::7] = ODD_NAN                       # another payload
    d2[3] = float("inf")
    d2[3, [9, 200]] = float("nan")              # +inf, then NaN
    d2[3, 250] = NEG_NAN
    d2[4] = float("nan")
    d2[4, 150] = 1.0                            # one finite among NaNs
    d2[5, ::2] = float("inf")
    d2[5, 1::2] = ODD_NAN
    return d2


def _rig_axes(rng):
    return _ties(rng, (2, 3, 5, 517), levels=4)


def _fleet_row(rng):
    d2 = _ties(rng, (2, 4, 16384), levels=40)
    d2[:, :, 4096:8192] = d2[:, :, :4096]       # every value at least twice
    return d2


ROWS = {"straddle": _straddle, "infinite": _infinite, "p_below_k": _p_below_k,
        "p_odd": _p_odd, "nan": _nan, "rig_axes": _rig_axes,
        "fleet_row": _fleet_row}


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("rows", sorted(ROWS))
def test_selection_equals_stable_sort(rows, k):
    d2 = ROWS[rows](np.random.default_rng(k))
    k_eff = min(k, d2.shape[-1])
    got = association.knn_select_nearest(d2, k_eff)
    assert got.dtype == torch.int64
    assert torch.equal(got, stable_first_k(d2, k_eff))


K_NP = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]],
                np.float32)


def _cloud(xyz, capacity):
    return association.project_cloud_to_image(
        PointCloud.from_numpy(xyz.astype(np.float32), None, capacity),
        torch.as_tensor(K_NP))


def _tied_xyz(rng, n):
    xyz = rng.integers(-4, 5, size=(n, 3)).astype(np.float32)
    xyz[:, 2] = np.abs(xyz[:, 2]) + 1.0                 # many equal d2
    return xyz


def _centers(rng, d, uvd):
    c = torch.as_tensor(rng.uniform(-50, 700, (d, 2)).astype(np.float32))
    c[:3] = uvd[:3, :2]                                 # on top of a point
    return c


def _c_tied(rng):
    uvd, valid = _cloud(_tied_xyz(rng, 1500), 2048)
    return uvd, valid, _centers(rng, 16, uvd)


def _c_sparse(rng):
    uvd, valid = _cloud(_tied_xyz(rng, 3), 100)         # 3 points, k up to 8
    return uvd, valid, _centers(rng, 5, uvd)


def _c_empty(rng):
    uvd, valid = _cloud(np.zeros((0, 3)), 64)
    return uvd, valid, _centers(rng, 4, uvd)


def _c_p_below_k(rng):
    uvd, valid = _cloud(_tied_xyz(rng, 3), 3)
    return uvd, valid, _centers(rng, 4, uvd)


def _c_nan_point(rng):
    # a cloud on the device keeps what packing on the host would drop
    xyz = _tied_xyz(rng, 1000)
    xyz[[0, 5, 6, 400], 0] = np.nan                     # valid: z > 0
    xyz[[7, 8], 1] = np.nan
    uvd, valid = association.project_cloud_to_image(
        PointCloud(xyz=torch.as_tensor(xyz), intensity=torch.zeros(1000),
                   count=torch.tensor(700, dtype=torch.int32)),
        torch.as_tensor(K_NP))
    assert bool(valid[0]) and bool(torch.isnan(uvd[0, 0]))
    centers = _centers(rng, 9, uvd)
    centers[8] = float("nan")                           # a NaN query too
    return uvd, valid, centers


def _c_rig_axis(rng):
    uvd, valid = _cloud(_tied_xyz(rng, 900), 1000)
    c = _centers(rng, 11, uvd)
    return (torch.stack([uvd, uvd.flip(0)]),
            torch.stack([valid, valid.flip(0)]), torch.stack([c, c + 7.0]))


CLOUDS = {"tied": _c_tied, "sparse": _c_sparse, "empty": _c_empty,
          "p_below_k": _c_p_below_k, "nan_point": _c_nan_point,
          "rig_axis": _c_rig_axis}


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_medians_bit_equal_to_the_stable_sort(cloud, k):
    uvd, valid, centers = CLOUDS[cloud](np.random.default_rng(10 + k))
    got = association.knn_median_depth_centers(uvd, valid, centers, k)
    want = median_by_sort(uvd, valid, centers, k)
    assert torch.equal(got, want)
    assert got.shape == centers.shape[:-1]
    if cloud == "empty":
        assert torch.equal(got, torch.full((4,), -1.0))
    if cloud in ("tied", "rig_axis"):
        assert (got > 0).all()
    # the kernel's plain twin is the same function
    assert torch.equal(cuda_knn.knn_median_depth_plain(uvd, valid, centers,
                                                       k), got)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_fleet_shape_tied_input_equals_jax(k):
    """(R, D, P) = (3, 64, 2048): (u, v) on a 40 x 30 pixel lattice and four
    depths, so most d2 are shared by many points; a tenth of the points
    invalid (parked as project_cloud_to_image parks them); box corners on
    whole pixels, so both packages take the same centers."""
    rng = np.random.default_rng(k)
    r, d, p = 3, 64, 2048
    uvd = np.stack([rng.integers(0, 40, (r, p)), rng.integers(0, 30, (r, p)),
                    rng.integers(1, 5, (r, p))], -1).astype(np.float32)
    valid = rng.random((r, p)) > 0.1
    uvd[~valid] = PointCloud.PAD_SENTINEL
    lo = rng.integers(-5, 40, (r, d, 2))
    xyxy = np.concatenate([lo, lo + 2 * rng.integers(0, 4, (r, d, 2))],
                          -1).astype(np.float32)
    jboxes = JaxBoxes(xyxy=jnp.asarray(xyxy), confidence=jnp.ones((r, d)),
                      label=jnp.zeros((r, d), jnp.int32),
                      valid=jnp.ones((r, d), bool))
    want = np.asarray(jax.jit(jax.vmap(
        lambda u, m, b: jassoc.knn_median_depth(u, m, b, k)))(
            jnp.asarray(uvd), jnp.asarray(valid), jboxes))
    centers = torch.as_tensor(xyxy[..., :2] + (xyxy[..., 2:] - xyxy[..., :2])
                              / 2.0)
    n0 = association.selections
    got = association.knn_median_depth_centers(
        torch.as_tensor(uvd), torch.as_tensor(valid), centers, k)
    assert association.selections == n0 + 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all()


def test_selections_counts_one_a_call():
    uvd, valid, centers = _c_rig_axis(np.random.default_rng(0))
    n0 = association.selections
    association.knn_median_depth_centers(uvd, valid, centers, 4)
    assert association.selections == n0 + 1
    association.knn_select_nearest(torch.zeros(2, 5), 2)
    assert association.selections == n0 + 2
    cuda_knn.knn_median_depth_plain(uvd[0], valid[0], centers[0], 4)
    assert association.selections == n0 + 3


SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, max_static_depth=16)
RIGS, TICKS = 2, 2


@pytest.fixture(scope="module")
def small_fleet():
    cfg = GridVisionConfig(**SMALL)
    params = weights.load_all(cfg, device="cpu")
    pool = FleetPool(cfg, RIGS, device="cpu")
    return cfg, params, [pool.obs(t) for t in range(TICKS)]


@pytest.mark.parametrize("backend", ["xla", "approx", "pallas"])
def test_every_plain_tick_selects_once_and_kernel_ticks_never(
        small_fleet, backend, monkeypatch):
    """A fleet tick (every rig in one call) and a single-rig step each make
    one selection with the plain backends, none with the kernel's: there
    the kernel's wrapper is stood in for (on a CPU tensor it would run the
    plain twin, which is this selection)."""
    cfg, params, obs_seq = small_fleet
    cfg = dataclasses.replace(cfg, knn_backend=backend)
    kernel_calls = []

    def kernel(uvd, uvd_valid, boxes, k):
        kernel_calls.append(uvd.shape)
        return torch.full(boxes.valid.shape, -1.0)

    monkeypatch.setattr(cuda_knn, "knn_median_depth_cuda", kernel)
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=params, device="cpu")
    n0 = association.selections
    states = eng.init_states(RIGS)
    for obs in obs_seq:
        states, _ = eng.fleet(states, obs)
    state = eng.init_state(0)
    for obs in obs_seq:
        state, _ = eng(state, obs.select(0))
    plain = backend != "pallas"
    assert association.selections - n0 == (2 * TICKS if plain else 0)
    assert len(kernel_calls) == (0 if plain else 2 * TICKS)
