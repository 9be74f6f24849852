"""The host side of the redesigned detector-stem and kNN kernels
(csrc/cuda_stem.cu, csrc/cuda_knn.cu), on the CPU:

- ConvBN_1 of the stem as an emulated 3xTF32 product (stride 2, SAME pad
  (0, 1)) stays within rtol = atol = 1e-4, the stem's bar, of its plain twin
  and of JAX's detector_stem_pallas (interpret mode on the CPU, as
  tests/test_pallas_stem.py runs it), at the reduced size of
  tests/test_torch_stem.py with randomized BN;
- the packed w1 that prepare_stem_constants returns unpacks to w1 * s1 split
  into hi and lo, and the constants have what the wrapper checks;
- the frame extent and the shared memory the conv0 kernel is given cover
  every tile's tap windows;
- the kNN kernel's partition (points in slices, centers in groups, the k
  smallest (d2, index) keys per slice, merged) in plain torch equals
  knn_median_depth_plain exactly, ties, sparse slices and empty clouds
  included;
- the rule that picks the number of slices fills the card once at the
  shapes the ticks use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.ops import pallas_stem
from grid_vision_tpu_torch.models.layers import same_pad
from grid_vision_tpu_torch.ops import cuda_knn, cuda_stem, tf32x3

from . import test_torch_csp as csp_case

torch.set_num_threads(1)

SIZE = csp_case.SIZE                              # a 64-pixel detector input


@pytest.mark.parametrize("seed", [0, 1])
def test_stem_conv1_in_3xtf32_matches_twin_and_jax_kernel(seed):
    tree, det = csp_case._detector(seed)
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    consts = cuda_stem.prepare_stem_constants(det)
    with torch.no_grad():
        got = tf32x3.detector_stem_3xtf32(torch.as_tensor(frames), det,
                                          SIZE).numpy()
        twin = cuda_stem.detector_stem_plain(torch.as_tensor(frames), consts,
                                             SIZE).numpy()
    assert got.shape == twin.shape == (2, SIZE // 4, SIZE // 4, 64)
    np.testing.assert_allclose(got, twin, rtol=1e-4, atol=1e-4)
    ref = np.asarray(pallas_stem.detector_stem_pallas(
        jnp.asarray(frames), tree, SIZE, jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_conv2d_3xtf32_stride_2_pads_as_the_twin_does():
    """Stride 2 with SAME pad (0, 1) on an even input and (1, 1) on an odd
    one: the emulated conv picks the rows F.conv2d picks."""
    rng = np.random.default_rng(3)
    wmat = torch.as_tensor(rng.normal(0, 0.2, (288, 64)).astype(np.float32))
    w_oihw = wmat.reshape(3, 3, 32, 64).permute(3, 2, 0, 1).contiguous()
    for n in (16, 17):
        x = torch.as_tensor(rng.normal(0, 1, (1, n, n, 32))
                            .astype(np.float32))
        pad = same_pad(n, 3, 2)
        assert pad == ((0, 1) if n % 2 == 0 else (1, 1))
        got = tf32x3.conv2d_3xtf32(x, wmat, 3, 2, pad)
        want = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                    (pad[0], pad[1], pad[0], pad[1])),
            w_oihw, stride=2).permute(0, 2, 3, 1)
        assert got.shape == want.shape == (1, -(-n // 2), -(-n // 2), 64)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_stem_constants_are_what_the_wrapper_checks():
    _, det = csp_case._detector(0)
    consts = cuda_stem.prepare_stem_constants(det)
    assert set(cuda_stem._SHAPES) <= set(consts)
    for name, shape in cuda_stem._SHAPES.items():
        t = consts[name]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert t.is_contiguous() and not t.requires_grad
    # w1frag unpacks to ConvBN_1's matrix in (ty, tx, c) row order with the
    # BN scale folded in, split into hi and lo
    w1 = consts["w1_oihw"].permute(2, 3, 1, 0).reshape(288, 64)
    want_hi, want_lo = tf32x3.split_tf32(w1 * consts["s1"])
    hi, lo = tf32x3.unpack_b_fragments(consts["w1frag"])
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    # one tap (32 channels x 64 outputs, hi and lo) is what the conv1
    # kernel streams at a time
    assert consts["w1frag"][:4].numel() * 4 == 16384
    x = torch.zeros((1, 96, 128, 3))
    for bad in (dict(consts, w1frag=consts["w1frag"][:-1]),
                dict(consts, b1=consts["b1"].double()),
                dict(consts, w0=consts["w0"].t())):
        with pytest.raises(ValueError, match="stem constant"):
            cuda_stem._launch(x, bad, SIZE)
    with pytest.raises(ValueError, match="images must be"):
        cuda_stem._launch(x.permute(0, 2, 1, 3), consts, SIZE)


@pytest.mark.parametrize("h,w,size", [(480, 640, 416), (96, 128, 64),
                                      (100, 130, 68), (1080, 1920, 416)])
def test_conv0_tile_extent_covers_every_tiles_tap_windows(h, w, size):
    """A conv0 block stages the frame rows from its first resized row's
    window to its last one's: never more than the extent the host sizes the
    shared memory by, at any tile of the grid, and within one block's
    memory."""
    s0 = -(-size // 2)
    pad0 = same_pad(size, 3, 2)[0]
    for n_in, span, tile in ((h, cuda_stem._TILE_RESIZED_ROWS, 8),
                             (w, cuda_stem._TILE_RESIZED_COLS, 32)):
        start, weights = cuda_stem.resize_taps(n_in, size)
        extent = cuda_stem.window_extent(start, weights.shape[1], span)
        assert extent <= n_in
        worst = 0
        for c0 in range(0, s0, tile):
            lo = 2 * c0 - pad0
            ra, rb = max(lo, 0), min(lo + span - 1, size - 1)
            worst = max(worst, start[rb] + weights.shape[1] - start[ra])
        assert worst <= extent
    fh, fw, band = cuda_stem.conv0_patch(h, w, size)
    assert 1 <= band <= fh
    assert (cuda_stem.conv0_shared_bytes(fh, fw, band)
            <= cuda_stem._MAX_SHARED_BYTES)
    if band < fh:       # a shorter band only where the whole patch is too big
        assert (cuda_stem.conv0_shared_bytes(fh, fw, band + 1)
                > cuda_stem._FOUR_BLOCKS_BYTES)


def test_conv0_rejects_a_patch_no_block_can_hold():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_stem.conv0_band(2000, 4000)
    with pytest.raises(ValueError, match="non-decreasing"):
        cuda_stem.window_extent(np.array([0, 2, 1], np.int32), 2, 2)


def _tied_cloud():
    """The cloud of tests/test_torch_knn.py's tie test: grid-quantized
    coordinates, many equal distances."""
    rng = np.random.default_rng(7)
    xyz = rng.integers(-4, 5, size=(600, 3)).astype(np.float32)
    xyz[:, 2] = np.abs(xyz[:, 2]) + 1.0
    uvd = np.stack([xyz[:, 0] * 40 + 320, xyz[:, 1] * 40 + 240, xyz[:, 2]],
                   -1).astype(np.float32)
    return uvd, np.ones(600, bool)


def _sparse_cloud():
    """Valid points in two short runs only: most slices hold fewer than k
    of them, some none."""
    uvd, _ = _tied_cloud()
    valid = np.zeros(600, bool)
    valid[[3, 4, 5, 301, 302]] = True
    valid[590:] = True
    return uvd, valid


def _empty_cloud():
    uvd, _ = _tied_cloud()
    return uvd, np.zeros(600, bool)


CLOUDS = {"tied": _tied_cloud, "sparse": _sparse_cloud,
          "empty": _empty_cloud}


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("n_slices", [1, 3, 8])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_knn_partition_model_equals_plain_twin(cloud, n_slices, k):
    uvd, valid = (torch.as_tensor(a) for a in CLOUDS[cloud]())
    rng = np.random.default_rng(k + n_slices)
    centers = torch.as_tensor(rng.uniform(-50, 700, (11, 2))
                              .astype(np.float32))
    centers[:3] = uvd[:3, :2]                     # on top of a point
    want = cuda_knn.knn_median_depth_plain(uvd, valid, centers, k)
    got = cuda_knn.knn_partition_model(uvd, valid, centers, k, n_slices,
                                       group=cuda_knn.center_group(k))
    assert torch.equal(got, want)
    if cloud == "empty":
        assert torch.equal(got, torch.full((11,), -1.0))
    # with a rig axis: each rig its own cloud and centers
    uvd2 = torch.stack([uvd, uvd.flip(0)])
    valid2 = torch.stack([valid, valid.flip(0)])
    centers2 = torch.stack([centers, centers + 7.0])
    got2 = cuda_knn.knn_partition_model(uvd2, valid2, centers2, k, n_slices)
    assert torch.equal(got2, cuda_knn.knn_median_depth_plain(
        uvd2, valid2, centers2, k))
    assert torch.equal(got2[0], got)


@pytest.mark.parametrize("n_rigs,p,d,want_slices", [
    (1, 16384, 64, 32),       # the single-rig tick
    (64, 8192, 16, 4),        # the fleet tick, 16 static queries a rig
    (64, 8192, 64, 1),        # the extension fleet tick: the rigs fill it
])
def test_knn_split_fills_the_card_once(n_rigs, p, d, want_slices):
    k = 4
    n_slices, slice_len = cuda_knn.knn_split(n_rigs, p, d, k)
    groups = -(-d // cuda_knn.center_group(k))
    blocks = n_rigs * groups * n_slices
    assert n_slices == want_slices
    assert n_slices * slice_len >= p > (n_slices - 1) * slice_len
    assert slice_len % 16 == 0
    # at least one block an SM, or every slice there is; never two waves
    assert blocks >= 132 or slice_len == cuda_knn.MIN_SLICE
    assert blocks <= cuda_knn.WAVE_BLOCKS
    assert slice_len >= cuda_knn.MIN_SLICE


@pytest.mark.parametrize("n_rigs,p,d,k", [(3, 1000, 5, 4), (1, 0, 4, 4),
                                          (1, 7, 1, 1), (200, 300, 64, 8),
                                          (1, 100000, 3, 8)])
def test_knn_split_covers_odd_shapes(n_rigs, p, d, k):
    n_slices, slice_len = cuda_knn.knn_split(n_rigs, p, d, k)
    assert n_slices >= 1 and slice_len >= 16 and slice_len % 16 == 0
    assert n_slices * slice_len >= p
    assert (n_slices - 1) * slice_len < max(p, 1)
    assert n_slices == 1 or slice_len >= cuda_knn.MIN_SLICE


def test_knn_scratch_is_kept_per_stream_and_grown():
    """The candidate keys and the arrival counters are kept from call to
    call (the kernel leaves the counters at 0): the same tensors while they
    are large enough, new zeroed counters when a call needs more, and a set
    of their own for another stream."""
    cuda_knn._scratch.clear()
    cpu = torch.device("cpu")
    keys, counters = cuda_knn._scratch_for(cpu, 7, 100, 8)
    assert keys.dtype == torch.int64 and keys.numel() == 100
    assert counters.dtype == torch.int32 and not counters.any()
    again = cuda_knn._scratch_for(cpu, 7, 50, 8)
    assert again[0] is keys and again[1] is counters
    grown = cuda_knn._scratch_for(cpu, 7, 50, 9)
    assert grown[1] is not counters and grown[1].numel() == 9
    assert not grown[1].any()
    other = cuda_knn._scratch_for(cpu, 8, 10, 1)
    assert other[0] is not grown[0]
    cuda_knn._scratch.clear()
