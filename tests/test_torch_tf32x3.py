"""3xTF32, the arithmetic of the tensor-core CSP-stage and orientation-front
kernels (csrc/gv_mma.cuh), emulated in plain torch (ops/tf32x3.py) on the
CPU:

- the hi / lo split reconstructs an f32 to 2^-21 relative and leaves the
  low 13 mantissa bits of both halves clear; rounding is to nearest, ties
  away from zero;
- the fragment packing of the weights is a lossless permutation, and the
  split constants that prepare_csp_constants / prepare_orient_constants
  return have the shapes, types and contiguity the wrappers check;
- the emulated product is f32-accurate where a single TF32 product is not;
- the CSP stage with every conv an emulated 3xTF32 product stays within
  rtol = atol = 1e-4 (the stage's bar) of its plain twin and of JAX's
  detector_csp_pallas in interpret mode, at the reduced size of
  tests/test_torch_csp.py;
- the orientation stem conv as an emulated 3xTF32 product stays within
  rtol = atol = 1e-3 (the front end's bar) of orient_front_plain on the
  strip of tests/test_torch_orient.py;
- a library's build key covers the headers of csrc/, so an edited
  gv_mma.cuh rebuilds the kernels that include it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.ops import pallas_csp
from grid_vision_tpu_torch.ops import (cuda_build, cuda_csp, cuda_orient,
                                       preprocess, tf32x3)

from . import test_torch_csp as csp_case
from . import test_torch_orient as orient_case

torch.set_num_threads(1)


def _values(seed, n=4096):
    """Normals over ~60 binades, both signs, with exact TF32 values,
    ties and zeros among them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n) * np.exp2(rng.integers(-30, 30, n))
    x = x.astype(np.float32)
    x[:4] = [0.0, 1.0, -1.0, 1.0 + 2.0 ** -11]      # the last is a tie
    return torch.as_tensor(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_reconstructs_and_clears_low_bits(seed):
    x = _values(seed)
    hi, lo = tf32x3.split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())


def test_round_tf32_ties_away_from_zero():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, 0.0, 0.15625])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -10, 0.0, 0.15625])
    assert torch.equal(tf32x3.round_tf32(x), want)


@pytest.mark.parametrize("k,n", [(8, 16), (64, 64), (480, 128), (288, 32)])
def test_pack_b_fragments_is_a_lossless_permutation(k, n):
    rng = np.random.default_rng(k + n)
    w = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32))
    frag = tf32x3.pack_b_fragments(w)
    assert frag.shape == (k // 8, n // 8, 32, 4)
    assert frag.dtype == torch.float32 and frag.is_contiguous()
    hi, lo = tf32x3.unpack_b_fragments(frag)
    want_hi, want_lo = tf32x3.split_tf32(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    # lane 4g + t of (ks, nt) holds rows 8 ks + 2t, + 1 of one channel
    ks, nt, g, t = k // 8 - 1, n // 8 - 1, 5, 2
    ch = int(tf32x3.fragment_channel(torch.tensor(nt), torch.tensor(g)))
    assert ch == 16 * (nt // 2) + 4 * (g // 2) + 2 * (nt % 2) + g % 2
    got = frag[ks, nt, 4 * g + t]
    want = torch.stack([want_hi[8 * ks + 2 * t, ch],
                        want_hi[8 * ks + 2 * t + 1, ch],
                        want_lo[8 * ks + 2 * t, ch],
                        want_lo[8 * ks + 2 * t + 1, ch]])
    assert torch.equal(got, want)


def test_fragment_channels_cover_every_channel_once():
    nt = torch.arange(16)[:, None].expand(16, 8)
    col = torch.arange(8)[None, :].expand(16, 8)
    ch = tf32x3.fragment_channel(nt, col).reshape(-1)
    assert torch.equal(torch.sort(ch).values, torch.arange(128))
    # a thread's columns 2t, 2t + 1 of tiles 2p, 2p + 1: four in a row
    for p, t in ((0, 0), (3, 2), (7, 3)):
        four = [int(tf32x3.fragment_channel(torch.tensor(2 * p + half),
                                            torch.tensor(2 * t + e)))
                for half in (0, 1) for e in (0, 1)]
        assert four == list(range(16 * p + 4 * t, 16 * p + 4 * t + 4))


@pytest.mark.parametrize("shape", [(7, 16), (16, 24)])
def test_pack_b_fragments_rejects_ragged_matrices(shape):
    with pytest.raises(ValueError, match="cannot pack"):
        tf32x3.pack_b_fragments(torch.zeros(shape))


@pytest.mark.parametrize("seed", [0, 1])
def test_product_is_f32_accurate_where_one_tf32_product_is_not(seed):
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.normal(0, 1, (64, 432)).astype(np.float32))
    b = torch.as_tensor(rng.normal(0, 1, (432, 32)).astype(np.float32))
    exact = a.double() @ b.double()
    b_hi, b_lo = tf32x3.split_tf32(b)
    err3 = (tf32x3.matmul_3xtf32(a, b_hi, b_lo).double() - exact).abs().max()
    err_f32 = ((a @ b).double() - exact).abs().max()
    err1 = ((tf32x3.round_tf32(a) @ b_hi).double() - exact).abs().max()
    assert float(err3) < 4 * float(err_f32) + 1e-6
    assert float(err1) > 20 * float(err3)


@pytest.mark.parametrize("seed", [0, 1])
def test_csp_stage_in_3xtf32_matches_twin_and_jax_kernel(seed):
    tree, det = csp_case._detector(seed)
    rng = np.random.default_rng(seed)
    size = csp_case.SIZE
    x = rng.normal(0, 1, (2, size // 4, size // 4, 64)).astype(np.float32)
    with torch.no_grad():
        got = tf32x3.detector_csp_3xtf32(torch.as_tensor(x), det).numpy()
        twin = cuda_csp.detector_csp_plain(torch.as_tensor(x), det).numpy()
    assert got.shape == (2, size // 8, size // 8, 128)
    np.testing.assert_allclose(got, twin, **csp_case.TOL)
    ref = np.asarray(pallas_csp.detector_csp_pallas(jnp.asarray(x), tree,
                                                    jnp.float32))
    np.testing.assert_allclose(got, ref, **csp_case.TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_orient_conv_in_3xtf32_matches_twin(seed):
    _, model = orient_case._variables(seed)
    images = torch.as_tensor(orient_case._images(seed=seed))
    xyxy, valid, rig = (torch.as_tensor(a)
                        for a in orient_case._strip(seed + 1))
    size = orient_case.SIZE
    with torch.no_grad():
        std = preprocess._standardize(
            cuda_orient.crops_by_rig(images, xyxy, rig, size), valid)
        got = tf32x3.orient_conv_3xtf32(std, model)
        twin = cuda_orient.orient_front_plain(images, xyxy, valid, rig,
                                              model, size)
    assert got.shape == twin.shape == (6, size // 8, size // 8,
                                       4 * orient_case.WIDTH)
    torch.testing.assert_close(got, twin, rtol=1e-3, atol=1e-3)
    # an invalid crop is an all-zero input: exactly relu(t)
    t = cuda_orient.prepare_orient_constants(model)["t"]
    assert torch.equal(got[~valid], torch.relu(t).expand_as(got[~valid]))


def test_csp_constants_are_what_the_wrapper_checks():
    _, det = csp_case._detector(0)
    consts = cuda_csp.prepare_csp_constants(det)
    assert set(consts) == set(cuda_csp._SHAPES)
    for name, shape in cuda_csp._SHAPES.items():
        t = consts[name]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert t.is_contiguous() and not t.requires_grad
    # w2 unpacks to ConvBN_2's folded matrix, split
    wmat, shift = tf32x3.folded_matrix(det.ConvBN_2)
    hi, lo = tf32x3.unpack_b_fragments(consts["w2"])
    want_hi, want_lo = tf32x3.split_tf32(wmat.detach())
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert torch.equal(consts["b2"], shift)
    x = torch.zeros((1, 16, 16, 64))
    for bad in (dict(consts, w2=consts["w2"][:-1]),
                dict(consts, ba=consts["ba"].double()),
                dict(consts, wc=consts["wc"].transpose(0, 1))):
        with pytest.raises(ValueError, match="CSP constant"):
            cuda_csp._launch(x, bad)


def test_orient_constants_are_what_the_wrapper_checks():
    _, model = orient_case._variables(3)
    consts = cuda_orient.prepare_orient_constants(model)
    f = 4 * orient_case.WIDTH
    assert set(consts) == {"wfrag", "t"}
    assert consts["wfrag"].shape == (60, f // 8, 32, 4)
    assert consts["t"].shape == (f,)
    for t in consts.values():
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert not t.requires_grad
    # rows uy * 40 + ux * 3 + c hold the folded kernel; 36..39 are zero
    hi, lo = tf32x3.unpack_b_fragments(consts["wfrag"])
    wmat, _ = tf32x3.folded_matrix(model.ConvBN_0)
    want_hi, want_lo = tf32x3.split_tf32(wmat.detach())
    runs = hi.reshape(12, 40, f)
    assert torch.equal(runs[:, :36].reshape(432, f), want_hi)
    assert torch.equal(lo.reshape(12, 40, f)[:, :36].reshape(432, f),
                       want_lo)
    assert not runs[:, 36:].any() and not lo.reshape(12, 40, f)[:, 36:].any()
    images = torch.zeros((1, 96, 128, 3))
    args = (torch.zeros((2, 4)), torch.ones(2, dtype=torch.bool),
            torch.zeros(2, dtype=torch.int64))
    for bad in (dict(consts, wfrag=consts["wfrag"][:-1]),
                dict(consts, t=consts["t"].double())):
        with pytest.raises(ValueError, match="orientation constants"):
            cuda_orient._launch(images, *args, bad, orient_case.SIZE)
    with pytest.raises(ValueError, match="int32 or int64"):
        cuda_orient._launch(images, args[0], args[1], args[2].float(),
                            consts, orient_case.SIZE)


def test_build_key_covers_source_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "other.cu").write_text('#include "h.cuh"\n// other\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = cuda_build._lib_path("k")
    assert first == cuda_build._lib_path("k")
    assert first.parent == cuda_build.BUILD_DIR
    (tmp_path / "h.cuh").write_text("// v2\n")
    edited_header = cuda_build._lib_path("k")
    assert edited_header != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert cuda_build._lib_path("k") not in (first, edited_header)
    (tmp_path / "new.cuh").write_text("// another header\n")
    assert cuda_build._lib_path("other") != cuda_build._lib_path("k")


def test_every_kernel_source_is_listed_and_headers_are_not():
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    assert sources == sorted(cuda_build.SOURCES)
    assert (cuda_build.CSRC / "gv_mma.cuh").exists()
    for name in ("cuda_csp", "cuda_orient"):
        assert '#include "gv_mma.cuh"' in (cuda_build.CSRC
                                           / f"{name}.cu").read_text()
