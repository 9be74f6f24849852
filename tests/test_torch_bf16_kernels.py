"""The bf16 forms of the stem, CSP-stage and orientation-front kernels: their
plain twins against the JAX package's Pallas kernels at
compute_dtype=bfloat16 (interpret mode on the CPU), at a reduced size
(96x128 frames, detector 64, orientation 64 / width 8), random weights with
a random BatchNorm, 8-bit frames. The bar is the JAX package's own bf16
kernel bar, rtol = atol = 0.06 (tests/test_pallas_orient.py:59-62), and
>= 99 % of the elements bit-equal.

The orientation front's statistics are single-pass f32 sums over a crop,
whose rounding depends on the order of the sum: the twin's (torch's) and
the Pallas kernel's (XLA's) differ by ~30 ulps of E[x^2], which moves ~2 %
of the bf16 outputs by one ulp. So the twin is held to the 0.06 bar as it
is, and to the bit-equal bar with the kernel's own statistics (the same
jnp.sum over the kernel's phase-blocked crop, which reproduces them
exactly) in place of its own.

Also: bf16mma's fragment packing (round trip, the k and n permutations) and
its emulated product; the wrappers' bf16 constants and their checks (the
wgmma packing of the bf16 stem: tests/test_torch_stem_bf16.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.ops import pallas_csp, pallas_orient, pallas_stem
from grid_vision_tpu.ops import preprocess as jpre
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu_torch.models import yolov4_tiny
from grid_vision_tpu_torch.ops import (bf16mma, cuda_build, cuda_csp,
                                       cuda_orient, cuda_stem, preprocess,
                                       tf32x3)

from . import test_torch_csp as csp_case
from . import test_torch_orient as orient_case

torch.set_num_threads(1)

SIZE = 64
BF16_TOL = dict(rtol=0.06, atol=0.06)
BF = torch.bfloat16


def _frames(n, seed, h=96, w=128):
    """8-bit frames (integers in [0, 255], exact in bf16), f32."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.float32)


def _hold(got, ref, share=0.99):
    """got (torch bf16) against ref (numpy) at the bf16 bar; returns the
    bit-equal share."""
    assert got.dtype == BF
    g = got.float().numpy()
    np.testing.assert_allclose(g, ref, **BF16_TOL)
    equal = (g == ref).mean()
    assert equal >= share, f"{equal} of the elements bit-equal"
    return equal


@pytest.mark.parametrize("seed", [0, 1])
def test_stem_twin_matches_jax_pallas_bf16(seed):
    tree, det = csp_case._detector(seed)
    frames = _frames(2, seed)
    ref = np.asarray(pallas_stem.detector_stem_pallas(
        jnp.asarray(frames), tree, SIZE, jnp.bfloat16).astype(jnp.float32))
    consts = cuda_stem.prepare_stem_constants(det, BF)
    got = cuda_stem.detector_stem_cuda(torch.as_tensor(frames).to(BF),
                                       consts, SIZE)
    assert got.shape == (2, SIZE // 4, SIZE // 4, 64)
    _hold(got, ref)


@pytest.mark.parametrize("layout", ["pallas2", "pallas3"])
def test_csp_twin_matches_jax_pallas_bf16(layout):
    tree, det = csp_case._detector(2)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(0, 1, (2, SIZE // 4, SIZE // 4, 64))
                        .astype(np.float32)).to(BF)
    fn = (pallas_csp.detector_csp_pallas if layout == "pallas2"
          else pallas_csp.detector_csp_flat)
    ref = np.asarray(fn(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                        tree, jnp.bfloat16).astype(jnp.float32))
    with torch.no_grad():
        got = cuda_csp.detector_csp_cuda(
            x, det, cuda_csp.prepare_csp_constants(det, BF))
    assert got.shape == (2, SIZE // 8, SIZE // 8, 128)
    _hold(got, ref)


def _pallas_stats(images, xyxy, rig):
    """The orientation kernel's statistics (mean, 1 / std), each (N, 1, 1,
    3): the bf16 crop (bit-equal to the kernel's), laid out in the kernel's
    phase-blocked order, summed by the same jnp.sum."""
    q = SIZE // 8

    @jax.jit
    def stats(img, box):
        one = JaxBoxes(xyxy=box[None], confidence=jnp.ones(1),
                       label=jnp.zeros(1, jnp.int32),
                       valid=jnp.ones(1, bool))
        crop = jpre.crop_resize(img, one, SIZE, compute_dtype=jnp.bfloat16,
                                out_dtype=jnp.bfloat16)[0]
        mean, inv = [], []
        for c in range(3):
            cf = (crop[..., c].reshape(q, 8, q, 8).transpose(1, 0, 3, 2)
                  .reshape(SIZE, SIZE).astype(jnp.float32))
            m = jnp.sum(cf) / float(SIZE * SIZE)
            var = jnp.maximum(jnp.sum(cf * cf) / float(SIZE * SIZE) - m * m,
                              0.0)
            mean.append(m)
            inv.append(1.0 / jnp.maximum(jnp.sqrt(var), 1e-6))
        return jnp.stack(mean), jnp.stack(inv)

    out = [stats(jnp.asarray(images[r]), jnp.asarray(b))
           for b, r in zip(xyxy, rig)]
    return tuple(torch.tensor(np.stack([np.asarray(o[i]) for o in out]))
                 [:, None, None, :] for i in range(2))


def test_orient_twin_matches_jax_pallas_bf16(monkeypatch):
    tree, model = orient_case._variables(2)
    images = _frames(3, 2)
    # a box clamped at the origin, a tiny upscaled one, an invalid slot
    xyxy, valid, rig = (a[[0, 2, 5]] for a in orient_case._strip(3))
    consts = pallas_orient.prepare_orient_constants(tree, SIZE,
                                                    orient_case.WIDTH)
    ref = np.asarray(pallas_orient.orient_front_pallas(
        jnp.asarray(images), jnp.asarray(xyxy), jnp.asarray(valid),
        jnp.asarray(rig), consts, SIZE, jnp.bfloat16).astype(jnp.float32))
    port_consts = cuda_orient.prepare_orient_constants(model, BF)

    def run():
        with torch.no_grad():
            return cuda_orient.orient_front_cuda(
                torch.as_tensor(images).to(BF), torch.as_tensor(xyxy),
                torch.as_tensor(valid), torch.as_tensor(rig), model,
                port_consts, SIZE)

    got = run()
    assert got.shape == (3, SIZE // 8, SIZE // 8, 4 * orient_case.WIDTH)
    _hold(got, ref, share=0.95)
    # the invalid crop: relu(t), rounded once
    t = port_consts["t"]
    assert torch.equal(got[-1], torch.relu(t).to(BF).expand_as(got[-1]))
    # with the kernel's own statistics the arithmetic is the kernel's
    mean, inv = _pallas_stats(images, xyxy, rig)
    own_mean, own_inv = cuda_orient.single_pass_stats(
        cuda_orient.crops_by_rig(torch.as_tensor(images).to(BF),
                                 torch.as_tensor(xyxy), torch.as_tensor(rig),
                                 SIZE, BF))
    torch.testing.assert_close(own_mean, mean, rtol=1e-6, atol=0)
    torch.testing.assert_close(own_inv, inv, rtol=1e-4, atol=0)
    monkeypatch.setattr(cuda_orient, "single_pass_stats",
                        lambda crops: (mean, inv))
    _hold(run(), ref)


def test_bf16_fragments_round_trip_and_layout():
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(0, 1, (64, 48)).astype(np.float32))
    frag = bf16mma.pack_b_fragments(w)
    assert frag.shape == (4, 6, 32, 4) and frag.dtype == BF
    assert torch.equal(bf16mma.unpack_b_fragments(frag), w.to(BF))
    # lane 4g + t of k step ks, n-tile nt: w[16 ks + 4t + j, channel]
    for ks, nt, lane in ((0, 0, 0), (1, 3, 13), (3, 5, 31)):
        g, t = lane // 4, lane % 4
        ch = int(tf32x3.fragment_channel(torch.tensor(nt), torch.tensor(g)))
        want = w[16 * ks + 4 * t:16 * ks + 4 * t + 4, ch].to(BF)
        assert torch.equal(frag[ks, nt, lane], want)
    with pytest.raises(ValueError, match="K % 16"):
        bf16mma.pack_b_fragments(w[:40])


def test_emulated_product_is_f32_of_rounded_operands():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.normal(0, 1, (32, 96)).astype(np.float32))
    b = torch.as_tensor(rng.normal(0, 1, (96, 16)).astype(np.float32))
    got = bf16mma.matmul_bf16(a, b)
    want = (a.to(BF).double() @ b.to(BF).double()).float()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(bf16mma.round_bf16(a), a.to(BF).float())


def test_bf16_constants_are_what_the_wrappers_check():
    _, det = csp_case._detector(0)
    _, model = orient_case._variables(0)
    stem = cuda_stem.prepare_stem_constants(det, BF)
    csp = cuda_csp.prepare_csp_constants(det, BF)
    orient = cuda_orient.prepare_orient_constants(model, BF)
    for consts, shapes in ((stem, cuda_stem._SHAPES_BF16),
                           (csp, cuda_csp._SHAPES_BF16)):
        assert cuda_build.consts_dtype(consts) == BF
        cuda_build.check_constants(consts, shapes, torch.device("cpu"), "x")
    # the packed weights are the plain twin's bf16 weights without the BN
    # scale (the stem's conv0 padded with zero rows from K = 27 to 32)
    w0 = bf16mma.unpack_b_fragments(stem["w0frag"])
    assert torch.equal(w0[:27], stem["w0_oihw"].permute(2, 3, 1, 0).reshape(
        27, 32))
    assert not w0[27:].float().any()
    w1 = stem["w1_oihw"].permute(2, 3, 1, 0).reshape(288, 64)
    assert torch.equal(bf16mma.unpack_wgmma_b(stem["w1wg"]), w1)
    w2 = csp["w2_oihw"].permute(2, 3, 1, 0).reshape(576, 64)
    assert torch.equal(bf16mma.unpack_wgmma_b(csp["w2"]),
                       w2[cuda_csp.k_pair_order(576)])
    f = orient["t"].shape[0]
    wo = bf16mma.unpack_wgmma_b_halves(orient["wwg"], f)
    assert torch.equal(wo, orient["w_oihw"].permute(2, 3, 1, 0).reshape(
        432, f))
    assert not bf16mma.unpack_wgmma_b_halves(
        orient["wwg"], 64 * orient["wwg"].shape[1])[:, f:].float().any()
    # an f32 activation into a bf16 form raises, and the other way round
    x = torch.zeros((1, 96, 128, 3))
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_stem.detector_stem_cuda(x, stem, SIZE)
    with pytest.raises(ValueError, match="float32"):
        cuda_stem.detector_stem_cuda(x.to(BF),
                                     cuda_stem.prepare_stem_constants(det),
                                     SIZE)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_csp.detector_csp_cuda(torch.zeros((1, 16, 16, 64)), det, csp)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_orient.orient_front_cuda(
            torch.zeros((1, 96, 128, 3)), torch.zeros((1, 4)),
            torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.int32),
            model, orient, SIZE)
    # the kernels' own checks (the launch refuses what the card would
    # misread)
    bad = dict(stem, w1wg=stem["w1wg"][:-1])
    with pytest.raises(ValueError, match="stem constant"):
        cuda_stem._launch(x.to(BF), bad, SIZE)
    with pytest.raises(ValueError, match="CSP constant"):
        cuda_csp._launch(torch.zeros((1, 16, 16, 64), dtype=BF),
                         dict(csp, sa=csp["sa"].double()))


def test_net_with_stem_external_in_bf16_matches_full_forward():
    """The bf16 detector fed the stem twin's output (stem_external) equals
    the bf16 net from the resized frames where the stem twin equals the
    net's own ConvBN_0 / ConvBN_1 in bf16: the heads agree at the bf16
    bar."""
    _, det = csp_case._detector(3)
    frames = torch.as_tensor(_frames(1, 3))
    consts = cuda_stem.prepare_stem_constants(det, BF)
    with torch.no_grad():
        stem = cuda_stem.detector_stem_cuda(frames.to(BF), consts, SIZE)
        a = yolov4_tiny.forward(det, stem, stem_external=True, dtype=BF)
        x = torch.stack([preprocess.preprocess_detector_image(im, SIZE, BF)
                         for im in frames])
        b = yolov4_tiny.forward(det, x, dtype=BF)
    for u, v in zip(a, b):
        assert u.dtype == torch.float32
        torch.testing.assert_close(u, v, **BF16_TOL)
