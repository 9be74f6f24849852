"""The int8 conv kernel's module (ops/cuda_int8.py) on the CPU, against the
JAX package's tools/bench_int8_mxu.py and models/yolov4_int8.py.

- The tool's Pallas GEMM (build_matmul) at both sites, whole-K (bk = K)
  and K-blocked (bk < K), in both dtypes, in interpret mode at M 256, K
  384, N 256: s8 -> s32 bit-equal to int8_matmul_plain, bf16 -> f32 within
  1e-4 of bf16_matmul_plain on unit-normal inputs (f32 sums of 384
  products of ~1; the plain version sums in f64).
- int8_matmul_plain of (M, K) x (K, N) is int8_conv_plain's 1x1 conv on
  the (1, M, 1, K) view: the kernel's GEMM form.
- A numpy emulation of the kernel's requant epilogue, step by step (f32
  scale product, f32 of the accumulator, the f64 multiply-add rounded once
  to f32, torch's leaky form), is bit-equal to requant and to the tail of
  jitted JAX _qconv, over accumulators beyond +-2^24, negative and zero
  outputs, per-sample and 0-d static scales; and, on a real layer, to
  jax.jit(_qconv) whole.
- On CPU tensors the wrappers and the int8 detector run the plain versions
  and never reach cuda_build.load; the wrapper's checks refuse what the
  kernel does not take before it would launch (a forced plan a layer
  cannot take, a misaligned weight matrix included).
- int8_plan, the kernel's plan: the N tile of fewest tile-costs over the
  card's SMs, the route of A at each of the detector's 19 sites, the ring
  within a block's shared memory, force_plan.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.models import yolov4_int8 as jint8
from grid_vision_tpu_torch.models import weights, yolov4_int8, yolov4_tiny
from grid_vision_tpu_torch.ops import cuda_build, cuda_int8
from grid_vision_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = __file__.rsplit("/tests/", 1)[0]
M, K, N = 256, 384, 256


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_int8_mxu", f"{REPO}/tools/bench_int8_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _tool()


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    return dict(
        int8=(rng.integers(-127, 127, (M, K), np.int8),
              rng.integers(-127, 127, (K, N), np.int8)),
        bf16=(rng.normal(size=(M, K)).astype(np.float32),
              rng.normal(size=(K, N)).astype(np.float32)))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("bk", [K, 128], ids=["whole_k", "k_blocked"])
def test_tool_pallas_matmul_matches_plain(tool, operands, dtype, bk):
    a, b = operands[dtype]
    if dtype == "int8":
        fn = tool.build_matmul(jnp.int8, jnp.int32, M, K, N, 128, bk, 128,
                               interpret=True)
        got = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
        want = cuda_int8.int8_matmul_plain(torch.tensor(a), torch.tensor(b))
        assert want.dtype == torch.int32
        np.testing.assert_array_equal(got, want.numpy())
        # the wrapper on a CPU tensor is its plain version
        assert torch.equal(cuda_int8.int8_matmul(torch.tensor(a),
                                                 torch.tensor(b)), want)
    else:
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        fn = tool.build_matmul(jnp.bfloat16, jnp.float32, M, K, N, 128, bk,
                               128, interpret=True)
        got = np.asarray(fn(ja, jb))
        ta = torch.tensor(np.asarray(ja.astype(jnp.float32))).bfloat16()
        tb = torch.tensor(np.asarray(jb.astype(jnp.float32))).bfloat16()
        want = cuda_int8.bf16_matmul_plain(ta, tb)
        assert want.dtype == torch.float32
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-4)
        assert torch.equal(cuda_int8.bf16_matmul(ta, tb), want)


def test_matmul_plain_is_the_1x1_conv_on_the_gemm_view(operands):
    a, b = (torch.tensor(t) for t in operands["int8"])
    conv = cuda_int8.int8_conv_plain(a.view(1, M, 1, K),
                                     b.t().reshape(N, K, 1, 1), 1)
    assert torch.equal(cuda_int8.int8_matmul_plain(a, b),
                       conv.reshape(M, N))


def epilogue(acc, sx, sw, bias):
    """The kernel's epilogue (csrc/cuda_int8.cu, requant) in numpy, step by
    step: acc (B, ..., N) int32, sx (B,) f32, sw and bias (N,) f32."""
    shape = (-1,) + (1,) * (acc.ndim - 1)
    s = sx.astype(np.float32).reshape(shape) * sw.astype(np.float32)
    a = acc.astype(np.float32)
    y = (a.astype(np.float64) * s.astype(np.float64)
         + bias.astype(np.float64)).astype(np.float32)
    return np.where(y > 0, y, y * np.float32(0.1))


def _jax_tail(acc, sx, sw, bias):
    """The tail of the JAX package's _qconv (models/yolov4_int8.py:122-123),
    jitted as its pipeline runs it."""
    def tail(acc, sx, sw, b):
        y = acc.astype(jnp.float32) * (sx * sw) + b
        return jax.nn.leaky_relu(y, 0.1)
    return np.asarray(jax.jit(tail)(acc, sx, sw, bias))


@pytest.mark.parametrize("static", [False, True], ids=["per_sample", "0d"])
def test_epilogue_emulation_bit_equal_to_requant_and_jax(static):
    rng = np.random.default_rng(1)
    b, n = 3, 64
    limit = 127 * 127 * 4608
    acc = rng.integers(-limit, limit + 1, (b, 5, 7, n)).astype(np.int32)
    acc[0, 0, 0, :8] = [0, 1, -1, 2 ** 24 + 1, -(2 ** 24) - 3, limit,
                        -limit, 2 ** 26 + 7]
    sw = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    bias[:4] = 0.0
    if static:
        sx0 = np.float32(rng.uniform(1e-3, 1e-1))
        sx_np, sx_t = np.full(b, sx0, np.float32), torch.tensor(sx0)
        sx_j = jnp.asarray(sx0)
    else:
        sx_np = rng.uniform(1e-3, 1e-1, b).astype(np.float32)
        sx_t = torch.tensor(sx_np).reshape(b, 1, 1, 1)
        sx_j = jnp.asarray(sx_np.reshape(b, 1, 1, 1))
    assert np.abs(acc).max() > 2 ** 24
    got = epilogue(acc, sx_np, sw, bias)
    assert (got < 0).any() and (got == 0).any() and (got > 0).any()
    layer = dict(sw=torch.tensor(sw), b=torch.tensor(bias))
    want = cuda_int8.requant(torch.tensor(acc), sx_t, layer).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jax_tail(jnp.asarray(acc), sx_j, jnp.asarray(sw),
                       jnp.asarray(bias)))
    # the wrapper's (B,) scale vector, as the kernel reads it
    np.testing.assert_array_equal(
        cuda_int8.per_sample(sx_t, b).numpy(), sx_np)


@pytest.fixture(scope="module")
def layers():
    tree = checkpoint.load_npz_tree(f"{REPO}/weights/detector.npz")
    det = weights.load_module(yolov4_tiny.YoloV4Tiny(
        yolov4_tiny.YoloConfig(input_size=96)), tree).eval()
    return jint8.quantize_detector(tree), yolov4_int8.quantize_detector(det)


@pytest.mark.parametrize("name,stride,cin", [
    ("ConvBN_0", 2, 3), ("ConvBN_5", 1, 512)])
def test_epilogue_emulation_bit_equal_to_jitted_qconv(layers, name, stride,
                                                      cin):
    qj, qp = layers
    rng = np.random.default_rng(cin)
    x = (rng.normal(size=(2, 15, 12, cin)) * 3).astype(np.float32)
    xt = torch.tensor(x)
    sx = yolov4_int8.act_scale(xt)
    acc = cuda_int8.int8_conv_plain(yolov4_int8.quantize_act(xt, sx),
                                    qp[name]["wq"], stride).numpy()
    got = epilogue(acc, sx.reshape(-1).numpy(), qp[name]["sw"].numpy(),
                   qp[name]["b"].numpy())
    want = jax.jit(lambda x: jint8._qconv(x, qj[name], stride))(
        jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("cuda_build.load reached on a CPU tensor")
    monkeypatch.setattr(cuda_build, "load", refuse)
    cuda_int8._entry.cache_clear()
    yield
    cuda_int8._entry.cache_clear()


def test_cpu_tensors_never_reach_the_build(layers, no_build):
    _, qp = layers
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 13, 11, 64)).astype(np.float32))
    n0, l0 = cuda_int8.launches, yolov4_int8.launches
    y = yolov4_int8._qconv(x, qp["ConvBN_2"], 1)
    sx = yolov4_int8.act_scale(x)
    assert torch.equal(y, cuda_int8.int8_conv_requant_plain(
        yolov4_int8.quantize_act(x, sx), sx, qp["ConvBN_2"], 1))
    images = torch.rand((1, 96, 96, 3), generator=torch.Generator()
                        .manual_seed(0))
    cfg = yolov4_tiny.YoloConfig(input_size=96)
    boxes, _ = yolov4_int8.forward_int8(qp, images, cfg)
    scales = yolov4_int8.calibrate_scales(qp, [images], cfg)
    yolov4_int8.forward_int8_static(qp, scales, images, cfg)
    a = torch.ones((5, 16), dtype=torch.int8)
    cuda_int8.int8_matmul(a, a.t())
    cuda_int8.bf16_matmul(a.bfloat16(), a.t().bfloat16())
    assert boxes.shape[1] == 3 * (3 * 3 + 6 * 6)
    assert cuda_int8.launches == n0 and yolov4_int8.launches == l0


@pytest.mark.parametrize("what", ["dtype", "contiguous", "kp", "weights",
                                  "scale", "bf16_channels", "wt_aligned",
                                  "forced_route", "bf16_tile"])
def test_wrapper_refuses_before_launch(no_build, what):
    x = torch.zeros((1, 5, 5, 32), dtype=torch.int8)
    wt = torch.zeros((64, 288), dtype=torch.int8)
    args, requant_by, forced = (x, wt, 3, 1), None, {}
    if what == "dtype":
        args = (x.float(), wt, 3, 1)
    elif what == "contiguous":
        args = (x.permute(0, 2, 1, 3), wt, 3, 1)
    elif what == "kp":
        args = (x, wt[:, :280].contiguous(), 3, 1)
    elif what == "weights":
        args = (x, wt.short(), 3, 1)
    elif what == "scale":
        requant_by = (torch.ones(2), torch.ones(64), torch.ones(64))
    elif what == "bf16_channels":
        args = (torch.zeros((1, 5, 5, 4), dtype=torch.bfloat16),
                torch.zeros((8, 48), dtype=torch.bfloat16), 3, 1)
    elif what == "wt_aligned":        # its TMA map needs a 16-byte base
        flat = torch.zeros(64 * 288 + 16, dtype=torch.int8)
        off = next(i for i in range(1, 16) if (flat.data_ptr() + i) % 16)
        args = (x, flat[off:off + 64 * 288].view(64, 288), 3, 1)
    elif what == "forced_route":      # a 3x3 conv is no plain matrix
        forced = dict(route="tiled")
    else:                             # bf16 tiles stop at 128
        args = (torch.zeros((1, 5, 5, 32), dtype=torch.bfloat16),
                torch.zeros((64, 288), dtype=torch.bfloat16), 3, 1)
        forced = dict(tile_n=256)
    with pytest.raises(ValueError), cuda_int8.force_plan(**forced):
        cuda_int8._launch(*args, requant_by)


# (m, n, k, c, ksize, stride) -> (tile_n, route): the detector's sites at
# 64 frames (ConvBN_0, ConvBN_3, ConvBN_5, ConvBN_6, ConvBN_4) and one
# (ConvBN_5), the tool's GEMM, an odd small conv and a GEMM whose rows are
# not 16-byte pieces
@pytest.mark.parametrize("m,n,k,c,ksize,stride,want", [
    (64 * 208 * 208, 32, 27, 3, 3, 2, (32, "runs")),
    (64 * 52 * 52, 128, 1152, 128, 3, 1, (128, "im2col")),
    (64 * 13 * 13, 512, 4608, 512, 3, 1, (128, "im2col")),
    (64 * 13 * 13, 256, 512, 512, 1, 1, (256, "tiled")),
    (64 * 26 * 26, 256, 2304, 256, 3, 1, (256, "im2col")),
    (169, 512, 4608, 512, 3, 1, (32, "im2col")),
    (8192, 256, 2304, 2304, 1, 1, (128, "tiled")),
    (100, 48, 432, 48, 3, 1, (32, "gather")),
    (10, 7, 8, 8, 1, 1, (32, "bytes"))])
def test_int8_plan_fills_the_card(m, n, k, c, ksize, stride, want):
    plan = cuda_int8.int8_plan(m, n, k, c, ksize, stride)
    assert (plan.tile_n, plan.route) == want
    m_tiles = -(-m // cuda_int8.TILE_M)
    assert plan.tiles == m_tiles * -(-n // plan.tile_n)
    assert plan.blocks == min(plan.tiles, cuda_int8.SMS)

    def cost(w):
        return (-(-(m_tiles * -(-n // w)) // cuda_int8.SMS)
                * (w + cuda_int8.TILE_COST))
    # no width up to the narrowest that covers n takes fewer tile-costs
    top = min((w for w in cuda_int8.TILE_N if w >= n),
              default=cuda_int8.TILE_N[0])
    assert all(cost(plan.tile_n) <= cost(w) for w in cuda_int8.TILE_N
               if w <= top)
    # bf16 keeps to 128 columns; fewer SMs never widen the tile
    bf = cuda_int8.int8_plan(m, n, k, c, ksize, stride, size=2) \
        if c * 2 % 16 == 0 else None
    assert bf is None or bf.tile_n <= 128
    assert cuda_int8.int8_plan(m, n, k, c, ksize, stride,
                               sms=8).blocks <= 8


@pytest.mark.parametrize("bn", cuda_int8.TILE_N)
def test_ring_fits_a_block(bn):
    """The ring's stages (at least 4: the gather's arrivals trail by 2)
    and the block's shared memory, as csrc/cuda_int8.cu's Smem<BN>."""
    stages, smem = cuda_int8.ring_stages(bn), cuda_int8.smem_bytes(bn)
    assert 4 <= stages <= cuda_int8.MAX_STAGES
    assert smem <= cuda_int8.MAX_SMEM
    stage = (cuda_int8.TILE_M + bn) * cuda_int8.STAGE_K
    assert smem == stages * stage + cuda_int8.SMEM_FIXED
    assert stages == cuda_int8.MAX_STAGES or smem + stage > cuda_int8.MAX_SMEM
    plan = cuda_int8.int8_plan(4096, bn, 1152, 128, 3, 1, tile_n=bn)
    assert (plan.stages, plan.smem) == (stages, smem)


def test_routes_at_every_site(layers):
    """The route of each of the detector's 19 convs: ConvBN_0 its runs,
    the 1x1 convs a tiled copy, every other 3x3 conv im2col (C of 128
    bytes or more a copy a stage, 32 and 64 a copy a tap); an unaligned x
    the bytes (s8)."""
    _, qp = layers
    want = {"ConvBN_0": "runs"}
    seen = {}

    def hook(x, site, layer, stride):
        xq = torch.zeros(x.shape, dtype=torch.int8)
        plan = cuda_int8.plan_for(xq, layer["wt"], layer["wq"].shape[-1],
                                  stride)
        seen[site] = plan.route
        k, c = layer["wq"].shape[-1], x.shape[-1]
        default = "tiled" if k == 1 else "im2col"
        assert plan.route == want.get(site, default), site
        assert cuda_int8.routes_for(c, k, stride, aligned=False)[0] == (
            "runs" if site == "ConvBN_0" else "bytes")
        return cuda_int8.int8_conv_requant_plain(
            xq, torch.ones(()), layer, stride)

    images = torch.zeros((1, 96, 96, 3))
    yolov4_int8._topology(qp, images, yolov4_tiny.YoloConfig(input_size=96),
                          hook)
    assert sorted(seen) == sorted(yolov4_int8.LAYERS)
    assert cuda_int8.routes_for(4, 3, 1, size=2, aligned=True) == ()
    # narrow taps: s8 only (a stage's taps past k x k are left as they are,
    # which only an integer product with B's zeros makes harmless)
    assert cuda_int8.routes_for(32, 3, 2) == ("im2col", "gather", "bytes")
    assert cuda_int8.routes_for(32, 3, 1, size=2) == ("gather",)
    assert cuda_int8.routes_for(48, 3, 1) == ("gather", "bytes")


def test_force_plan_overrides_and_restores():
    rule = cuda_int8.int8_plan(8192, 256, 2304)
    with cuda_int8.force_plan(tile_n=64):
        assert cuda_int8.int8_plan(8192, 256, 2304).tile_n == 64
        with cuda_int8.force_plan(route="gather"):
            forced = cuda_int8.int8_plan(8192, 256, 2304)
            assert (forced.route, forced.tile_n) == ("gather", rule.tile_n)
        with pytest.raises(ValueError):
            cuda_int8.int8_plan(8192, 256, 2304, size=2, tile_n=256)
        assert cuda_int8.int8_plan(8192, 256, 2304).tile_n == 64
    assert cuda_int8.int8_plan(8192, 256, 2304) == rule
    with pytest.raises(ValueError), cuda_int8.force_plan(route="runs"):
        cuda_int8.int8_plan(8192, 256, 2304)
