"""The five configuration knobs against the JAX package, on the CPU, at its
own bars:

- detector_s2d_stem: the s2d stem convs against the JAX net with
  s2d_stem=True, and against the port's plain 3x3/s2 convs, to 1e-5
  (tests/test_models.py:53-74); the parameter tree is the same.
- orientation_s2d_fold=False: the repacked stem against the JAX net with
  s2d_fold=False, and against the folded stem, to 1e-4 on the orientation
  and 1e-3 on confidence and dims (tests/test_models.py:77-100).
- detector_stem_backend="im2col": ops/stem_im2col.py against JAX's
  detector_stem_im2col_xla (its constants from the port's own fold), and
  the detector on it against the plain chain, to 1e-4
  (tests/test_pallas_stem.py:44-52); any frame size.
- knn_backend="approx": the port's search (association.knn_median_depth,
  a stable sort's first k) gives medians equal to JAX's jitted
  knn_median_depth_approx (exact on the CPU, ties to the lowest index), on
  clouds built with ties.
- orientation_arch="resnet": init leaf for leaf to 1e-6, the f32 forward
  to 1e-4, three AdamW train steps within tests/test_torch_train_steps.py's
  bars of JAX's steps run in float64 (losses rtol 1e-5; parameters within
  1e-4 and >= 99.99 % within atol 1e-6 / rtol 1e-4; running statistics
  atol 1e-5).

Sizes: detector input 64, orientation input 64 / width 8, batch 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.ops import association as jassoc
from grid_vision_tpu.ops import pallas_stem
from grid_vision_tpu.train import trainer as jtrainer
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu_torch.models import orientation_net, weights, yolov4_tiny
from grid_vision_tpu_torch.ops import association, stem_im2col
from grid_vision_tpu_torch.train import trainer
from grid_vision_tpu_torch.types import Boxes
from grid_vision_tpu_torch.utils import checkpoint, prng

torch.set_num_threads(1)

SIZE, OSIZE, WIDTH, BATCH = 64, 64, 8, 4


def _detector():
    jcfg = jyolo.YoloConfig(input_size=SIZE, compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jyolo.init_params(jax.random.PRNGKey(0), jcfg))
    # BatchNorm statistics away from the identity, so the folds matter
    rng = np.random.default_rng(5)
    for leaf in checkpoint.tree_to_flat(tree["batch_stats"]):
        node = tree["batch_stats"]
        *path, name = checkpoint.split_key(leaf)
        for p in path:
            node = node[p]
        node[name] = (rng.uniform(0.5, 1.5, node[name].shape)
                      if name == "var" else
                      rng.normal(0, 0.1, node[name].shape)).astype(np.float32)
    det = weights.load_module(yolov4_tiny.YoloV4Tiny(
        yolov4_tiny.YoloConfig(input_size=SIZE)), tree).eval()
    return tree, det


@torch.no_grad()
def test_s2d_stem_matches_jax():
    tree, det = _detector()
    img = np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    want = jyolo.forward(tree, jnp.asarray(img), jyolo.YoloConfig(
        input_size=SIZE, compute_dtype=jnp.float32, s2d_stem=True))
    got = yolov4_tiny.forward(det, torch.tensor(img), s2d_stem=True)
    plain = yolov4_tiny.forward(det, torch.tensor(img))
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("frame", [(96, 128), (90, 122)])
@torch.no_grad()
def test_im2col_stem_matches_jax(frame):
    tree, det = _detector()
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 255, (2, *frame, 3)).astype(np.float32)
    consts = stem_im2col.prepare_im2col_constants(det)
    jconsts = pallas_stem.prepare_stem_constants(tree)
    for k, v in jconsts.items():
        np.testing.assert_allclose(consts[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    want = pallas_stem.detector_stem_im2col_xla(
        jnp.asarray(frames), tree, SIZE, jnp.float32)
    got = stem_im2col.detector_stem_im2col(torch.tensor(frames), consts,
                                           SIZE)
    assert got.shape == (2, SIZE // 4, SIZE // 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the detector on it against the plain resize + ConvBN_0/1 chain
    from grid_vision_tpu_torch.ops.preprocess import preprocess_detector_image
    net_in = preprocess_detector_image(torch.tensor(frames), SIZE)
    ref = yolov4_tiny.forward(det, net_in)
    out = yolov4_tiny.forward(det, got, stem_external=True)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _orientation(arch, fold=True, width=WIDTH):
    jcfg = jorient.OrientationConfig(input_size=OSIZE, width=width,
                                     arch=arch, s2d_fold=fold,
                                     compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jorient.init_params(jax.random.PRNGKey(3), jcfg))
    net = weights.load_module(orientation_net.make_model(
        orientation_net.OrientationConfig(input_size=OSIZE, width=width,
                                          arch=arch, s2d_fold=fold,
                                          compute_dtype=torch.float32)),
        tree).eval()
    return jcfg, tree, net


@torch.no_grad()
def test_unfolded_orientation_stem_matches_jax():
    jcfg, tree, net = _orientation("s2d", fold=False)
    crops = np.random.default_rng(4).normal(size=(BATCH, OSIZE, OSIZE, 3)
                                            ).astype(np.float32)
    want = jorient.forward(tree, jnp.asarray(crops), jcfg)
    got = orientation_net.forward(net, torch.tensor(crops))
    folded = orientation_net.forward(net, torch.tensor(crops), s2d_fold=True)
    for i, (g, w, f) in enumerate(zip(got, want, folded)):
        tol = 1e-4 if i == 0 else 1e-3
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=tol, atol=tol)


@torch.no_grad()
def test_resnet_init_and_forward_match_jax():
    jcfg, tree, _ = _orientation("resnet")
    net = orientation_net.init_params(prng.prng_key(3),
                                      orientation_net.OrientationConfig(
                                          input_size=OSIZE, width=WIDTH,
                                          arch="resnet"))
    got_tree = checkpoint.tree_to_flat(weights.flax_tree(net))
    want_tree = checkpoint.tree_to_flat(tree)
    assert got_tree.keys() == want_tree.keys()
    assert any("ResBlock_2" in k and "Conv_2" in k for k in want_tree)
    assert not any("ResBlock_1" in k and "Conv_2" in k for k in want_tree)
    for k in want_tree:
        np.testing.assert_allclose(got_tree[k], want_tree[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    crops = np.random.default_rng(5).normal(size=(BATCH, OSIZE, OSIZE, 3)
                                            ).astype(np.float32)
    want = jorient.forward(tree, jnp.asarray(crops), jcfg)
    got = orientation_net.forward(net.eval(), torch.tensor(crops))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


PEAK, WARMUP, DECAY = 2e-3, 2, 10


def _multibin_batches(n):
    rng = np.random.default_rng(6)
    return [[rng.normal(size=(BATCH, OSIZE, OSIZE, 3)).astype(np.float32),
             (rng.normal(size=(BATCH, 3)) * 0.3).astype(np.float32),
             rng.integers(0, 2, BATCH).astype(np.int32),
             rng.uniform(-1, 1, BATCH).astype(np.float32)]
            for _ in range(n)]


def test_resnet_three_train_steps_match_jax_f64():
    batches = _multibin_batches(3)
    init = jorient.init_params(jax.random.PRNGKey(0), jorient.
                               OrientationConfig(input_size=OSIZE,
                                                 width=WIDTH, arch="resnet"))
    with jax.enable_x64(True):
        jcfg = jorient.OrientationConfig(input_size=OSIZE, width=WIDTH,
                                         arch="resnet",
                                         compute_dtype=jnp.float64)
        tx = optax.adamw(optax.warmup_cosine_decay_schedule(
            0.0, PEAK, warmup_steps=WARMUP, decay_steps=DECAY),
            weight_decay=1e-5)
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), init)
        state = jtrainer.TrainState(variables=variables,
                                    opt_state=tx.init(variables["params"]),
                                    step=jnp.zeros((), jnp.int32))
        step = jtrainer.make_train_step("multibin", jcfg, tx)
        want_losses = []
        for b in batches:
            state, m = step(state, *[x.astype(np.float64)
                                     if x.dtype == np.float32 else x
                                     for x in b])
            want_losses.append(float(m["loss"]))
        want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      state.variables)
    cfg = orientation_net.OrientationConfig(input_size=OSIZE, width=WIDTH,
                                            arch="resnet",
                                            compute_dtype=torch.float32)
    ptx = trainer.AdamW(trainer.warmup_cosine_decay_schedule(
        0.0, PEAK, WARMUP, DECAY), weight_decay=1e-5)
    pstate = trainer.init_train_state("multibin", cfg, ptx, prng.prng_key(0))
    pstep = trainer.make_train_step("multibin", cfg, ptx)
    losses = []
    for b in batches:
        pstate, m = pstep(pstate, *[torch.tensor(x) for x in b])
        losses.append(m["loss"].item())
    assert pstate.step == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    ref = weights.params_from_jax(want)
    got = pstate.model.state_dict()
    assert ref.keys() == got.keys()
    n = off = 0
    for k, r in ref.items():
        g = got[k].numpy().astype(np.float64)
        r = r.numpy().astype(np.float64)
        if "running" in k:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=k)
            continue
        err = np.abs(g - r)
        assert err.max() <= 1e-4, (k, err.max())
        n += r.size
        off += int((err > 1e-6 + 1e-4 * np.abs(r)).sum())
    assert off / n <= 1e-4, off / n


def test_approx_knn_medians_equal_jax_and_exact():
    rng = np.random.default_rng(7)
    p, d, k = 300, 12, 4
    uvd = np.stack([rng.integers(0, 40, p), rng.integers(0, 30, p),
                    rng.integers(1, 6, p)], -1).astype(np.float32)
    uvd[:40] = uvd[40:80]                 # duplicate points: tied distances
    valid = rng.uniform(size=p) > 0.2
    xyxy = np.sort(rng.integers(0, 40, (d, 2, 2)), axis=1).reshape(d, 4)[
        :, [0, 2, 1, 3]].astype(np.float32)
    jboxes = JaxBoxes(xyxy=jnp.asarray(xyxy), confidence=jnp.ones(d),
                      label=jnp.zeros(d, jnp.int32),
                      valid=jnp.ones(d, bool))
    want = np.asarray(jax.jit(jassoc.knn_median_depth_approx,
                              static_argnums=3)(
        jnp.asarray(uvd), jnp.asarray(valid), jboxes, k))
    boxes = Boxes(xyxy=torch.tensor(xyxy), confidence=torch.ones(d),
                  label=torch.zeros(d, dtype=torch.int32),
                  valid=torch.ones(d, dtype=torch.bool))
    got = association.knn_median_depth(
        torch.tensor(uvd), torch.tensor(valid), boxes, k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > d // 2
    # a tie case: [3, 1, 1, 2, 1, 0.5, inf], k = 4 -> 5, 1, 2, 4
    d2 = torch.tensor([[3, 1, 1, 2, 1, 0.5, float("inf")]])
    idx = association.knn_select_nearest(d2, 4)
    assert idx.tolist() == [[5, 1, 2, 4]]
    _, jidx = jax.lax.approx_min_k(jnp.asarray(d2.numpy()), 4)
    assert np.asarray(jidx).tolist() == [[5, 1, 2, 4]]
