"""Train-mode forwards, losses and gradients of both nets (f32) against the
JAX package, the weights carried across by params_from_jax: heads of
model.apply(train=True, mutable=["batch_stats"]) to 1e-4, the new batch
statistics to 1e-5, loss and aux to rtol 1e-5 of jax.value_and_grad's, and
the gradients to atol 1e-5 / rtol 1e-4 of JAX's value_and_grad run in
float64.

Why float64 for the gradients: the JAX package's own f32 gradients stray
from its f64 ones by up to 0.2 at the detector's early layers (ConvBN_2's
kernel; XLA sums the BatchNorm moments E[x], E[x^2] serially in f32, and
the batch variance E[x^2] - E[x]^2 cancels), far beyond this bar, while the
port's f32 gradients meet it against the f64 run (torch's cascade sums).
The detector runs at input 64, batch 4: at 32 its 13-grid BatchNorms
normalize over 4 values each and f32 gradients of any implementation lose
their last digits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.train import losses as jlosses
from grid_vision_tpu.train import synth_data as jsynth
from grid_vision_tpu_torch.models import orientation_net, weights, yolov4_tiny
from grid_vision_tpu_torch.models.layers import new_batch_stats
from grid_vision_tpu_torch.train import losses

torch.set_num_threads(1)

DET = dict(size=64, batch=4)
ORI = dict(size=32, width=8, batch=8)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _detector_case():
    jcfg = jyolo.YoloConfig(input_size=DET["size"], compute_dtype=jnp.float32)
    batch = [np.asarray(b) for b in jax.jit(
        lambda k: jsynth.make_batch_on_device(k, DET["batch"], jcfg,
                                              (96, 128)))(
        jax.random.PRNGKey(3))]
    variables = jax.tree_util.tree_map(
        np.asarray, jyolo.init_params(jax.random.PRNGKey(0), jcfg))
    model = yolov4_tiny.YoloV4Tiny(yolov4_tiny.YoloConfig(
        input_size=DET["size"], compute_dtype=torch.float32))
    weights.load_module(model, variables)
    cfg64 = jyolo.YoloConfig(input_size=DET["size"],
                             compute_dtype=jnp.float64)
    return (jcfg, cfg64, variables, batch, model, jlosses.yolo_loss,
            losses.yolo_loss, model.cfg)


def _orientation_case():
    jcfg = jorient.OrientationConfig(input_size=ORI["size"],
                                     width=ORI["width"],
                                     compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    n, s = ORI["batch"], ORI["size"]
    batch = [rng.normal(size=(n, s, s, 3)).astype(np.float32),
             (rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
             rng.integers(0, 2, n).astype(np.int32),
             rng.uniform(-1, 1, n).astype(np.float32),
             rng.integers(0, 2, n).astype(np.float32),
             rng.integers(0, 2, n).astype(np.float32)]
    variables = jax.tree_util.tree_map(
        np.asarray, jorient.init_params(jax.random.PRNGKey(0), jcfg))
    model = orientation_net.OrientationNetS2D(orientation_net.
                                              OrientationConfig(
        input_size=s, width=ORI["width"], s2d_fold=False,
        compute_dtype=torch.float32))
    weights.load_module(model, variables)
    cfg64 = jorient.OrientationConfig(input_size=s, width=ORI["width"],
                                      compute_dtype=jnp.float64)
    return (jcfg, cfg64, variables, batch, model, jlosses.multibin_loss,
            losses.multibin_loss, model.cfg)


CASES = {"detector": _detector_case, "orientation": _orientation_case}


@pytest.mark.parametrize("net", sorted(CASES))
def test_train_mode_forward_matches_flax(net):
    """Heads to 1e-4 and the new batch statistics to 1e-5 of flax's
    train-mode apply (in float64: the JAX package's f32 apply itself strays
    by ~2e-4 in the detector's heads, its batch moments summed serially);
    the module's own buffers stay as they were."""
    _, cfg64, variables, batch, model, _, _, _ = CASES[net]()
    with jax.enable_x64(True):
        jmodel = (jyolo.YoloV4Tiny(cfg64) if net == "detector"
                  else jorient.make_model(cfg64))
        jout, mutated = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            _f64(variables), batch[0].astype(np.float64))
        jout, mutated = _np(jout), _np(mutated)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    out = model(torch.tensor(batch[0]))
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4)
    stats = new_batch_stats(model)
    want = weights.params_from_jax(mutated)
    assert stats.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(stats[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert new_batch_stats(model) == {}


@pytest.mark.parametrize("net", sorted(CASES))
def test_loss_and_gradients_match_jax(net):
    jcfg, cfg64, variables, batch, model, jloss, loss_fn, cfg = CASES[net]()

    def value_and_grad(cfg_, vars_, batch_):
        def f(p):
            return jloss({"params": p, "batch_stats": vars_["batch_stats"]},
                         *batch_, cfg=cfg_)
        return jax.jit(jax.value_and_grad(f, has_aux=True))(vars_["params"])

    (jl, (jmut, jaux)), _ = value_and_grad(jcfg, variables, batch)
    with jax.enable_x64(True):
        b64 = [b.astype(np.float64) if b.dtype == np.float32 else b
               for b in batch]
        (l64, (mut64, _)), g64 = value_and_grad(cfg64, _f64(variables), b64)
        l64, mut64, g64 = float(l64), _np(mut64), _np(g64)

    loss, (mutated, aux) = loss_fn(model, *[torch.tensor(b) for b in batch],
                                   cfg=cfg)
    loss.backward()
    loss = loss.item()
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    np.testing.assert_allclose(loss, l64, rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = weights.params_from_jax(mut64)
    assert mutated.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(mutated[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    grads = weights.params_from_jax({"params": g64})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_max_splits_its_gradient_among_ties():
    """yolo_loss's objectness is jnp.max over the classes, whose gradient is
    shared evenly among tied maxima (saturated bf16 sigmoids do tie):
    torch.amax, not torch.max(dim)."""
    confs = torch.tensor([[0.7, 0.7, 0.1]], requires_grad=True)
    torch.amax(confs, dim=-1).sum().backward()
    jg = jax.grad(lambda c: jnp.max(c, axis=-1).sum())(
        jnp.asarray(confs.detach().numpy()))
    np.testing.assert_array_equal(confs.grad.numpy(), np.asarray(jg))


def test_ciou_and_bce_match():
    rng = np.random.default_rng(1)
    lo = rng.uniform(0, 0.6, (50, 2))
    pred = np.concatenate([lo, lo + rng.uniform(0.01, 0.4, (50, 2))], -1)
    lo = rng.uniform(0, 0.6, (50, 2))
    tgt = np.concatenate([lo, lo + rng.uniform(0.01, 0.4, (50, 2))], -1)
    pred, tgt = pred.astype(np.float32), tgt.astype(np.float32)
    np.testing.assert_allclose(
        losses._ciou(torch.tensor(pred), torch.tensor(tgt)).numpy(),
        np.asarray(jlosses._ciou(jnp.asarray(pred), jnp.asarray(tgt))),
        rtol=1e-5, atol=1e-6)
    p = rng.uniform(0, 1, 100).astype(np.float32)
    t = (rng.uniform(0, 1, 100) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        losses._bce(torch.tensor(p), torch.tensor(t)).numpy(),
        np.asarray(jlosses._bce(jnp.asarray(p), jnp.asarray(t))),
        rtol=1e-6)
