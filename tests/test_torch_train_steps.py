"""The train step (train/trainer.py) against the JAX package's: optax's
warmup-cosine schedule and AdamW update, three steps of the detector from
the same init in f32 and in bf16, and the JAX test's overfit case.

The f32 trajectory is held to the JAX package's train step run in float64:
its f32 step strays from that by up to ~2e-2 in the parameters after three
steps (its f32 gradients do, see tests/test_torch_train_losses.py), while
the port's stays within the bars. After the first nonzero learning rate,
AdamW moves every parameter by about lr whatever its gradient's size, so a
gradient below f32's resolution moves by a rounding's sign: the parameter
bar (atol 1e-6 / rtol 1e-4) holds for >= 99.99 % of the elements, and
every element within 1e-4, far under such a flip (2 x the summed lr,
6e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.train import synth_data as jsynth
from grid_vision_tpu.train import trainer as jtrainer
from grid_vision_tpu.train.targets import assign_targets as jassign
from grid_vision_tpu_torch.models import weights, yolov4_tiny
from grid_vision_tpu_torch.train import trainer
from grid_vision_tpu_torch.train.targets import assign_targets
from grid_vision_tpu_torch.utils import prng

torch.set_num_threads(1)

PEAK, WARMUP, DECAY = 2e-3, 2, 10      # three steps: lr 0, 1e-3, 2e-3


@pytest.mark.parametrize("warmup,decay", [(2, 10), (0, 4), (20, 100),
                                          (100, 8000)])
def test_schedule_is_optax(warmup, decay):
    want = optax.warmup_cosine_decay_schedule(0.0, PEAK, warmup_steps=warmup,
                                              decay_steps=decay)
    got = trainer.warmup_cosine_decay_schedule(0.0, PEAK, warmup, decay)
    for count in [0, 1, 2, warmup, warmup + 1, decay // 2, decay - 1, decay,
                  decay + 7]:
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=count)


def test_adamw_update_is_optax():
    """Given the same gradients, torch.optim.AdamW with the schedule set
    each step moves the parameters as optax.adamw(schedule, 1e-5) does:
    weight decay on every leaf, eps outside the square root, lr read
    before the count increments (step 0: lr 0)."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-4, 1))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, PEAK, warmup_steps=WARMUP, decay_steps=DECAY),
        weight_decay=1e-5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    ptx = trainer.AdamW(trainer.warmup_cosine_decay_schedule(
        0.0, PEAK, WARMUP, DECAY), weight_decay=1e-5)
    opt = ptx.init(module)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.named_parameters():
            p.grad = torch.tensor(g[k])
        for group in opt.param_groups:
            group["lr"] = ptx.lr(step)
        opt.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} step {step}")


def _batches(cfg, n, batch):
    mk = jax.jit(lambda k: jsynth.make_batch_on_device(k, batch, cfg,
                                                       (96, 128)))
    return [[np.asarray(b) for b in mk(jax.random.PRNGKey(10 + i))]
            for i in range(n)]


def _jax_run(cfg, batches, variables):
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, PEAK, warmup_steps=WARMUP, decay_steps=DECAY),
        weight_decay=1e-5)
    state = jtrainer.TrainState(variables=variables,
                                opt_state=tx.init(variables["params"]),
                                step=jnp.zeros((), jnp.int32))
    step = jtrainer.make_train_step("yolo", cfg, tx)
    out = []
    for b in batches:
        state, m = step(state, *b)
        out.append(float(m["loss"]))
    return out, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       state.variables)


def _port_run(cfg, batches):
    tx = trainer.AdamW(trainer.warmup_cosine_decay_schedule(
        0.0, PEAK, WARMUP, DECAY), weight_decay=1e-5)
    state = trainer.init_train_state("yolo", cfg, tx, prng.prng_key(0))
    step = trainer.make_train_step("yolo", cfg, tx)
    out = []
    for b in batches:
        state, m = step(state, *[torch.tensor(x) for x in b])
        out.append(m["loss"].item())
    assert state.step == len(batches)
    return out, state.model.state_dict()


def test_three_adamw_steps_f32():
    size, batch = 64, 4
    jcfg = jyolo.YoloConfig(input_size=size, compute_dtype=jnp.float32)
    batches = _batches(jcfg, 3, batch)
    init = jyolo.init_params(jax.random.PRNGKey(0), jcfg)
    with jax.enable_x64(True):
        f64 = [[x.astype(np.float64) if x.dtype == np.float32 else x
                for x in b] for b in batches]
        want_losses, want = _jax_run(
            jyolo.YoloConfig(input_size=size, compute_dtype=jnp.float64),
            f64, jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), init))
    f32_losses, _ = _jax_run(jcfg, batches, init)
    losses, state = _port_run(yolov4_tiny.YoloConfig(
        input_size=size, compute_dtype=torch.float32), batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    # lr is 0 at step 0: the first two steps see the initial parameters
    np.testing.assert_allclose(losses[:2], f32_losses[:2], rtol=1e-5)
    ref = weights.params_from_jax(want)
    assert ref.keys() == state.keys()
    n = off = 0
    for k, r in ref.items():
        got = state[k].numpy().astype(np.float64)
        r = r.numpy().astype(np.float64)
        if "running" in k:
            np.testing.assert_allclose(got, r, rtol=0, atol=1e-5, err_msg=k)
            continue
        err = np.abs(got - r)
        assert err.max() <= 1e-4, (k, err.max())
        n += r.size
        off += int((err > 1e-6 + 1e-4 * np.abs(r)).sum())
    assert off / n <= 1e-4, off / n


def test_three_adamw_steps_bf16():
    """bf16 compute with f32 parameters (both CLIs' default): the losses of
    three steps to rtol 2e-2 of the JAX package's bf16 steps."""
    size, batch = 64, 4
    jcfg = jyolo.YoloConfig(input_size=size)
    batches = _batches(jyolo.YoloConfig(input_size=size,
                                        compute_dtype=jnp.float32), 3, batch)
    want, _ = _jax_run(jcfg, batches,
                       jyolo.init_params(jax.random.PRNGKey(0), jcfg))
    got, _ = _port_run(yolov4_tiny.YoloConfig(input_size=size), batches)
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_overfit_single_batch():
    """tests/test_targets.py's overfit case through the port: Adam on one
    tiny batch drives the loss down (learning works through decode and
    loss)."""
    cfg = yolov4_tiny.YoloConfig(input_size=64, compute_dtype=torch.float32)
    tx = trainer.AdamW(3e-3, weight_decay=0.0)
    state = trainer.init_train_state("yolo", cfg, tx, prng.prng_key(0))
    step = trainer.make_train_step("yolo", cfg, tx)
    gt = {"x_min": 0.25, "y_min": 0.25, "x_max": 0.75, "y_max": 0.75,
          "label": 9}
    tb, tc, tp = assign_targets([gt], cfg)
    for a, b in zip((tb, tc, tp), jassign([gt], jyolo.YoloConfig(
            input_size=64))):
        np.testing.assert_array_equal(a, b)
    images = prng.uniform(prng.prng_key(1), (2, 64, 64, 3))
    batch = (images, *(torch.tensor(a)[None].repeat(
        (2,) + (1,) * a.ndim) for a in (tb, tc, tp)))
    losses = []
    for _ in range(30):
        state, metrics = step(state, *batch)
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_mesh_is_a_later_slice():
    """make_train_step takes mesh= (parallel/mesh.make_mesh; the sharded
    step is held to the unsharded one in tests/test_torch_train_mesh.py): a
    step on a (2, 2) mesh runs, and a batch on another device than the
    mesh's raises. The test keeps the name it had when the port refused
    mesh=."""
    from grid_vision_tpu_torch.parallel.mesh import make_mesh
    cfg = yolov4_tiny.YoloConfig(input_size=32, compute_dtype=torch.float32)
    tx = trainer.SGD(1e-2)
    state = trainer.init_train_state("yolo", cfg, tx, prng.prng_key(0))
    mesh = make_mesh(4, tp=2, device="cpu")
    step = trainer.make_train_step("yolo", cfg, tx, mesh=mesh)
    gt = {"x_min": 0.25, "y_min": 0.25, "x_max": 0.75, "y_max": 0.75,
          "label": 9}
    tb, tc, tp = assign_targets([gt], cfg)
    batch = (prng.uniform(prng.prng_key(1), (4, 32, 32, 3)),
             *(torch.tensor(a)[None].repeat((4,) + (1,) * a.ndim)
               for a in (tb, tc, tp)))
    state, metrics = step(state, *batch)
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    meta = make_mesh(4, tp=2, device="meta")
    with pytest.raises(ValueError, match="mesh"):
        trainer.make_train_step("yolo", cfg, tx, mesh=meta)(state, *batch)
