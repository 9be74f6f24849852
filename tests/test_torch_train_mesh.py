"""The training mesh (parallel/mesh.py: make_mesh, shard_params, replicate)
and the sharded train step (train/trainer.make_train_step(..., mesh=)) on
the CPU, on 8 logical shards:

- tests/test_parallel.py:105-146's contract: three SGD steps of the
  detector (input 32, f32, batch 8, a (4, 2) mesh) finite and falling,
  step == 3; a wide conv weight split over tp.
- the sharded step against the JAX package's step jitted over its (4, 2)
  mesh of 8 virtual CPU devices, both nets, and against the port's
  unsharded step from the same init and batches, within
  tests/test_torch_train_steps.py's bars: losses rtol 1e-5; parameters
  within 1e-4 and >= 99.99 % within atol 1e-6 / rtol 1e-4; running
  statistics atol 1e-5.
- a batch that does not split into the dp shards is refused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.parallel import mesh as jmesh
from grid_vision_tpu.train import trainer as jtrainer
from grid_vision_tpu_torch.models import orientation_net, weights, yolov4_tiny
from grid_vision_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                 shard_params)
from grid_vision_tpu_torch.train import trainer
from grid_vision_tpu_torch.utils import prng

torch.set_num_threads(1)

MESH_STEPS = 3


def _yolo_batch(cfg, b):
    n = cfg.num_anchors_total
    images = prng.uniform(prng.prng_key(1), (b, cfg.input_size,
                                             cfg.input_size, 3))
    tgt_boxes = torch.tensor([[0.2, 0.2, 0.6, 0.6]]).repeat(b, n, 1)
    tgt_class = torch.zeros((b, n), dtype=torch.int32)
    tgt_pos = torch.zeros((b, n))
    tgt_pos[:, 0] = 1.0
    return images, tgt_boxes, tgt_class, tgt_pos


def test_sharded_train_step_dp_tp():
    mesh = make_mesh(8, ("dp", "tp"), tp=2, device="cpu")
    assert mesh.shape == {"dp": 4, "tp": 2} and mesh.size == 8
    ycfg = yolov4_tiny.YoloConfig(input_size=32, compute_dtype=torch.float32)
    tx = trainer.SGD(1e-2)
    state = trainer.init_train_state("yolo", ycfg, tx, prng.prng_key(0))
    placements = shard_params(state.model, mesh)
    stats = replicate(state.model, mesh)
    assert set(placements) == {k for k, _ in state.model.named_parameters()}
    assert all(not p.tp_sharded for p in stats.values())
    train_step = trainer.make_train_step("yolo", ycfg, tx, mesh)
    batch = _yolo_batch(ycfg, 8)
    losses = []
    for _ in range(3):
        state, metrics = train_step(state, *batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]              # it actually optimizes
    assert state.step == 3


def test_tp_sharding_applied():
    mesh = make_mesh(8, ("dp", "tp"), tp=2, device="cpu")
    net = yolov4_tiny.init_params(prng.prng_key(0), yolov4_tiny.YoloConfig(
        input_size=32, compute_dtype=torch.float32))
    placements = shard_params(net, mesh)
    params = dict(net.named_parameters())
    wide = [k for k, p in params.items() if p.dim() == 4 and p.shape[0] >= 128]
    assert wide
    sharded = [k for k in wide if placements[k].tp_sharded]
    assert sharded, "no wide kernel was tp-sharded"
    assert all(placements[k].dim == 0 for k in sharded)  # output channels
    # 1-D leaves (biases, BatchNorm) and narrow kernels stay replicated
    assert not any(placements[k].tp_sharded for k, p in params.items()
                   if p.dim() == 1)
    assert placements["ConvBN_0.Conv_0.weight"].tp_sharded       # 32 >= 16
    tp8 = shard_params(net, make_mesh(8, tp=8, device="cpu"))
    assert not tp8["ConvBN_0.Conv_0.weight"].tp_sharded            # 32 < 64
    assert tp8["ConvBN_1.Conv_0.weight"].tp_sharded                # 64


def _multibin_batch(size, b):
    rng = np.random.default_rng(6)
    return [torch.tensor(rng.normal(size=(b, size, size, 3))
                         .astype(np.float32)),
            torch.tensor((rng.normal(size=(b, 3)) * 0.3).astype(np.float32)),
            torch.tensor(rng.integers(0, 2, b).astype(np.int32)),
            torch.tensor(rng.uniform(-1, 1, b).astype(np.float32))]


CASES = {
    "yolo": (yolov4_tiny.YoloConfig(input_size=64,
                                    compute_dtype=torch.float32),
             lambda c: _yolo_batch(c, 4)),
    "multibin": (orientation_net.OrientationConfig(
        input_size=32, width=8, s2d_fold=False, compute_dtype=torch.float32),
        lambda c: _multibin_batch(32, 8)),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_sharded_step_equals_unsharded(kind):
    """On one device the psum over the dp shards is the whole batch's
    gradient, so the sharded step, three SGD(1e-2) steps from the same
    init and batch, gives the unsharded step's losses, parameters and
    running statistics bit for bit (the CPU's convs are deterministic)."""
    cfg, make_batch = CASES[kind]
    opt = trainer.SGD(1e-2)
    batch = make_batch(cfg)
    runs = []
    for mesh in (None, make_mesh(4, tp=2, device="cpu")):
        state = trainer.init_train_state(kind, cfg, opt, prng.prng_key(0))
        step = trainer.make_train_step(kind, cfg, opt, mesh)
        losses = []
        for _ in range(3):
            state, m = step(state, *batch)
            losses.append(m["loss"].item())
        runs.append((losses, state.model.state_dict()))
    (want_losses, want), (losses, got) = runs
    assert losses == want_losses
    assert want.keys() == got.keys()
    for k, r in want.items():
        assert torch.equal(got[k], r), k


def test_mesh_step_refuses_a_batch_that_does_not_split():
    """A batch of 6 on a (4, 2) mesh has no whole dp shards: the step
    raises, as the JAX package's sharding of the batch over dp does."""
    cfg, make_batch = CASES["multibin"]
    opt = trainer.SGD(1e-2)
    state = trainer.init_train_state("multibin", cfg, opt, prng.prng_key(0))
    step = trainer.make_train_step("multibin", cfg, opt,
                                   make_mesh(8, tp=2, device="cpu"))
    with pytest.raises(ValueError, match="dp shards"):
        step(state, *[b[:6] for b in make_batch(cfg)])
    assert state.step == 0


def _jax_mesh_run(kind, jcfg, init, batch):
    """JAX's make_train_step(..., mesh=) on its 8 virtual CPU devices as a
    (4, 2) mesh, optax.sgd(1e-2), MESH_STEPS steps on one batch, the
    parameters placed as tests/test_parallel.py places them. Returns the
    losses and the variables before each step and after the last, in
    float64 on the host."""
    mesh = jmesh.make_mesh(8, ("dp", "tp"), tp=2)
    tx = optax.sgd(1e-2)
    host = functools.partial(jax.tree_util.tree_map,
                             lambda a: np.asarray(a, np.float64))
    with mesh:
        variables = {"params": jmesh.shard_params(init["params"], mesh),
                     "batch_stats": jmesh.replicate(init["batch_stats"],
                                                    mesh)}
        state = jtrainer.TrainState(variables=variables,
                                    opt_state=tx.init(variables["params"]),
                                    step=jnp.zeros((), jnp.int32))
        step = jtrainer.make_train_step(kind, jcfg, tx, mesh)
        losses, states = [], [host(state.variables)]
        for _ in range(MESH_STEPS):
            state, m = step(state, *batch)
            losses.append(float(m["loss"]))
            states.append(host(state.variables))
        assert int(state.step) == MESH_STEPS
    return losses, states


def _assert_state_near(got, want):
    """tests/test_torch_train_steps.py's bars: parameters within 1e-4 and
    >= 99.99 % within atol 1e-6 / rtol 1e-4; running statistics atol
    1e-5."""
    ref = weights.params_from_jax(want)
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


JAX_CASES = {
    "yolo": (lambda dt: jyolo.YoloConfig(input_size=32, compute_dtype=dt),
             jyolo.init_params),
    "multibin": (lambda dt: jorient.OrientationConfig(
        input_size=32, width=8, s2d_fold=False, compute_dtype=dt),
        jorient.init_params),
}


@pytest.mark.parametrize("kind", sorted(JAX_CASES))
def test_sharded_step_matches_jax_mesh_step(kind):
    """The port's mesh= step against the JAX package's step jitted over
    its (4, 2) mesh, from the same flax init and batch (the detector at
    tests/test_parallel.py's input 32 / batch 8, the orientation net at 32
    / width 8 / batch 8), three SGD(1e-2) steps. JAX's mesh step runs in
    float64 (its f32 gradients stray from the exact ones further than the
    port's, tests/test_torch_train_steps.py). Each of the port's steps
    starts from the parameters and statistics JAX's step started from, and
    is held at the train-step bars: loss rtol 1e-5, and the state after it
    (_assert_state_near). Left to run free, the detector reaches a point at
    its third step where a change of 1e-5 in the parameters (step one's f32
    rounding, JAX's own f32 step included) moves the gradient of
    ConvBN_5's kernel by ~5e-2, so three free steps would test where the
    rounding fell rather than the step. JAX's f32 mesh step's first loss is
    held at rtol 1e-5 too."""
    make_cfg, jinit = JAX_CASES[kind]
    # host copies: the jitted step donates the arrays it is given
    init = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(0), make_cfg(jnp.float32)))
    if kind == "yolo":
        cfg = yolov4_tiny.YoloConfig(input_size=32,
                                     compute_dtype=torch.float32)
        batch = [b.numpy() for b in _yolo_batch(cfg, 8)]
    else:
        cfg = orientation_net.OrientationConfig(
            input_size=32, width=8, s2d_fold=False,
            compute_dtype=torch.float32)
        batch = [b.numpy() for b in _multibin_batch(32, 8)]
    f32_losses, _ = _jax_mesh_run(kind, make_cfg(jnp.float32), init, batch)
    with jax.enable_x64(True):
        want_losses, want = _jax_mesh_run(
            kind, make_cfg(jnp.float64),
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   init),
            [b.astype(np.float64) if b.dtype == np.float32 else b
             for b in batch])
    opt = trainer.SGD(1e-2)
    mesh = make_mesh(8, ("dp", "tp"), tp=2, device="cpu")
    state = trainer.init_train_state(kind, cfg, opt, prng.prng_key(0))
    _assert_state_near(state.model.state_dict(), want[0])     # flax's init
    shard_params(state.model, mesh)
    replicate(state.model, mesh)
    step = trainer.make_train_step(kind, cfg, opt, mesh)
    for i in range(MESH_STEPS):
        state.model.load_state_dict(weights.params_from_jax(want[i]))
        state, m = step(state, *[torch.tensor(b) for b in batch])
        np.testing.assert_allclose(m["loss"].item(), want_losses[i],
                                   rtol=1e-5, err_msg=f"step {i}")
        _assert_state_near(state.model.state_dict(), want[i + 1])
    assert state.step == MESH_STEPS
    np.testing.assert_allclose(want_losses[0], f32_losses[0], rtol=1e-5)
