"""The production bf16 configuration (compute_dtype="bfloat16") as a whole:
the port against the JAX package on the CPU, at the reduced size of
tests/test_torch_pipeline.py, the same random weights on both sides.

- detect, with the shipped weights at full width: the port's bf16
  detector on the plain ("xla") backend and on the kernel backends (their
  plain twins here, which round where the Pallas kernels round) against
  JAX's bf16 XLA detector: > 95 % of the slots agree on validity, xyxy
  within 2 px, labels equal (tests/test_pallas_stem.py:115-145's bar);
- step and fleet_step, compat and extension: occupancy_i8 agreement >= 99 %
  on the mean and >= 97.5 % at the least per tick (PARITY.json
  per_step_min_agreement of JAX's own bf16 against f32); with JAX's net
  outputs injected into the port (the detector's boxes and confidences, the
  orientation net's outputs), 100 %: everything downstream of the nets is
  f32 in both packages;
- each orientation_compute under each compute_dtype runs, and the
  orientation branch computes in pipeline._orientation_dtype.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu import demo as jdemo
from grid_vision_tpu import pipeline as jpipe
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.io.scene import SyntheticScene as JaxScene
from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.runtime.stream import obs_from_scene as jobs_from_scene
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu.types import Obs as JaxObs
from grid_vision_tpu.types import PointCloud as JaxCloud
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.models import orientation_net, weights
from grid_vision_tpu_torch.runtime.stream import FleetPool, obs_from_scene

torch.set_num_threads(1)

TICKS, R = 3, 3
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, max_static_depth=16,
             compute_dtype="bfloat16")
KERNELS = dict(detector_stem_backend="pallas2",
               orientation_stem_backend="pallas", grid_backend="pallas",
               knn_backend="pallas")
EXTENSION = dict(compat=False, raycast_free_space=True,
                 vision_depth_refine=True, class_aware_nms=True)
HEAD_SCALE = 150.0


@pytest.fixture(scope="module")
def nets():
    tree = jax.tree_util.tree_map(
        np.asarray, jweights.init_all(JaxConfig(**SMALL), seed=3))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * HEAD_SCALE
    port = weights.load_all(GridVisionConfig(**SMALL), device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(port[key], tree[key])
    return tree, port


def _scenes(jcfg, cfg, seed=1):
    jscene = JaxScene(jcfg, seed=seed, n_ground=600)
    scene = SyntheticScene(cfg, seed=seed, n_ground=600)
    for s in (jscene, scene):
        s.add_default_traffic()
        s.add_default_statics()
    return jscene, scene


def _jax_obs(obs):
    j = lambda t: jnp.asarray(t.float().numpy())              # noqa: E731
    return JaxObs(image=j(obs.image),
                  cloud=JaxCloud(xyz=j(obs.cloud.xyz),
                                 intensity=j(obs.cloud.intensity),
                                 count=jnp.asarray(obs.cloud.count.numpy())),
                  has_image=jnp.asarray(obs.has_image.numpy()),
                  has_cloud=jnp.asarray(obs.has_cloud.numpy()))


def _agreement(out, jout):
    """Per rig (or the one grid) occupancy_i8 agreement of one tick."""
    eq = out.occupancy_i8.numpy() == np.asarray(jout.occupancy_i8)
    return eq.reshape((-1,) + eq.shape[-2:]).mean(axis=(1, 2))


@pytest.fixture(scope="module")
def shipped():
    """The shipped weights at full width, and a rendered traffic frame
    (tests/test_pallas_stem.py's detect-level case)."""
    base = dict(max_points=2048, compute_dtype="bfloat16",
                detection_weights_file="weights/detector.npz",
                vision_weights_file="weights/orientation.npz")
    jcfg = JaxConfig(**base)
    tree = jax.tree_util.tree_map(np.asarray, jweights.load_all(jcfg))
    port = weights.load_all(GridVisionConfig(**base), device="cpu")
    scene = JaxScene(jcfg, seed=3, n_ground=1000)
    scene.add_default_traffic()
    image = np.asarray(scene.image_at(0.5), np.float32)
    ref = jax.jit(functools.partial(jpipe.detect, cfg=jcfg))(
        tree, jnp.asarray(image))
    return base, port, image, ref


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas2"])
def test_detect_matches_jax_bf16(shipped, backend):
    """The port's bf16 detect (plain backend, or the kernels' twins)
    against JAX's bf16 XLA detect at full width: > 95 % of the slots agree
    on validity, boxes valid in both within 2 px, labels equal."""
    base, port, image, ref = shipped
    cfg = GridVisionConfig(**base, detector_stem_backend=backend)
    with torch.no_grad():
        got = pipeline.detect(port, torch.as_tensor(image), cfg)
    vr, vg = np.asarray(ref.valid), got.valid.numpy()
    assert vr.sum() > 0
    assert (vr == vg).mean() > 0.95
    both = vr & vg
    np.testing.assert_allclose(got.xyxy.numpy()[both],
                               np.asarray(ref.xyxy)[both], atol=2.0)
    np.testing.assert_array_equal(got.label.numpy()[both],
                                  np.asarray(ref.label)[both])


def _run_step(tree, port, flags, ticks=TICKS):
    """(per-tick agreement, box counts equal per tick) of the port's bf16
    Engine on the kernel backends against JAX's jitted bf16 step on its
    XLA backends."""
    jcfg = JaxConfig(**SMALL, **flags)
    cfg = GridVisionConfig(**SMALL, **flags, **KERNELS)
    jstep = jax.jit(functools.partial(jpipe.step, cfg=jcfg))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=port, device="cpu")
    jscene, scene = _scenes(jcfg, cfg)
    jstate, state = JaxState.create(jcfg), eng.init_state()
    agree, same = [], []
    for i in range(ticks):
        t = i / 10.0
        jstate, jout = jstep(tree, jstate, jobs_from_scene(jscene, t, jcfg),
                             jdemo.default_extrinsics())
        state, out = eng(state, obs_from_scene(scene, t, cfg, "cpu"))
        agree.append(_agreement(out, jout))
        same.append(int(out.boxes.valid.sum())
                    == int(np.asarray(jout.boxes.valid).sum()))
    return np.concatenate(agree), same


def _assert_bars(agree):
    assert agree.mean() >= 0.99, agree
    assert agree.min() >= 0.975, agree


@pytest.mark.parametrize("mode", ["compat", "extension"])
def test_step_matches_jax_bf16(nets, mode):
    tree, port = nets
    agree, _ = _run_step(tree, port, EXTENSION if mode == "extension" else {})
    _assert_bars(agree)


@pytest.mark.parametrize("mode", ["compat", "extension"])
def test_fleet_step_matches_jax_bf16(nets, mode):
    """3 rigs of the fleet scene pool in bf16 storage, budget 2 R."""
    tree, port = nets
    flags = EXTENSION if mode == "extension" else {}
    jcfg = JaxConfig(**SMALL, **flags)
    cfg = GridVisionConfig(**SMALL, **flags, **KERNELS)
    jstep = jax.jit(functools.partial(jpipe.fleet_step, cfg=jcfg,
                                      orientation_budget=2 * R))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=port, device="cpu")
    pool = FleetPool(cfg, R, device="cpu", image_dtype=torch.bfloat16)
    jstates, states = JaxState.create_batch(jcfg, R), eng.init_states(R)
    agree = []
    for i in range(TICKS):
        obs = pool.obs(i)
        assert obs.image.dtype == torch.bfloat16
        jstates, jout = jstep(tree, jstates, _jax_obs(obs),
                              jdemo.default_extrinsics())
        states, out = eng.fleet(states, obs, 2 * R)
        agree.append(_agreement(out, jout))
    _assert_bars(np.concatenate(agree))


def _inject_jax_nets(monkeypatch, tree, jcfg):
    """The port's pipeline with the JAX package's bf16 nets in place of its
    own: the detector on the same frames, the orientation net on the
    port's crops (bit-equal to JAX's at this size, tested in
    test_torch_bf16_preprocess.py)."""
    @jax.jit
    def jdetector(tree, images):
        net_in, ycfg = jpipe._detector_input(tree, images, jcfg)
        return jpipe._detector_forward(tree, net_in, ycfg, jcfg)

    def detector(params, images, cfg):
        boxes, confs = jdetector(tree, jnp.asarray(images.float().numpy()))
        return torch.tensor(np.asarray(boxes)), \
            torch.tensor(np.asarray(confs))

    ocfg = jorient.OrientationConfig(
        input_size=jcfg.network_height, width=jcfg.orientation_width,
        arch="s2d", s2d_fold=True, compute_dtype=jnp.bfloat16)
    jnet = jax.jit(lambda v, x: jorient.forward(v, x.astype(jnp.bfloat16),
                                                ocfg))

    def orientation(model, crops, stem_external=False, dtype=None,
                    s2d_fold=None):
        assert not stem_external and crops.dtype == torch.bfloat16
        assert s2d_fold                 # the config's folded stem
        outs = jnet(tree["orientation"], jnp.asarray(crops.float().numpy()))
        return tuple(torch.tensor(np.asarray(o)) for o in outs)

    monkeypatch.setattr(pipeline, "_detector_forward", detector)
    monkeypatch.setattr(pipeline.orientation_net, "forward", orientation)


@pytest.mark.parametrize("mode", ["compat", "extension"])
def test_step_with_jax_nets_injected_is_exact(nets, monkeypatch, mode):
    tree, port = nets
    flags = EXTENSION if mode == "extension" else {}
    _inject_jax_nets(monkeypatch, tree, JaxConfig(**SMALL, **flags))
    jcfg = JaxConfig(**SMALL, **flags)
    cfg = GridVisionConfig(**SMALL, **flags)
    jstep = jax.jit(functools.partial(jpipe.step, cfg=jcfg))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=port, device="cpu")
    jscene, scene = _scenes(jcfg, cfg)
    jstate, state = JaxState.create(jcfg), eng.init_state()
    n_poses = 0
    for i in range(TICKS):
        t = i / 10.0
        jstate, jout = jstep(tree, jstate, jobs_from_scene(jscene, t, jcfg),
                             jdemo.default_extrinsics())
        state, out = eng(state, obs_from_scene(scene, t, cfg, "cpu"))
        np.testing.assert_array_equal(out.boxes.valid.numpy(),
                                      np.asarray(jout.boxes.valid))
        np.testing.assert_array_equal(out.poses.valid.numpy(),
                                      np.asarray(jout.poses.valid))
        assert _agreement(out, jout).min() == 1.0, f"tick {i}"
        n_poses += int(out.poses.valid.sum())
    assert n_poses > 0


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("orient", ["follow", "float32", "bfloat16"])
def test_orientation_compute_mixes_run(nets, monkeypatch, compute, orient):
    """Every orientation_compute under every compute_dtype passes
    validate() and runs step and fleet_step; the orientation net sees
    crops (or the front kernel's activation) in _orientation_dtype."""
    _, port = nets
    flags = dict(SMALL, compute_dtype=compute, orientation_compute=orient)
    cfg = GridVisionConfig(**flags, **KERNELS)
    cfg.validate()
    want = torch.bfloat16 if (orient == "bfloat16" or (
        orient == "follow" and compute == "bfloat16")) else torch.float32
    assert pipeline._orientation_dtype(cfg) == want
    seen = []
    real = orientation_net.forward

    def spy(model, x, stem_external=False, dtype=torch.float32,
            s2d_fold=None):
        seen.append((x.dtype, dtype))
        return real(model, x, stem_external, dtype, s2d_fold)

    monkeypatch.setattr(pipeline.orientation_net, "forward", spy)
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=port, device="cpu")
    _, scene = _scenes(JaxConfig(**flags), cfg)
    obs = obs_from_scene(scene, 0.0, cfg, "cpu")
    _, out = eng(eng.init_state(), obs)
    pool = FleetPool(cfg, 2, device="cpu", image_dtype=torch.bfloat16)
    _, fout = eng.fleet(eng.init_states(2), pool.obs(0), 4)
    assert seen and all(x == want and d == want for x, d in seen), seen
    for o in (out, fout):
        assert torch.isfinite(o.poses.position[o.poses.valid]).all()
        assert o.occupancy_i8.dtype == torch.int8
