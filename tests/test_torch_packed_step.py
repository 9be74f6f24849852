"""The port's packed entry points (pipeline.step_packed, Engine.warmup /
call_packed / call_packed_delta / call_packed_chunk) at a reduced size:

- against the JAX package's jitted step_packed (its "xla" backends; the
  port on its kernel backends, whose wrappers run their plain twins
  here): compat f32, three ticks of the same wire buffers and the same
  weights; occupancy_i8 100 % equal and box counts equal;
- within the port: the packed tick bit-equal to the typed tick (f32, bf16,
  extension mode, PCA, the fleet tick on uint8 frames), replay_chunked
  and replay_delta bit-equal to the per-frame replay;
- the yuv420 / f16 wire: equal to JAX's ticks on the same buffers, and
  >= 99 % of cells within one int8 step of the lossless wire at the JAX
  package's test configuration (its bar, tests/test_packed_obs.py)."""

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
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.runtime.stream import \
    packed_from_scene as jpacked_from_scene
from grid_vision_tpu.io.scene import SyntheticScene as JaxScene
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu_torch import demo, pipeline, types
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.runtime import stream

torch.set_num_threads(1)

# reduced size: 96x128 camera, detector 64, orientation 64 / width 8, a
# 30 m x 10 m grid at 0.25 m, 512 points
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25)
KERNELS = dict(detector_stem_backend="pallas", grid_backend="pallas",
               knn_backend="pallas")
HEAD_SCALE = 150.0      # a handful of a random head's anchors clear 0.6
TICKS = 3


@functools.lru_cache(maxsize=None)
def _params(seed=1):
    tree = jax.tree_util.tree_map(
        np.asarray, jweights.init_all(JaxConfig(**SMALL), seed=seed))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * HEAD_SCALE
    nets = weights.load_all(GridVisionConfig(**SMALL), device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])
    return tree, nets


def _engine(cfg_kw, **kw):
    cfg = GridVisionConfig(**dict(SMALL, **cfg_kw))
    return pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                           params=_params()[1], device="cpu", **kw)


def _scene(cfg, seed=1):
    scene = SyntheticScene(cfg, seed=seed, n_ground=600)
    scene.add_default_traffic()
    scene.add_default_statics()
    return scene


def _assert_same(out, ref, what):
    for name, a, b in (
            ("occupancy_i8", out.occupancy_i8, ref.occupancy_i8),
            ("boxes", out.boxes.xyxy, ref.boxes.xyxy),
            ("box validity", out.boxes.valid, ref.boxes.valid),
            ("poses", out.poses.position, ref.poses.position),
            ("pose validity", out.poses.valid, ref.poses.valid),
            ("static depths", out.static_depths, ref.static_depths)):
        assert torch.equal(a, b), f"{what}: {name}"


def test_step_packed_matches_jax_step_packed():
    jcfg = JaxConfig(**SMALL)
    tree, _ = _params()
    jstep = jax.jit(functools.partial(jpipe.step_packed, cfg=jcfg))
    eng = _engine(KERNELS)
    jscene = JaxScene(jcfg, seed=1, n_ground=600)
    jscene.add_default_traffic()
    jscene.add_default_statics()
    scene = _scene(eng.cfg)
    jstate, state = JaxState.create(jcfg), eng.init_state()
    n_boxes = 0
    for i in range(TICKS):
        buf, _ = stream.packed_from_scene(scene, i / 10.0, eng.cfg)
        jbuf, _ = jpacked_from_scene(jscene, i / 10.0, jcfg)
        np.testing.assert_array_equal(buf, jbuf)
        jstate, jout = jstep(tree, jstate, jnp.asarray(jbuf),
                             jdemo.default_extrinsics())
        state, out = pipeline.step_packed(
            eng.params, state, torch.from_numpy(buf), eng.extrinsics,
            eng.cfg)
        np.testing.assert_array_equal(out.occupancy_i8.numpy(),
                                      np.asarray(jout.occupancy_i8))
        n = int(out.boxes.valid.sum())
        assert n == int(np.asarray(jout.boxes.valid).sum())
        n_boxes += n
        np.testing.assert_array_equal(state.log_odds.numpy(),
                                      np.asarray(jstate.log_odds))
    assert n_boxes > 0


@pytest.mark.parametrize("mode", ["f32", "bf16", "extension", "pca"])
def test_packed_tick_bit_equal_to_typed(mode):
    """The rgb8 wire keeps the frame uint8 through the tick; every
    consumer's cast of it is exact, so the outputs are the f32 frame's."""
    kw = dict(KERNELS)
    if mode == "bf16":
        kw.update(compute_dtype="bfloat16")
    elif mode == "extension":
        kw.update(compat=False, raycast_free_space=True,
                  vision_depth_refine=True, class_aware_nms=True)
    elif mode == "pca":
        kw.update(use_vision_orientation=False)
    eng = _engine(kw)
    scene = _scene(eng.cfg)
    s_typed = s_packed = eng.init_state()
    for i in range(TICKS):
        obs = stream.obs_from_scene(scene, i / 10.0, eng.cfg, "cpu")
        buf, _ = stream.packed_from_scene(scene, i / 10.0, eng.cfg)
        s_typed, ref = eng(s_typed, obs)
        s_packed, out = eng.call_packed(s_packed, buf)
        _assert_same(out, ref, f"{mode} tick {i}")
        assert torch.equal(s_packed.log_odds, s_typed.log_odds)
        assert torch.equal(s_packed.rng, s_typed.rng)


def test_fleet_tick_on_uint8_frames_bit_equal():
    """The fleet orientation path (images.to(gdtype)) and the detector
    take uint8 frames as they take the f32 ones."""
    eng = _engine(dict(KERNELS, detector_stem_backend="pallas2",
                       orientation_stem_backend="pallas"))
    scene = _scene(eng.cfg)
    obs_b = types.stack([stream.obs_from_scene(scene, t, eng.cfg, "cpu")
                         for t in (0.0, 0.3)])
    u8 = dataclasses.replace(obs_b, image=obs_b.image.to(torch.uint8))
    _, ref = eng.fleet(eng.init_states(2), obs_b, 4)
    _, out = eng.fleet(eng.init_states(2), u8, 4)
    _assert_same(out, ref, "fleet uint8")


WIRE = dict(wire_image_codec="yuv420", wire_cloud_dtype="float16")


def test_wire_mode_matches_jax():
    """yuv420 / f16 wire, same buffers, same weights: the port's ticks
    equal JAX's (the decode is bit-equal), and so does its agreement with
    the lossless wire (98.77 % here for both packages: the scaled random
    heads flip boxes on the lossy colours)."""
    tree, _ = _params()
    agree = []
    for package in ("jax", "port"):
        grids = []
        for extra in ({}, WIRE):
            if package == "jax":
                jcfg = JaxConfig(**SMALL, **extra)
                jscene = JaxScene(jcfg, seed=1, n_ground=600)
                jscene.add_default_traffic()
                jscene.add_default_statics()
                jstep = jax.jit(functools.partial(jpipe.step_packed,
                                                  cfg=jcfg))
                js = JaxState.create(jcfg)
                for i in range(TICKS):
                    js, jout = jstep(tree, js, jnp.asarray(jpacked_from_scene(
                        jscene, i / 10.0, jcfg)[0]),
                        jdemo.default_extrinsics())
                grids.append(np.asarray(jout.occupancy_i8, np.int32))
            else:
                eng = _engine(dict(KERNELS, **extra))
                scene = _scene(eng.cfg)
                s = eng.init_state()
                for i in range(TICKS):
                    s, out = eng.call_packed(s, stream.packed_from_scene(
                        scene, i / 10.0, eng.cfg)[0])
                grids.append(out.occupancy_i8.numpy().astype(np.int32))
        agree.append((np.abs(grids[0] - grids[1]) <= 1).mean())
        if package == "jax":
            jax_grids = grids
    np.testing.assert_array_equal(grids[1], jax_grids[1])
    assert agree[1] == agree[0], agree


def test_full_width_wires_match_jax_fixture():
    """Full width, shipped weights, the `run` command's scene: the port's
    first ticks on each wire equal the JAX package's
    (tests/fixtures/stream_wire_jax.npz, tools/jax_stream_fixture.py),
    and so does the share of cells within one int8 step between the
    wires."""
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = np.load(os.path.join(root, "tests", "fixtures",
                               "stream_wire_jax.npz"))
    meta = json.loads(str(ref["meta"]))
    grids = {}
    nets = None
    for wire, flags in meta["wires"].items():
        cfg = GridVisionConfig(**meta["weights"], **flags,
                               **dict(KERNELS,
                                      detector_stem_backend="pallas2"))
        eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                              params=nets, device="cpu", base_dir=root)
        nets = {k: eng.params[k] for k in ("detector", "orientation")}
        scene = SyntheticScene(cfg, **meta["scene"])
        scene.add_default_traffic()
        s = eng.init_state()
        grids[wire] = []
        for i in range(TICKS):
            s, out = eng.call_packed(s, stream.packed_from_scene(
                scene, i / 10.0, cfg)[0])
            key = f"{wire}/{i}/"
            np.testing.assert_array_equal(out.occupancy_i8.numpy(),
                                          ref[key + "occupancy_i8"])
            assert (int(out.boxes.valid.sum())
                    == int(ref[key + "boxes_valid"].sum()))
            grids[wire].append(out.occupancy_i8.int())
    for i in range(TICKS):
        d = (grids["rgb8_f32"][i] - grids["yuv420_f16"][i]).abs()
        assert ((d <= 1).float().mean().item()
                == pytest.approx(ref["within_one_step"][i], abs=1e-6))


def test_wire_mode_grid_close_to_lossless():
    """The JAX package's own bar at its test's configuration
    (tests/test_packed_obs.py: 96x128 camera, the default detector and
    orientation sizes, random weights): >= 99 % of cells within one int8
    step of the lossless wire after three ticks."""
    base = dict(max_points=512, camera_image_height=96,
                camera_image_width=128, fx=64.0, fy=64.0, cx=64.0, cy=48.0,
                grid_x=24, grid_y=12, resolution=0.25, **KERNELS)
    lossless = pipeline.Engine(GridVisionConfig(**base),
                               extrinsics=demo.default_extrinsics("cpu"),
                               device="cpu")
    wire = pipeline.Engine(GridVisionConfig(**base, **WIRE),
                           extrinsics=lossless.extrinsics,
                           params=lossless.params, device="cpu")
    scene = SyntheticScene(lossless.cfg, seed=0)
    scene.add_default_traffic()
    s_l, s_w = lossless.init_state(), wire.init_state()
    for i in range(TICKS):
        s_l, out_l = lossless.call_packed(
            s_l, stream.packed_from_scene(scene, i / 10.0, lossless.cfg)[0])
        s_w, out_w = wire.call_packed(
            s_w, stream.packed_from_scene(scene, i / 10.0, wire.cfg)[0])
    a = out_l.occupancy_i8.int()
    b = out_w.occupancy_i8.int()
    assert ((a - b).abs() <= 1).float().mean().item() >= 0.99


def test_chunked_and_delta_replay_bit_equal_to_per_frame():
    eng = _engine(KERNELS)
    per_frame = stream.replay(eng, _scene(eng.cfg), n_steps=6)
    chunked = stream.replay_chunked(eng, _scene(eng.cfg), n_steps=6, chunk=3)
    delta = stream.replay_delta(eng, _scene(eng.cfg), n_steps=6)
    assert chunked.n_steps == 6 and delta.n_steps == 6
    enc = delta.delta_encoder
    assert enc.keyframes >= 1 and enc.deltas >= 1, (enc.keyframes,
                                                    enc.deltas)
    for res in (chunked, delta):
        assert torch.equal(res.final_state.log_odds,
                           per_frame.final_state.log_odds)
        assert torch.equal(res.final_state.rng, per_frame.final_state.rng)
    ring = stream.replay_ring(eng, _scene(eng.cfg), n_steps=6, chunk=3,
                              ring=6)
    assert ring.n_steps == 6
    assert torch.isfinite(ring.final_state.log_odds).all()


def test_call_packed_chunk_stacks_every_output():
    eng = _engine(KERNELS)
    scene = _scene(eng.cfg)
    bufs = np.stack([stream.packed_from_scene(scene, i / 10.0, eng.cfg)[0]
                     for i in range(3)])
    state, outs = eng.call_packed_chunk(eng.init_state(), bufs)
    assert outs.occupancy_i8.shape == (3,) + eng.cfg.grid_size
    s = eng.init_state()
    for k in range(3):
        s, out = eng.call_packed(s, torch.from_numpy(bufs[k].copy()))
        _assert_same(outs.select(k), out, f"chunk step {k}")
    assert torch.equal(state.log_odds, s.log_odds)
    assert int(state.step) == 3


def test_delta_keyframe_returns_the_frame():
    eng = _engine(KERNELS)
    scene = _scene(eng.cfg)
    buf, _ = stream.packed_from_scene(scene, 0.0, eng.cfg)
    prev = torch.zeros((96, 128, 3), dtype=torch.uint8)
    _, frame, _ = eng.call_packed_delta(eng.init_state(), prev, buf,
                                        keyframe=True)
    assert frame.dtype == torch.uint8
    np.testing.assert_array_equal(
        frame.numpy(), np.clip(scene.image_at(0.0), 0, 255).astype(np.uint8))
    yuv = _engine(dict(KERNELS, wire_image_codec="yuv420"))
    with pytest.raises(ValueError, match="rgb8"):
        yuv.call_packed_delta(yuv.init_state(), prev, buf, keyframe=True)


def test_warmup_and_read_only_host_buffers():
    """warmup runs one blank tick; a read-only host buffer (a recording's
    np.frombuffer) is accepted; a non-uint8 tensor is refused."""
    eng = _engine(KERNELS)
    eng.warmup()
    buf, _ = stream.packed_from_scene(_scene(eng.cfg), 0.0, eng.cfg)
    ro = np.frombuffer(buf.tobytes(), np.uint8)
    assert not ro.flags.writeable
    _, a = eng.call_packed(eng.init_state(), ro)
    _, b = eng.call_packed(eng.init_state(), buf)
    _assert_same(a, b, "read-only buffer")
    for bad in (torch.zeros(8), np.zeros(8, np.float32)):
        with pytest.raises(ValueError, match="uint8"):
            eng.call_packed(eng.init_state(), bad)
