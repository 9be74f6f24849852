"""The port's bench (grid_vision_tpu_torch/bench.py) against the root
bench.py: the perturbation draws bit-equal to JAX's over chained chunk
keys, the digest of the same outputs within rtol 1e-6 (f32 sums in
another order), a chunk of fleet ticks equal to the same ticks through
pipeline.fleet_step bit for bit (2 rigs x 2 ticks, f32, "xla" backends,
96x128 frames, random weights), the digest moved by one zeroed output,
and the timing loop's rules (measure with a stubbed chunk).

Against JAX's chunk (bench.py's run_chunk body, jitted fleet_step, on
JAX's own perturbed pool) the digest is held within rtol 1e-5 on the PCA
pose branch (equal there bit for bit). In vision mode the perturbation's
non-integer brightness turns the synthetic scene's flat-painted objects
into crops of ~0 variance plus rounding noise, which the standardization
divides by max(std, 1e-6) in both packages (the standing finding on flat
orientation crops): such a crop's net output is the packages' rounding
noise amplified, a pose moves by up to 2.4 m and the digest by ~1e-3,
so the vision chunk is held to the port's own fleet_step instead (and the
vision tick to JAX by tests/test_torch_fleet.py on unperturbed frames).
"""

import dataclasses
import functools
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from grid_vision_tpu import demo as jdemo
from grid_vision_tpu import pipeline as jpipe
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu_torch import bench, demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.utils import prng

torch.set_num_threads(1)

R, SCAN = 2, 2
# reduced size: 96x128 camera, detector 64, orientation 64 / width 8, a
# 30 m x 10 m grid at 0.25 m, 512 points; bench.py's fleet configuration
# (static compaction to 16) in f32 on the "xla" backends
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, max_static_depth=16)
HEAD_SCALE = 150.0          # random heads clear the 0.6 threshold
BUDGET = 5 * R


def _jax_key_chain(n):
    """bench.py's carried key: PRNGKey(100), then each chunk's
    (successor, chunk key) split; the chunk keys of n chunks."""
    key, subs = jax.random.PRNGKey(100), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def test_draw_perturbations_bit_equal_to_jax():
    key = prng.prng_key(100)
    for jsub in _jax_key_chain(3):
        key, sub = prng.split(key)
        np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub))
        jb, jj = jbench.draw_perturbations(jsub, 8, 128)
        b, j = bench.draw_perturbations(sub, 8, 128)
        assert b.shape == (8, 128, 1, 1, 1) and j.shape == (8, 128, 1, 3)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(j.numpy(), np.asarray(jj))


def test_apply_perturbation_bf16_rounds_once_like_jax():
    """A bf16-cast brightness added to bf16 frames: one bf16 rounding of
    the exact sum, as in the JAX bench."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (R, 6, 5, 3)).astype(np.float32)
    bright = rng.uniform(-8, 8, (R, 1, 1, 1)).astype(np.float32)
    xyz = rng.normal(size=(R, 7, 3)).astype(np.float32)
    jitter = rng.uniform(-0.03, 0.03, (R, 1, 3)).astype(np.float32)
    from grid_vision_tpu.types import Obs as JObs, PointCloud as JCloud
    from grid_vision_tpu_torch.types import Obs, PointCloud
    jpool = JObs(image=jnp.asarray(img, jnp.bfloat16),
                 cloud=JCloud(xyz=jnp.asarray(xyz),
                              intensity=jnp.zeros((R, 7)),
                              count=jnp.full((R,), 7, jnp.int32)),
                 has_image=jnp.ones((R,), bool),
                 has_cloud=jnp.ones((R,), bool))
    pool = Obs(image=torch.tensor(img).to(torch.bfloat16),
               cloud=PointCloud(xyz=torch.tensor(xyz),
                                intensity=torch.zeros(R, 7),
                                count=torch.full((R,), 7, dtype=torch.int32)),
               has_image=torch.ones(R, dtype=torch.bool),
               has_cloud=torch.ones(R, dtype=torch.bool))
    jout = jax.jit(jbench.apply_perturbation)(jpool, jnp.asarray(bright),
                                              jnp.asarray(jitter))
    out = bench.apply_perturbation(pool, torch.tensor(bright),
                                   torch.tensor(jitter))
    assert out.image.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.image.float().numpy(),
                                  np.asarray(jout.image, np.float32))
    np.testing.assert_array_equal(out.cloud.xyz.numpy(),
                                  np.asarray(jout.cloud.xyz))


@pytest.fixture(scope="module")
def small():
    """The JAX and port configurations, the same random weights (heads
    scaled), the port's Engine and its pool on the CPU."""
    jcfg, cfg = JaxConfig(**SMALL), GridVisionConfig(**SMALL)
    tree = jax.tree_util.tree_map(np.asarray, jweights.init_all(jcfg, 1))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * HEAD_SCALE
    nets = weights.load_all(cfg, device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    pool = bench.build_pool(cfg, R, "cpu", image_dtype=torch.float32)
    return jcfg, cfg, tree, eng, pool


@pytest.fixture(scope="module")
def jax_chunk(small):
    return _jax_chunk(small[0], small[2])


def _jax_chunk(jcfg, tree):
    """JAX's chunk: bench.py's run_chunk body (split, draws, perturbed
    pool, jitted fleet_step, output_digest) on JAX's own pool."""
    jpool = jbench.build_obs_pool(jcfg, R)
    step = jax.jit(functools.partial(jpipe.fleet_step, cfg=jcfg,
                                     orientation_budget=BUDGET))
    _, sub = jax.random.split(jax.random.PRNGKey(100))
    bright, jitter = jbench.draw_perturbations(sub, SCAN, R)
    states, acc, outs = JaxState.create_batch(jcfg, R), 0.0, []
    for t in range(SCAN):
        obs = jbench.apply_perturbation(jpool, bright[t], jitter[t])
        states, out = step(tree, states, obs, jdemo.default_extrinsics())
        acc = acc + jbench.output_digest(out)
        outs.append(out)
    return jpool, float(acc), outs, states


def test_pool_matches_bench_pool(small, jax_chunk):
    pool, jpool = small[4], jax_chunk[0]
    np.testing.assert_array_equal(pool.image.numpy(), np.asarray(jpool.image))
    np.testing.assert_array_equal(pool.cloud.xyz.numpy(),
                                  np.asarray(jpool.cloud.xyz))
    np.testing.assert_array_equal(pool.cloud.count.numpy(),
                                  np.asarray(jpool.cloud.count))


def _port_ticks(eng, cfg, pool):
    """The chunk's ticks written out: the same key split, draws and
    perturbations through pipeline.fleet_step."""
    _, sub = prng.split(prng.prng_key(100))
    bright, jitter = bench.draw_perturbations(sub, SCAN, R)
    states, acc, outs = eng.init_states(R), torch.zeros(()), []
    for t in range(SCAN):
        obs = bench.apply_perturbation(pool, bright[t], jitter[t])
        states, out = pipeline.fleet_step(eng.params, states, obs,
                                          eng.extrinsics, cfg,
                                          orientation_budget=BUDGET)
        acc = acc + bench.output_digest(out)
        outs.append(out)
    return states, acc, outs


def test_run_chunk_equals_fleet_step(small):
    _, cfg, _, eng, pool = small
    key = prng.prng_key(100)
    states, acc, key2 = bench.run_chunk(eng.params, eng.init_states(R), pool,
                                        eng.extrinsics, cfg, key, SCAN,
                                        BUDGET)
    ref_states, ref_acc, outs = _port_ticks(eng, cfg, pool)
    assert torch.equal(acc, ref_acc)
    assert torch.equal(states.log_odds, ref_states.log_odds)
    np.testing.assert_array_equal(key2.numpy(),
                                  prng.split(key)[0].numpy())
    assert sum(int(o.poses.valid.sum()) for o in outs) > 0


def test_run_chunk_matches_jax_pca(small):
    """The PCA pose branch (2048 points: its RANSAC draws 1024 point
    pairs): the port's chunk within rtol 1e-5 of JAX's (equal here), the
    grids bit-equal."""
    jcfg, cfg, tree, eng, _ = small
    over = dict(use_vision_orientation=False, max_points=2048)
    jcfg, cfg = (dataclasses.replace(c, **over) for c in (jcfg, cfg))
    eng = pipeline.Engine(cfg, extrinsics=eng.extrinsics, params=eng.params,
                          device="cpu")
    pool = bench.build_pool(cfg, R, "cpu", image_dtype=torch.float32)
    _, jacc, jouts, jstates = _jax_chunk(jcfg, tree)
    states, acc, _ = bench.run_chunk(eng.params, eng.init_states(R), pool,
                                     eng.extrinsics, cfg, prng.prng_key(100),
                                     SCAN, BUDGET)
    assert np.isfinite(jacc) and sum(int(o.poses.valid.sum())
                                     for o in jouts) > 0
    np.testing.assert_allclose(float(acc), jacc, rtol=1e-5)
    np.testing.assert_array_equal(states.log_odds.numpy(),
                                  np.asarray(jstates.log_odds))


def test_output_digest_matches_jax_and_sees_every_output(small, jax_chunk):
    _, jacc, jouts, _ = jax_chunk
    out = _port_from_jax(jouts[-1])
    d = bench.output_digest(out)
    np.testing.assert_allclose(float(d), float(jbench.output_digest(
        jouts[-1])), rtol=1e-6)
    for name in ("static_points", "occupancy_i8"):
        moved = dataclasses.replace(out, **{name: torch.zeros_like(
            getattr(out, name))})
        assert float(bench.output_digest(moved)) != float(d), name
    for owner, name in (("poses", "position"), ("boxes", "confidence")):
        part = getattr(out, owner)
        part = dataclasses.replace(part, **{name: torch.zeros_like(
            getattr(part, name))})
        moved = dataclasses.replace(out, **{owner: part})
        assert float(bench.output_digest(moved)) != float(d), name
    sat = dataclasses.replace(out.saturation, orientation_dropped=torch.ones(
        R, dtype=torch.int32))
    assert float(bench.output_digest(dataclasses.replace(
        out, saturation=sat))) != float(d)


def _port_from_jax(jout):
    """A port StepOutput holding a JAX StepOutput's arrays."""
    from grid_vision_tpu_torch import types
    conv = lambda x: torch.from_numpy(np.array(x))          # noqa: E731

    def build(cls, j):
        return cls(**{f.name: (build(type_of[f.name], getattr(j, f.name))
                               if f.name in type_of else
                               conv(getattr(j, f.name)))
                      for f in dataclasses.fields(cls)})
    type_of = dict(boxes=types.Boxes, static_boxes=types.Boxes,
                   poses=types.LShapePoses, saturation=types.SaturationStats)
    return build(types.StepOutput, jout)


def test_bench_config_defaults_and_knobs():
    cfg, n_rigs, scan, budget_s, budget = bench.bench_config({})
    assert (n_rigs, scan, budget_s, budget) == (128, 8, 180.0, 640)
    assert (cfg.max_points, cfg.compute_dtype, cfg.max_static_depth,
            cfg.knn_backend, cfg.detector_stem_backend,
            cfg.orientation_stem_backend, cfg.orientation_compute,
            cfg.detection_weights_file, cfg.vision_weights_file) == (
        8192, "bfloat16", 16, "xla", "pallas", "xla", "follow",
        "weights/detector.npz", "weights/orientation.npz")
    env = dict(GV_BENCH_RIGS="64", GV_BENCH_SCAN="4", GV_BENCH_BUDGET_S="12",
               GV_BENCH_STEM="pallas2", GV_BENCH_ORIENT_STEM="pallas",
               GV_BENCH_ORIENT_DTYPE="float32", GV_BENCH_KNN="pallas")
    cfg, n_rigs, scan, budget_s, budget = bench.bench_config(env)
    assert (n_rigs, scan, budget_s, budget) == (64, 4, 12.0, 320)
    assert (cfg.detector_stem_backend, cfg.orientation_stem_backend,
            cfg.orientation_compute, cfg.knn_backend) == (
        "pallas2", "pallas", "float32", "pallas")
    pipeline.check_slice(cfg)


class _Clock:
    """A fake clock: each chunk takes `chunk_s`, each readback `sync_s`
    (plus `extra` seconds on the given group numbers)."""

    def __init__(self, chunk_s, sync_s, slow_groups=(), extra=0.0):
        self.t, self.chunk_s, self.sync_s = 0.0, chunk_s, sync_s
        self.slow_groups, self.extra = set(slow_groups), extra
        self.syncs = 0

    def __call__(self):
        return self.t

    def chunk(self):
        self.t += self.chunk_s

    def sync(self):
        self.syncs += 1
        self.t += self.sync_s
        # syncs 1-4: settle and the three latency probes
        if self.syncs - 4 in self.slow_groups:
            self.t += self.extra


def test_measure_groups_latency_and_median():
    clk = _Clock(0.01, 0.002, slow_groups=(2,), extra=5.0)
    r = bench.measure(clk.chunk, clk.sync, frames_per_chunk=100,
                      budget_s=0.0, clock=clk)
    assert len(r["group_fps"]) == 3 and r["chunks"] == 48
    assert r["sync_latency_s"] == pytest.approx(0.002)
    # a group is 16 chunks of 0.01 s: the readback latency is taken off
    steady = 1600 / 0.16
    assert r["group_fps"][0] == pytest.approx(steady)
    assert r["group_fps"][1] < steady / 10            # the stalled group
    assert r["fps"] == pytest.approx(steady)           # the median
    assert r["frames"] == 4800
    # the whole window's rate counts the stall
    assert r["window_fps"] == pytest.approx(4800 / (3 * 0.16 + 5.0))


def test_measure_runs_for_a_third_of_the_budget_and_caps_chunks():
    clk = _Clock(0.01, 0.0)
    r = bench.measure(clk.chunk, clk.sync, 10, budget_s=3.0, clock=clk)
    assert r["chunks"] == 7 * 16                # 1 s = 6.25 groups -> 7
    clk = _Clock(0.01, 0.0)
    r = bench.measure(clk.chunk, clk.sync, 10, budget_s=1e9, clock=clk)
    assert r["chunks"] == 256 and len(r["group_fps"]) == 16


def test_result_line_keys():
    doc = json.loads(bench.result_line(1234.5678))
    assert doc == {"metric": "fused_frames_per_sec", "value": 1234.6,
                   "unit": "frames/s"}
    assert set(doc) == set(itertools.islice(
        ("metric", "value", "unit", "vs_baseline"), 3))
