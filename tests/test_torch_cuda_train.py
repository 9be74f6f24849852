"""Training, evaluation, the CLI and the training mesh on the card: the
CLI's trainers without a host sync and the fleet tick on their weights,
mAP and pose quality through the kernels, the int8 detector's mAP, the
`demo`, `view`, `bench` and `run` commands, and sharded train steps, each
against the plain backends, the CPU's results or the CPU tests' floors.

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
Imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda*.py --noconftest -q
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from grid_vision_tpu_torch import pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights

from .test_torch_cuda_tick import (BF16_KERNELS, BUDGET, N_RIGS, PLAIN, ROOT,
                                   assert_bf16_bars, compare_outputs, counted,
                                   run_fleet, sync_free, to_bf16)
from .test_torch_cuda_tick import cuda_device, paths  # noqa: F401

torch.set_num_threads(1)

TRAIN_STEPS = 100               # two chunks of TRAIN_SCAN steps a net
TRAIN_SCAN = 50
TRAIN_DET = dict(batch=32, size=416)             # the CLI's defaults
TRAIN_ORI = dict(batch=64, size=224, width=32)   # the shipped net's
TRAIN_TICKS = 3


# -- the CLI's trainers, then the fleet on their weights ---------------------

@pytest.fixture(scope="module")
def trained(paths, tmp_path_factory):
    """`train detector` (TRAIN_STEPS steps in chunks of TRAIN_SCAN, 16
    scene frames) and `train orientation` (32 scene crops) at full size,
    every chunk under torch.cuda.set_sync_debug_mode("error"), the launch
    counters from zero: (detector run, orientation run, their weights'
    paths, the kernel launches)."""
    from grid_vision_tpu_torch.ops import cuda_csp, cuda_stem
    from grid_vision_tpu_torch.train import fit_on_device, fit_orientation
    from grid_vision_tpu_torch.utils import prng
    # A first render copies the MultiBin bin centres to the card, once a
    # process (fit_orientation._bins): done here, before any chunk, as a
    # train step's batch would have.
    fit_orientation.render_crop(prng.split(prng.prng_key(
        0, device=paths.engine.device), TRAIN_ORI["batch"]), TRAIN_ORI["size"])
    out = tmp_path_factory.mktemp("trained")
    det_path = str(out / "detector.npz")
    ori_path = str(out / "orientation.npz")
    chunks = (fit_on_device.run_chunk, fit_orientation.run_chunk)
    fit_on_device.run_chunk = lambda *a, **k: sync_free(
        lambda: chunks[0](*a, **k))
    fit_orientation.run_chunk = lambda *a, **k: sync_free(
        lambda: chunks[1](*a, **k))
    launches = (cuda_stem.launches, cuda_csp.launches)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            det = fit_on_device.main([
                "--steps", str(TRAIN_STEPS), "--scan", str(TRAIN_SCAN),
                "--scene-frames", "16", "--batch", str(TRAIN_DET["batch"]),
                "--input-size", str(TRAIN_DET["size"]), "--out", det_path])
            ori = fit_orientation.main([
                "--steps", str(TRAIN_STEPS), "--scan", str(TRAIN_SCAN),
                "--scene-crops", "32", "--batch", str(TRAIN_ORI["batch"]),
                "--input-size", str(TRAIN_ORI["size"]),
                "--width", str(TRAIN_ORI["width"]), "--out", ori_path])
    finally:
        fit_on_device.run_chunk, fit_orientation.run_chunk = chunks
    launched = (cuda_stem.launches - launches[0]) + (cuda_csp.launches
                                                     - launches[1])
    return det, ori, det_path, ori_path, launched


@pytest.mark.cuda
def test_train_cli_loss_falls_without_a_kernel(trained):
    """Both trainers' losses finite and falling (the mean of the last 10
    steps below that of the first 10); no kernel of csrc/ launched
    (training is plain torch)."""
    det, ori, _, _, launched = trained
    assert launched == 0
    for r in (det, ori):
        losses = r["losses"].reshape(-1)
        assert all(math.isfinite(x) for x in losses)
        assert float(losses[-10:].mean()) < float(losses[:10].mean())


@pytest.mark.cuda
def test_trained_weights_reload_equal(paths, trained):
    det, ori, det_path, ori_path, _ = trained
    nets = weights.load_all(dataclasses.replace(
        paths.fleet_cfg, detection_weights_file=det_path,
        vision_weights_file=ori_path), device=paths.engine.device)
    for name, r in (("detector", det), ("orientation", ori)):
        want = r["state"].model.state_dict()
        for k, v in nets[name].state_dict().items():
            assert torch.equal(v, want[k]), (name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fleet_on_trained_weights_agrees_with_plain(paths, trained, dtype):
    """TRAIN_TICKS fleet ticks on the trained weights on the kernel
    backends against the plain ones: f32 at compare_outputs' bars, bf16 at
    the bf16 bars, each kernel (the bf16 forms in bf16) once a tick; in
    bf16 also against the detector's kernels with the rest plain (the same
    boxes: every rig-tick clean)."""
    _, _, det_path, ori_path, _ = trained
    c = dataclasses.replace(paths.fleet_cfg, compute_dtype=dtype,
                            detection_weights_file=det_path,
                            vision_weights_file=ori_path)
    nets = weights.load_all(c, device=paths.engine.device)
    kern = paths.engine_of(c, params=nets)
    plain = paths.engine_of(dataclasses.replace(c, **PLAIN), params=nets)
    t = TRAIN_TICKS
    if dtype == "float32":
        obs = paths.fleet_obs[:t]
        outs = counted(lambda: run_fleet(kern, obs, BUDGET),
                       dict(detector_stem=t, detector_csp=t, orient_front=t,
                            grid_update=t, knn_median_depth=t))
        compare_outputs(c, outs, run_fleet(plain, obs, BUDGET), per_rig=True)
        return
    obs = to_bf16(paths.fleet_obs[:t])
    outs = counted(lambda: run_fleet(kern, obs, BUDGET),
                   {k: t for k in BF16_KERNELS})
    assert_bf16_bars(c, outs, run_fleet(plain, obs, BUDGET))
    half = paths.engine_of(dataclasses.replace(
        c, **{k: v for k, v in PLAIN.items()
              if k != "detector_stem_backend"}), params=nets)
    r = assert_bf16_bars(c, outs, run_fleet(half, obs, BUDGET))
    assert r["clean_rig_ticks"] == N_RIGS * t, r


@pytest.mark.cuda
def test_bf16_forms_on_trained_weights_match_their_twins(paths, trained):
    """The three bf16 forms on the trained weights at the fleet's shapes,
    on 8-bit frames, against their twins at the JAX package's bf16 bar
    (rtol = atol = 0.06): the stem on N_RIGS frames with >= 99.9 % of the
    elements bit-equal, the CSP stage on the stem's output and the
    orientation front on BUDGET crops (flat crops held to finiteness only)
    with >= 99 %."""
    from grid_vision_tpu_torch.ops import cuda_csp, cuda_orient, cuda_stem
    _, _, det_path, ori_path, _ = trained
    cfg = paths.fleet_cfg
    dev = paths.engine.device
    nets = weights.load_all(dataclasses.replace(
        cfg, detection_weights_file=det_path, vision_weights_file=ori_path),
        device=dev)
    det, net = nets["detector"], nets["orientation"]
    bf = torch.bfloat16
    h, w = cfg.camera_image_height, cfg.camera_image_width

    def frames(seed, n):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, 256, (n, h, w, 3), generator=g,
                             device=dev).to(bf)

    def hold(got, ref, share):
        assert got.dtype == ref.dtype == bf
        torch.testing.assert_close(got.float(), ref.float(), rtol=0.06,
                                   atol=0.06)
        assert (got == ref).float().mean().item() >= share

    with torch.no_grad():
        img = frames(11, N_RIGS)
        consts = cuda_stem.prepare_stem_constants(det, bf)
        x = cuda_stem.detector_stem_cuda(img, consts, cfg.resize)
        hold(x, cuda_stem.detector_stem_plain(img, consts, cfg.resize), 0.999)
        consts = cuda_csp.prepare_csp_constants(det, bf)
        hold(cuda_csp.detector_csp_cuda(x, det, consts),
             cuda_csp.detector_csp_plain(x, det, consts), 0.99)
        del img, x
        images = frames(15, N_RIGS)
        g = torch.Generator(device=dev).manual_seed(14)
        u = torch.rand((BUDGET, 4), generator=g, device=dev)
        x0, y0 = u[:, 0] * (w + 60) - 40, u[:, 1] * (h + 60) - 40
        xyxy = torch.stack([x0, y0, x0 + 8 + u[:, 2] * 300,
                            y0 + 8 + u[:, 3] * 250], dim=-1)
        valid = torch.rand((BUDGET,), generator=g, device=dev) > 0.1
        rig = torch.sort(torch.randint(0, N_RIGS, (BUDGET,), generator=g,
                                       device=dev)).values
        size = cfg.network_height
        consts = cuda_orient.prepare_orient_constants(net, bf)
        got = cuda_orient.orient_front_cuda(images, xyxy, valid, rig, net,
                                            consts, size)
        ref = cuda_orient.orient_front_plain(images, xyxy, valid, rig, net,
                                             size, consts)
        keep = cuda_orient.crops_by_rig(images, xyxy, rig, size).std(
            dim=(1, 2)).amin(dim=-1) >= 1.0
    assert torch.isfinite(got.float()).all()
    hold(got[keep], ref[keep], 0.99)


# -- evaluation through the kernels ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("source,n", [("synth", 50), ("scene", 64)])
def test_eval_map_through_the_kernels(paths, source, n):
    """50 held-out synth frames (the JAX package's keys) and 64 scene
    frames through pipeline.detect_batch in chunks of 16 (eval confidence
    0.05), on "pallas2" (the stem and CSP kernels once a chunk) and on the
    plain backends: equal box counts every frame, mAP@0.5 within 1e-3 of
    each other, and on both the floors of tests/test_eval_map.py (synth
    >= 0.95, scene >= 0.85, all ten classes >= 0.5, scene Bike >= 0.72
    and Motorbike >= 0.75)."""
    from grid_vision_tpu_torch.train import eval_map
    dev = paths.engine.device
    base = GridVisionConfig(
        detection_weights_file=os.path.join(ROOT, "weights/detector.npz"),
        vision_weights_file=os.path.join(ROOT, "weights/orientation.npz"),
        confidence_threshold=0.05)
    nets = weights.load_all(base, device=dev)
    images, gts = (eval_map.heldout_synth(n, base, device=dev)
                   if source == "synth" else eval_map.heldout_scene(n, base))
    chunks = -(-n // 16)
    res = {}
    for name, c, want in (
            ("kernels", dataclasses.replace(
                base, detector_stem_backend="pallas2"),
             dict(detector_stem=chunks, detector_csp=chunks)),
            ("plain", base, {})):
        params = pipeline.Engine(c, params=nets, device=dev).params
        preds = counted(lambda: eval_map.detect_images(params, images, c,
                                                       device=dev), want)
        res[name] = (preds, eval_map.score_detections(preds, gts))
    (kp, kr), (pp, pr) = res["kernels"], res["plain"]
    assert [len(p[0]) for p in kp] == [len(p[0]) for p in pp]
    assert abs(kr.map50 - pr.map50) <= 1e-3
    for r in (kr, pr):
        aps = r.per_class_ap
        assert r.map50 >= (0.95 if source == "synth" else 0.85), r.to_dict()
        assert len(aps) == 10 and all(ap >= 0.5 for ap in aps.values())
        if source == "scene":
            assert aps["Bike"] >= 0.72 and aps["Motorbike"] >= 0.75


@pytest.mark.cuda
def test_eval_pose_through_the_kernels(paths):
    """eval_pose.evaluate_poses with oracle boxes on the grid and kNN
    kernels (each once a frame), held to the floors of
    tests/test_eval_pose.py: PCA at 10 frames >= 20 matched, median < 0.10
    m; vision at 5 frames, the refine below the faithful median; the
    refine at 15 frames >= 30 matched, median < 0.8 m, p90 < 2.5 m."""
    from grid_vision_tpu_torch.train import eval_pose
    pcfg = GridVisionConfig(
        vision_weights_file=os.path.join(ROOT, "weights/orientation.npz"),
        grid_backend="pallas", knn_backend="pallas")
    res = {}
    for name, mode, frames, refine in (("pca", "pca", 10, False),
                                       ("vision", "vision", 5, False),
                                       ("refine5", "vision", 5, True),
                                       ("refine", "vision", 15, True)):
        res[name] = counted(lambda: eval_pose.evaluate_poses(
            mode, frames, cfg=pcfg, refine=refine,
            device=paths.engine.device),
            dict(grid_update=frames, knn_median_depth=frames))
    p, v, r5, r15 = (res[k] for k in ("pca", "vision", "refine5", "refine"))
    assert p["n_matched"] >= 20 and p["pos_err_median_m"] < 0.10, p
    assert r5["n_matched"] > 0, r5
    assert r5["pos_err_median_m"] < v["pos_err_median_m"], (v, r5)
    assert (r15["n_matched"] >= 30 and r15["pos_err_median_m"] < 0.8
            and r15["pos_err_p90_m"] < 2.5), r15


@pytest.mark.cuda
def test_int8_map_within_0_03_of_the_float_detectors(paths):
    """mAP@0.5 on 50 held-out synth frames: the int8 detector at least the
    float one's - 0.03 (tests/test_int8_detector.py's margin)."""
    from grid_vision_tpu_torch.train import eval_map
    base = GridVisionConfig(
        detection_weights_file=os.path.join(ROOT, "weights/detector.npz"))
    nets = weights.load_all(base, device=paths.engine.device)
    r_f = eval_map.evaluate_detector(nets, base, n_images=50)
    r_i = eval_map.evaluate_detector(
        nets, dataclasses.replace(base, detector_precision="int8",
                                  compat=False), n_images=50)
    assert r_i.map50 >= r_f.map50 - 0.03, (r_i.map50, r_f.map50)


# -- the CLI: demo, run --publish / view --http, bench, run under defaults ---

def cli(*args, timeout=600, **kw):
    proc = subprocess.run([sys.executable, "-m", "grid_vision_tpu_torch",
                           *args], capture_output=True, text=True, cwd=ROOT,
                          timeout=timeout, **kw)
    assert proc.returncode == 0, (args, proc.stderr[-2000:])
    return proc


@pytest.mark.cuda
def test_demo_cli_writes_its_files_and_the_replays_grid(paths, tmp_path):
    """`demo --mode pca --det oracle --steps 6` and `demo --mode vision
    --det net --steps 6` write their PGM / PPM / markers files at ticks 0
    and 5; the net run's last grid equals the PGM of the last tick of
    runtime/stream.replay on the same scene, weights and configuration."""
    from grid_vision_tpu_torch import demo
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.runtime import native
    from grid_vision_tpu_torch.runtime.stream import replay
    for mode, det in (("pca", "oracle"), ("vision", "net")):
        out = tmp_path / f"demo_{mode}_{det}"
        cli("demo", "--mode", mode, "--det", det, "--steps", "6", "--out",
            str(out))
        assert sorted(os.listdir(out)) == sorted(
            f"{kind}_{i:03d}.{ext}" for kind, ext in (
                ("dets", "ppm"), ("grid", "pgm"), ("markers", "json"))
            for i in (0, 5))
    cfg = GridVisionConfig(use_vision_orientation=True, max_points=8192,
                           detection_weights_file="/weights/detector.npz",
                           vision_weights_file="/weights/orientation.npz")
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics(
        paths.engine.device), seed=0, device=paths.engine.device,
        base_dir=ROOT)
    scene = SyntheticScene(cfg, seed=0)
    scene.add_default_traffic()
    last = {}
    replay(eng, scene, n_steps=6, hz=10.0,
           on_step=lambda i, s, o: last.update(out=o))
    ref_pgm = tmp_path / "replay_005.pgm"
    native.write_pgm(str(ref_pgm), last["out"].occupancy_i8.cpu().numpy())
    assert ref_pgm.read_bytes() == (
        tmp_path / "demo_vision_net" / "grid_005.pgm").read_bytes()


@pytest.mark.cuda
def test_run_publish_then_view_http_serves_the_last_frame(paths):
    """`run --steps 6 --publish NAME`, then `view --session NAME --http
    PORT --seconds 5`: / names the session, /grid.png's pixels equal
    grid_frame_rgb(the session's last frame, scale=2), one /grid.gvd
    record decodes to the last frame's grid and step; view exits 0."""
    from grid_vision_tpu_torch.io import png
    from grid_vision_tpu_torch.runtime import native, session, viewer
    name = f"gvcard-{os.getpid()}-view"
    cli("run", "--steps", "6", "--publish", name)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    view = subprocess.Popen(
        [sys.executable, "-m", "grid_vision_tpu_torch", "view", "--session",
         name, "--http", str(port), "--seconds", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        t_end, index = time.time() + 30, None
        while index is None and time.time() < t_end:
            try:
                index = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/", timeout=5).read()
            except OSError:
                time.sleep(0.1)
        assert index is not None and name.encode() in index
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/grid.png",
                                      timeout=10).read()
        sub = session.SessionSubscriber(name)
        frame = sub.poll(wait_new=False)
        sub.close()
        assert (png.decode_rgb(body)
                == viewer.grid_frame_rgb(frame, scale=2)).all()
        grid, step, _ = next(viewer.gvd_client("127.0.0.1", port,
                                               max_records=1))
        assert (grid == frame.grid).all() and step == frame.step == 5
        _, err = view.communicate(timeout=60)
        assert view.returncode == 0, err[-2000:]
    finally:
        if view.poll() is None:
            view.kill()
            view.communicate()
        for ch in (session.GRID_CHANNEL, session.MARKERS_CHANNEL,
                   session.OVERLAY_CHANNEL, session.FORECAST_CHANNEL,
                   session.CLOUDVIZ_CHANNEL):
            path = native.shm_path(name, ch)
            if os.path.exists(path):
                os.remove(path)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["defaults", "pallas2_pallas"])
def test_bench_cli_prints_its_metric(paths, mode):
    """`python -m grid_vision_tpu_torch bench` in each of bench.MODES with
    GV_BENCH_BUDGET_S=12 exits 0 and ends with one JSON line {"metric":
    "fused_frames_per_sec", "value" > 0, "unit": "frames/s"}."""
    from grid_vision_tpu_torch import bench
    proc = cli("bench", timeout=900, env=dict(
        os.environ, GV_BENCH_BUDGET_S="12", **bench.MODES[mode]))
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["metric"] == "fused_frames_per_sec"
    assert doc["unit"] == "frames/s" and float(doc["value"]) > 0


@pytest.mark.cuda
def test_run_cli_under_torchs_default_flags(paths):
    """`run --steps 3` in a process that leaves torch's TF32 flags at
    their defaults replays its 3 steps."""
    assert "replayed 3 steps" in cli("run", "--steps", "3").stderr


# -- the training mesh (parallel/mesh.py) ------------------------------------

MESH_STEPS = 3


def mesh_cases(dev, det, ori):
    """{kind: (config, batch)} of the detector and the orientation net at
    these sizes, f32."""
    from grid_vision_tpu_torch.models import orientation_net, yolov4_tiny
    ycfg = yolov4_tiny.YoloConfig(input_size=det["size"],
                                  compute_dtype=torch.float32)
    ocfg = orientation_net.OrientationConfig(
        input_size=ori["size"], width=ori["width"], s2d_fold=False,
        compute_dtype=torch.float32)
    rng, b, size = np.random.default_rng(6), ori["batch"], ori["size"]
    multibin = tuple(torch.tensor(a, device=dev) for a in (
        rng.normal(size=(b, size, size, 3)).astype(np.float32),
        (rng.normal(size=(b, 3)) * 0.3).astype(np.float32),
        rng.integers(0, 2, b).astype(np.int32),
        rng.uniform(-1, 1, b).astype(np.float32)))
    return {"yolo": (ycfg, yolo_batch(dev, ycfg, det["batch"])),
            "multibin": (ocfg, multibin)}


def yolo_batch(dev, cfg, b):
    from grid_vision_tpu_torch.utils import prng
    n = cfg.num_anchors_total
    tgt_pos = torch.zeros((b, n), device=dev)
    tgt_pos[:, 0] = 1.0
    return (prng.uniform(prng.prng_key(1, device=dev),
                         (b, cfg.input_size, cfg.input_size, 3)),
            torch.tensor([[0.2, 0.2, 0.6, 0.6]], device=dev).repeat(b, n, 1),
            torch.zeros((b, n), dtype=torch.int32, device=dev), tgt_pos)


def mesh_run(kind, cfg, batch, mesh):
    """MESH_STEPS SGD(1e-2) steps from the seed-0 init: (state, losses)."""
    from grid_vision_tpu_torch.train import trainer
    from grid_vision_tpu_torch.utils import prng
    tx = trainer.SGD(1e-2)
    state = trainer.init_train_state(
        kind, cfg, tx, prng.prng_key(0, device=batch[0].device))
    step = trainer.make_train_step(kind, cfg, tx, mesh)
    losses = []
    for _ in range(MESH_STEPS):
        state, metrics = step(state, *batch)
        losses.append(metrics["loss"].item())
    return state, losses


def apart(s0, s1):
    """(max |dparam|, share of parameters off atol 1e-6 / rtol 1e-4, max
    |d running statistic|)."""
    want, got = s0.model.state_dict(), s1.model.state_dict()
    n = off = 0
    worst = stats = 0.0
    for k, r in want.items():
        err = (got[k].double() - r.double()).abs()
        if "running" in k:
            stats = max(stats, float(err.max()))
            continue
        worst = max(worst, float(err.max()))
        n += r.numel()
        off += int((err > 1e-6 + 1e-4 * r.double().abs()).sum())
    return worst, off / n, stats


@pytest.fixture
def mesh(paths):
    """A (2, 2) grid of logical shards of the card; cuDNN deterministic
    (restored after): on one device the sharded step runs the unsharded
    step's backward, so a difference can only be the mesh path's own."""
    from grid_vision_tpu_torch.parallel.mesh import make_mesh
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield make_mesh(4, ("dp", "tp"), tp=2, device=paths.engine.device)
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_mesh_contract(paths, mesh):
    """tests/test_parallel.py's contract on the card: MESH_STEPS steps of
    the detector (input 32, batch 8) on the mesh, finite and falling, step
    == MESH_STEPS; a wide conv weight split over tp."""
    from grid_vision_tpu_torch.models import yolov4_tiny
    from grid_vision_tpu_torch.parallel.mesh import replicate, shard_params
    cfg = yolov4_tiny.YoloConfig(input_size=32, compute_dtype=torch.float32)
    state, losses = mesh_run("yolo", cfg, yolo_batch(paths.engine.device,
                                                     cfg, 8), mesh)
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    assert state.step == MESH_STEPS
    placements = shard_params(state.model, mesh)
    replicate(state.model, mesh)
    params = dict(state.model.named_parameters())
    assert any(params[k].dim() == 4 for k, p in placements.items()
               if p.tp_sharded)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["yolo", "multibin"])
def test_mesh_step_equals_unsharded_at_the_tests_sizes(paths, mesh, kind):
    """The sharded step against the unsharded one from the same init and
    batch, MESH_STEPS steps, at tests/test_torch_train_mesh.py's sizes
    (detector 64, batch 4; orientation 32 / 8, batch 8) and
    tests/test_torch_train_steps.py's bars (losses rtol 1e-5; parameters
    within 1e-4 and >= 99.99 % within atol 1e-6 / rtol 1e-4; running
    statistics atol 1e-5)."""
    cfg, batch = mesh_cases(paths.engine.device, dict(size=64, batch=4),
                            dict(size=32, width=8, batch=8))[kind]
    (s0, want), (s1, got) = (mesh_run(kind, cfg, batch, m)
                             for m in (None, mesh))
    worst, off, stats = apart(s0, s1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert worst <= 1e-4 and off <= 1e-4 and stats <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["yolo", "multibin"])
def test_mesh_step_at_the_clis_sizes_within_a_reordered_batch(paths, mesh,
                                                              kind):
    """At the CLI's sizes (detector 416, batch 8; orientation 224 / 32,
    batch 16) the sharded step held against the unsharded one by the
    run's own control, the unsharded step on the batch in reverse order
    (these nets' sensitivity to the order of the sums: SGD(1e-2) moves
    them far in a step): the sharded losses' largest relative error and
    the largest error of a parameter and of a running statistic within
    the reversed batch's. A dropped, doubled or misordered shard moves a
    parameter by about lr x its gradient, far beyond that."""
    cfg, batch = mesh_cases(paths.engine.device, dict(size=416, batch=8),
                            dict(size=224, width=32, batch=16))[kind]
    perm = torch.arange(batch[0].shape[0] - 1, -1, -1,
                        device=batch[0].device)
    (s0, want), (s1, got), (s2, other) = (
        mesh_run(kind, cfg, b, m) for b, m in (
            (batch, None), (batch, mesh),
            (tuple(x[perm] for x in batch), None)))

    def rel(v):
        return max(abs(a - b) / abs(b) for a, b in zip(v, want))

    err, control = apart(s0, s1), apart(s0, s2)
    assert rel(got) <= rel(other), (got, other, want)
    assert err[0] <= control[0] and err[2] <= control[2], (err, control)
