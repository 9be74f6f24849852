#!/usr/bin/env python3
"""Device time by kernel name of the port's stem and kNN wrappers, on one
NVIDIA card (grid_vision_tpu_torch; imports nothing of JAX):

    python3 tools/torch_kernel_times.py            # from the repo's root
    python3 tools/torch_kernel_times.py stem       # or: knn

torch.profiler over a few calls at the ticks' shapes (64 frames of 480x640
to 416; 64 rigs x 8192 points x 16 and 64 queries, one rig x 16384 x 64);
prints one JSON line per shape with the microseconds per call of every
kernel of csrc/ (named gv_*). The quick look at where a call's device time
goes while a kernel is being worked on: compile a variant, run this, compare.
chip_smoke.py holds the kernels to their twins and times whole calls.
"""

import json
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from grid_vision_tpu_torch import GridVisionConfig  # noqa: E402
from grid_vision_tpu_torch.models import weights  # noqa: E402
from grid_vision_tpu_torch.ops import cuda_knn, cuda_stem  # noqa: E402


def kernel_us(fn, iters: int = 10):
    """{kernel name: microseconds per call of fn()} for the gv_* kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if "gv_" in e.name:
            name = e.name[e.name.index("gv_"):].split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return {k: round(v, 2) for k, v in out.items()}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    which = set(sys.argv[1:]) or {"stem", "knn"}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    if "knn" in which:
        for r, p, d in ((64, 8192, 16), (64, 8192, 64), (1, 16384, 64)):
            uvd = torch.rand((r, p, 3), generator=g, device=dev) * \
                torch.tensor([640.0, 480.0, 60.0], device=dev)
            valid = torch.rand((r, p), generator=g, device=dev) > 0.1
            centers = torch.rand((r, d, 2), generator=g, device=dev) * \
                torch.tensor([640.0, 480.0], device=dev)
            got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers,
                                                         4)
            ref = cuda_knn.knn_median_depth_plain(uvd, valid, centers, 4)
            print(json.dumps(dict(
                kernel="knn", shape=[r, p, d], equal=bool(torch.equal(got,
                                                                      ref)),
                us=kernel_us(lambda: cuda_knn.knn_median_depth_centers_cuda(
                    uvd, valid, centers, 4)))), flush=True)
    if "stem" in which:
        cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
        det = weights.load_all(cfg, device=dev)["detector"]
        consts = cuda_stem.prepare_stem_constants(det)
        for batch in (64, 1):
            img = torch.rand((batch, 480, 640, 3), generator=g,
                             device=dev) * 255
            print(json.dumps(dict(
                kernel="stem", shape=list(img.shape),
                us=kernel_us(lambda: cuda_stem.detector_stem_cuda(
                    img, consts, cfg.resize)))), flush=True)


if __name__ == "__main__":
    main()
