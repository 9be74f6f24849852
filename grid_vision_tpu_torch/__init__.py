"""grid_vision_tpu_torch: the PyTorch / CUDA port of grid_vision_tpu.

A package of its own beside the JAX package, which stays the reference:
it imports torch and numpy, never jax, flax or anything of
grid_vision_tpu. Entry points (``pipeline.Engine``, ``pipeline.step``,
``pipeline.fleet_step``) run on CUDA unless the caller asks for the CPU,
with either pose branch: the vision orientation net, or the PCA branch
(``use_vision_orientation=False``: ops/plane.py, ops/association.py,
ops/lshape.py), fed typed tensors or the JAX package's packed wire
(``Engine.call_packed*``; runtime/stream.py, runtime/record.py and
``python -m grid_vision_tpu_torch run|record|play``). The TPU kernels of
the main path are hand-written CUDA kernels for Hopper (csrc/), built with
nvcc at first use; on CPU tensors each wrapper runs its plain torch twin.
"""

from .config import GridVisionConfig, load_config
from .types import (Boxes, Extrinsics, GridState, LShapePoses, Obs,
                    PointCloud, SaturationStats, StepOutput)

__all__ = ["GridVisionConfig", "load_config", "Boxes", "Extrinsics",
           "GridState", "LShapePoses", "Obs", "PointCloud",
           "SaturationStats", "StepOutput"]
