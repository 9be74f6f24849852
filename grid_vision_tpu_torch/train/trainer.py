"""The train step (counterpart of grid_vision_tpu/train/trainer.py).

``make_train_step("yolo" | "multibin", model_cfg, tx)`` returns
``train_step(state, *batch) -> (state, metrics)``: the loss and its
gradients by autograd on the state's module, then ``tx``'s update, then the
new running statistics of the train-mode forward into the module's
buffers (the JAX step's ``{"params": new, **mutated}``). The step launches
eager torch ops (cuDNN's convolutions on the card, the counterpart of the
JAX step's plain XLA: no kernel of the JAX package serves training, which
normalizes with batch statistics) and reads nothing back, so a loop of
steps runs without synchronizing the card.

``AdamW`` is the counterpart of ``optax.adamw(schedule, weight_decay)``:
torch.optim.AdamW (the same update: decoupled weight decay on every
parameter, BatchNorm's and the biases included, eps added outside the
square root) with the learning rate set before each step from the
schedule at the number of steps taken so far, as optax reads its schedule
at the update count before incrementing it (step 0 of a warmup from 0 has
lr = 0).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Union

import numpy as np
import torch
from torch import nn

from ..device import ieee_convs
from ..models import orientation_net, yolov4_tiny
from . import losses

_f32 = np.float32


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: a linear warmup from init_value
    to peak_value over warmup_steps, then a cosine decay to end_value at
    decay_steps, held there. Evaluated in f32 on the host, as optax's
    jitted schedule is (count -> lr)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")
    alpha = _f32(0.0 if peak_value == 0 else end_value / peak_value)
    cos_steps = _f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = _f32(1) - _f32(count) / _f32(warmup_steps)
            return float(_f32(init_value - peak_value) * frac
                         + _f32(peak_value))
        c = np.minimum(_f32(count - warmup_steps), cos_steps)
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c
                                               / cos_steps))
        return float(_f32(peak_value) * ((_f32(1) - alpha) * cosine + alpha))

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(learning_rate, weight_decay=...) with optax's b1, b2 and
    eps, as a torch.optim.AdamW factory: learning_rate is a float or a
    schedule (count -> lr)."""
    learning_rate: Union[float, Callable[[int], float]]
    weight_decay: float = 1e-4

    def init(self, module: nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(module.parameters(), lr=self.lr(0),
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    def lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return float(self.learning_rate)


@dataclasses.dataclass
class TrainState:
    """The module (parameters and running statistics: flax's variables),
    the optimizer (its moments) and the number of steps taken."""
    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def _loss_fn(loss_kind: str, model_cfg):
    if loss_kind == "yolo":
        return functools.partial(losses.yolo_loss, cfg=model_cfg)
    if loss_kind == "multibin":
        return functools.partial(losses.multibin_loss, cfg=model_cfg)
    raise ValueError(loss_kind)


def make_train_step(loss_kind: str, model_cfg, tx: AdamW,
                    mesh=None) -> Callable:
    """train_step(state, *batch) -> (state, metrics), updating state's
    module and optimizer in place. loss_kind: "yolo" (batch = images,
    tgt_boxes, tgt_class, tgt_pos) or "multibin" (batch = crops, tgt_dims,
    tgt_bin, tgt_angle_offset[, dim_weight, angle_weight]). metrics: the
    loss and the loss's aux terms, detached on the device."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded train step (the training mesh: make_mesh, "
            "shard_params, replicate) is a later slice of the port")
    loss_fn = _loss_fn(loss_kind, model_cfg)

    def train_step(state: TrainState, *batch):
        model, opt = state.model, state.opt
        opt.zero_grad(set_to_none=True)
        # the backward's convs run when backward() is called: one scope
        # holds the forward and the backward out of TF32
        with ieee_convs():
            loss, (mutated, aux) = loss_fn(model, *batch, train=True)
            loss.backward()
        for group in opt.param_groups:
            group["lr"] = tx.lr(state.step)
        opt.step()
        buffers = dict(model.named_buffers())
        with torch.no_grad():
            for key, value in mutated.items():
                buffers[key].copy_(value)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def init_train_state(loss_kind: str, model_cfg, tx: AdamW,
                     rng: torch.Tensor) -> TrainState:
    """The net of model_cfg with flax's init from `rng` (on rng's device,
    train mode) and tx's optimizer over its parameters."""
    if loss_kind == "yolo":
        model = yolov4_tiny.init_params(rng, model_cfg)
    else:
        model = orientation_net.init_params(rng, model_cfg)
    model.train()
    return TrainState(model=model, opt=tx.init(model))
