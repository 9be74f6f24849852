"""The rig mesh, logical shards of a fleet's rigs, each on a device, and
the dp x tp training mesh (counterpart of grid_vision_tpu/parallel/mesh.py:
rig_mesh, make_mesh, shard_params, replicate).

The JAX package shards rigs over a 1-D ``rig`` axis of a device mesh, and
some of its results depend on the number of shards: the fleet's
orientation budget and the shared grid's budget apply per shard
(parallel/fleet.py, parallel/shared_grid.py), the city grid splits its rows
over them (parallel/city_grid.py). A torch device has no mesh, so the port
keeps the shards as a list of devices, one entry a shard. A device may
repeat: 8 logical shards may all live on ``cpu``, or on ``cuda:0`` of one
H100, and compute what 8 devices of the JAX mesh compute. Shard s holds
rigs [s * n / S, (s + 1) * n / S). As in the JAX package all shards run in
one process (its mesh has no DCN path).

The training mesh (``make_mesh``: a (dp, tp) grid of logical shards)
shards the batch over dp and the wide conv and dense kernels' output
channels over tp (``shard_params``; the rest is ``replicate``d), as the
JAX package's jit over its mesh does. That mesh too is one process. Its
shards here are logical shards of one device, so the sharding changes
where nothing lives; it fixes what the sharded train step computes
(train/trainer.make_train_step(..., mesh=)): the forward on the whole
batch, BatchNorm moments and loss over all of it, and the gradients
summed over the dp shards, as the JAX mesh's psum sums them. On one
device that sum is the whole batch's gradient, which the step's plain
backward computes. tp changes no number: each output channel's sums are the same
whichever shard holds it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device


class RigMesh:
    """One device per logical shard (devices may repeat)."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a rig mesh needs at least one shard")
        self.devices: List[torch.device] = [resolve_device(d)
                                            for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The first shard's device: where whole-fleet tensors live."""
        return self.devices[0]

    def shards(self, n: int) -> Iterator[Tuple[torch.device, int, int]]:
        """(device, first rig, end rig) of each shard of n rigs."""
        if n % self.size:
            raise ValueError(f"{n} % {self.size} shards != 0")
        local = n // self.size
        for s, dev in enumerate(self.devices):
            yield dev, s * local, (s + 1) * local

    def groups(self, n: int) -> Iterator[Tuple[torch.device, int, int]]:
        """shards() with runs of consecutive shards on one device merged:
        for work whose result does not depend on the shard count."""
        run = None
        for dev, a, b in self.shards(n):
            if run is not None and run[0] == dev:
                run = (dev, run[1], b)
                continue
            if run is not None:
                yield run
            run = (dev, a, b)
        yield run

    def __repr__(self) -> str:
        return f"RigMesh({[str(d) for d in self.devices]})"


def rig_mesh(n_shards: Optional[int] = None, device="cuda") -> RigMesh:
    """A rig mesh of n_shards shards. On "cuda", one shard a visible card
    by default, cards reused round-robin when n_shards exceeds them (two
    logical shards on one H100 are cuda:0 twice); on "cpu", n_shards (1 by
    default) shards of the CPU. CUDA without a card raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    n = n_shards or len(cards)
    return RigMesh([cards[i % len(cards)] for i in range(n)])


def nets_on(params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Copies of the nets in params ("detector", "orientation") on
    `device`, for a shard there (an Engine folds its kernels' constants
    from them)."""
    return {k: copy.deepcopy(params[k]).to(device)
            for k in ("detector", "orientation") if k in params}


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """A (dp, tp) grid of logical shards, all on one device: shard (i, j)
    is dp row i, tp column j. axis_names names the two axes (the JAX
    package's ("dp", "tp"))."""
    device: torch.device
    dp: int
    tp: int
    axis_names: Tuple[str, str] = ("dp", "tp")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (self.dp, self.tp)))

    @property
    def size(self) -> int:
        return self.dp * self.tp


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "tp"), tp: int = 1,
              device="cuda") -> TrainMesh:
    """A training mesh of n_devices logical shards (default 1) on `device`
    (the card unless the CPU is asked for; CUDA without a card raises),
    shaped (n_devices // tp, tp)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = n_devices or 1
    if n % tp:
        raise ValueError(f"n_devices {n} not divisible by tp {tp}")
    return TrainMesh(dev, n // tp, tp, tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives on a TrainMesh: split along `dim` into mesh.tp
    equal pieces over the tp axis (each dp row holds all of them), or
    replicated on every shard (dim None)."""
    mesh: TrainMesh
    dim: Optional[int]

    @property
    def tp_sharded(self) -> bool:
        return self.dim is not None


def shard_params(params, mesh: TrainMesh, tp_axis: str = "tp"
                 ) -> Dict[str, Placement]:
    """The JAX package's tensor-parallel rule, leaf by leaf of a module's
    parameters (or a {name: tensor} dict): a conv or dense weight (2-D or
    more) whose output-channel dim (torch's first, flax's last) divides by
    the tp size and is at least 8 x the tp size is split over tp_axis;
    everything else is replicated."""
    tp = mesh.shape[tp_axis]
    leaves = (dict(params.named_parameters())
              if isinstance(params, torch.nn.Module) else params)
    return {name: Placement(mesh, 0 if (leaf.dim() >= 2
                                        and leaf.shape[0] % tp == 0
                                        and leaf.shape[0] >= 8 * tp)
                            else None)
            for name, leaf in leaves.items()}


def replicate(tree, mesh: TrainMesh) -> Dict[str, Placement]:
    """Every leaf of a module's buffers (the BatchNorm statistics) or of a
    {name: tensor} dict replicated on every shard."""
    leaves = (dict(tree.named_buffers())
              if isinstance(tree, torch.nn.Module) else tree)
    return {name: Placement(mesh, None) for name in leaves}
