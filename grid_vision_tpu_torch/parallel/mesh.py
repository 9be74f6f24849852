"""The rig mesh: logical shards of a fleet's rigs, each on a device
(counterpart of grid_vision_tpu/parallel/mesh.py's rig_mesh).

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

The dp x tp training mesh (make_mesh, shard_params, replicate) belongs to
the trainer, which the port does not have yet.
"""

from __future__ import annotations

import copy
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
