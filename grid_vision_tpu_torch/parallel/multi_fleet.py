"""Multi-fleet orchestration: independent fleets on groups of a mesh's
devices (counterpart of grid_vision_tpu/parallel/multi_fleet.py).

A card serving a whole operation hosts many logical deployments at once:
two cities' fleets with different camera intrinsics, or a canary fleet on
new detector weights next to the production fleet. Each is a Fleet on its
own group of the mesh's shards, with its own GridVisionConfig, weights and
extrinsics; the fleets share nothing.

The JAX package overlaps the fleets by asynchronous dispatch onto disjoint
devices. Here the groups may repeat one card (the mesh's devices may:
RigMesh([cuda:0, cuda:0]) holds two fleets on one H100), so on CUDA each
fleet issues its work on its own torch.cuda.Stream: step_all issues every
fleet before it hands back any result, and the kernels' wrappers launch on
the current stream, which is then the fleet's. A fleet's stream first waits
for the work already queued on the caller's stream (the host-to-device
copies of its inputs); the caller's stream waits for every fleet's before
step_all returns. What overlaps is bounded by the host: a fleet whose tick
reads a value back (NMS) waits for its own stream there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import GridVisionConfig
from ..types import Extrinsics, GridState, Obs, _map
from .fleet import Fleet
from .mesh import RigMesh, rig_mesh


class MultiFleet:
    """G independent fleets over G groups of a RigMesh's shards.

    configs: one GridVisionConfig a fleet (heterogeneous allowed).
    rigs_per_fleet: rigs a fleet (must divide its group's size).
    devices_per_fleet: shards a group; defaults to an even split of the
      mesh's shards over the fleets.
    params_list / extrinsics_list: optional weights / extrinsics a fleet
      (e.g. a canary fleet on other weights).
    mesh: the shards to split (default: rig_mesh(), one a visible card).
    """

    def __init__(self, configs: Sequence[GridVisionConfig],
                 rigs_per_fleet: int,
                 devices_per_fleet: Optional[int] = None,
                 params_list: Optional[Sequence[Dict[str, Any]]] = None,
                 extrinsics_list: Optional[Sequence[Extrinsics]] = None,
                 seed: int = 0, mesh: Optional[RigMesh] = None):
        mesh = mesh or rig_mesh()
        g = len(configs)
        if g == 0:
            raise ValueError("need at least one fleet config")
        per = devices_per_fleet or mesh.size // g
        if per <= 0 or g * per > mesh.size:
            raise ValueError(f"{g} fleets x {per} shards exceeds "
                             f"{mesh.size}")
        self.device_groups = [tuple(mesh.devices[i * per:(i + 1) * per])
                              for i in range(g)]
        self.fleets: List[Fleet] = [
            Fleet(cfg, n_rigs=rigs_per_fleet,
                  mesh=RigMesh(self.device_groups[i]),
                  params=params_list[i] if params_list else None,
                  extrinsics=extrinsics_list[i] if extrinsics_list else None,
                  seed=seed + i)
            for i, cfg in enumerate(configs)]
        self.streams = [torch.cuda.Stream(f.device)
                        if f.device.type == "cuda" else None
                        for f in self.fleets]

    @property
    def n_fleets(self) -> int:
        return len(self.fleets)

    def init_states(self, seed: int = 0) -> List[GridState]:
        return [f.init_states(seed + 100 * i)
                for i, f in enumerate(self.fleets)]

    def shard_obs(self, obs_list: Sequence[Obs]) -> List[Obs]:
        return [f.shard_obs(o) for f, o in zip(self.fleets, obs_list)]

    def _each(self, call, *args_lists) -> list:
        """call(fleet, *args) for every fleet, each on its own stream (on
        CUDA), all issued before the caller's stream waits for them."""
        results = []
        for f, stream, *args in zip(self.fleets, self.streams, *args_lists):
            if stream is None:
                results.append(call(f, *args))
                continue
            caller = torch.cuda.current_stream(f.device)
            stream.wait_stream(caller)
            for a in args:
                # the inputs were made on the caller's stream: keep their
                # memory from being reused while this stream reads them
                _map(a, lambda t: t.record_stream(stream))
            with torch.cuda.stream(stream):
                results.append(call(f, *args))
        for f, stream in zip(self.fleets, self.streams):
            if stream is not None:
                torch.cuda.current_stream(f.device).wait_stream(stream)
        return results

    def step_all(self, states_list: Sequence[GridState],
                 obs_list: Sequence[Obs]):
        """One tick of every fleet, every fleet issued before any result is
        handed back. Returns (states_list, outs_list)."""
        results = self._each(lambda f, s, o: f(s, o), states_list, obs_list)
        return [r[0] for r in results], [r[1] for r in results]

    def run_all(self, states_list: Sequence[GridState],
                obs_list: Sequence[Obs], steps: int) -> List[GridState]:
        """`steps` ticks a fleet (Fleet.run), each fleet's on its
        stream."""
        return self._each(lambda f, s, o: f.run(s, o, steps), states_list,
                          obs_list)

    def telemetry(self, outs_list) -> Dict[str, Any]:
        """Per-fleet saturation telemetry summed over rigs (host ints)."""
        agg = {}
        for i, outs in enumerate(outs_list):
            sat = outs.saturation
            agg[f"fleet{i}"] = {
                "prenms_overflow": int(sat.prenms_overflow.sum()),
                "orientation_clamped": int(sat.orientation_clamped.sum()),
                "orientation_dropped": int(sat.orientation_dropped.sum()),
                "boxes": int(outs.boxes.valid.sum()),
            }
        return agg
