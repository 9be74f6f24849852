"""Rig fleet: N independent sensor rigs stepping together (counterpart of
grid_vision_tpu/parallel/fleet.py; BASELINE.json configs[4], "64 simulated
sensor rigs stepping independent grids in parallel").

The JAX package vmaps the fused step over a leading rig axis and shards the
rigs over a 1-D device mesh with zero cross-device collectives. The port
runs pipeline.fleet_step, which carries the rig axis through every stage
and launches each kernel once a tick with the rig batch as its grid. The
rigs split over the logical shards of a RigMesh (parallel/mesh.py): the
whole-fleet tensors (states, observations, outputs) live on the mesh's
first device, and a shard on another device works on a copy of its rigs'
slice. Where the result does not depend on the shard count (__call__, run,
tracked_step) consecutive shards on one device run as one batch; the
orientation budget of compacted_step applies per shard, as the JAX
package's shard_map applies it, so there each shard runs alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import pipeline
from ..config import GridVisionConfig
from ..ops import tracking
from ..types import Extrinsics, GridState, Obs, _map
from ..utils import checkpoint
from .mesh import RigMesh, nets_on, rig_mesh


def _cat(parts):
    """Concatenate same-typed values (or tuples of them) along the rig
    axis, in order."""
    first = parts[0]
    if isinstance(first, tuple):
        return tuple(_cat([p[i] for p in parts]) for i in range(len(first)))
    if len(parts) == 1:
        return first
    kw = {}
    for f in dataclasses.fields(first):
        vals = [getattr(p, f.name) for p in parts]
        kw[f.name] = (torch.cat(vals) if isinstance(vals[0], torch.Tensor)
                      else _cat(vals))
    return type(first)(**kw)


def rig_slice(value, a: int, b: int, device):
    """Rigs [a, b) of a value with a leading rig axis, on `device` (a view
    when it is already there)."""
    return _map(value, lambda t: t[a:b].to(device))


class Fleet:
    """pipeline.fleet_step over n_rigs rigs, split over a RigMesh's shards
    (default: rig_mesh(), one shard a visible card)."""

    def __init__(self, cfg: GridVisionConfig, n_rigs: int,
                 mesh: Optional[RigMesh] = None,
                 params: Optional[Dict[str, Any]] = None,
                 extrinsics: Optional[Extrinsics] = None, seed: int = 0):
        cfg.validate()
        self.cfg = cfg
        self.n_rigs = n_rigs
        self.mesh = mesh or rig_mesh()
        if n_rigs % self.mesh.size:
            raise ValueError(f"n_rigs {n_rigs} % shards {self.mesh.size} "
                             "!= 0")
        self.device = self.mesh.home
        self.engine = pipeline.Engine(cfg, extrinsics=extrinsics,
                                      params=params, seed=seed,
                                      device=self.device)
        self.params = self.engine.params
        self.extrinsics = self.engine.extrinsics
        self._engines = {self.device: self.engine}

    def _engine(self, dev: torch.device) -> pipeline.Engine:
        """The fleet's nets and extrinsics on a shard's device."""
        eng = self._engines.get(dev)
        if eng is None:
            eng = self._engines[dev] = pipeline.Engine(
                self.cfg, extrinsics=self.extrinsics.to(dev),
                params=nets_on(self.params, dev), device=dev)
        return eng

    def _run(self, parts, fn, *values):
        """fn(engine, *slices) on each (device, a, b) part of the rigs,
        results back on the home device, concatenated in rig order."""
        out = []
        for dev, a, b in parts:
            res = fn(self._engine(dev),
                     *(rig_slice(v, a, b, dev) for v in values))
            out.append(_map_tuple(res, self.device))
        return _cat(out)

    # -- the tick ----------------------------------------------------------
    def __call__(self, states: GridState, obs_batch: Obs):
        """One tick of every rig: fleet_step with no orientation budget,
        which equals each rig's own step (the JAX package's vmap(step)).
        states / obs_batch have a leading rig axis. Returns (states',
        StepOutput with a rig axis)."""
        return self._run(self.mesh.groups(self.n_rigs),
                         lambda e, s, o: e.fleet(s, o), states, obs_batch)

    def compacted_step(self, states: GridState, obs_batch: Obs,
                       budget_per_rig: int = 5):
        """One tick through fleet_step per shard with the fleet-compacted
        orientation budget budget_per_rig x the shard's rigs (the JAX
        package's shard_map of fleet_step; the bench's headline path).
        Equals __call__ when the budget covers each shard's load."""
        local = self.n_rigs // self.mesh.size
        return self._run(self.mesh.shards(self.n_rigs),
                         lambda e, s, o: e.fleet(s, o,
                                                 budget_per_rig * local),
                         states, obs_batch)

    def run(self, states: GridState, obs_batch: Obs, steps: int):
        """`steps` ticks on the same observations; only the final states
        are returned (the JAX package's lax.scan, whose per-step outputs
        are not materialized)."""
        for _ in range(steps):
            states, _out = self(states, obs_batch)
        return states

    # -- per-rig multi-object tracking (ops/tracking.py) -------------------
    def init_tracks(self, tcfg: Optional[tracking.TrackConfig] = None
                    ) -> tracking.TrackState:
        """An empty track table a rig, stacked on the rig axis."""
        return tracking.TrackState.create(tcfg or tracking.TrackConfig(),
                                          self.device, rigs=self.n_rigs)

    def tracked_step(self, states: GridState,
                     tracks: tracking.TrackState, obs_batch: Obs,
                     dt=0.05, tcfg: Optional[tracking.TrackConfig] = None):
        """The tick, then the rig-batched tracker: each rig carries its own
        track table (ids are per-rig streams), as the JAX package's
        vmap(step_tracked). Returns (states', tracks', outs, TrackStats)."""
        tcfg = tcfg or tracking.TrackConfig()
        states, outs = self(states, obs_batch)
        tracks, stats = tracking.update_tracks(tracks, outs, dt, self.cfg,
                                               tcfg)
        return states, tracks, outs, stats

    def forecast(self, tracks: tracking.TrackState, horizons,
                 tcfg: Optional[tracking.TrackConfig] = None
                 ) -> torch.Tensor:
        """Predictive occupancy a rig (ops/tracking.forecast_occupancy),
        exported as int8 0..100 on the occupancy_i8 raster (probability x
        100, rounded half to even as jnp.round rounds). Returns (R, K, H,
        W) int8 for K horizons (seconds)."""
        p = tracking.forecast_occupancy(tracks, horizons, self.cfg,
                                        tcfg or tracking.TrackConfig())
        return torch.round(p * 100.0).to(torch.int8)

    # -- states ------------------------------------------------------------
    def init_states(self, seed: int = 0) -> GridState:
        """Stacked states; rig r's PRNG stream is PRNGKey(seed + r)."""
        return GridState.create_batch(self.cfg, self.n_rigs, seed,
                                      device=self.device)

    def shard_obs(self, obs_batch: Obs) -> Obs:
        """The observation batch on the fleet's device."""
        return obs_batch.to(self.device)

    # -- checkpoint / resume (the whole fleet's grids) ---------------------
    def save_states(self, states: GridState, path: str) -> None:
        checkpoint.save(path, states)

    def restore_states(self, path: str) -> GridState:
        return checkpoint.restore(path, self.init_states())


def _map_tuple(res, device):
    """A value, or a tuple of values, on `device`."""
    if isinstance(res, tuple):
        return tuple(_map_tuple(r, device) for r in res)
    return res.to(device)
