"""Sensor recording + deterministic playback: the rosbag equivalent
(counterpart of grid_vision_tpu/runtime/record.py; the same .gvr format,
so a recording made by either package plays in the other).

A recording is a flat file of packed-wire observations
(types.Obs.pack_bytes, the single-buffer format the streaming ingest
uses), so a recording IS a stream: playback re-drives the engine byte for
byte through `Engine.call_packed` / `call_packed_chunk` with no
re-rendering.

File layout (little-endian):
    magic  b"GVR1"
    u32    header_json_len
    bytes  header json: {"config": {...full GridVisionConfig...},
                         "frame_nbytes": N}
    repeat:  u64 stamp_ns | frame (frame_nbytes raw packed obs)

The config travels WITH the data (like a bag's connection records), so
playback reconstructs the exact unpack geometry; a frame's byte size is
fixed by the config, making the file random-access (frame i at
header_end + i * (8 + frame_nbytes)).

CLI:
    python -m grid_vision_tpu_torch record --out traffic.gvr --steps 200
    python -m grid_vision_tpu_torch play traffic.gvr [--chunk 8] [--cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from ..config import GridVisionConfig
from ..types import Obs

MAGIC = b"GVR1"
_LEN = struct.Struct("<I")
_STAMP = struct.Struct("<Q")


class RecordWriter:
    """Append packed observations to a .gvr file."""

    def __init__(self, path: str, cfg: GridVisionConfig):
        self.cfg = cfg
        self.frame_nbytes = Obs.packed_nbytes(cfg)
        self._f = open(path, "wb")
        header = json.dumps({
            "config": dataclasses.asdict(cfg),
            "frame_nbytes": self.frame_nbytes,
        }).encode()
        self._f.write(MAGIC)
        self._f.write(_LEN.pack(len(header)))
        self._f.write(header)
        self.n_frames = 0

    def write(self, packed: np.ndarray, stamp_ns: int = 0) -> None:
        buf = np.ascontiguousarray(packed, np.uint8)
        if buf.nbytes != self.frame_nbytes:
            raise ValueError(f"frame is {buf.nbytes} bytes, recording "
                             f"expects {self.frame_nbytes}")
        self._f.write(_STAMP.pack(stamp_ns))
        self._f.write(buf.tobytes())
        self.n_frames += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Random-access reader over a .gvr file."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a GVR recording")
        (hlen,) = _LEN.unpack(self._f.read(4))
        header = json.loads(self._f.read(hlen))
        # validate at open time: a hand-edited/corrupt header should be
        # a clean ValueError here, not a cryptic unpack failure later
        self.cfg = GridVisionConfig(**header["config"]).validate()
        self.frame_nbytes = int(header["frame_nbytes"])
        if self.frame_nbytes != Obs.packed_nbytes(self.cfg):
            raise ValueError("frame size does not match recorded config")
        self._data_off = 8 + hlen
        self._rec = _STAMP.size + self.frame_nbytes
        size = os.fstat(self._f.fileno()).st_size
        self.n_frames = (size - self._data_off) // self._rec

    def read(self, i: int) -> Tuple[np.ndarray, int]:
        if not (0 <= i < self.n_frames):
            raise IndexError(i)
        self._f.seek(self._data_off + i * self._rec)
        stamp = _STAMP.unpack(self._f.read(_STAMP.size))[0]
        buf = np.frombuffer(self._f.read(self.frame_nbytes), np.uint8)
        return buf, stamp

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        for i in range(self.n_frames):
            yield self.read(i)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def record_scene(path: str, cfg: GridVisionConfig, n_steps: int,
                 hz: float = 10.0, seed: int = 0) -> int:
    """Record a synthetic-scene drive (the demo data source)."""
    from ..io.scene import SyntheticScene
    from .stream import packed_from_scene

    scene = SyntheticScene(cfg, seed=seed)
    scene.add_default_traffic()
    with RecordWriter(path, cfg) as w:
        for i in range(n_steps):
            t = i / hz
            buf, _ = packed_from_scene(scene, t, cfg)
            w.write(buf, stamp_ns=int(t * 1e9))
        return w.n_frames


def play(path: str, chunk: int = 8, session: Optional[str] = None,
         on_step=None, grid_out: Optional[str] = None, device="cuda",
         base_dir: str = "."):
    """Drive an engine on `device` (the card unless the CPU is asked for)
    from a recording (chunked ingest: `chunk` frames a host->device
    copy). Returns (n_frames, final GridState). session=NAME publishes
    grid / markers (runtime/session.py). grid_out=FILE.gvg records the
    output occupancy stream (io/grid_codec keyframe + delta records, the
    output-side bag). base_dir: where the config's weight files are
    looked up."""
    from ..demo import default_extrinsics
    from ..pipeline import Engine

    with RecordReader(path) as r:
        eng = Engine(r.cfg, extrinsics=default_extrinsics(device),
                     device=device, base_dir=base_dir)
        state = eng.init_state()
        pub = None
        if session is not None:
            from .session import SessionPublisher
            pub = SessionPublisher(session, r.cfg)
        gw = None
        if grid_out is not None:
            from ..io.grid_codec import GridRecordWriter
            gw = GridRecordWriter(grid_out)
        n = 0
        if pub is None and on_step is None and gw is None:
            while n < r.n_frames:
                k = min(chunk, r.n_frames - n)
                bufs = np.stack([r.read(n + j)[0] for j in range(k)])
                state, _outs = eng.call_packed_chunk(state, bufs)
                n += k
        else:
            for buf, stamp in r:
                state, out = eng.call_packed(state, buf)
                if pub is not None:
                    pub.publish(n, out)
                if gw is not None:
                    gw.write(out.occupancy_i8.cpu().numpy(), step=n,
                             stamp_ns=stamp)
                if on_step is not None:
                    on_step(n, state, out)
                n += 1
        if pub is not None:
            pub.close()
        if gw is not None:
            gw.close()
        return n, state
