"""Occupancy-grid delta codec: keyframe + sparse-delta streaming (a copy
of grid_vision_tpu/io/grid_codec.py, kept here so this package never
imports the JAX package; the records are byte-compatible).

The reference publishes the FULL nav_msgs/OccupancyGrid every tick
(grid_vision_node.cpp:265-278) — 100 kB/tick at the default 500x200
grid, which is fine on an intra-host DDS loop but dominates the wire
for any remote consumer. Between ticks
the int8 occupancy image barely changes: in steady state most cells sit
at the decay clamp (occupancy 12, sigmoid(-2.0)) or at the prior, and
only cells under recent footprints move. This module exploits that with
a two-record stream:

  keyframe  byte-RLE of the full grid (self-contained; late joiners and
            gap recovery start here). Grids RLE extremely well: the
            500x200 demo grid keyframes at ~1-3 kB.
  delta     changed-span patch against the PREVIOUS grid: merged runs
            of changed cells as (start, length) spans + raw new bytes.
            Typical demo-scene deltas are 200-900 bytes (100-500x below
            the raw grid).

Record layout (little-endian), shared header then payload:
    u8  kind (0=keyframe, 1=delta)   u8 pad
    u16 reserved
    u32 seq        monotone stream sequence; a delta applies to seq-1
    u32 rows, cols
    u32 step       engine step number
    u64 stamp_ns
  keyframe payload:  u32 n_runs | u8 value[n_runs] | u32 run[n_runs]
  delta payload:     u32 n_spans | u32 start[n] | u32 len[n] | bytes

Decoding is exact: GridDeltaDecoder reproduces the encoder's input
byte-for-byte (tested against random and engine-produced streams). A
decoder that misses records (latest-wins transports, lossy links)
detects the sequence gap and waits for the next keyframe.

Consumers: GridRecordWriter/-Reader persist the stream as a .gvg file
(the output-side companion of the .gvr sensor recording,
runtime/record.py, `play --grid-out`).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

_HDR = struct.Struct("<BBHIIIIQ")  # kind, pad, rsvd, seq, rows, cols, step, stamp
KEYFRAME = 0
DELTA = 1

# Spans closer than this are merged into one: 8 bytes of span bookkeeping
# buys fewer, longer contiguous patches (and numpy-friendly decode).
_GAP_MERGE = 16


def _rle_encode(flat_u8: np.ndarray) -> bytes:
    """Byte run-length encode (vectorized): values + u32 run lengths."""
    n = flat_u8.size
    if n == 0:
        return struct.pack("<I", 0)
    change = np.flatnonzero(np.diff(flat_u8)) + 1
    starts = np.concatenate([[0], change])
    runs = np.diff(np.concatenate([starts, [n]])).astype(np.uint32)
    values = flat_u8[starts]
    return (struct.pack("<I", values.size) + values.tobytes()
            + runs.tobytes())


def _rle_decode(payload: memoryview, n_cells: int) -> np.ndarray:
    (n_runs,) = struct.unpack_from("<I", payload, 0)
    o = 4
    values = np.frombuffer(payload, np.uint8, n_runs, o)
    o += n_runs
    runs = np.frombuffer(payload, np.uint32, n_runs, o)
    out = np.repeat(values, runs)
    if out.size != n_cells:
        raise ValueError(f"keyframe decodes to {out.size} cells, "
                         f"expected {n_cells}")
    return out


def _delta_spans(prev: np.ndarray, cur: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Merged (start, length) spans covering every differing byte."""
    idx = np.flatnonzero(prev != cur)
    if idx.size == 0:
        z = np.zeros(0, np.uint32)
        return z, z
    brk = np.flatnonzero(np.diff(idx) > _GAP_MERGE)
    starts = idx[np.concatenate([[0], brk + 1])]
    ends = idx[np.concatenate([brk, [idx.size - 1]])] + 1
    return starts.astype(np.uint32), (ends - starts).astype(np.uint32)


class GridDeltaEncoder:
    """Stateful encoder. encode() returns one record; emits a keyframe
    first, after every `keyframe_interval` records, on shape change, or
    when the delta would not be smaller than a keyframe."""

    def __init__(self, keyframe_interval: int = 32):
        if keyframe_interval < 1:
            raise ValueError("keyframe_interval must be >= 1")
        self.keyframe_interval = keyframe_interval
        self._prev: Optional[np.ndarray] = None
        self._shape: Optional[Tuple[int, int]] = None
        self._seq = 0
        self._since_key = 0

    def encode(self, grid_i8: np.ndarray, step: int = 0,
               stamp_ns: int = 0) -> bytes:
        g = np.ascontiguousarray(grid_i8, np.int8)
        if g.ndim != 2:
            raise ValueError(f"grid must be 2D, got {g.shape}")
        flat = g.reshape(-1).view(np.uint8)
        rows, cols = g.shape
        want_key = (self._prev is None or self._shape != (rows, cols)
                    or self._since_key >= self.keyframe_interval)
        seq = self._seq
        hdr = lambda kind: _HDR.pack(kind, 0, 0, seq, rows, cols,
                                     step, stamp_ns)
        if not want_key:
            starts, lens = _delta_spans(self._prev, flat)
            payload = (struct.pack("<I", starts.size) + starts.tobytes()
                       + lens.tobytes()
                       + b"".join(flat[s:s + l].tobytes()
                                  for s, l in zip(starts, lens)))
            key_payload = _rle_encode(flat)
            if len(payload) < len(key_payload):
                rec = hdr(DELTA) + payload
                self._since_key += 1
            else:
                want_key = True
        if want_key:
            rec = hdr(KEYFRAME) + _rle_encode(flat)
            self._since_key = 0
        self._prev = flat.copy()
        self._shape = (rows, cols)
        self._seq += 1
        return rec


class GridDeltaDecoder:
    """Stateful decoder. decode() returns (grid_i8, step, stamp_ns) or
    None when the record cannot be applied (sequence gap after missed
    records — recovery is automatic at the next keyframe)."""

    def __init__(self):
        self._prev: Optional[np.ndarray] = None
        self._shape: Optional[Tuple[int, int]] = None
        self._seq: Optional[int] = None

    def decode(self, record: bytes
               ) -> Optional[Tuple[np.ndarray, int, int]]:
        mv = memoryview(record)
        kind, _p, _r, seq, rows, cols, step, stamp = _HDR.unpack_from(mv)
        payload = mv[_HDR.size:]
        n_cells = rows * cols
        if kind == KEYFRAME:
            flat = _rle_decode(payload, n_cells).copy()
        elif kind == DELTA:
            if (self._prev is None or self._seq != seq - 1
                    or self._shape != (rows, cols)):
                self._seq = None   # gap: drop until the next keyframe
                return None
            (n_spans,) = struct.unpack_from("<I", payload, 0)
            o = 4
            starts = np.frombuffer(payload, np.uint32, n_spans, o)
            o += 4 * n_spans
            lens = np.frombuffer(payload, np.uint32, n_spans, o)
            o += 4 * n_spans
            # Validate the WHOLE record before touching decoder state: a
            # truncated/corrupt record must not leave _prev half-patched
            # at an unchanged _seq (a later well-formed delta would then
            # apply cleanly onto corrupt state with no gap detected).
            total = int(lens.sum(dtype=np.int64))
            if (o + total != len(payload)
                    or (n_spans and int((starts.astype(np.int64)
                                         + lens).max()) > n_cells)):
                raise ValueError(
                    "corrupt delta record: spans exceed payload/grid")
            flat = self._prev
            for s, l in zip(starts, lens):
                flat[s:s + l] = np.frombuffer(payload, np.uint8, l, o)
                o += int(l)
        else:
            raise ValueError(f"unknown record kind {kind}")
        self._prev = flat
        self._shape = (rows, cols)
        self._seq = seq
        return flat.view(np.int8).reshape(rows, cols).copy(), step, stamp


def read_record_header(record: bytes) -> Tuple[int, int, int, int, int, int]:
    """(kind, seq, rows, cols, step, stamp_ns) of one record."""
    kind, _p, _r, seq, rows, cols, step, stamp = _HDR.unpack_from(record)
    return kind, seq, rows, cols, step, stamp


# ----------------------------------------------------------------------
# .gvg grid-stream recording: the OUTPUT-side companion of the .gvr
# sensor recording. File = magic + length-prefixed codec records.
# ----------------------------------------------------------------------

GVG_MAGIC = b"GVG1"
_RECLEN = struct.Struct("<I")


class GridRecordWriter:
    """Persist an engine's occupancy stream as keyframe+delta records."""

    def __init__(self, path: str, keyframe_interval: int = 32):
        self._f = open(path, "wb")
        self._f.write(GVG_MAGIC)
        self._enc = GridDeltaEncoder(keyframe_interval)
        self.n_records = 0

    def write(self, grid_i8: np.ndarray, step: int = 0,
              stamp_ns: int = 0) -> None:
        rec = self._enc.encode(grid_i8, step, stamp_ns)
        self._f.write(_RECLEN.pack(len(rec)))
        self._f.write(rec)
        self.n_records += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GridRecordReader:
    """Iterate (grid_i8, step, stamp_ns) out of a .gvg file."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(4) != GVG_MAGIC:
            raise ValueError(f"{path}: not a GVG grid recording")
        self.nbytes = os.fstat(self._f.fileno()).st_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int, int]]:
        dec = GridDeltaDecoder()
        while True:
            raw = self._f.read(_RECLEN.size)
            if len(raw) < _RECLEN.size:
                return
            (n,) = _RECLEN.unpack(raw)
            rec = self._f.read(n)
            if len(rec) < n:
                raise ValueError("truncated .gvg record")
            out = dec.decode(rec)
            if out is not None:   # a well-formed file never gaps
                yield out

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
