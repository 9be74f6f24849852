"""ctypes binding for the native host runtime (runtime_cc/, the repo's
host library; this package keeps its own copy of the JAX package's
binding, grid_vision_tpu/runtime/native.py, and imports nothing of it).

Provides the C++ implementations of the host-side hot path — sensor
mailboxes (the reference's latest-wins DDS buffers), PointCloud2-style
binary packing into the engine's fixed-capacity layout, a second
independent grid oracle for parity checks, and PGM snapshot export.

The library is built lazily from runtime_cc/gridvision_host.cpp on first
use, into this package's own build directory (build/grid_vision_tpu_torch/,
named by a hash of the source): a process that also loads the JAX package's
binding then holds two copies of the library, so the two packages' mailbox
slots and shared-memory handles never mix. Everything degrades to
pure-NumPy fallbacks when no compiler is available. All of it is host
code: no device is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO_ROOT, "runtime_cc", "gridvision_host.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "grid_vision_tpu_torch")
# runtime_cc/Makefile's flags
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++20", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False

PAD_SENTINEL = 1.0e8


def _so_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_CXXFLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libgridvision_host-{digest.hexdigest()[:12]}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        so = _so_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS,
                            "-o", tmp, _SOURCE], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, so)
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    lib.gv_mailbox_write.restype = ctypes.c_uint64
    lib.gv_mailbox_write.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_uint64]
    lib.gv_mailbox_read.restype = ctypes.c_int64
    lib.gv_mailbox_read.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.gv_mailbox_seq.restype = ctypes.c_uint64
    lib.gv_mailbox_seq.argtypes = [ctypes.c_int]
    lib.gv_pack_cloud.restype = ctypes.c_int64
    lib.gv_pack_cloud.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.gv_pack_cloud_transform.restype = ctypes.c_int64
    lib.gv_pack_cloud_transform.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]
    lib.gv_grid_update.restype = None
    lib.gv_grid_update.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.gv_write_pgm.restype = ctypes.c_int
    lib.gv_write_pgm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int8), ctypes.c_int,
        ctypes.c_int]
    lib.gv_shm_open.restype = ctypes.c_int
    lib.gv_shm_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int]
    lib.gv_shm_capacity.restype = ctypes.c_int64
    lib.gv_shm_capacity.argtypes = [ctypes.c_int]
    lib.gv_shm_write.restype = ctypes.c_int64
    lib.gv_shm_write.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_uint64]
    lib.gv_shm_read.restype = ctypes.c_int64
    lib.gv_shm_read.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    lib.gv_shm_close.restype = None
    lib.gv_shm_close.argtypes = [ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# Mailboxes
# ---------------------------------------------------------------------------

class Mailbox:
    """Latest-wins frame buffer (the reference's imageCallback /
    cloudCallback overwrite semantics, grid_vision_node.cpp:79-106)."""

    _next_id = 0

    def __init__(self):
        lib = _load()
        if lib is None:
            self._frame = None
            self._seq = 0
            self._id = -1
        else:
            self._id = Mailbox._next_id
            Mailbox._next_id += 1
            if self._id >= 64:
                raise RuntimeError("too many native mailboxes")
        self._lib = lib

    def write(self, data: bytes, stamp_ns: int = 0) -> int:
        if self._lib is None:
            self._frame = (bytes(data), stamp_ns)
            self._seq += 1
            return self._seq
        buf = np.frombuffer(data, np.uint8)
        return self._lib.gv_mailbox_write(self._id, _u8ptr(buf), len(buf),
                                          stamp_ns)

    def read(self):
        """Returns (bytes, stamp_ns) of the latest frame, or None."""
        if self._lib is None:
            return self._frame
        size = self._lib.gv_mailbox_read(
            self._id, ctypes.POINTER(ctypes.c_uint8)(), -1,
            ctypes.POINTER(ctypes.c_uint64)())
        if size <= 0:
            return None
        out = np.empty(size, np.uint8)
        stamp = ctypes.c_uint64(0)
        n = self._lib.gv_mailbox_read(self._id, _u8ptr(out), size,
                                      ctypes.byref(stamp))
        if n <= 0:
            return None
        return out.tobytes(), stamp.value

    @property
    def seq(self) -> int:
        if self._lib is None:
            return self._seq
        return self._lib.gv_mailbox_seq(self._id)


# ---------------------------------------------------------------------------
# Named shared-memory mailboxes (cross-process)
# ---------------------------------------------------------------------------

_SHM_MAGIC = 0x4756534853454D31  # "GVSHSEM1"
_SHM_HEADER = 64
_SHM_TABLE_FULL = -6             # gv_shm_open: the handle table is full


def shm_path(session: str, channel: str) -> str:
    """Canonical mailbox path for a (session, channel) pair."""
    base = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
    return os.path.join(base, f"gv_{session}.{channel}.mbx")


class ShmMailbox:
    """Cross-process latest-wins mailbox: a file-backed seqlock buffer
    (usually in /dev/shm) with the same semantics as Mailbox, reachable
    from ANY process — the transport of the session channels
    (runtime/session.py: the engine publishes grid/markers/overlay; a
    viewer attaches) and multi-process sensor producers.

    Uses the native seqlock implementation when the library is built; the
    pure-Python mmap fallback implements the identical 64-byte-header
    layout, so native and Python endpoints interoperate freely. The
    library holds 256 mailboxes a process; a mailbox beyond them takes the
    Python path (a 64-rig fleet server alone holds 128 sensor mailboxes and
    two or three session channels a rig).
    """

    def __init__(self, path: str, capacity: int = 0, create: bool = False):
        self.path = path
        self._h = -1
        self._mm = None
        lib = _load()
        if lib is not None:
            h = lib.gv_shm_open(path.encode(), capacity, 1 if create else 0)
            if h >= 0:
                self._h = h
                self._lib = lib
                self.capacity = int(lib.gv_shm_capacity(h))
                return
            if h != _SHM_TABLE_FULL:
                raise OSError(f"gv_shm_open({path!r}) failed: {h}")
        # Pure-Python fallback: identical on-disk layout via mmap.
        import mmap
        import struct
        self._struct = struct
        if create:
            if capacity <= 0:
                raise ValueError("capacity required to create")
            with open(path, "wb") as f:
                f.write(b"\0" * (_SHM_HEADER + capacity))
            mode = "r+b"
        else:
            mode = "r+b"
            if not os.path.exists(path):
                raise OSError(f"no mailbox at {path}")
        self._f = open(path, mode)
        self._mm = mmap.mmap(self._f.fileno(), 0)
        self._lib = None
        if create:
            self._mm[24:32] = struct.pack("<q", capacity)
            self._mm[32:40] = struct.pack("<Q", _SHM_MAGIC)
            self.capacity = capacity
        else:
            magic, = struct.unpack("<Q", self._mm[32:40])
            if magic != _SHM_MAGIC:
                raise OSError(f"{path} is not a gridvision mailbox")
            self.capacity, = struct.unpack("<q", self._mm[24:32])

    def write(self, data: bytes, stamp_ns: int = 0) -> int:
        if self._h >= 0:
            buf = np.frombuffer(data, np.uint8)
            rc = self._lib.gv_shm_write(self._h, _u8ptr(buf), len(buf),
                                        stamp_ns)
            if rc < 0:
                raise ValueError(f"shm write failed ({rc}); "
                                 f"payload {len(data)} > {self.capacity}?")
            return int(rc)
        st = self._struct
        if len(data) > self.capacity:
            raise ValueError(f"payload {len(data)} > {self.capacity}")
        mm = self._mm
        seq, = st.unpack("<Q", mm[0:8])
        mm[0:8] = st.pack("<Q", seq + 1)          # odd: writing
        mm[8:16] = st.pack("<q", len(data))
        mm[16:24] = st.pack("<Q", stamp_ns)
        mm[_SHM_HEADER:_SHM_HEADER + len(data)] = data
        mm[0:8] = st.pack("<Q", seq + 2)          # even: stable
        return (seq + 2) // 2

    def read(self, min_seq: int = 0):
        """Latest frame as (bytes, stamp_ns, seq), or None if no frame yet
        or seq <= min_seq (lets pollers skip frames already seen)."""
        if self._h >= 0:
            size = self._lib.gv_shm_read(
                self._h, ctypes.POINTER(ctypes.c_uint8)(), -1,
                ctypes.POINTER(ctypes.c_uint64)(),
                ctypes.POINTER(ctypes.c_uint64)())
            if size <= 0:
                return None
            out = np.empty(size, np.uint8)
            stamp = ctypes.c_uint64(0)
            seq = ctypes.c_uint64(0)
            n = self._lib.gv_shm_read(self._h, _u8ptr(out), size,
                                      ctypes.byref(stamp), ctypes.byref(seq))
            if n <= 0 or seq.value <= min_seq:
                return None
            return out[:n].tobytes(), stamp.value, int(seq.value)
        st = self._struct
        mm = self._mm
        for _ in range(1024):
            s0, = st.unpack("<Q", mm[0:8])
            if s0 == 0:
                return None
            if s0 & 1:
                continue
            size, = st.unpack("<q", mm[8:16])
            stamp, = st.unpack("<Q", mm[16:24])
            data = bytes(mm[_SHM_HEADER:_SHM_HEADER + size])
            s1, = st.unpack("<Q", mm[0:8])
            if s0 == s1:
                if s0 // 2 <= min_seq:
                    return None
                return data, stamp, s0 // 2
        return None

    def close(self) -> None:
        if self._h >= 0:
            self._lib.gv_shm_close(self._h)
            self._h = -1
        if self._mm is not None:
            self._mm.close()
            self._f.close()
            self._mm = None

    def unlink(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Cloud packing
# ---------------------------------------------------------------------------

def pack_cloud(blob: bytes, n_points: int, stride: int, xyz_off: int,
               intensity_off: int, capacity: int,
               transform: Optional[np.ndarray] = None):
    """PointCloud2-style binary -> (xyz (cap,3) f32, intensity (cap,) f32,
    count) packed valid-first with sentinel padding. Optional fused 4x4
    rigid transform (row-major)."""
    lib = _load()
    out_xyz = np.empty((capacity, 3), np.float32)
    out_int = np.empty((capacity,), np.float32)
    if lib is not None:
        buf = np.frombuffer(blob, np.uint8)
        if transform is None:
            n = lib.gv_pack_cloud(_u8ptr(buf), n_points, stride, xyz_off,
                                  intensity_off, _f32ptr(out_xyz),
                                  _f32ptr(out_int), capacity)
        else:
            t = np.ascontiguousarray(transform, np.float32)
            n = lib.gv_pack_cloud_transform(
                _u8ptr(buf), n_points, stride, xyz_off, intensity_off,
                _f32ptr(t), _f32ptr(out_xyz), _f32ptr(out_int), capacity)
        return out_xyz, out_int, int(n)

    # NumPy fallback
    raw = np.frombuffer(blob, np.uint8)[: n_points * stride]
    raw = raw.reshape(n_points, stride)
    xyz = raw[:, xyz_off:xyz_off + 12].copy().view(np.float32)
    inten = (raw[:, intensity_off:intensity_off + 4].copy().view(np.float32)[:, 0]
             if intensity_off >= 0 else np.zeros(n_points, np.float32))
    finite = np.isfinite(xyz).all(axis=1)
    xyz, inten = xyz[finite], np.where(np.isfinite(inten[finite]),
                                       inten[finite], 0.0)
    if transform is not None:
        xyz = xyz @ np.asarray(transform, np.float32)[:3, :3].T + \
            np.asarray(transform, np.float32)[:3, 3]
    n = min(len(xyz), capacity)
    out_xyz.fill(PAD_SENTINEL)
    out_int.fill(0.0)
    out_xyz[:n] = xyz[:n]
    out_int[:n] = inten[:n]
    return out_xyz, out_int, n


# ---------------------------------------------------------------------------
# Native grid oracle + PGM export
# ---------------------------------------------------------------------------

def grid_update_native(log_odds: np.ndarray, boxes: np.ndarray, *,
                       center, length, resolution, decay, hit, lo_min,
                       lo_max):
    """In-place native grid update. boxes: (N, 4) [px, py, length, width].
    Returns (log_odds, occupancy). Raises if the native lib is missing."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    lo = np.ascontiguousarray(log_odds, np.float32)
    occ = np.empty_like(lo)
    b = np.ascontiguousarray(boxes, np.float32)
    lib.gv_grid_update(
        _f32ptr(lo), _f32ptr(occ), lo.shape[0], lo.shape[1],
        float(center[0]), float(center[1]), float(length[0]),
        float(length[1]), float(resolution), _f32ptr(b), b.shape[0],
        float(decay), float(hit), float(lo_min), float(lo_max))
    return lo, occ


def write_pgm(path: str, grid_i8: np.ndarray) -> None:
    """Occupancy int8 [0,100] -> PGM snapshot (occupied = dark)."""
    lib = _load()
    g = np.ascontiguousarray(grid_i8, np.int8)
    if lib is not None:
        rc = lib.gv_write_pgm(path.encode(), g.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int8)), g.shape[0], g.shape[1])
        if rc != 0:
            raise IOError(f"gv_write_pgm failed for {path}")
        return
    vals = g.astype(np.int32)
    px = np.where(vals < 0, 127, 255 - (vals * 255) // 100).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (g.shape[1], g.shape[0]))
        f.write(px.tobytes())
