"""Minimal PNG encode/decode (stdlib zlib only) for the HTTP viewer (a
copy of grid_vision_tpu/io/png.py: the same bytes).

The reference leans on RViz/cv_bridge for image surfaces; this repo's
image pipeline is numpy end-to-end, and the only consumer needing a
browser-renderable format is the live viewer's HTTP mode. Encoder emits
8-bit RGB (color type 2) with filter 0 on every row; the decoder handles
exactly what the encoder produces (round-trip tested) — it exists for
tests, not as a general PNG reader.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_rgb(image: np.ndarray, compress_level: int = 1) -> bytes:
    """(H, W, 3) uint8 (or float [0,255], clipped) -> PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    # filter byte 0 prepended to every row
    raw = np.empty((h, 1 + w * 3), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * 3)
    idat = zlib.compress(raw.tobytes(), compress_level)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def decode_rgb(data: bytes) -> np.ndarray:
    """Inverse of encode_rgb (8-bit RGB, filter 0 rows only)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("decoder handles 8-bit RGB only")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    raw = raw.reshape(h, 1 + w * 3)
    if (raw[:, 0] != 0).any():
        raise ValueError("decoder handles filter-0 rows only")
    return raw[:, 1:].reshape(h, w, 3).copy()
