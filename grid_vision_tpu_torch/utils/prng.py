"""The JAX package's PRNG keys on torch tensors: ``jax.random.PRNGKey``,
``split``, ``fold_in``, ``randint``, ``uniform``, ``normal`` and
``truncated_normal`` for the raw ``(2,)`` uint32 threefry2x32 key layout,
bit-equal to JAX's default implementation with
``jax_threefry_partitionable=True`` (the default since JAX 0.5).

torch's uint32 has few ops, so the arithmetic runs in int64 masked to 32
bits; keys go in and come out as uint32 tensors. Every function takes keys
with any leading batch shape (one key per rig on the fleet path, one per
image of a training batch).

Float draws follow XLA's arithmetic as JAX compiles it: ``uniform``'s
``u * (max - min) + min`` is one fused multiply-add (rounded once, the
product exact in f64), and ``normal`` / ``truncated_normal`` take XLA's f32
inverse error function (``erfinv``: Giles' single-precision polynomial,
its Horner steps fused) rather than torch.erfinv, which differs by up to
~65 ulps.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int32 words left by r (the right shift made logical)."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 -> the int32 with the same bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on int64 tensors holding
    uint32 values; k1/k2 broadcast against x1/x2. Returns (y1, y2) as int64
    holding uint32. The rounds run on int32 words, whose additions wrap
    modulo 2**32."""
    k1, k2, x1, x2 = (_i32(t) for t in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = x1 + ks[0]
    x2 = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + (ks[(i + 2) % 3] + (i + 1))
    return x1.to(torch.int64) & _MASK, x2.to(torch.int64) & _MASK


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the (2,) uint32 key [seed >> 32,
    seed & 0xFFFFFFFF] for a non-negative integer seed."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=device).to(torch.uint32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): (..., 2) uint32 keys -> (..., num, 2).
    The partitionable form: the counter of new key i is the 64-bit i
    (high word 0, low word i), hashed once."""
    k = key.to(torch.int64)
    k1, k2 = k[..., 0:1], k[..., 1:2]                 # (..., 1)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1).to(torch.uint32)


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), (..., 2) keys ->
    (..., *shape). The partitionable bits: element i (row-major flat index)
    hashes the 64-bit counter i, and its bits are the two output words
    xor-ed."""
    shape = tuple(shape)
    k = key.to(torch.int64)
    k1, k2 = k[..., 0:1], k[..., 1:2]                 # (..., 1)
    lo = torch.arange(math.prod(shape), dtype=torch.int64,
                      device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (y1 ^ y2).reshape(key.shape[:-1] + shape)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a uint32 `data`: the key hashes
    the counter (0, data), as split's new key `data` is."""
    k = key.to(torch.int64)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1],
                          torch.zeros_like(k[..., 0]),
                          torch.full_like(k[..., 0], int(data) & _MASK))
    return torch.stack([y1, y2], dim=-1).to(torch.uint32)


def fold_in_str(key: torch.Tensor, *parts) -> torch.Tensor:
    """flax's static fold-in of a module path (``LazyRng``'s suffix of
    names and counters): the SHA-1 of the parts (a name as UTF-8, a counter
    as its minimal big-endian bytes), its first 4 bytes as a big-endian
    uint32 folded in once."""
    m = hashlib.sha1()
    for x in parts:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) (int32, Python int
    bounds): two bit draws from split(key), combined modulo the span by
    the multiplier 2**32 mod span, in uint32 arithmetic."""
    minval, maxval = int(minval), int(maxval)
    keys = split(key)
    hi, lo = _bits(keys[..., 0, :], shape), _bits(keys[..., 1, :], shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (((2 ** 16 % span) ** 2) & _MASK) % span
    # int64 products wrap modulo 2**64, which keeps their low 32 bits
    off = (((hi % span) * mult) & _MASK) + lo % span
    off = (off & _MASK) % span
    return (off + minval).to(torch.int32)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32 (XLA's contracted multiply-add), for f32
    tensors or Python floats b, c: the product of two f32 values is exact in
    f64."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def f32(x) -> float:
    """A Python float as the f32 that XLA computes with."""
    return float(np.float32(x))


def uniform(key: torch.Tensor, shape, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, minval=minval, maxval=maxval): f32 in
    [minval, maxval), (..., 2) keys -> (..., *shape). The top 23 of each
    element's 32 bits become the mantissa of a float in [1, 2), minus 1,
    then max(minval, u * (maxval - minval) + minval), the multiply-add
    fused as jitted XLA computes it. minval / maxval: Python floats or
    f32 tensors that broadcast against the result."""
    bits = _bits(key, shape)
    mantissa = (bits >> 9) | 0x3F800000               # < 2**31
    f = mantissa.to(torch.int32).view(torch.float32) - 1.0
    if isinstance(minval, float) and isinstance(maxval, float) \
            and (minval, maxval) == (0.0, 1.0):
        return f
    if not isinstance(minval, torch.Tensor):
        minval = torch.full((), f32(minval), dtype=torch.float32,
                            device=key.device)
    if not isinstance(maxval, torch.Tensor):
        maxval = torch.full((), f32(maxval), dtype=torch.float32,
                            device=key.device)
    span = maxval - minval
    return torch.maximum(minval, fma(f, span, minval))


# XLA's f32 erf_inv (Giles, "Approximating the erfinv function"): w < 5
# and w >= 5 polynomial coefficients, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 inverse error function: w = -log1p(-x * x) (the product
    fused), then a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3,
    Horner steps fused, times x; +-inf at +-1. Within 2 ulps of jitted
    JAX on the CPU (its log1p is an approximation; here f64 rounded)."""
    w = -torch.log1p(fma(-x, x, 0.0).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    # each coefficient is an f32 value: torch.where of two Python floats
    # builds it on the card without a host copy
    coef = [torch.where(small, f32(a), f32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = fma(p, w, c)
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


_SQRT2 = f32(math.sqrt(2.0))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal(key, shape) in f32: sqrt(2) * erfinv(u), u uniform
    in [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * erfinv(uniform(key, shape, lo, 1.0))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape) -> torch.Tensor:
    """jax.random.truncated_normal(key, lower, upper, shape) in f32: u
    uniform between erf(lower / sqrt 2) and erf(upper / sqrt 2), sqrt(2) *
    erfinv(u), clipped to the open interval (lower, upper)."""
    lo, hi = f32(lower), f32(upper)
    a = f32(math.erf(f32(lo / _SQRT2)))
    b = f32(math.erf(f32(hi / _SQRT2)))
    out = _SQRT2 * erfinv(uniform(key, shape, a, b))
    return torch.clamp(out, float(np.nextafter(np.float32(lo), np.inf)),
                       float(np.nextafter(np.float32(hi), -np.inf)))
