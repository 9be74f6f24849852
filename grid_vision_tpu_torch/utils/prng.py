"""The JAX package's PRNG keys on torch tensors: ``jax.random.PRNGKey`` and
``jax.random.split`` for the raw ``(2,)`` uint32 threefry2x32 key layout,
bit-equal to JAX's default implementation with
``jax_threefry_partitionable=True`` (the default since JAX 0.5).

torch's uint32 has few ops, so the arithmetic runs in int64 masked to 32
bits; keys go in and come out as uint32 tensors. Every function takes keys
with any leading batch shape (one key per rig on the fleet path).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on int64 tensors holding
    uint32 values; k1/k2 broadcast against x1/x2. Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


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


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.uniform(key, shape): f32 in [0, 1), (..., 2) keys ->
    (..., *shape). The partitionable bits: element i (row-major flat
    index) hashes the 64-bit counter i, its 32 bits are the two output
    words xor-ed; the top 23 of them become the mantissa of a float in
    [1, 2), minus 1."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    k = key.to(torch.int64)
    k1, k2 = k[..., 0:1], k[..., 1:2]                 # (..., 1)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    mantissa = ((y1 ^ y2) >> 9) | 0x3F800000          # < 2**31
    f = mantissa.to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(key.shape[:-1] + shape)
