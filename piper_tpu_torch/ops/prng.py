"""JAX's threefry random streams, in PyTorch.

The port's own copy of the `jax.random` functions the JAX package draws
its noise with, written against JAX 0.9's sources (jax/_src/prng.py,
jax/_src/random.py) with `jax_threefry_partitionable` on (its default)
and 64-bit mode off (its default):

  prng_key(seed)        threefry_seed (prng.py:802)
  fold_in(key, data)    threefry_fold_in (prng.py:1168)
  split(key, n)         _threefry_split_foldlike (prng.py:1143-1160)
  random_bits(key, s)   _threefry_random_bits_partitionable (prng.py:1184)
  uniform(key, s, ...)  _uniform (random.py:435)
  normal(key, s)        _normal_real (random.py:867)

With partitionable threefry every element's bits are a pure function of
(key, flat index): threefry2x32 of the key and the index's high and low
32 bits, the two output words xor-ed. So every function here is
elementwise integer arithmetic, which runs alike on the CPU and on the
card, inside a CUDA graph too, and a row's numbers never depend on the
rows beside it.

A key is an int64 tensor of shape (..., 2) holding two uint32 words.
Every function takes a batch of keys, (*K, 2), and returns (*K, *shape):
each key draws its own stream. All arithmetic is int64 masked to 32
bits, since torch's uint32 lacks arithmetic on CUDA. The bits and the
uniforms are exact; `normal` follows XLA's erf_inv polynomial, but XLA
fuses each of its steps into one rounding and its log1p is its own, so
a normal may differ by a float32 ulp (at most 4.8e-7 over 10^6 draws
on the CPU).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# nextafter(-1, 0) in float32: the lower end of normal's uniforms
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA's float32 erf_inv (Giles' approximation, as StableHLO's CHLO
# decomposition writes it): Horner coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)

Shape = Union[int, Sequence[int]]


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (prng.py:883-935, unrolled). Every input
    is an int64 tensor of uint32 values (they broadcast together) or a
    Python int: one key's hash is cheapest on the host in ints."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) with 64-bit mode off: the seed's low 32
    bits, after a zero word."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: threefry of the count (0, data) under `key`.
    `data` is an int or an integer tensor that broadcasts against the
    keys' batch shape; the result has the broadcast shape plus (2,)."""
    if isinstance(data, int):  # a fill, not a host copy: capturable
        data = torch.full((), data & MASK, dtype=torch.int64, device=key.device)
    else:
        data = data.to(device=key.device, dtype=torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counters(key: torch.Tensor, shape: Tuple[int, ...]):
    """Each key's words and the (high, low) words of the flat index of
    every element of `shape`, broadcast to (*K, *shape)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device).reshape(shape)
    lift = (...,) + (None,) * len(shape)
    return key[..., 0][lift], key[..., 1][lift], idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split, foldlike: key i is threefry of the count i.
    (*K, 2) -> (*K, num, 2)."""
    k0, k1, hi, lo = _counters(key, (num,))
    return torch.stack(threefry2x32(k0, k1, hi, lo), dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (partitionable: the two words of
    threefry of the flat index, xor-ed). (*K, 2) -> (*K, *shape) int64."""
    b1, b2 = threefry2x32(*_counters(key, (shape,) if isinstance(shape, int) else tuple(shape)))
    return b1 ^ b2


def uniform(
    key: torch.Tensor, shape: Shape, minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """jax.random.uniform in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference in float32, as XLA computes them
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp(floats * span + float(lo), min=float(lo))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: w = -log1p(-x^2), a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1. Each Horner
    step rounds once, as the fused multiply-add XLA emits does (computed
    in float64, then rounded): plain float32 steps miss XLA by up to
    7.2e-7, these by 4.8e-7, torch.erfinv (another approximation) by
    2e-5 in the tails."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b)))
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """jax.random.normal in float32: sqrt(2) * erf_inv(u) for u uniform
    on [nextafter(-1, 0), 1)."""
    return erfinv(uniform(key, shape, _NORMAL_LO, 1.0)) * _SQRT2
