"""Bit-exact `jax.random` threefry2x32 in torch integer math, on any device.

Generation draws each stream's step-t uniforms from
`uniform(fold_in(fold_in(key(seed), stream_index), t), (N, 2))`
(deviation #10, ref: the JAX package's generation/sampler.py:180-195,
260-271).  The port reproduces those bits so that a fixed seed gives the
same draws, and hence the same notes, as the JAX package.  It follows
JAX 0.9's code path (jax/_src/prng.py) with the default
`jax_threefry_partitionable=True`:

  * key(seed)      = [seed >> 32, seed & 0xFFFFFFFF]   (uint32 seeds: [0, seed])
  * fold_in(k, d)  = threefry2x32(k, (0, d))
  * random bits    = b1 ^ b2 of threefry2x32(k, (hi, lo) of the flat iota)
  * uniform float  = bitcast((bits >> 9) | 0x3F800000) - 1.0

torch has no full uint32 arithmetic, so words live in int64 and are masked
back to 32 bits after every add and rotate.  Keys are int64 tensors of
shape [..., 2]; every function broadcasts over the leading dimensions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under key (k1, k2); all int64 holding uint32 values, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed, device=None) -> torch.Tensor:
    """`jax.random.key(uint32 seed)` as raw key data [..., 2]."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([seed >> 32, seed & _MASK], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)` for uint32 `data` (broadcast)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def uniform(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.uniform(k, shape)` (float32 in [0, 1)) for every key of
    `k` [..., 2] -> [..., *shape]."""
    shape = tuple(shape)
    count = 1
    for d in shape:
        count *= d
    lo = torch.arange(count, dtype=torch.int64, device=k.device).reshape(shape)
    lead = k.shape[:-1]
    expand = (slice(None),) * len(lead) + (None,) * len(shape)
    b1, b2 = threefry2x32(k[..., 0][expand], k[..., 1][expand],
                          torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
