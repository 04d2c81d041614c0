"""The random streams that the reference has to work out again: the
training step's dropout generator, the fused stacks' hash masks and the
generation uniforms.  Frozen copies, in plain PyTorch and NumPy, of what
the published code path defines; none of it is imported from the program.

  * `step_generator`: the dropout generator of training step `step`,
    seeded from numpy's SeedSequence([seed, step]) (the training step's
    documented derivation; `parallel/train_step.py::step_generator` in
    the port).
  * `keep_bits`: the Murmur3-finalizer keep decision of the biaxial
    stacks' in-kernel dropout (the Pallas kernels' `_mask`,
    `ops/pallas_biax.py:102-130` of the JAX package), over the TPU row
    tiling; the fused two-layer stack's inter-layer mask is the same hash
    at site 6, tile 0 and the global row.
  * `threefry2x32`, `key`, `fold_in`, `uniform`: jax.random's threefry
    with the partitionable layout, in int64 arithmetic masked to 32 bits:
    stream g's step-t uniforms are uniform(fold_in(fold_in(key(seed), g),
    t), (N, 2)).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_U32 = 0xFFFFFFFF

# Dropout-site salts of the biaxial stacks, and the fused stack's.
S_IN, S_STYLE0, S_STYLE1, S_MID, S_OUT, S_STYLE0C = 0, 1, 2, 3, 4, 5
S_STACK_MID = 6
MAX_TILE_ROWS = 256


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The dropout generator of training step `step` on one process."""
    word = int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(word)


def row_tiling(A: int, B: int) -> int:
    """The TPU kernels' tile height k over (across, batch) rows: the
    largest k dividing A with k * B <= 256 (1 when B alone exceeds it)."""
    if B >= MAX_TILE_ROWS:
        return 1
    return max(k for k in range(1, A + 1)
               if A % k == 0 and k * B <= MAX_TILE_ROWS)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_bits(seed: int, site: int, j, s, idx: torch.Tensor,
              keep_prob: float) -> torch.Tensor:
    """The keep decision of element index `idx` of tile j at scan step s
    (int64 tensors broadcast together)."""
    dev = idx.device
    j = torch.as_tensor(j, dtype=torch.int64, device=dev)
    s = torch.as_tensor(s, dtype=torch.int64, device=dev)
    base = (_mul32(torch.tensor(seed & _U32, dtype=torch.int64, device=dev),
                   0x9E3779B1)
            ^ ((site * 0x85EBCA77) & _U32)
            ^ _mul32(j, 0xC2B2AE3D) ^ _mul32(s, 0x27D4EB2F))
    x = (idx + base) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    threshold = int((1.0 - keep_prob) * 0xFFFFFFFF) & _U32
    return x >= threshold


def stack_mask(seed: int, site: int, S: int, A: int, B: int, W: int,
               keep_prob: float, device) -> Optional[torch.Tensor]:
    """A biaxial stack's mask of one site, [S, A, B, W] float32, kept
    elements 1/keep: element (s, a, b, col) lies in tile a // k, row
    (a % k) B + b, index row W + col."""
    if keep_prob >= 1.0:
        return None
    k = row_tiling(A, B)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    s = ar(S)[:, None, None, None]
    a = ar(A)[None, :, None, None]
    b = ar(B)[None, None, :, None]
    col = ar(W)[None, None, None, :]
    keep = keep_bits(seed, site, a // k, s, ((a % k) * B + b) * W + col,
                     keep_prob)
    return keep.float() / keep_prob


def fused_stack_mask(seed: int, S: int, R: int, H: int, keep_prob: float,
                     device) -> Optional[torch.Tensor]:
    """The fused two-layer stack's inter-layer mask, [S, R, H] float32:
    element (s, r, j) keeps by the hash at site 6, tile 0, step s, index
    r H + j."""
    if keep_prob >= 1.0:
        return None
    steps = torch.arange(S, dtype=torch.int64, device=device)[:, None, None]
    rows = torch.arange(R, dtype=torch.int64, device=device)[None, :, None]
    cols = torch.arange(H, dtype=torch.int64, device=device)[None, None, :]
    keep = keep_bits(seed, S_STACK_MID, 0, steps, rows * H + cols, keep_prob)
    return keep.float() / keep_prob


# -- threefry -----------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _U32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the counter pair (x1, x2) under key
    (k1, k2); int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _U32
    x2 = (x2 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _U32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _U32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x1, x2


def key(seed, device=None) -> torch.Tensor:
    """jax.random.key of a uint32 seed, as raw key data [..., 2]."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([seed >> 32, seed & _U32], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _U32
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def uniform(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.uniform(k, shape) in float32 for every key of k [..., 2]
    -> [..., *shape]."""
    shape = tuple(shape)
    lo = torch.arange(int(np.prod(shape)), dtype=torch.int64,
                      device=k.device).reshape(shape)
    lead = (slice(None),) * (k.dim() - 1) + (None,) * len(shape)
    b1, b2 = threefry2x32(k[..., 0][lead], k[..., 1][lead],
                          torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
