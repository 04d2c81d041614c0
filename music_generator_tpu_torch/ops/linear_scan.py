"""The gated linear recurrence of `time_axis_kind="linear"` (the JAX
package's `ops/linear_scan.py`): a minGRU-style unit

    g_t = sigmoid(x_t @ W_g + b_g)          (update gate)
    z_t = tanh(x_t @ W_z + b_z)             (candidate)
    h_t = (1 - g_t) * h_{t-1} + g_t * z_t

whose recurrence h_t = a_t * h_{t-1} + b_t (a = 1 - g, b = g * z) is
associative: (a, b) pairs compose as (a1 * a2, a2 * b1 + b2).  The time
dimension therefore runs as a log-depth scan with no recurrent matmul.

The JAX package runs that scan as `jax.lax.associative_scan`, which XLA
lowers to elementwise operations (no Pallas kernel).  `associative_scan`
here is the same odd/even tree, combine for combine, so its float32 and
bfloat16 results are JAX's bit for bit on the same (a, b); gradients come
from autograd through the same operations.  The unit is off by default
(`Config.time_axis_kind = "lstm"`)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from music_generator_tpu_torch.utils import spans


class GLRUParams(nn.Module):
    """kernel [in, 2H] (the gate block, then the candidate block) and bias
    [2H]: the JAX `GLRUParams` leaves, under the `lstm` name of the axis
    layer (the keystr paths `.time_axis[l].lstm.kernel` / `.bias`)."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(input_dim, 2 * hidden))
        self.bias = nn.Parameter(torch.zeros(2 * hidden))


def glru_gates(p: GLRUParams, xs: torch.Tensor, dt: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of h_t = a_t h_{t-1} + b_t for inputs xs [..., in], in `dt`:
    pre = x @ W + b, a = 1 - sigmoid(pre[:H]), b = sigmoid(pre[:H]) *
    tanh(pre[H:])."""
    H = p.bias.shape[0] // 2
    pre = xs.to(dt) @ p.kernel.to(dt) + p.bias.to(dt)
    g = torch.sigmoid(pre[..., :H])
    z = torch.tanh(pre[..., H:])
    return 1.0 - g, g * z


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 0; `even` has as many rows as
    `odd` or one more."""
    n = odd.shape[0]
    pairs = torch.stack([even[:n], odd], dim=1).flatten(0, 1)
    return torch.cat([pairs, even[n:]]) if even.shape[0] > n else pairs


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) along dim 0 under `_combine`, as
    jax.lax.associative_scan builds it: combine the pairs (0, 1), (2, 3),
    ...; scan the combined half; combine its results with elements 2, 4,
    ... (dropping its last result when the length is even); prepend
    element 0; interleave."""
    T = a.shape[0]
    if T < 2:
        return a, b
    ra, rb = _combine(a[0:-1:2], b[0:-1:2], a[1::2], b[1::2])
    oa, ob = associative_scan(ra, rb)
    if T % 2 == 0:
        ea, eb = _combine(oa[:-1], ob[:-1], a[2::2], b[2::2])
    else:
        ea, eb = _combine(oa, ob, a[2::2], b[2::2])
    ea = torch.cat([a[:1], ea])
    eb = torch.cat([b[:1], eb])
    return _interleave(ea, oa), _interleave(eb, ob)


def glru_scan(p: GLRUParams, xs: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """xs [T, B, in] -> hs [T, B, H] from a zero state, in the compute
    dtype: one [T*B, in] @ [in, 2H] product for every step's gates, then
    the log-depth scan (the spans `linear_scan.tree` and, over its
    backward, `linear_scan.tree.bwd`)."""
    a, b = glru_gates(p, xs, compute_dtype)
    with spans.span("linear_scan.tree"):
        hs = associative_scan(a, b)[1]
    spans.backward_span("linear_scan.tree.bwd", (hs,), (a, b))
    return hs


def glru_scan_sequential(p: GLRUParams, xs: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The same recurrence one step at a time: the oracle of the
    associative form."""
    a, b = glru_gates(p, xs, compute_dtype)
    h = torch.zeros(a.shape[1:], dtype=compute_dtype, device=a.device)
    hs = []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return torch.stack(hs)


def glru_step(p: GLRUParams, x: torch.Tensor, h: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One streaming step (generation): x [B, in], h [B, H] -> new h."""
    a, b = glru_gates(p, x, compute_dtype)
    return a * h.to(compute_dtype) + b
