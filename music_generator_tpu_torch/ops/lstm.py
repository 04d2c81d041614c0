"""LSTM cell and layer scan (ref: model.py:84,122 — Keras LSTM), written out
rather than `nn.LSTM`: the gate order is (i, f, g, o) over a `[in, 4H]`
kernel, the layout of the JAX package's `ops/lstm.py`, and the recurrent
activation is either sigmoid or Keras 2's hard_sigmoid (deviation #12)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def keras2_hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras 2's hard_sigmoid: clip(0.2x + 0.5, 0, 1) — NOT
    `F.hardsigmoid`, which is Keras 3's x/6 + 0.5."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


RECURRENT_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": keras2_hard_sigmoid,
}


def check_recurrent_activation(name: str) -> None:
    if name not in RECURRENT_ACTIVATIONS:
        raise ValueError(
            f"unknown lstm_recurrent_activation={name!r}; expected one of "
            f"{sorted(RECURRENT_ACTIVATIONS)}")


def gates(z: torch.Tensor, c: torch.Tensor, hidden: int,
          recurrent_activation: str = "sigmoid",
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four-gate nonlinearity on z = x@W + h@U + b, shape [B, 4H]."""
    act = RECURRENT_ACTIVATIONS[recurrent_activation]
    i = act(z[:, :hidden])
    f = act(z[:, hidden:2 * hidden])
    g = torch.tanh(z[:, 2 * hidden:3 * hidden])
    o = act(z[:, 3 * hidden:])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              recurrent_activation: str = "sigmoid",
              compute_dtype: Optional[torch.dtype] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell step: x [B, D], h/c [B, H] -> (h', c') float32.  `params`
    carries `kernel` [D, 4H], `recurrent` [H, 4H] and `bias` [4H].  The
    JAX `lstm_step` (ops/lstm.py:75-85) in `compute_dtype` (x's dtype when
    None): x, h and the weights rounded to it, each product and their sum
    rounded to it, then the bias (rounded to it) added in float32, where
    XLA on the CPU keeps the sum that feeds the float32 gates; c stays
    float32."""
    hidden = params.recurrent.shape[0]
    dt = compute_dtype or x.dtype
    z = ((x.to(dt) @ params.kernel.to(dt) + h.to(dt) @ params.recurrent.to(dt))
         .float() + params.bias.to(dt).float())
    return gates(z, c.float(), hidden, recurrent_activation)


def lstm_scan(params, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
              c0: Optional[torch.Tensor] = None,
              compute_dtype: torch.dtype = torch.float32,
              recurrent_activation: str = "sigmoid",
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LSTM layer over a sequence, the JAX package's
    `lstm_scan(kernel="pallas")` (ops/lstm.py:88-124): xs [S, R, D] ->
    (hs [S, R, H] in the compute dtype, (h_T, c_T) float32).  The input
    projection of every step, xs @ kernel + bias in the compute dtype, is
    one matmul; the recurrence is ops/recurrence.py's kernel."""
    # Imported here: ops/recurrence.py imports this module.
    from music_generator_tpu_torch.ops.recurrence import lstm_recurrence
    S, R, D = xs.shape
    hidden = params.recurrent.shape[0]
    dt = compute_dtype
    if h0 is None:
        h0 = torch.zeros(R, hidden, device=xs.device)
    if c0 is None:
        c0 = torch.zeros(R, hidden, device=xs.device)
    xw = (xs.reshape(S * R, D).to(dt) @ params.kernel.to(dt)
          + params.bias.to(dt)).reshape(S, R, 4 * hidden)
    return lstm_recurrence(xw, params.recurrent, h0, c0, dt,
                           recurrent_activation)
