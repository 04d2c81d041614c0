"""The single-layer LSTM recurrence over a precomputed input projection: the
JAX package's `ops/pallas_lstm.py` (`pallas_lstm_recurrence`) as a pair of
hand-written CUDA kernels (`csrc/lstm_recurrence.cu`) inside a
`torch.autograd.Function`, beside its plain PyTorch version.

    lstm_recurrence(xw [S,R,4H], u [H,4H], h0 [R,H], c0 [R,H])
        -> (hs [S,R,H] in the compute dtype, (h_T, c_T) float32)

xw = x @ W + b is computed outside (`ops/lstm.py::lstm_scan`).  Per step,
the arithmetic of `_fwd_kernel` (pallas_lstm.py:95-136): z = xw_t +
(h_{t-1} @ U summed in float32, cast to the compute dtype), gates in the
compute dtype (the logistic as 0.5*tanh(0.5x)+0.5, or Keras 2's
hard_sigmoid), c in float32, h = o * tanh(c cast to the compute dtype).  hs
leaves in the compute dtype; h_T (not rounded) and c_T in float32.

The backward is `_bwd_rule`'s (pallas_lstm.py:280-347): the cotangent of
h_T joins that of hs[S-1] in float32, the cotangent of c_T seeds the dc
carry, the kernel recomputes the gates from xw and the h_{t-1} / c_{t-1}
tapes and writes dxw (dz in the compute dtype), and dU = sum_t h_{t-1}^T dz_t
is the deterministic weight-gradient reduction of `csrc/biax_common.cuh`.
The forward writes its c_{t-1} tape only when autograd will need it (the
Pallas `tape=False` variant for eval).

On a CPU tensor the wrapper runs the plain version
(`lstm_recurrence_reference`, a loop over the scan whose autograd gives
the reference gradient); on a CUDA tensor it launches the kernels or
raises.  Launch counters: `lstm_recurrence.fwd_launches` /
`.bwd_launches`; the plain version counts `.calls`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from music_generator_tpu_torch.ops import _build
from music_generator_tpu_torch.ops.biax import (WGRAD_CHUNKS, _P, _I, _WGRAD,
                                                _cell, _check, _is_bf16,
                                                _layout, _on_cuda, _ptr,
                                                _stream, _wgrad)
from music_generator_tpu_torch.ops.lstm import check_recurrent_activation

_SIGNATURES = {
    "lstm_rec_fwd": [_I] + [_P] * 8 + [_I] * 4 + [_P],
    "lstm_rec_bwd": [_I] + [_P] * 10 + [_I] * 4 + [_P],
    "biax_wgrad": _WGRAD,
}


def lstm_recurrence_reference(xw, u, h0, c0, compute_dtype=torch.float32,
                              recurrent_activation: str = "sigmoid"):
    """The recurrence as a plain loop over S; see the module docstring."""
    lstm_recurrence_reference.calls += 1
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    xw, U = xw.to(cdt), u.to(cdt)
    h, c = h0.float(), c0.float()
    hs = []
    for t in range(xw.shape[0]):
        h, c = _cell(xw[t], h, c, U, hard)
        hs.append(h.to(cdt))
    return torch.stack(hs), (h, c)


lstm_recurrence_reference.calls = 0


class _Recurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, u, h0, c0, cdt, hard):
        dev = _on_cuda("lstm_recurrence", xw, u, h0, c0)
        S, R, H4 = xw.shape
        H = H4 // 4
        uc = u.to(cdt).contiguous()
        h0f, c0f = h0.float().contiguous(), c0.float().contiguous()
        tapes = any(ctx.needs_input_grad)
        hs = torch.empty(S, R, H, dtype=cdt, device=dev)
        cs = torch.empty_like(hs) if tapes else None
        hT, cT = (torch.empty(R, H, device=dev) for _ in range(2))
        lib = _build.bind("lstm_recurrence", _SIGNATURES)
        with torch.cuda.device(dev):
            _check(lib.lstm_rec_fwd(
                _is_bf16(cdt), xw.data_ptr(), _layout(uc).data_ptr(),
                h0f.data_ptr(), c0f.data_ptr(), hs.data_ptr(), _ptr(cs),
                hT.data_ptr(), cT.data_ptr(), S, R, H, int(hard),
                _stream(dev)), "lstm_rec_fwd")
        lstm_recurrence.fwd_launches += 1
        if tapes:
            ctx.save_for_backward(xw, uc, h0f, hs, cs)
            ctx.cfg = (cdt, hard)
            ctx.dtypes = (u.dtype, h0.dtype, c0.dtype)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        xw, uc, h0f, hs, cs = ctx.saved_tensors
        cdt, hard = ctx.cfg
        dev = xw.device
        S, R, H4 = xw.shape
        H = H4 // 4
        # Terminal cotangents: dh_T joins the last step's in float32.
        dhs = dhs.to(torch.float32, memory_format=torch.contiguous_format,
                     copy=True)
        dhs[-1] += dhT.float()
        dcT = dcT.float().contiguous()
        hs_prev = torch.cat([h0f.to(cdt)[None], hs[:-1]])
        dxw = torch.empty_like(xw)
        dh0, dc0 = (torch.empty(R, H, device=dev) for _ in range(2))
        lib = _build.bind("lstm_recurrence", _SIGNATURES)
        with torch.cuda.device(dev):
            _check(lib.lstm_rec_bwd(
                _is_bf16(cdt), *(t.data_ptr() for t in (
                    xw, _layout(uc), _layout(uc.t()), hs_prev, cs, dhs, dcT,
                    dxw, dh0, dc0)),
                S, R, H, int(hard), _stream(dev)), "lstm_rec_bwd")
            ws = torch.empty(WGRAD_CHUNKS * H * H4, device=dev)
            du = _wgrad(lib, hs_prev, 0, dxw, H, ws)
        lstm_recurrence.bwd_launches += 1
        return (dxw, du.to(ctx.dtypes[0]), dh0.to(ctx.dtypes[1]),
                dc0.to(ctx.dtypes[2]), None, None)


def lstm_recurrence(xw, u, h0, c0, compute_dtype=torch.float32,
                    recurrent_activation: str = "sigmoid"
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """The fused recurrence (pallas_lstm.py:374): xw [S, R, 4H] (= x@W + b),
    u [H, 4H], h0/c0 [R, H].  Returns (hs [S, R, H] in the compute dtype,
    (h_T, c_T) float32), differentiable in xw, u, h0 and c0.  CPU tensors
    take the plain version; CUDA tensors the kernels."""
    check_recurrent_activation(recurrent_activation)
    xw = xw.to(compute_dtype)
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(xw, u, h0, c0, compute_dtype,
                                         recurrent_activation)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_recurrence runs on CPU or CUDA tensors, "
                         f"got {xw.device}")
    _is_bf16(compute_dtype)
    hs, hT, cT = _Recurrence.apply(xw.contiguous(), u, h0, c0, compute_dtype,
                                   recurrent_activation == "hard_sigmoid")
    return hs, (hT, cT)


lstm_recurrence.fwd_launches = 0
lstm_recurrence.bwd_launches = 0
