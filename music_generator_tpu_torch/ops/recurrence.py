"""The single-layer LSTM recurrence over a precomputed input projection: the
JAX package's `ops/pallas_lstm.py` (`pallas_lstm_recurrence`) as
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

The forward (`lstm_recurrence_fwd`) is one launch of the biaxial stacks'
forward scan with its ends set: h0 and c0 seed the carries (the product
runs at s = 0 too) and h_T, c_T are written at the last step; U is
resident in a thread-block cluster in bfloat16 and streamed in float32, by
`biax.scan_route`.  `lstm_recurrence_fwd_staged` is that scan in plain
PyTorch, its yardstick (tests, chip_smoke.py).

The backward is `_bwd_rule`'s (pallas_lstm.py:280-347), as passes
(`lstm_recurrence_bwd`): the tapes (h_{t-1}, and the cotangent of h_T
joined to that of hs[S-1] in float32), one bulk GEMM that recomputes the
pre-activations z = xw + (h_{t-1} U -> T) of all steps, a reversed scan
that carries only dh <- dz U^T (dc seeded with the cotangent of c_T; U
resident in a thread-block cluster in bfloat16, streamed in float32, by
`biax.scan_route`) and writes dxw (dz in the compute dtype) and the
initial-state gradients, then dU = sum_t h_{t-1}^T dz_t by the
deterministic weight-gradient reduction of `csrc/biax_common.cuh`.
`lstm_recurrence_bwd_staged` is those passes in plain PyTorch, the
yardstick of the CUDA passes (tests, chip_smoke.py).  The forward writes
its c_{t-1} tape only when autograd will need it (the Pallas `tape=False`
variant for eval).

On a CPU tensor the wrapper runs the plain version
(`lstm_recurrence_reference`, a loop over the scan whose autograd gives
the reference gradient); on a CUDA tensor it launches the kernels or
raises.  Launch counters: `lstm_recurrence.fwd_launches` /
`.bwd_launches`, the forward's scans by route `.fwd_cluster_scans` /
`.fwd_streamed_scans` and the backward's `.cluster_scans` /
`.streamed_scans`; the plain version counts `.calls`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from music_generator_tpu_torch.ops import _build, biax
from music_generator_tpu_torch.ops.biax import (WGRAD_CHUNKS, _P, _I, _WGRAD,
                                                _cell, _check, _dot,
                                                _forward_scan,
                                                _is_bf16, _layout, _marker,
                                                _on_cuda, _ptr,
                                                _reverse_scan, _stream,
                                                _wgrad)
from music_generator_tpu_torch.ops.lstm import check_recurrent_activation

_SIGNATURES = {
    "lstm_rec_fwd": [_I, _I] + [_P] * 8 + [_I] * 4 + [_P, _P],
    "lstm_rec_bwd_preact": [_I] + [_P] * 4 + [_I, _I, _P],
    "lstm_rec_bwd_scan": [_I, _I] + [_P] * 7 + [_I] * 4 + [_P, _P],
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


def lstm_recurrence_fwd_staged(xw, u, h0, c0, compute_dtype=torch.float32,
                               recurrent_activation: str = "sigmoid",
                               tapes: bool = True):
    """The forward as the CUDA kernel computes it, in plain PyTorch (no
    autograd): the forward scan of the biaxial stacks
    (`biax._forward_scan`) over xw [S, R, 4H] in the compute dtype with
    h[-1] = h0 and c seeded from c0 [R, H].  Returns (hs, cs [S, R, H] in
    the compute dtype, h after step t and c before it; h_T (not rounded),
    c_T [R, H] float32); cs is None without `tapes`."""
    cdt = compute_dtype
    hs, cs, hT, cT = _forward_scan(
        xw.to(cdt), u.to(cdt), recurrent_activation == "hard_sigmoid",
        h0=h0, c0=c0, ends=True)
    return hs, cs if tapes else None, hT, cT


def lstm_recurrence_bwd_staged(xw, u, h0, hs, cs, dhs, dhT, dcT,
                               compute_dtype=torch.float32,
                               recurrent_activation: str = "sigmoid"):
    """The backward as the CUDA passes compute it, in plain PyTorch (no
    autograd), with their cast points.  xw [S, R, 4H] and u [H, 4H] are
    the forward's inputs, h0 [R, H] its initial h, hs and cs [S, R, H] its
    tapes (h after step t, c before it, in the compute dtype), dhs, dhT and
    dcT the cotangents of hs, h_T and c_T.

      0. the tapes: hs_prev = [h0 -> T, hs[:-1]], and dhs in float32 with
         dhT added to its last step;
      1. z = xw + (hs_prev U -> T) over all S R rows at once;
      2. the reversed scan (`biax._reverse_scan`): dc seeded with dcT, dh =
         dz U^T (float32) the only carried product;
      3. dU = sum_t hs_prev_t^T dz_t in float32.

    Returns (dxw in the compute dtype, dU, dh0, dc0 float32)."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    S, R, H4 = xw.shape
    H = H4 // 4
    xw, U, hs, cs = (t.to(cdt) for t in (xw, u, hs, cs))
    # 0. the tapes
    hs_prev = torch.cat([h0.to(cdt)[None], hs[:-1]])
    ext = dhs.float().clone()
    ext[-1] += dhT.float()
    # 1. - 3.
    z = xw + _dot(hs_prev, U).to(cdt)
    dz, (dh0, dc0) = _reverse_scan(z, cs, ext, U, hard, dc=dcT.float())
    du = _dot(hs_prev.reshape(S * R, H).t(), dz.reshape(S * R, H4))
    return dz, du, dh0, dc0


def lstm_recurrence_fwd(xw, u, h0, c0, compute_dtype=torch.float32,
                        recurrent_activation: str = "sigmoid",
                        tapes: bool = True,
                        scan_prof: Optional[torch.Tensor] = None):
    """Kernel 8 on CUDA tensors (`lstm_rec_fwd`, the forward scan on
    `biax.scan_route(compute_dtype)`): the results of
    `lstm_recurrence_fwd_staged`, (hs, cs [S, R, H] in the compute dtype,
    h after step t and c before it; h_T, c_T [R, H] float32).  cs is None
    without `tapes`.  With an int64 tensor `scan_prof` [9] on the card, the
    cluster scan writes its first block's clock cycles per phase and its
    plan, as the biaxial forwards' scans do.  Counts
    `lstm_recurrence.fwd_launches`, and `.fwd_cluster_scans` or
    `.fwd_streamed_scans`."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("lstm_recurrence", xw, u, h0, c0)
    S, R, H4 = xw.shape
    H = H4 // 4
    xw, uc = xw.to(cdt).contiguous(), u.to(cdt).contiguous()
    h0f, c0f = h0.float().contiguous(), c0.float().contiguous()
    hs = torch.empty(S, R, H, dtype=cdt, device=dev)
    cs = torch.empty_like(hs) if tapes else None
    hT, cT = (torch.empty(R, H, device=dev) for _ in range(2))
    route = biax.scan_route(cdt)
    lib = _build.bind("lstm_recurrence", _SIGNATURES)
    with torch.cuda.device(dev):
        _check(lib.lstm_rec_fwd(
            _is_bf16(cdt), int(route == "cluster"), xw.data_ptr(),
            _layout(uc).data_ptr(), h0f.data_ptr(), c0f.data_ptr(),
            hs.data_ptr(), _ptr(cs), hT.data_ptr(), cT.data_ptr(), S, R, H,
            int(hard), _ptr(scan_prof), _stream(dev)),
            f"lstm_rec_fwd ({route})")
    if route == "cluster":
        lstm_recurrence.fwd_cluster_scans += 1
    else:
        lstm_recurrence.fwd_streamed_scans += 1
    lstm_recurrence.fwd_launches += 1
    return hs, cs, hT, cT


def lstm_recurrence_bwd(xw, u, h0, hs, cs, dhs, dhT, dcT,
                        compute_dtype=torch.float32,
                        recurrent_activation: str = "sigmoid", marks=None,
                        scan_prof: Optional[torch.Tensor] = None):
    """Kernel 9 on CUDA tensors: the arguments and results of
    `lstm_recurrence_bwd_staged`, whose passes it runs
    (csrc/lstm_recurrence.cu): the tapes, `lstm_rec_bwd_preact`,
    `lstm_rec_bwd_scan` on `biax.scan_route(compute_dtype)` and the dU
    reduction `biax_wgrad`.  With a list `marks`, a recorded CUDA event is
    appended after each pass, as (name, event), behind ("start", event):
    "tapes", "preact", "scan", "wgrad".  With an int64 tensor `scan_prof`
    [9] on the card, the cluster scan writes its first block's clock cycles
    per phase and its plan, as the biaxial backwards' scans do.  Counts
    `lstm_recurrence.bwd_launches`, and `.cluster_scans` or
    `.streamed_scans`."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("lstm_recurrence", xw, u, h0, hs, cs, dhs, dhT, dcT)
    S, R, H4 = xw.shape
    H = H4 // 4
    xw, uc, hs, cs = (t.to(cdt).contiguous() for t in (xw, u, hs, cs))
    route = biax.scan_route(cdt)
    lib = _build.bind("lstm_recurrence", _SIGNATURES)
    bf, st = _is_bf16(cdt), _stream(dev)
    mark = _marker(marks)
    with torch.cuda.device(dev):
        mark("start")
        hs_prev = torch.cat([h0.to(cdt)[None], hs[:-1]])
        ext = dhs.to(torch.float32, memory_format=torch.contiguous_format,
                     copy=True)
        ext[-1] += dhT.float()
        dcT = dcT.float().contiguous()
        mark("tapes")
        dxw = torch.empty_like(xw)              # z in, dz out
        _check(lib.lstm_rec_bwd_preact(
            bf, hs_prev.data_ptr(), _layout(uc).data_ptr(), xw.data_ptr(),
            dxw.data_ptr(), S * R, H, st), "lstm_rec_bwd_preact")
        mark("preact")
        dh0, dc0 = (torch.empty(R, H, device=dev) for _ in range(2))
        scan_u = uc if route == "cluster" else _layout(uc.t())
        _check(lib.lstm_rec_bwd_scan(
            bf, int(route == "cluster"), dxw.data_ptr(), cs.data_ptr(),
            ext.data_ptr(), scan_u.data_ptr(), dcT.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), S, R, H, int(hard),
            _ptr(scan_prof), st), f"lstm_rec_bwd_scan ({route})")
        if route == "cluster":
            lstm_recurrence.cluster_scans += 1
        else:
            lstm_recurrence.streamed_scans += 1
        mark("scan")
        ws = torch.empty(WGRAD_CHUNKS * H * H4, device=dev)
        du = _wgrad(lib, hs_prev, 0, dxw, H, ws)
        mark("wgrad")
    lstm_recurrence.bwd_launches += 1
    return dxw, du, dh0, dc0


class _Recurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, u, h0, c0, cdt, act):
        tapes = any(ctx.needs_input_grad)
        hs, cs, hT, cT = lstm_recurrence_fwd(xw, u, h0, c0, cdt, act, tapes)
        if tapes:
            ctx.save_for_backward(xw, u, h0, hs, cs)
            ctx.cfg = (cdt, act)
            ctx.dtypes = (u.dtype, h0.dtype, c0.dtype)
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        dxw, du, dh0, dc0 = lstm_recurrence_bwd(*ctx.saved_tensors, dhs, dhT,
                                                dcT, *ctx.cfg)
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
                                   recurrent_activation)
    return hs, (hT, cT)


lstm_recurrence.fwd_launches = 0
lstm_recurrence.bwd_launches = 0
lstm_recurrence.fwd_cluster_scans = 0
lstm_recurrence.fwd_streamed_scans = 0
lstm_recurrence.cluster_scans = 0
lstm_recurrence.streamed_scans = 0
