"""One DeepJ axis as a fused two-layer LSTM stack: the JAX package's
`ops/pallas_lstm2.py` (`pallas_lstm2`) as a pair of hand-written CUDA
kernels (`csrc/lstm2.cu`) inside a `torch.autograd.Function`, beside its
plain PyTorch version.

    lstm2_stack(x0 [S,R,F], s1m [S,R,H], w0 [F,4H], b0, b1 [4H],
                u0, w1, u1 [H,4H], h00, c00, h10, c10 [R,H])
        -> (hs1 [S,R,H] in the compute dtype, (h0T, c0T, h1T, c1T) float32)

Per step, the arithmetic of `_make_fwd_kernel` (pallas_lstm2.py:109-177):
xw0 = (x0_t @ W0 summed in float32 -> compute dtype) + b0, layer-0 cell,
x1 = h0_t * mask_t + s1m_t in the compute dtype, xw1 = (x1 @ W1 -> compute
dtype) + b1, layer-1 cell.  The cell is `_cell` of ops/biax.py: gates in the
compute dtype, c float32, h = o * tanh(c cast to the compute dtype).  The
terminal states leave in float32, h not rounded.

The inter-layer keep-mask is the port's own: the TPU kernel draws it from
the TPU's hardware PRNG keyed per (batch tile, step) (`_mask`,
pallas_lstm2.py:96-106), bits no other device can give.  Here an element
(step s, row r, unit j) keeps when the Murmur3 finalizer of
`csrc/biax_common.cuh` (`mval`, site `S_STACK_MID`, tile 0, row r of the
whole row space) clears the TPU kernel's threshold
int((1 - keep) * 0xFFFFFFFF); kept values are scaled by 1/keep in the
compute dtype.  It is a pure function of (seed, step, row, unit), so it
does not depend on how any kernel tiles the rows, and the forward and the
backward regenerate the same mask.

The backward is `_bwd_impl`'s (pallas_lstm2.py:357-447): dh1T joins the
cotangent of hs1[S-1] (summed in float32, then rounded to the compute
dtype), dc0T and dc1T seed the dc carries, and the cotangent of h0T is
IGNORED, as the TPU kernel ignores it (`del dh0T`, :370-374: no consumer
differentiates h0T).  The plain version returns h0T detached, so it
ignores it too.  The weight gradients dW0, db0, dU0, dW1, dU1, db1 are
the deterministic reduction of `csrc/biax_common.cuh` over the dz tapes.
The forward writes its backward tapes (hs0, cs0, cs1) only when autograd
will need them (the Pallas `tapes=False` variant).

On a CPU tensor the wrapper runs the plain version
(`lstm2_stack_reference`); on a CUDA tensor it launches the kernels or
raises.  Launch counters: `lstm2_stack.fwd_launches` / `.bwd_launches`;
the plain version counts `.calls`.

`dump_masks` writes the stack's masks out as one [S, R, H] array (the
JAX package's `extract_masks` of tools/tpu_validate_lstm2.py) through the
kernel of `csrc/lstm2_masks.cu`, beside its plain version `stack_masks`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from music_generator_tpu_torch.ops import _build
from music_generator_tpu_torch.ops.biax import (WGRAD_CHUNKS, _F, _P, _I, _U,
                                                _WGRAD, _apply, _cell, _check,
                                                _dot, _is_bf16, _keep_bits,
                                                _keep_scale, _layout,
                                                _mask_args, _on_cuda, _ptr,
                                                _stream, _wgrad)
from music_generator_tpu_torch.ops.lstm import check_recurrent_activation

S_STACK_MID = 6     # mask site salt (Site in csrc/biax_common.cuh); 0-5 are
                    # the biaxial stacks' sites

_SIGNATURES = {
    "lstm2_fwd": [_I] + [_P] * 20 + [_I] * 4 + [_U, _U, _F, _I, _I, _P],
    "lstm2_bwd": [_I] + [_P] * 29 + [_I] * 4 + [_U, _U, _F, _I, _I, _P],
    "biax_wgrad": _WGRAD,
}


def keep_mask(seed: int, step, rows: torch.Tensor, H: int, keep_prob: float,
              dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The inter-layer keep-mask, scaled by 1/keep, of the global rows
    `rows` (int64) at scan step(s) `step`: shape rows.shape + (H,).  None
    when dropout is off."""
    if keep_prob >= 1.0:
        return None
    cols = torch.arange(H, dtype=torch.int64, device=rows.device)
    keep = _keep_bits(seed, S_STACK_MID, 0, step, rows[..., None] * H + cols,
                      keep_prob)
    return keep.to(dtype) * _keep_scale(keep_prob, dtype)


def stack_masks(seed: int, S: int, R: int, H: int, keep_prob: float,
                dtype: torch.dtype, device=None) -> Optional[torch.Tensor]:
    """The masks of a whole stack, [S, R, H]."""
    steps = torch.arange(S, dtype=torch.int64, device=device)[:, None, None]
    rows = torch.arange(R, dtype=torch.int64, device=device)
    return keep_mask(seed, steps, rows.expand(S, R), H, keep_prob, dtype)


_MASK_SIGNATURES = {"lstm2_masks": [_I, _P, _I, _I, _I, _U, _U, _F, _P]}


def dump_masks(seed: int, S: int, R: int, H: int, dropout_p: float,
               dtype: torch.dtype = torch.float32,
               device=None) -> Optional[torch.Tensor]:
    """The masks the fused stack applies at inter-layer rate `dropout_p`
    under `seed`, [S, R, H] in `dtype` (kept elements 1/keep in the dtype,
    dropped ones 0); None when dropout is off.  On the CPU the plain
    version (`stack_masks`); on a CUDA device the kernel of
    csrc/lstm2_masks.cu, which evaluates the same device function the
    stack's kernels do.  Launch counter: `dump_masks.launches`."""
    keep = 1.0 - dropout_p
    if keep >= 1.0:
        return None
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cpu":
        return stack_masks(seed, S, R, H, keep, dtype, dev)
    if dev.type != "cuda":
        raise ValueError(f"dump_masks runs on the CPU or CUDA, got {dev}")
    bf16 = _is_bf16(dtype)
    if R * H >= 2 ** 31 or S > 65535:
        raise ValueError(f"dump_masks takes R * H < 2**31 and S <= 65535, "
                         f"got S={S}, R={R}, H={H}")
    out = torch.empty(S, R, H, dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    mseed, thr, scale, _ = _mask_args(dropout_p, seed, dtype)
    lib = _build.bind("lstm2_masks", _MASK_SIGNATURES)
    with torch.cuda.device(dev):
        _check(lib.lstm2_masks(bf16, out.data_ptr(), S, R, H, mseed, thr,
                               scale, _stream(dev)), "lstm2_masks")
    dump_masks.launches += 1
    return out


dump_masks.launches = 0


def lstm2_stack_reference(x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10,
                          c10, dropout_p: float = 0.0, seed: int = 0,
                          compute_dtype=torch.float32,
                          recurrent_activation: str = "sigmoid"):
    """The stack as a plain loop over S; see the module docstring."""
    lstm2_stack_reference.calls += 1
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    S, R, _ = x0.shape
    H = u0.shape[0]
    x0, s1m = x0.to(cdt), s1m.to(cdt)
    W0, U0, W1, U1 = (w.to(cdt) for w in (w0, u0, w1, u1))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    masks = stack_masks(seed, S, R, H, 1.0 - dropout_p, cdt, x0.device)
    h0, c0, h1, c1 = (s.float() for s in (h00, c00, h10, c10))
    out = []
    for t in range(S):
        xw0 = _dot(x0[t], W0).to(cdt) + B0
        h0, c0 = _cell(xw0, h0, c0, U0, hard)
        x1 = _apply(h0.to(cdt), None if masks is None else masks[t]) + s1m[t]
        xw1 = _dot(x1, W1).to(cdt) + B1
        h1, c1 = _cell(xw1, h1, c1, U1, hard)
        out.append(h1.to(cdt))
    return torch.stack(out), (h0.detach(), c0, h1, c1)


lstm2_stack_reference.calls = 0


def _pad8(t: torch.Tensor) -> torch.Tensor:
    """Rows padded to a multiple of 8 values (16-byte rows in bfloat16),
    what the tensor-core weight-gradient reduction reads."""
    pad = -t.shape[-1] % 8
    return F.pad(t, (0, pad)) if pad else t


class _Stack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10,
                dropout_p, seed, cdt, hard):
        dev = _on_cuda("lstm2_stack", x0, s1m, w0, b0, b1, u0, w1, u1, h00,
                       c00, h10, c10)
        S, R, Fin = x0.shape
        H = u0.shape[0]
        xs = [t.to(cdt).contiguous() for t in (x0, s1m)]
        ws = [t.to(cdt).contiguous() for t in (w0, b0, b1, u0, w1, u1)]
        st = [t.float().contiguous() for t in (h00, c00, h10, c10)]
        tapes = any(ctx.needs_input_grad)
        new = lambda: torch.empty(S, R, H, dtype=cdt, device=dev)
        hs1 = new()
        hs0, cs0, cs1 = (new(), new(), new()) if tapes else (None,) * 3
        fin = [torch.empty(R, H, device=dev) for _ in range(4)]
        mats = [_layout(ws[0]), ws[1], ws[2], _layout(ws[3]),
                _layout(ws[4]), _layout(ws[5])]
        lib = _build.bind("lstm2", _SIGNATURES)
        with torch.cuda.device(dev):
            _check(lib.lstm2_fwd(
                _is_bf16(cdt), *(t.data_ptr() for t in xs + mats + st),
                _ptr(hs0), _ptr(cs0), hs1.data_ptr(), _ptr(cs1),
                *(t.data_ptr() for t in fin), S, R, Fin, H,
                *_mask_args(dropout_p, seed, cdt), int(hard), _stream(dev)),
                "lstm2_fwd")
        lstm2_stack.fwd_launches += 1
        if tapes:
            ctx.save_for_backward(*xs, *ws, st[0], st[2], hs0, cs0, hs1, cs1)
            ctx.cfg = (dropout_p, seed, cdt, hard)
            ctx.dtypes = tuple(t.dtype for t in (
                x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10))
        return (hs1, *fin)

    @staticmethod
    def backward(ctx, dhs1, dh0T, dc0T, dh1T, dc1T):
        (x0, s1m, w0, b0, b1, u0, w1, u1, h00, h10,
         hs0, cs0, hs1, cs1) = ctx.saved_tensors
        dropout_p, seed, cdt, hard = ctx.cfg
        dev = x0.device
        S, R, Fin = x0.shape
        H = u0.shape[0]
        H4 = 4 * H
        # dh0T is ignored (pallas_lstm2.py:370-374); dh1T joins the last
        # step's cotangent in float32, then the sum rounds to the compute
        # dtype.
        del dh0T
        dhs1 = dhs1.float()
        dhs1 = torch.cat([dhs1[:-1], (dhs1[-1] + dh1T.float())[None]])
        dhs1 = dhs1.to(cdt).contiguous()
        hs0p = torch.cat([h00.to(cdt)[None], hs0[:-1]])
        hs1p = torch.cat([h10.to(cdt)[None], hs1[:-1]])
        e = lambda *shape: torch.empty(*shape, dtype=cdt, device=dev)
        dx0, ds1m, x1t = e(S, R, Fin), e(S, R, H), e(S, R, H)
        dz0, dz1 = e(S, R, H4), e(S, R, H4)
        dst = [torch.empty(R, H, device=dev) for _ in range(4)]
        fwd = [_layout(w) for w in (w0, u0, w1, u1)]
        trans = [_layout(w.t()) for w in (w0, u0, w1, u1)]
        lib = _build.bind("lstm2", _SIGNATURES)
        with torch.cuda.device(dev):
            _check(lib.lstm2_bwd(
                _is_bf16(cdt), *(t.data_ptr() for t in (
                    x0, s1m, fwd[0], b0, b1, fwd[1], fwd[2], fwd[3], *trans,
                    hs0p, cs0, hs1p, cs1, hs0, dhs1, dc0T.float().contiguous(),
                    dc1T.float().contiguous(), dx0, ds1m, x1t, dz0, dz1,
                    *dst)),
                S, R, Fin, H, *_mask_args(dropout_p, seed, cdt), int(hard),
                _stream(dev)), "lstm2_bwd")
            ws = torch.empty(WGRAD_CHUNKS * max(Fin, H) * H4, device=dev)
            dw0 = _wgrad(lib, _pad8(x0), 0, dz0, Fin, ws)
            du0 = _wgrad(lib, hs0p, 0, dz0, H, ws)
            dw1 = _wgrad(lib, x1t, 0, dz1, H, ws)
            du1 = _wgrad(lib, hs1p, 0, dz1, H, ws)
            db0 = _wgrad(lib, None, 0, dz0, 1, ws).reshape(H4)
            db1 = _wgrad(lib, None, 0, dz1, 1, ws).reshape(H4)
        lstm2_stack.bwd_launches += 1
        grads = (dx0, ds1m, dw0, db0, db1, du0, dw1, du1, *dst)
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes)) + (
            None,) * 4


def lstm2_stack(x0, s1m, w0, b0, b1, u0, w1, u1, h00=None, c00=None,
                h10=None, c10=None, dropout_p: float = 0.0, seed: int = 0,
                compute_dtype=torch.float32,
                recurrent_activation: str = "sigmoid"
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The fused two-layer stack (pallas_lstm2.py:485).  x0 [S, R, F] the
    layer-0 input (style-0 term added), s1m [S, R, H] the masked layer-1
    style term, w0/b0 the layer-0 projection, b1 the layer-1 bias, u0/w1/u1
    [H, 4H]; initial states default to zeros.  dropout_p is the
    inter-layer rate, seed the mask seed.  Returns (hs1 [S, R, H] in the
    compute dtype, (h0T, c0T, h1T, c1T) float32).  CPU tensors take the
    plain version; CUDA tensors the kernels."""
    check_recurrent_activation(recurrent_activation)
    S, R, _ = x0.shape
    H = u0.shape[0]
    zero = lambda: torch.zeros(R, H, device=x0.device)
    states = [zero() if s is None else s for s in (h00, c00, h10, c10)]
    args = (x0.to(compute_dtype), s1m.to(compute_dtype), w0, b0.reshape(-1),
            b1.reshape(-1), u0, w1, u1, *states)
    if x0.device.type == "cpu":
        return lstm2_stack_reference(*args, dropout_p, seed, compute_dtype,
                                     recurrent_activation)
    if x0.device.type != "cuda":
        raise ValueError(f"lstm2_stack runs on CPU or CUDA tensors, got "
                         f"{x0.device}")
    _is_bf16(compute_dtype)
    hs1, *fin = _Stack.apply(*args, float(dropout_p), int(seed),
                             compute_dtype,
                             recurrent_activation == "hard_sigmoid")
    return hs1, tuple(fin)


lstm2_stack.fwd_launches = 0
lstm2_stack.bwd_launches = 0
