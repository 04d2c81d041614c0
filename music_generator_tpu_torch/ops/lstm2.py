"""One DeepJ axis as a fused two-layer LSTM stack: the JAX package's
`ops/pallas_lstm2.py` (`pallas_lstm2`) as hand-written CUDA kernels
(`csrc/lstm2.cu`: forward and backward in passes) inside a
`torch.autograd.Function`, beside its plain PyTorch version.

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

On CUDA tensors the forward runs as passes (`lstm2_fwd`, the biaxial
stacks' machinery), since only h0 U0 and h1 U1 carry from step to step:
x0 padded to 16-byte rows, layer 0's input pre-activations (x0 W0 -> T) +
b0 as one bulk GEMM, layer 0's forward scan from h00, c00 (writing h0T,
c0T), x1 = (hs0 * mask -> T) + s1m -> T, layer 1's GEMM, and layer 1's
forward scan from h10, c10 (writing h1T, c1T).  The scans keep U resident
in a thread-block cluster in bfloat16 and stream it in float32, by
`biax.scan_route`.  `lstm2_fwd_staged` is those passes in plain PyTorch,
their yardstick (tests, chip_smoke.py).

The backward is `_bwd_impl`'s (pallas_lstm2.py:357-447): dh1T joins the
cotangent of hs1[S-1] (summed in float32, then rounded to the compute
dtype), dc0T and dc1T seed the dc carries, and the cotangent of h0T is
IGNORED, as the TPU kernel ignores it (`del dh0T`, :370-374: no consumer
differentiates h0T).  The plain version returns h0T detached, so it
ignores it too.  On CUDA tensors it runs as passes (`lstm2_bwd`, the
biaxial stacks' machinery): the tapes, a prologue forming both layer
inputs, both layers' pre-activations as two bulk GEMMs, layer 1's
reversed scan, dx1 = dz1 W1^T with the mask in its epilogue, layer 0's
reversed scan, dx0 = dz0 W0^T, then the weight gradients dW0, db0, dU0,
dW1, dU1, db1 by the deterministic reduction of `csrc/biax_common.cuh`
over the dz tapes.  Only dh <- dz U^T carries from step to step; each
scan starts its dc carry from the cotangent of the layer's c_T and
returns the initial-state gradients.  The scans keep U resident in a
thread-block cluster in bfloat16 and stream it in float32, by
`biax.scan_route`.  `lstm2_bwd_staged` is those passes in plain
PyTorch, their yardstick (tests, chip_smoke.py).  The forward writes its
backward tapes (hs0, cs0, cs1) only when autograd will need them (the
Pallas `tapes=False` variant).

On a CPU tensor the wrapper runs the plain version
(`lstm2_stack_reference`); on a CUDA tensor it launches the kernels or
raises.  Launch counters: `lstm2_stack.fwd_launches` / `.bwd_launches`,
the forward's scans by route `.fwd_cluster_scans` / `.fwd_streamed_scans`,
the backward's `.cluster_scans` / `.streamed_scans`; the plain version
counts `.calls`.

`dump_masks` writes the stack's masks out as one [S, R, H] array (the
JAX package's `extract_masks` of tools/tpu_validate_lstm2.py) through the
kernel of `csrc/lstm2_masks.cu`, beside its plain version `stack_masks`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from music_generator_tpu_torch.ops import _build, biax
from music_generator_tpu_torch.ops.biax import (WGRAD_CHUNKS, _F, _P, _I, _U,
                                                _PRO_X1, _PRO_XTOT, _WGRAD,
                                                _apply, _cell, _check, _dot,
                                                _forward_scan, _is_bf16,
                                                _keep_bits, _keep_scale,
                                                _layout, _marker, _mask_args,
                                                _on_cuda, _pad8, _ptr,
                                                _reverse_scan, _stream,
                                                _wgrad)
from music_generator_tpu_torch.ops.lstm import check_recurrent_activation

S_STACK_MID = 6     # mask site salt (Site in csrc/biax_common.cuh); 0-5 are
                    # the biaxial stacks' sites

_SIGNATURES = {
    "lstm2_fwd_prologue": [_I, _I] + [_P] * 5 + [_I] * 4 + [_U, _U, _F, _I,
                                                           _P],
    "lstm2_fwd_in": [_I, _P, _I, _I] + [_P] * 3 + [_I, _I, _P],
    "lstm2_fwd_scan": [_I, _I] + [_P] * 8 + [_I] * 4 + [_P, _P],
    "lstm2_bwd_prologue": [_I] + [_P] * 5 + [_I] * 4 + [_U, _U, _F, _I, _P],
    "lstm2_bwd_preact": [_I, _P, _I, _I] + [_P] * 5 + [_I, _I, _P],
    "lstm2_bwd_scan": [_I, _I] + [_P] * 8 + [_I] * 4 + [_P, _P],
    "lstm2_bwd_dx": [_I, _I, _P, _P] + [_I] * 4 + [_P, _P, _U, _U, _F, _I,
                                                   _P],
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


def lstm2_fwd_staged(x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10,
                     dropout_p: float = 0.0, seed: int = 0,
                     compute_dtype=torch.float32,
                     recurrent_activation: str = "sigmoid",
                     tapes: bool = True):
    """The forward as the CUDA passes compute it, in plain PyTorch (no
    autograd), with their cast points and mask:

      1. - 2. layer 0's input pre-activations P0 = (x0 W0 -> T) + b0 over
         all S R rows at once;
      3. layer 0's forward scan (`biax._forward_scan`): z = P0[t] + (h[t-1]
         U0 -> T), h[-1] = h00, c seeded from c00, gates in T, c in
         float32, h = o tanh(c -> T);
      4. x1 = (hs0 * mask -> T) + s1m -> T;
      5. P1 = (x1 W1 -> T) + b1;
      6. layer 1's forward scan, as 3. with h10, c10.

    Returns the results of `lstm2_fwd`: (hs0, cs0, hs1, cs1 [S, R, H] in
    the compute dtype, h after step t and c before it; h0T, c0T, h1T, c1T
    [R, H] float32, h not rounded); hs0, cs0 and cs1 are None without
    `tapes`."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    S, R, _ = x0.shape
    H = u0.shape[0]
    x0, s1m = x0.to(cdt), s1m.to(cdt)
    W0, U0, W1, U1 = (w.to(cdt) for w in (w0, u0, w1, u1))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    masks = stack_masks(seed, S, R, H, 1.0 - dropout_p, cdt, x0.device)
    # 1. - 3.
    hs0, cs0, h0T, c0T = _forward_scan(_dot(x0, W0).to(cdt) + B0, U0, hard,
                                       h0=h00, c0=c00, ends=True)
    # 4. - 6.
    x1 = _apply(hs0, masks) + s1m
    hs1, cs1, h1T, c1T = _forward_scan(_dot(x1, W1).to(cdt) + B1, U1, hard,
                                       h0=h10, c0=c10, ends=True)
    if not tapes:
        hs0 = cs0 = cs1 = None
    return hs0, cs0, hs1, cs1, h0T, c0T, h1T, c1T


def lstm2_fwd(x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10,
              dropout_p: float = 0.0, seed: int = 0,
              compute_dtype=torch.float32,
              recurrent_activation: str = "sigmoid", tapes: bool = True,
              marks=None, scan_prof: Optional[torch.Tensor] = None):
    """Kernel 6 on CUDA tensors: the arguments and results of
    `lstm2_fwd_staged`, whose six passes it runs (csrc/lstm2.cu):
    `lstm2_fwd_prologue` (xp), `lstm2_fwd_in` and `lstm2_fwd_scan` of
    layer 0, the prologue's x1, then `lstm2_fwd_in` and `lstm2_fwd_scan` of
    layer 1.  The scans take `biax.scan_route(compute_dtype)`; without
    tapes hs0 is scratch and cs0, cs1 are not written.  With a list
    `marks`, a recorded CUDA event is appended after each pass, as (name,
    event), behind ("start", event): "xp", "in0", "scan0", "x1", "in1",
    "scan1".  With an int64 tensor `scan_prof` [2, 9] on the card, the
    cluster scans of layers 0 and 1 write their first block's clock cycles
    per phase and their plan, as the biaxial forwards' scans do.  Counts
    `lstm2_stack.fwd_launches`, and `.fwd_cluster_scans` or
    `.fwd_streamed_scans` once per scan."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("lstm2_stack", x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00,
                   h10, c10)
    S, R, Fin = x0.shape
    H = u0.shape[0]
    M = S * R
    x0, s1m, w0, b0, b1, u0, w1, u1 = (
        t.to(cdt).contiguous() for t in (x0, s1m, w0, b0.reshape(-1),
                                         b1.reshape(-1), u0, w1, u1))
    h00, c00, h10, c10 = (t.float().contiguous()
                          for t in (h00, c00, h10, c10))
    e = lambda *shape: torch.empty(*shape, dtype=cdt, device=dev)
    # Rows padded to 8 values (zeros): 16-byte rows for the products.
    xp, x1 = e(S, R, _pad8(Fin)), e(S, R, _pad8(H))
    pre = e(S, R, 4 * H)               # P of layer 0, then of layer 1
    hs0, hs1 = e(S, R, H), e(S, R, H)
    cs0, cs1 = (e(S, R, H), e(S, R, H)) if tapes else (None, None)
    fin = [torch.empty(R, H, device=dev) for _ in range(4)]
    w0, u0, w1, u1 = (_layout(w) for w in (w0, u0, w1, u1))
    route = biax.scan_route(cdt)
    lib = _build.bind("lstm2", _SIGNATURES)
    bf, st = _is_bf16(cdt), _stream(dev)
    drop = _mask_args(dropout_p, seed, cdt)
    mark = _marker(marks)

    def prologue(part, name):
        _check(lib.lstm2_fwd_prologue(
            bf, part, *(t.data_ptr() for t in (x0, s1m, hs0, xp, x1)), S, R,
            Fin, H, *drop, st), "lstm2_fwd_prologue")
        mark(name)

    def layer(i, xin, K, w, b, u, hs, cs, h0, c0, hT, cT):
        _check(lib.lstm2_fwd_in(bf, xin.data_ptr(), xin.shape[-1], K,
                                w.data_ptr(), b.data_ptr(), pre.data_ptr(),
                                M, H, st), "lstm2_fwd_in")
        mark(f"in{i}")
        prof = None if scan_prof is None else scan_prof[i]
        _check(lib.lstm2_fwd_scan(
            bf, int(route == "cluster"), pre.data_ptr(), hs.data_ptr(),
            _ptr(cs), u.data_ptr(), *(t.data_ptr() for t in (h0, c0, hT,
                                                             cT)),
            S, R, H, int(hard), _ptr(prof), st), f"lstm2_fwd_scan ({route})")
        mark(f"scan{i}")
        if route == "cluster":
            lstm2_stack.fwd_cluster_scans += 1
        else:
            lstm2_stack.fwd_streamed_scans += 1

    with torch.cuda.device(dev):
        mark("start")
        prologue(_PRO_XTOT, "xp")
        layer(0, xp, Fin, w0, b0, u0, hs0, cs0, h00, c00, *fin[:2])
        prologue(_PRO_X1, "x1")
        layer(1, x1, H, w1, b1, u1, hs1, cs1, h10, c10, *fin[2:])
    lstm2_stack.fwd_launches += 1
    return ((hs0 if tapes else None), cs0, hs1, cs1, *fin)


def lstm2_bwd_staged(x0, s1m, w0, b0, b1, u0, w1, u1, h00, h10, hs0, cs0,
                     hs1, cs1, dhs1, dh1T, dc0T, dc1T, dropout_p: float = 0.0,
                     seed: int = 0, compute_dtype=torch.float32,
                     recurrent_activation: str = "sigmoid"):
    """The backward as the CUDA passes compute it, in plain PyTorch (no
    autograd), with their cast points and mask.  x0 ... u1 and the initial
    h00, h10 [R, H] are the forward's inputs; hs0, cs0, hs1, cs1 [S, R, H]
    its tapes (h after step t, c before it, in the compute dtype); dhs1,
    dh1T, dc0T and dc1T the cotangents of hs1, h1T, c0T and c1T (that of
    h0T is ignored).

      0. the tapes: hs0p = [h00 -> T, hs0[:-1]], hs1p likewise, and dhs1
         with dh1T added to its last step in float32, rounded to T;
      1. the prologue: x1 = (hs0 * mask -> T) + s1m -> T;
      2. the pre-activations z = ((in W -> T) + b) + (hp U -> T) of both
         layers over all S R rows;
      3. layer 1's reversed scan (`biax._reverse_scan`): dc seeded with
         dc1T, dh = dz1 U1^T (float32) the only carried product;
      4. dx1 = dz1 W1^T in float32: ds1m = dx1 -> T, and the mid term
         dx1 * mask that layer 0 adds to its dh at the same step;
      5. layer 0's reversed scan, as 3. with dc0T;
      6. dx0 = dz0 W0^T -> T;
      7. the weight gradients, float32 sums of in^T dz and of dz.

    Returns (dx0, ds1m in the compute dtype; dw0, db0, db1, du0, dw1, du1,
    dh00, dc00, dh10, dc10 float32), the order of the stack's inputs."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    S, R, Fin = x0.shape
    H = u0.shape[0]
    x0, s1m, hs0, cs0, hs1, cs1 = (t.to(cdt) for t in (x0, s1m, hs0, cs0,
                                                       hs1, cs1))
    W0, U0, W1, U1 = (w.to(cdt) for w in (w0, u0, w1, u1))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    masks = stack_masks(seed, S, R, H, 1.0 - dropout_p, cdt, x0.device)
    # 0. the tapes
    hs0p = torch.cat([h00.to(cdt)[None], hs0[:-1]])
    hs1p = torch.cat([h10.to(cdt)[None], hs1[:-1]])
    ext = dhs1.float().clone()
    ext[-1] += dh1T.float()
    ext = ext.to(cdt)
    # 1. - 2.
    x1 = _apply(hs0, masks) + s1m
    z0 = (_dot(x0, W0).to(cdt) + B0) + _dot(hs0p, U0).to(cdt)
    z1 = (_dot(x1, W1).to(cdt) + B1) + _dot(hs1p, U1).to(cdt)
    # 3. - 6.
    dz1, (dh10, dc10) = _reverse_scan(z1, cs1, ext, U1, hard,
                                      dc=dc1T.float())
    dx1 = _dot(dz1, W1.t())
    dmid = _apply(dx1, None if masks is None else masks.float())
    dz0, (dh00, dc00) = _reverse_scan(z0, cs0, dmid, U0, hard,
                                      dc=dc0T.float())
    dx0 = _dot(dz0, W0.t()).to(cdt)
    # 7.
    flat = lambda t: t.reshape(S * R, t.shape[-1])
    wg = lambda a, dz: _dot(flat(a).t(), flat(dz))
    return (dx0, dx1.to(cdt), wg(x0, dz0), flat(dz0).float().sum(0),
            flat(dz1).float().sum(0), wg(hs0p, dz0), wg(x1, dz1),
            wg(hs1p, dz1), dh00, dc00, dh10, dc10)


def lstm2_bwd(x0, s1m, w0, b0, b1, u0, w1, u1, h00, h10, hs0, cs0, hs1, cs1,
              dhs1, dh1T, dc0T, dc1T, dropout_p: float = 0.0, seed: int = 0,
              compute_dtype=torch.float32,
              recurrent_activation: str = "sigmoid", marks=None,
              scan_prof: Optional[torch.Tensor] = None):
    """Kernel 7 on CUDA tensors: the arguments and results of
    `lstm2_bwd_staged`, whose passes it runs (csrc/lstm2.cu): the tapes,
    `lstm2_bwd_prologue`, two `lstm2_bwd_preact`, `lstm2_bwd_scan` of
    layer 1, `lstm2_bwd_dx` of layer 1, the scan of layer 0, the dx of
    layer 0, and the reductions `biax_wgrad`.  The scans take
    `biax.scan_route(compute_dtype)`.  With a list `marks`, a recorded CUDA
    event is appended after each pass, as (name, event), behind ("start",
    event): "tapes", "prologue", "preact", "scan1", "dx1", "scan0", "dx0",
    "wgrad".  With an int64 tensor `scan_prof` [2, 9] on the card, the
    cluster scans of layers 1 and 0 write their first block's clock cycles
    per phase and their plan, as the biaxial backwards' scans do.  Counts
    `lstm2_stack.bwd_launches`, and `.cluster_scans` or `.streamed_scans`
    once per scan."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("lstm2_stack", x0, s1m, w0, b0, b1, u0, w1, u1, h00, h10,
                   hs0, cs0, hs1, cs1, dhs1, dh1T, dc0T, dc1T)
    S, R, Fin = x0.shape
    H = u0.shape[0]
    H4, M = 4 * H, S * R
    x0, s1m, w0, b0, b1, u0, w1, u1, hs0, cs0, hs1, cs1 = (
        t.to(cdt).contiguous() for t in (x0, s1m, w0, b0.reshape(-1),
                                         b1.reshape(-1), u0, w1, u1, hs0,
                                         cs0, hs1, cs1))
    route = biax.scan_route(cdt)
    scan_u = [u if route == "cluster" else _layout(u.t()) for u in (u0, u1)]
    mats = [_layout(w) for w in (w0, u0, w1, u1, w0.t(), w1.t())]
    e = lambda *shape, dt=cdt: torch.empty(*shape, dtype=dt, device=dev)
    f32 = torch.float32
    lib = _build.bind("lstm2", _SIGNATURES)
    bf, st = _is_bf16(cdt), _stream(dev)
    drop = _mask_args(dropout_p, seed, cdt)
    mark = _marker(marks)
    ends = [torch.empty(R, H, device=dev) for _ in range(4)]

    def scan(layer, z, cs, ext_t, ext_f, dcT, dh0, dc0):
        prof = None if scan_prof is None else scan_prof[1 - layer]
        _check(lib.lstm2_bwd_scan(
            bf, int(route == "cluster"), z.data_ptr(), cs.data_ptr(),
            _ptr(ext_t), _ptr(ext_f), scan_u[layer].data_ptr(),
            dcT.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), S, R, H,
            int(hard), _ptr(prof), st), f"lstm2_bwd_scan ({route})")
        if route == "cluster":
            lstm2_stack.cluster_scans += 1
        else:
            lstm2_stack.streamed_scans += 1

    def dx(layer, z, wt, Nout, out_t, out_b):
        _check(lib.lstm2_bwd_dx(bf, layer, z.data_ptr(), wt.data_ptr(), S, R,
                                H, Nout, out_t.data_ptr(), _ptr(out_b),
                                *drop, st), "lstm2_bwd_dx")

    with torch.cuda.device(dev):
        mark("start")
        # 0. the tapes
        hs0p = torch.cat([h00.to(cdt)[None], hs0[:-1]])
        hs1p = torch.cat([h10.to(cdt)[None], hs1[:-1]])
        # dhs1 rounded to T, its last step summed with dh1T in float32
        # first: the values of the float32 sum rounded to T.
        ext = dhs1.to(cdt, memory_format=torch.contiguous_format, copy=True)
        ext[-1] = dhs1[-1].float() + dh1T.float()
        dc0T, dc1T = (t.float().contiguous() for t in (dc0T, dc1T))
        mark("tapes")
        # 1. - 2.  Rows padded to 8 values (zeros): 16-byte rows.
        xp, x1 = e(S, R, _pad8(Fin)), e(S, R, _pad8(H))
        _check(lib.lstm2_bwd_prologue(
            bf, *(t.data_ptr() for t in (x0, s1m, hs0, xp, x1)), S, R, Fin,
            H, *drop, st), "lstm2_bwd_prologue")
        mark("prologue")
        z0, z1 = e(S, R, H4), e(S, R, H4)       # z in, dz out
        for xin, K, w, b, hp, u, z in ((xp, Fin, mats[0], b0, hs0p, mats[1],
                                        z0),
                                       (x1, H, mats[2], b1, hs1p, mats[3],
                                        z1)):
            _check(lib.lstm2_bwd_preact(
                bf, xin.data_ptr(), xin.shape[-1], K, w.data_ptr(),
                b.data_ptr(), hp.data_ptr(), u.data_ptr(), z.data_ptr(), M,
                H, st), "lstm2_bwd_preact")
        mark("preact")
        # 3. - 6.
        scan(1, z1, cs1, ext, None, dc1T, ends[2], ends[3])
        mark("scan1")
        ds1m, dmid = e(S, R, H), e(S, R, H, dt=f32)
        dx(1, z1, mats[5], H, ds1m, dmid)
        mark("dx1")
        scan(0, z0, cs0, None, dmid, dc0T, ends[0], ends[1])
        mark("scan0")
        dx0 = e(S, R, Fin)
        dx(0, z0, mats[4], Fin, dx0, None)
        mark("dx0")
        # 7.
        ws = e(WGRAD_CHUNKS * max(Fin, H) * H4, dt=f32)
        dw0 = _wgrad(lib, xp, 0, z0, Fin, ws)
        du0 = _wgrad(lib, hs0p, 0, z0, H, ws)
        dw1 = _wgrad(lib, x1, 0, z1, H, ws)
        du1 = _wgrad(lib, hs1p, 0, z1, H, ws)
        db0 = _wgrad(lib, None, 0, z0, 1, ws).reshape(H4)
        db1 = _wgrad(lib, None, 0, z1, 1, ws).reshape(H4)
        mark("wgrad")
    lstm2_stack.bwd_launches += 1
    return (dx0, ds1m, dw0, db0, db1, du0, dw1, du1, *ends)


class _Stack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10,
                dropout_p, seed, cdt, act):
        tapes = any(ctx.needs_input_grad)
        hs0, cs0, hs1, cs1, *fin = lstm2_fwd(
            x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10, dropout_p,
            seed, cdt, act, tapes)
        if tapes:
            ctx.save_for_backward(x0, s1m, w0, b0, b1, u0, w1, u1, h00, h10,
                                  hs0, cs0, hs1, cs1)
            ctx.cfg = (dropout_p, seed, cdt, act)
            ctx.dtypes = tuple(t.dtype for t in (
                x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10))
        return (hs1, *fin)

    @staticmethod
    def backward(ctx, dhs1, dh0T, dc0T, dh1T, dc1T):
        # dh0T is ignored (pallas_lstm2.py:370-374).
        del dh0T
        grads = lstm2_bwd(*ctx.saved_tensors, dhs1, dh1T, dc0T, dc1T,
                          *ctx.cfg)
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
                             compute_dtype, recurrent_activation)
    return hs1, tuple(fin)


lstm2_stack.fwd_launches = 0
lstm2_stack.bwd_launches = 0
lstm2_stack.fwd_cluster_scans = 0
lstm2_stack.fwd_streamed_scans = 0
lstm2_stack.cluster_scans = 0
lstm2_stack.streamed_scans = 0
