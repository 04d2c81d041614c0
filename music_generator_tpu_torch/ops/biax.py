"""The biaxial training stacks: the time-axis and note-axis two-layer LSTM
stacks of the JAX package's `ops/pallas_biax.py` (v3), as hand-written CUDA
kernels (`csrc/biax_time.cu`, `csrc/biax_note.cu`) inside
`torch.autograd.Function`s, beside their plain PyTorch versions.

    biax_time_stack(x [T,N,B,F], s0 [T,B,F], s1 [T,B,H], w0, b0, b1, u0,
                    w1, u1) -> hs1 [T,N,B,H]          (compute dtype)
    biax_note_stack(ht [T,N,B,Ht], chosen [N,T,B,C], s0 [T,B,Ht+C],
                    s1 [T,B,H], w0, b0, b1, u0, w1, u1, whead [H,3],
                    bhead [3]) -> [N,T,B,3]           (float32)

The time stack scans T with rows (n, b); the note stack scans N with rows
(t, b) and reads the time stack's output through its output-dropout mask
(`S_IN`), adds the split style-0 terms (`S_STYLE0` over the Ht columns,
`S_STYLE0C` over the chosen columns), and ends in the fused heads
sigmoid(play, replay) ++ linear volume.

The arithmetic is the Pallas kernels' (`_cell_fwd`, pallas_biax.py:133-141):
products accumulate in float32 and are cast to the compute dtype, gates run
in the compute dtype with the sigmoid as 0.5*tanh(0.5x)+0.5 (or Keras 2's
hard_sigmoid, clip(0.2x+0.5, 0, 1)), c stays float32 and
h = o * tanh(c cast to the compute dtype).

Dropout masks are the Pallas kernels' Murmur3 keep-masks (`_mask`,
pallas_biax.py:102-130), bit for bit, under the TPU kernels' row tiling
(`_row_tiling`): for the time stack an element (t, n, b, col) of a site of
width W sits in tile j = n // k at scan step t, row r = (n % k) * B + b, at
index r * W + col; the note stack swaps the roles of t and n.  The CUDA
kernels tile rows their own way and compute these coordinates per element.

On a CPU tensor the wrappers run the plain versions
(`biax_time_stack_reference`, `biax_note_stack_reference`: loops over the
scan whose autograd gives the reference gradient).  On a CUDA tensor they
launch the kernels or raise.  The wrappers take the float32 parameters and
cast them inside, and return float32 weight gradients, as the custom VJPs
do (pallas_biax.py:536-559, 1053-1081).  Launch counters:
`biax_time_stack.fwd_launches` / `.bwd_launches`, the same on
`biax_note_stack`; the plain versions count `.calls`.

Every CUDA path runs in passes, because only one product carries from
one scan step to the next: h U in a forward, dh <- dz U^T in a backward.
The time forward (`biax_time_fwd`) is six passes: xtot, layer 0's input
pre-activations as one bulk product, layer 0's forward scan, x1, layer 1's
bulk product, layer 1's scan; the note forward (`biax_note_fwd`) the same
six and the heads as a seventh.  In both backwards (`biax_time_bwd`,
`biax_note_bwd`) the forward's gates, the note stack's heads backward,
dx1 = dz1 W1^T and dx = dz0 W0^T are elementwise passes and bulk products
outside the two reversed scans.  The stacks share that machinery
(`csrc/biax_passes.cuh`).  The `*_staged` functions (`biax_time_fwd_staged`,
`biax_note_fwd_staged`, `biax_time_bwd_staged`, `biax_note_bwd_staged`)
are the same computations in plain PyTorch.  In bfloat16 the scans keep
U resident in a thread-block cluster (one block for the note stack's
H = 128), in float32 they stream it (`scan_route`); each stack's
`.fwd_cluster_scans` and `.fwd_streamed_scans` count its forward's
scans, `.cluster_scans` and `.streamed_scans` its backward's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from music_generator_tpu_torch.ops import _build
from music_generator_tpu_torch.ops.lstm import check_recurrent_activation

# Dropout-site salts (pallas_biax.py:52-56, 607).
S_IN = 0        # the time stack's output dropout, applied by the note stack
S_STYLE0 = 1
S_STYLE1 = 2
S_MID = 3       # inter-layer dropout
S_OUT = 4       # output dropout (note stack only)
S_STYLE0C = 5   # style-0 mask over the chosen-feature columns

MAX_TILE_ROWS = 256
_U32 = 0xFFFFFFFF


def _row_tiling(A: int, B: int, max_rows: int = 0) -> Tuple[int, int]:
    """The TPU kernels' tiling of the (across, batch) row space into (k, B)
    blocks: the largest k dividing A with k * B <= max_rows (256).
    Returns (k, A // k).  The masks are defined on it."""
    max_rows = max_rows or MAX_TILE_ROWS
    if B >= max_rows:
        return 1, A
    best = 1
    for k in range(1, A + 1):
        if A % k == 0 and k * B <= max_rows:
            best = k
    return best, A // best


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without overflowing
    int64: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _threshold(keep_prob: float) -> int:
    """The keep threshold as the Pallas kernel computes it on the host."""
    return int((1.0 - keep_prob) * 0xFFFFFFFF) & _U32


def _keep_scale(keep_prob: float, dtype: torch.dtype) -> float:
    """1/keep in the compute dtype, the value a kept element is scaled by."""
    return float(torch.tensor(1.0 / keep_prob, dtype=dtype))


def _keep_bits(seed: int, site: int, j, s, idx: torch.Tensor,
               keep_prob: float) -> torch.Tensor:
    """The Murmur3-finalizer keep decision of each element index `idx`
    (int64 tensors broadcastable together) of tile j at scan step s."""
    j = torch.as_tensor(j, dtype=torch.int64, device=idx.device)
    s = torch.as_tensor(s, dtype=torch.int64, device=idx.device)
    base = (_mul32(torch.tensor(seed & _U32, dtype=torch.int64,
                                device=idx.device), 0x9E3779B1)
            ^ ((site * 0x85EBCA77) & _U32)
            ^ _mul32(j, 0xC2B2AE3D) ^ _mul32(s, 0x27D4EB2F))
    x = (idx + base) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= _threshold(keep_prob)


def _mask(seed: int, site: int, j: int, s: int, shape: Tuple[int, int],
          keep_prob: float, dtype: torch.dtype,
          device=None) -> Optional[torch.Tensor]:
    """The keep-mask of one (site, tile j, scan step s), shape (R, W),
    scaled by 1/keep: `_mask` of pallas_biax.py:102-130.  None when
    dropout is off."""
    if keep_prob >= 1.0:
        return None
    R, W = shape
    rows = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(W, dtype=torch.int64, device=device)[None, :]
    keep = _keep_bits(seed, site, j, s, rows * W + cols, keep_prob)
    return keep.to(dtype) * _keep_scale(keep_prob, dtype)


def stack_mask(seed: int, site: int, S: int, A: int, B: int, W: int,
               keep_prob: float, dtype: torch.dtype,
               device=None) -> Optional[torch.Tensor]:
    """The masks of one site over a whole stack, [S, A, B, W] (scan step,
    across, batch, column), under the TPU tiling k = _row_tiling(A, B)."""
    if keep_prob >= 1.0:
        return None
    k, _ = _row_tiling(A, B)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    s = ar(S)[:, None, None, None]
    a = ar(A)[None, :, None, None]
    b = ar(B)[None, None, :, None]
    col = ar(W)[None, None, None, :]
    idx = ((a % k) * B + b) * W + col
    keep = _keep_bits(seed, site, a // k, s, idx, keep_prob)
    return keep.to(dtype) * _keep_scale(keep_prob, dtype)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation (exact products of compute-dtype
    operands, summed in float32)."""
    return a.float() @ b.float()


def _gate(x: torch.Tensor, hard: bool) -> torch.Tensor:
    """The recurrent gate in x's dtype: 0.5*tanh(0.5x)+0.5, or Keras 2's
    hard_sigmoid with the constant 0.2 in x's dtype."""
    if hard:
        c = torch.tensor(0.2, dtype=x.dtype, device=x.device)
        return torch.clamp(x * c + 0.5, 0.0, 1.0)
    return 0.5 * torch.tanh(0.5 * x) + 0.5


def _cell(z_in: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
          u: torch.Tensor, hard: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_cell_fwd`: z = z_in + (h_cdt @ U -> cdt), gates in the compute
    dtype, c float32, h = o * tanh(c_cdt) in float32."""
    cdt = z_in.dtype
    H = u.shape[0]
    z = z_in + _dot(h.to(cdt), u).to(cdt)
    i = _gate(z[:, :H], hard)
    f = _gate(z[:, H:2 * H], hard)
    g = torch.tanh(z[:, 2 * H:3 * H])
    o = _gate(z[:, 3 * H:], hard)
    c_new = f.float() * c + (i * g).float()
    h_new = o.float() * torch.tanh(c_new.to(cdt)).float()
    return h_new, c_new


def _apply(x: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    return x if m is None else x * m


def biax_time_stack_reference(x, s0, s1, w0, b0, b1, u0, w1, u1,
                              dropout_p: float = 0.0, seed: int = 0,
                              compute_dtype=torch.float32,
                              recurrent_activation: str = "sigmoid"):
    """The time stack as a plain loop over T (rows (n, b)); see the module
    docstring.  Returns hs1 [T, N, B, H] in the compute dtype."""
    biax_time_stack_reference.calls += 1
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    T, N, B, F = x.shape
    H = u0.shape[0]
    R, dev = N * B, x.device
    keep = 1.0 - dropout_p
    x, s0, s1 = x.to(cdt), s0.to(cdt), s1.to(cdt)
    W0, U0, W1, U1 = (w.to(cdt) for w in (w0, u0, w1, u1))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    m0 = stack_mask(seed, S_STYLE0, T, N, B, F, keep, cdt, dev)
    m1 = stack_mask(seed, S_STYLE1, T, N, B, H, keep, cdt, dev)
    mmid = stack_mask(seed, S_MID, T, N, B, H, keep, cdt, dev)
    h0 = c0 = h1 = c1 = torch.zeros(R, H, device=dev)
    out = []
    for t in range(T):
        xt = x[t] + _apply(s0[t][None].expand(N, B, F),
                           None if m0 is None else m0[t])
        xw0 = _dot(xt.reshape(R, F), W0).to(cdt) + B0
        h0, c0 = _cell(xw0, h0, c0, U0, hard)
        x1 = _apply(h0.to(cdt), None if mmid is None else mmid[t].reshape(R, H))
        s1t = s1[t][None].expand(N, B, H).reshape(R, H)
        x1 = x1 + _apply(s1t, None if m1 is None else m1[t].reshape(R, H))
        xw1 = _dot(x1, W1).to(cdt) + B1
        h1, c1 = _cell(xw1, h1, c1, U1, hard)
        out.append(h1.to(cdt).reshape(N, B, H))
    return torch.stack(out)


biax_time_stack_reference.calls = 0


def biax_note_stack_reference(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1,
                              whead, bhead, dropout_p: float = 0.0,
                              seed: int = 0, compute_dtype=torch.float32,
                              recurrent_activation: str = "sigmoid"):
    """The note stack as a plain loop over N (rows (t, b)); see the module
    docstring.  Returns [N, T, B, 3] float32."""
    biax_note_stack_reference.calls += 1
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    T, N, B, Ht = ht.shape
    C = chosen.shape[-1]
    H = u0.shape[0]
    R, dev = T * B, ht.device
    keep = 1.0 - dropout_p
    ht, chosen = ht.to(cdt), chosen.to(cdt)
    s0t = s0[..., :Ht].to(cdt).reshape(R, Ht)
    s0c = s0[..., Ht:].to(cdt).reshape(R, C)
    s1 = s1.to(cdt).reshape(R, H)
    W0t, W0c = w0[:Ht].to(cdt), w0[Ht:].to(cdt)
    U0, W1, U1, Wh = (w.to(cdt) for w in (u0, w1, u1, whead))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    bh = bhead.reshape(-1).float()

    def masks(site, width):
        m = stack_mask(seed, site, N, T, B, width, keep, cdt, dev)
        return [None] * N if m is None else m.reshape(N, R, width)

    m_in, m0t, m0c = masks(S_IN, Ht), masks(S_STYLE0, Ht), masks(S_STYLE0C, C)
    m1, mmid, m_out = masks(S_STYLE1, H), masks(S_MID, H), masks(S_OUT, H)
    h0 = c0 = h1 = c1 = torch.zeros(R, H, device=dev)
    out = []
    for n in range(N):
        xt = _apply(ht[:, n].reshape(R, Ht), m_in[n])
        xt_tot = xt + _apply(s0t, m0t[n])
        ch_tot = chosen[n].reshape(R, C) + _apply(s0c, m0c[n])
        xw0 = (_dot(xt_tot, W0t) + _dot(ch_tot, W0c)).to(cdt) + B0
        h0, c0 = _cell(xw0, h0, c0, U0, hard)
        x1 = _apply(h0.to(cdt), mmid[n]) + _apply(s1, m1[n])
        xw1 = _dot(x1, W1).to(cdt) + B1
        h1, c1 = _cell(xw1, h1, c1, U1, hard)
        h1d = _apply(h1.to(cdt), m_out[n])
        z = _dot(h1d, Wh) + bh
        zs = _gate(z[:, :2].to(cdt), False).float()
        out.append(torch.cat([zs, z[:, 2:]], dim=-1).reshape(T, B, 3))
    return torch.stack(out)


biax_note_stack_reference.calls = 0


def _gate_grad(s: torch.Tensor, hard: bool) -> torch.Tensor:
    """d gate / dz through the gate's float32 output s (`_gate_grad`)."""
    if hard:
        return ((s > 0) & (s < 1)).float() * 0.2
    return s * (1.0 - s)


def _reverse_scan(z: torch.Tensor, cs: torch.Tensor, ext: torch.Tensor,
                  u: torch.Tensor, hard: bool,
                  dc: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Passes 3 and 5 of both staged backwards: one layer's cell backward,
    reversed over the scanned axis.  z [S, R, 4H] holds the pre-activations
    in the compute dtype, cs [S, R, H] the previous c, ext [S, R, H] the
    external dh of each step; dh = dz U^T (float32) is the only carried
    product.  The dc carry starts at `dc` [R, H] (float32; zeros when None).
    Returns dz [S, R, 4H] rounded to the compute dtype and the carries after
    the first step, (dz[0] U^T, dc), in float32."""
    cdt = z.dtype
    S, R, H4 = z.shape
    H = H4 // 4
    dz = torch.empty_like(z)
    dh_carry = torch.zeros(R, H, device=z.device)
    dc = torch.zeros(R, H, device=z.device) if dc is None else dc.float()
    for t in reversed(range(S)):
        i, f, o = (_gate(z[t, :, a * H:(a + 1) * H], hard)
                   for a in (0, 1, 3))
        g = torch.tanh(z[t, :, 2 * H:3 * H])
        cp = cs[t].float()
        tc = torch.tanh((f.float() * cp + (i * g).float()).to(cdt)).float()
        i, f, g, o = i.float(), f.float(), g.float(), o.float()
        dh = dh_carry + ext[t].float()
        dc = dc + dh * o * (1.0 - tc * tc)
        dz[t] = torch.cat([dc * g * _gate_grad(i, hard),
                           dc * cp * _gate_grad(f, hard),
                           dc * i * (1.0 - g * g),
                           dh * tc * _gate_grad(o, hard)], -1).to(cdt)
        dc = dc * f
        dh_carry = _dot(dz[t], u.t())
    return dz, (dh_carry, dc)


def _forward_scan(pre: torch.Tensor, u: torch.Tensor, hard: bool,
                  h0: Optional[torch.Tensor] = None,
                  c0: Optional[torch.Tensor] = None,
                  ends: bool = False) -> Tuple[torch.Tensor, ...]:
    """Passes 3 and 6 of the staged forwards, and the recurrence's forward:
    one layer's cell over the scanned axis.  pre [S, R, 4H] holds the input
    pre-activations ((in W -> T) + b, or the recurrence's xw) in the compute
    dtype; h[s-1] U (float32, cast to T) is the only carried product.
    h[-1] = h0 and the c carry starts at c0 ([R, H], zeros when None).
    Returns hs, cs [S, R, H] in the compute dtype (h after step s, c before
    it) and, with `ends`, the last h (not rounded) and c in float32."""
    cdt = pre.dtype
    S, R, H4 = pre.shape
    zeros = torch.zeros(R, H4 // 4, device=pre.device)
    h = zeros if h0 is None else h0.float()
    c = zeros if c0 is None else c0.float()
    hs, cs = [], []
    for s in range(S):
        cs.append(c.to(cdt))
        h, c = _cell(pre[s], h, c, u, hard)
        hs.append(h.to(cdt))
    out = (torch.stack(hs), torch.stack(cs))
    return out + (h, c) if ends else out


def _time_masks(seed, T, N, B, F, H, dropout_p, cdt, dev):
    """The time stack's (m_style0, m_style1, m_mid), each None at p = 0."""
    keep = 1.0 - dropout_p
    return tuple(stack_mask(seed, site, T, N, B, W, keep, cdt, dev)
                 for site, W in ((S_STYLE0, F), (S_STYLE1, H), (S_MID, H)))


def _time_xtot(x, s0, m0) -> torch.Tensor:
    """The time stack's layer-0 input xtot = x + s0 m_style0 as rows
    [T, N B, F] (each operation rounded to the compute dtype)."""
    T, N, B, F = x.shape
    return (x + _apply(s0[:, None].expand(T, N, B, F), m0)).reshape(
        T, N * B, F)


def _time_x1(hs0, s1, mmid, m1) -> torch.Tensor:
    """The time stack's layer-1 input x1 = hs0 m_mid + s1 m_style1 as rows
    [T, N B, H]."""
    T, N, B, H = hs0.shape
    return (_apply(hs0, mmid)
            + _apply(s1[:, None].expand(T, N, B, H), m1)).reshape(
                T, N * B, H)


def biax_time_fwd_staged(x, s0, s1, w0, b0, b1, u0, w1, u1,
                         dropout_p: float = 0.0, seed: int = 0,
                         compute_dtype=torch.float32,
                         recurrent_activation: str = "sigmoid"):
    """The time stack's forward as the CUDA kernels compute it, in plain
    PyTorch (no autograd): the six passes of `csrc/biax_time.cu` with
    their cast points and masks.

      1. xtot = x + masked style-0 (each operation rounded to T);
      2. layer 0's input pre-activations P0 = (xtot W0 -> T) + b0 for all
         T N B rows at once;
      3. the layer-0 scan: z = P0[t] + (h[t-1] U0 -> T), h[-1] = 0, gates
         in T, c in float32, h = o tanh(c -> T);
      4. x1 = masked hs0 + masked style-1;
      5. P1 = (x1 W1 -> T) + b1;
      6. the layer-1 scan, as 3.

    Returns the tapes (hs0, cs0, hs1, cs1) [T, N, B, H] in the compute
    dtype (h after step t, c before it)."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    T, N, B, F = x.shape
    H = u0.shape[0]
    x, s0, s1 = x.to(cdt), s0.to(cdt), s1.to(cdt)
    W0, U0, W1, U1 = (w.to(cdt) for w in (w0, u0, w1, u1))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    m0, m1, mmid = _time_masks(seed, T, N, B, F, H, dropout_p, cdt, x.device)
    tape = lambda t: t.reshape(T, N, B, H)
    # 1. - 3.
    hs0, cs0 = _forward_scan(_dot(_time_xtot(x, s0, m0), W0).to(cdt) + B0,
                             U0, hard)
    # 4. - 6.
    x1 = _time_x1(tape(hs0), s1, mmid, m1)
    hs1, cs1 = _forward_scan(_dot(x1, W1).to(cdt) + B1, U1, hard)
    return tuple(tape(t) for t in (hs0, cs0, hs1, cs1))


def biax_time_bwd_staged(x, s0, s1, w0, b0, b1, u0, w1, u1, hs0, cs0, hs1,
                         cs1, dhs1, dropout_p: float = 0.0, seed: int = 0,
                         compute_dtype=torch.float32,
                         recurrent_activation: str = "sigmoid"):
    """The time stack's backward as the CUDA kernels compute it, in plain
    PyTorch (no autograd): the six passes of `csrc/biax_time.cu` with
    their cast points and masks.  hs0, cs0, hs1, cs1 [T, N, B, H] are the
    forward's tapes (h after step t, c before it, in the compute dtype) and
    dhs1 the cotangent of hs1.

      1. prologue: xtot = x + masked style-0, x1 = masked hs0 + masked
         style-1 (each operation rounded to the compute dtype);
      2. bulk pre-activations z = ((in W -> T) + b) + (h[t-1] U -> T),
         h[-1] = 0;
      3. the layer-1 scan, reversed: the cell backward gives dz1 (rounded
         to T), and dh = dz1 U1^T (float32) is the only carried product;
      4. dx1 = dz1 W1^T in float32: the style-1 rows dx1 * m_style1 and the
         term dx1 * m_mid that layer 0 adds to its dh at the same step;
      5. the layer-0 scan, as 3;
      6. dx = dz0 W0^T (rounded to T) and the style-0 rows dx * m_style0.

    The style gradients sum the rows over the notes of each TPU tile,
    rounded to T per tile, then over the tiles; the weight gradients are
    float32 sums of in^T dz.  Returns (dx, ds0, ds1, dw0, db0, db1, du0,
    dw1, du1): dx in the compute dtype, the rest float32."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    T, N, B, F = x.shape
    H = u0.shape[0]
    R, dev = N * B, x.device
    k, _ = _row_tiling(N, B)
    x, s0, s1 = x.to(cdt), s0.to(cdt), s1.to(cdt)
    W0, U0, W1, U1 = (w.to(cdt) for w in (w0, u0, w1, u1))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    hs0, cs0, hs1, cs1, dhs1 = (t.to(cdt) for t in (hs0, cs0, hs1, cs1,
                                                    dhs1))
    m0, m1, mmid = _time_masks(seed, T, N, B, F, H, dropout_p, cdt, dev)
    rows = lambda t: t.reshape(T, R, t.shape[-1])
    f32 = lambda m: None if m is None else rows(m).float()

    # 1. prologue
    xtot, x1 = _time_xtot(x, s0, m0), _time_x1(hs0, s1, mmid, m1)
    # 2. bulk pre-activations
    prev = lambda h: torch.cat([torch.zeros_like(h[:1]), h[:-1]])
    hp0, hp1 = prev(rows(hs0)), prev(rows(hs1))
    z0 = (_dot(xtot, W0).to(cdt) + B0) + _dot(hp0, U0).to(cdt)
    z1 = (_dot(x1, W1).to(cdt) + B1) + _dot(hp1, U1).to(cdt)

    # 3. - 6.
    dz1, _ = _reverse_scan(z1, rows(cs1), rows(dhs1), U1, hard)
    dx1 = _dot(dz1, W1.t())
    ds1r, dmid = _apply(dx1, f32(m1)), _apply(dx1, f32(mmid))
    dz0, _ = _reverse_scan(z0, rows(cs0), dmid, U0, hard)
    dxo = _dot(dz0, W0.t())
    ds0r = _apply(dxo, f32(m0))

    def tile_sums(r, W):
        part = r.reshape(T, N // k, k, B, W).sum(2)
        return part.to(cdt).float().sum(1)

    flat = lambda t: t.reshape(T * R, t.shape[-1])
    wg = lambda a, dz: _dot(flat(a).t(), flat(dz))
    return (dxo.to(cdt).reshape(T, N, B, F), tile_sums(ds0r, F),
            tile_sums(ds1r, H), wg(xtot, dz0), flat(dz0).float().sum(0),
            flat(dz1).float().sum(0), wg(hp0, dz0), wg(x1, dz1),
            wg(hp1, dz1))


def _note_masks(seed, T, N, B, Ht, C, H, dropout_p, cdt, dev):
    """The note stack's (m_in, m_style0, m_style0c, m_style1, m_mid, m_out)
    as rows [N, T B, W], each None at p = 0."""
    keep = 1.0 - dropout_p

    def rows(site, W):
        m = stack_mask(seed, site, N, T, B, W, keep, cdt, dev)
        return None if m is None else m.reshape(N, T * B, W)

    return tuple(rows(site, W) for site, W in (
        (S_IN, Ht), (S_STYLE0, Ht), (S_STYLE0C, C), (S_STYLE1, H),
        (S_MID, H), (S_OUT, H)))


def _note_xtot(ht, chosen, s0, m_in, m0t, m0c) -> torch.Tensor:
    """The note stack's layer-0 input xtot = (ht m_in + s0t m_style0) ++
    (chosen + s0c m_style0c) as rows [N, T B, Ht + C] (each operation
    rounded to the compute dtype)."""
    T, N, B, Ht = ht.shape
    R = T * B
    s0 = s0.reshape(R, s0.shape[-1])
    rows = lambda t: t.reshape(N, R, t.shape[-1])
    return torch.cat([_apply(rows(ht.transpose(0, 1)), m_in)
                      + _apply(s0[:, :Ht], m0t),
                      rows(chosen) + _apply(s0[:, Ht:], m0c)], -1)


def _note_x1(hs0, s1, mmid, m1) -> torch.Tensor:
    """The note stack's layer-1 input x1 = hs0 m_mid + s1 m_style1 from the
    rows hs0 [N, T B, H]."""
    return _apply(hs0, mmid) + _apply(s1.reshape(-1, hs0.shape[-1]), m1)


def _note_heads(hs1, wh, bh, m_out):
    """The heads on the rows hs1 [N, T B, H]: (h1d = hs1 m_out, the float32
    pre-activation z = h1d Wh + bh, sigmoid(z[..., :2] -> T) in float32)."""
    h1d = _apply(hs1, m_out)
    z = _dot(h1d, wh) + bh
    return h1d, z, _gate(z[..., :2].to(hs1.dtype), False).float()


def biax_note_fwd_staged(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, whead,
                         bhead, dropout_p: float = 0.0, seed: int = 0,
                         compute_dtype=torch.float32,
                         recurrent_activation: str = "sigmoid"):
    """The note stack's forward as the CUDA kernels compute it, in plain
    PyTorch (no autograd): the seven passes of `csrc/biax_note.cu` with
    their cast points and masks.  Rows m = n R + g, g = (t, b), R = T B.

      1. xtot = (ht m_in + s0t m_style0) ++ (chosen + s0c m_style0c) (each
         operation rounded to the compute dtype);
      2. layer 0's input pre-activations P0 = (xtot W0 -> T) + b0 for all
         N T B rows at once, one float32 sum over the Ht and C columns;
      3. the layer-0 scan over the pitches: z = P0[n] + (h[n-1] U0 -> T),
         h[-1] = 0, gates in T, c in float32, h = o tanh(c -> T);
      4. x1 = hs0 m_mid + s1 m_style1;
      5. P1 = (x1 W1 -> T) + b1;
      6. the layer-1 scan, as 3.;
      7. the heads: z = (hs1 m_out) Wh + bh in float32, out =
         sigmoid(z_play, z_replay -> T) ++ z_volume.

    Returns (out [N, T, B, 3] float32, hs0, cs0, hs1, cs1 [N, T, B, H] in
    the compute dtype (h after pitch n, c before it)), as `biax_note_fwd`."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    T, N, B, Ht = ht.shape
    C = chosen.shape[-1]
    H = u0.shape[0]
    ht, chosen, s0, s1 = (t.to(cdt) for t in (ht, chosen, s0, s1))
    W0, U0, W1, U1, Wh = (w.to(cdt) for w in (w0, u0, w1, u1, whead))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    bh = bhead.reshape(-1).float()
    m_in, m0t, m0c, m1, mmid, m_out = _note_masks(
        seed, T, N, B, Ht, C, H, dropout_p, cdt, ht.device)
    # 1. - 3.
    xtot = _note_xtot(ht, chosen, s0, m_in, m0t, m0c)
    hs0, cs0 = _forward_scan(_dot(xtot, W0).to(cdt) + B0, U0, hard)
    # 4. - 6.
    x1 = _note_x1(hs0, s1, mmid, m1)
    hs1, cs1 = _forward_scan(_dot(x1, W1).to(cdt) + B1, U1, hard)
    # 7.
    _, z, sg = _note_heads(hs1, Wh, bh, m_out)
    out = torch.cat([sg, z[..., 2:]], -1).reshape(N, T, B, 3)
    return (out, *(t.reshape(N, T, B, H) for t in (hs0, cs0, hs1, cs1)))


def biax_note_bwd_staged(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, whead,
                         bhead, hs0, cs0, hs1, cs1, dout,
                         dropout_p: float = 0.0, seed: int = 0,
                         compute_dtype=torch.float32,
                         recurrent_activation: str = "sigmoid"):
    """The note stack's backward as the CUDA kernels compute it, in plain
    PyTorch (no autograd): the seven passes of `csrc/biax_note.cu` with
    their cast points and masks.  hs0, cs0, hs1, cs1 [N, T, B, H] are the
    forward's tapes (h after pitch n, c before it, in the compute dtype)
    and dout [N, T, B, 3] the cotangent of the output.  Rows m = n R + g,
    g = (t, b), R = T B.

      1. prologue and heads backward: xtot = (ht m_in + s0t m_style0) ++
         (chosen + s0c m_style0c), x1 = hs0 m_mid + s1 m_style1, h1d =
         hs1 m_out (each operation rounded to the compute dtype); the
         heads' dz (float32): dout sigma (1 - sigma) for play and replay,
         dout for volume; ext1 = ((dz -> T) Wh^T) m_out (float32);
      2. bulk pre-activations z = ((in W -> T) + b) + (h[n-1] U -> T),
         h[-1] = 0;
      3. the layer-1 scan, reversed over the pitches, with ext1;
      4. dx1 = dz1 W1^T in float32: the style-1 rows dx1 m_style1 and the
         mid term dx1 m_mid;
      5. the layer-0 scan with the mid term;
      6. dx = dz0 W0^T: dht = (dx[:, :Ht] m_in -> T), dch = (dx[:, Ht:] ->
         T), the style-0 rows dx[:, :Ht] m_style0 ++ dx[:, Ht:] m_style0c;
      7. the style gradients sum the rows over the pitches in the order
         n = N - 1 .. 0 (float32, no per-tile rounding); the weight
         gradients are float32 sums of in^T dz.

    Returns (dht [T, N, B, Ht], dch [N, T, B, C] in the compute dtype;
    ds0 [T, B, Ht + C], ds1 [T, B, H], dw0, db0, db1, du0, dw1, du1, dwh,
    dbh in float32), the order of the stack's inputs."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    T, N, B, Ht = ht.shape
    C = chosen.shape[-1]
    H = u0.shape[0]
    R = T * B
    rows = lambda t: t.reshape(N, R, t.shape[-1])
    ht, chosen, s0, s1 = (t.to(cdt) for t in (ht, chosen, s0, s1))
    W0, U0, W1, U1, Wh = (w.to(cdt) for w in (w0, u0, w1, u1, whead))
    B0, B1 = b0.reshape(-1).to(cdt), b1.reshape(-1).to(cdt)
    bh = bhead.reshape(-1).float()
    hs0, cs0, hs1, cs1 = (rows(t.to(cdt)) for t in (hs0, cs0, hs1, cs1))
    m_in, m0t, m0c, m1, mmid, m_out = _note_masks(
        seed, T, N, B, Ht, C, H, dropout_p, cdt, ht.device)
    f32 = lambda m: None if m is None else m.float()

    # 1. prologue and heads backward
    xtot = _note_xtot(ht, chosen, s0, m_in, m0t, m0c)
    x1 = _note_x1(hs0, s1, mmid, m1)
    h1d, _, sg = _note_heads(hs1, Wh, bh, m_out)
    d = rows(dout.float())
    dzh = torch.cat([d[..., :2] * sg * (1.0 - sg), d[..., 2:]], -1)
    ext1 = _apply(_dot(dzh.to(cdt), Wh.t()), f32(m_out))
    # 2. bulk pre-activations
    prev = lambda h: torch.cat([torch.zeros_like(h[:1]), h[:-1]])
    hp0, hp1 = prev(hs0), prev(hs1)
    z0 = (_dot(xtot, W0).to(cdt) + B0) + _dot(hp0, U0).to(cdt)
    z1 = (_dot(x1, W1).to(cdt) + B1) + _dot(hp1, U1).to(cdt)
    # 3. - 6.
    dz1, _ = _reverse_scan(z1, cs1, ext1, U1, hard)
    dx1 = _dot(dz1, W1.t())
    ds1r, dmid = _apply(dx1, f32(m1)), _apply(dx1, f32(mmid))
    dz0, _ = _reverse_scan(z0, cs0, dmid, U0, hard)
    dx = _dot(dz0, W0.t())
    dxt, dxc = dx[..., :Ht], dx[..., Ht:]
    dht = _apply(dxt, f32(m_in)).to(cdt).reshape(N, T, B, Ht).transpose(0, 1)
    ds0r = torch.cat([_apply(dxt, f32(m0t)), _apply(dxc, f32(m0c))], -1)

    # 7. reductions
    def pitch_sum(r):
        tot = torch.zeros_like(r[0])
        for n in reversed(range(N)):
            tot = tot + r[n]
        return tot.reshape(T, B, r.shape[-1])

    flat = lambda t: t.reshape(N * R, t.shape[-1])
    wg = lambda a, dz: _dot(flat(a).t(), flat(dz))
    return (dht.contiguous(), dxc.to(cdt).reshape(N, T, B, C),
            pitch_sum(ds0r), pitch_sum(ds1r), wg(xtot, dz0),
            flat(dz0).float().sum(0), flat(dz1).float().sum(0),
            wg(hp0, dz0), wg(x1, dz1), wg(hp1, dz1), wg(h1d, dzh),
            flat(dzh).sum(0))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
_SIGNATURES = {
    "biax_time": {
        "biax_time_prologue": [_I, _I] + [_P] * 6 + [_I] * 6
        + [_U, _U, _F, _I, _P],
        "biax_time_fwd_in": [_I, _P, _I, _I, _P, _P, _P, _I, _I, _P],
        "biax_time_fwd_scan": [_I, _I] + [_P] * 4 + [_I] * 6 + [_P, _P],
        "biax_time_bwd_preact": [_I, _P, _I, _I] + [_P] * 5 + [_I] * 3
        + [_P],
        "biax_time_bwd_scan": [_I, _I] + [_P] * 5 + [_I] * 7 + [_P, _P],
        "biax_time_bwd_dx": [_I, _I, _P, _P, _I, _I, _I, _P, _P, _P]
        + [_I] * 6 + [_U, _U, _F, _I, _P],
        "biax_time_ds": [_I, _P, _I, _I, _I, _I, _I, _P, _P],
    },
    "biax_note": {
        "biax_note_prologue": [_I, _I] + [_P] * 14 + [_I] * 7
        + [_U, _U, _F, _I, _P],
        "biax_note_fwd_in": [_I, _P, _I, _I, _P, _P, _P, _I, _I, _P],
        "biax_note_fwd_scan": [_I, _I] + [_P] * 4 + [_I] * 6 + [_P, _P],
        "biax_note_heads": [_I] + [_P] * 4 + [_I] * 5 + [_U, _U, _F, _I,
                                                        _P],
        "biax_note_bwd_preact": [_I, _P, _I, _I] + [_P] * 5 + [_I] * 3
        + [_P],
        "biax_note_bwd_scan": [_I, _I] + [_P] * 4 + [_I] * 6 + [_P, _P],
        "biax_note_bwd_dx": [_I, _I, _P, _P, _I, _I, _I] + [_P] * 4
        + [_I] * 6 + [_U, _U, _F, _I, _P],
        "biax_note_ds": [_P, _I, _I, _I, _P, _P],
    },
}
_WGRAD = [_I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P]
# The parts of the prologues (biax_time_prologue: xtot, x1;
# biax_note_prologue: xtot, x1, the heads' backward).
_PRO_XTOT, _PRO_X1, _PRO_HEADS = 1, 2, 4
WGRAD_CHUNKS = 32           # row chunks of the weight-gradient reduction


def _library(name: str) -> ctypes.CDLL:
    return _build.bind(name, {**_SIGNATURES[name], "biax_wgrad": _WGRAD})


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _is_bf16(cdt: torch.dtype) -> int:
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {cdt}")
    return int(cdt == torch.bfloat16)


def _kind(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else (2 if t.dtype == torch.bfloat16 else 1)


def _wgrad(lib, a: Optional[torch.Tensor], shift: int, b: torch.Tensor,
           K: int, ws: torch.Tensor) -> torch.Tensor:
    """sum over rows r of a[r - shift, :K]^T b[r] (a rows before `shift`
    read as zero; a None gives the column sums of b) ->
    float32 [K, M], by the kernel `biax_wgrad` in the library: row chunks
    summed in a fixed order, no atomics."""
    M = b.shape[-1]
    rows = b.numel() // M
    out = torch.empty(K, M, dtype=torch.float32, device=b.device)
    _check(lib.biax_wgrad(
        _kind(a), _ptr(a), 0 if a is None else a.shape[-1], shift, _kind(b),
        b.data_ptr(), M, rows, K, M, WGRAD_CHUNKS, ws.data_ptr(),
        out.data_ptr(), _stream(b.device)), "biax_wgrad")
    return out


def _layer_wgrads(lib, xtot: torch.Tensor, K: int, hs0: torch.Tensor,
                  x1: torch.Tensor, hs1: torch.Tensor, z0: torch.Tensor,
                  z1: torch.Tensor, R: int, ws: torch.Tensor):
    """Both layers' weight gradients from their inputs (xtot with K
    columns, x1), their h tapes (read one scan step back: shift R) and
    their dz tapes, by `_wgrad`: (dw0, db0, db1, du0, dw1, du1), the order
    of the stacks' gradients."""
    H, H4 = hs0.shape[-1], z0.shape[-1]
    dw0 = _wgrad(lib, xtot, 0, z0, K, ws)
    du0 = _wgrad(lib, hs0, R, z0, H, ws)
    dw1 = _wgrad(lib, x1, 0, z1, H, ws)
    du1 = _wgrad(lib, hs1, R, z1, H, ws)
    db0 = _wgrad(lib, None, 0, z0, 1, ws).reshape(H4)
    db1 = _wgrad(lib, None, 0, z1, 1, ws).reshape(H4)
    return dw0, db0, db1, du0, dw1, du1


def _layout(m: torch.Tensor) -> torch.Tensor:
    """A product's matrix m [K, N] (in the compute dtype) as the kernels
    take it: [K, N] for float32 (CUDA-core FMAs over rows of m); for
    bfloat16 the transpose [N, K rounded up to 32], zero-padded, so the
    tensor-core operands read K-contiguous runs."""
    if m.dtype == torch.float32:
        return m.contiguous()
    K, N = m.shape
    out = m.new_zeros(N, -(-K // 32) * 32)
    out[:, :K] = m.t()
    return out


def _mask_args(dropout_p: float, seed: int, cdt: torch.dtype):
    keep = 1.0 - dropout_p
    if keep >= 1.0:
        return 0, 0, 1.0, 0
    return (seed & _U32, _threshold(keep), _keep_scale(keep, cdt), 1)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _on_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got one "
                         f"on {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, got "
                             f"one on {t.device}")
    return dev


def scan_route(cdt: torch.dtype) -> str:
    """The biaxial stacks' scans by dtype: U resident in a thread-block
    cluster in bfloat16, streamed from L2 in float32."""
    return "cluster" if cdt == torch.bfloat16 else "streamed"


def _marker(marks):
    """mark(name): with a list `marks`, append (name, a recorded CUDA
    event); without one, nothing."""
    def mark(name):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
    return mark


def _fwd_layers(lib, kind: str, stack, cdt, pre, M: int, dims, hard: bool,
                scan_prof, mark):
    """run(i, xin, K, w, b, u, hs, cs): passes 2-3 (layer 0) or 5-6 (layer
    1) of a stack's forward, `biax_{kind}_fwd_in` into `pre` and
    `biax_{kind}_fwd_scan` on `scan_route(cdt)`, marked "in{i}" and
    "scan{i}"; dims = (T, N, B, H, k).  Counts `stack.fwd_cluster_scans`
    or `.fwd_streamed_scans`."""
    fwd_in = getattr(lib, f"biax_{kind}_fwd_in")
    fwd_scan = getattr(lib, f"biax_{kind}_fwd_scan")
    route = scan_route(cdt)
    bf, st, H = _is_bf16(cdt), _stream(pre.device), dims[3]

    def run(i, xin, K, w, b, u, hs, cs):
        _check(fwd_in(bf, xin.data_ptr(), xin.shape[-1], K, w.data_ptr(),
                      b.data_ptr(), pre.data_ptr(), M, H, st),
               f"biax_{kind}_fwd_in")
        mark(f"in{i}")
        prof = None if scan_prof is None else scan_prof[i]
        _check(fwd_scan(bf, int(route == "cluster"), pre.data_ptr(),
                        hs.data_ptr(), _ptr(cs), u.data_ptr(), *dims,
                        int(hard), _ptr(prof), st),
               f"biax_{kind}_fwd_scan ({route})")
        mark(f"scan{i}")
        if route == "cluster":
            stack.fwd_cluster_scans += 1
        else:
            stack.fwd_streamed_scans += 1

    return run


def biax_time_fwd(x, s0, s1, w0, b0, b1, u0, w1, u1, dropout_p: float = 0.0,
                  seed: int = 0, compute_dtype=torch.float32,
                  recurrent_activation: str = "sigmoid", tapes: bool = True,
                  marks=None, scan_prof: Optional[torch.Tensor] = None):
    """The time stack's forward kernels on CUDA tensors: (hs0, cs0, hs1,
    cs1) [T, N, B, H] in the compute dtype (h after step t, c before it),
    the three tapes None when `tapes` is False, by the six passes of
    `biax_time_fwd_staged` (csrc/biax_time.cu).  The scans take
    `scan_route(compute_dtype)`; without tapes hs0 is scratch and cs0, cs1
    are not written.  With a list `marks`, a recorded CUDA event is
    appended after each pass, as (name, event), behind ("start", event).
    With an int64 tensor `scan_prof` [2, 9] on the card, the cluster scans
    of layers 0 and 1 write their first block's clock cycles per phase,
    summed over the steps (the product with its block barrier, the cell
    work, the cluster barrier, then 0) and their plan (cluster size, rows
    and units per block, K parts = 1, clusters the card holds at once).
    Counts `biax_time_stack.fwd_launches`, and `.fwd_cluster_scans` or
    `.fwd_streamed_scans` once per scan."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("biax_time_stack", x, s0, s1, w0, b0, b1, u0, w1, u1)
    T, N, B, F = x.shape
    H = u0.shape[0]
    M = T * N * B
    k, _ = _row_tiling(N, B)
    x, s0, s1, w0, b0, b1, u0, w1, u1 = (
        t.to(cdt).contiguous() for t in (x, s0, s1, w0, b0.reshape(-1),
                                         b1.reshape(-1), u0, w1, u1))
    e = lambda *shape: torch.empty(*shape, dtype=cdt, device=dev)
    # Rows padded to 8 values (zeros): 16-byte rows for the products.
    xtot, x1 = e(T, N, B, _pad8(F)), e(T, N, B, _pad8(H))
    pre = e(T, N, B, 4 * H)            # P of layer 0, then of layer 1
    hs0, hs1 = e(T, N, B, H), e(T, N, B, H)
    cs0, cs1 = (e(T, N, B, H), e(T, N, B, H)) if tapes else (None, None)
    w0, u0, w1, u1 = (_layout(w) for w in (w0, u0, w1, u1))
    lib = _library("biax_time")
    bf, st = _is_bf16(cdt), _stream(dev)
    dims = (T, N, B, F, H, k)
    drop = _mask_args(dropout_p, seed, cdt)
    mark = _marker(marks)
    run_layer = _fwd_layers(lib, "time", biax_time_stack, cdt, pre, M,
                            (T, N, B, H, k), hard, scan_prof, mark)

    def prologue(halves, name):
        _check(lib.biax_time_prologue(
            bf, halves, x.data_ptr(), s0.data_ptr(), s1.data_ptr(),
            hs0.data_ptr(), xtot.data_ptr(), x1.data_ptr(), *dims, *drop,
            st), "biax_time_prologue")
        mark(name)

    with torch.cuda.device(dev):
        mark("start")
        prologue(_PRO_XTOT, "xtot")
        run_layer(0, xtot, F, w0, b0, u0, hs0, cs0)
        prologue(_PRO_X1, "x1")
        run_layer(1, x1, H, w1, b1, u1, hs1, cs1)
    biax_time_stack.fwd_launches += 1
    return (hs0 if tapes else None), cs0, hs1, cs1


def biax_time_bwd(x, s0, s1, w0, b0, b1, u0, w1, u1, hs0, cs0, hs1, cs1,
                  dhs1, dropout_p: float = 0.0, seed: int = 0,
                  compute_dtype=torch.float32,
                  recurrent_activation: str = "sigmoid", marks=None,
                  scan_prof: Optional[torch.Tensor] = None):
    """The time stack's backward kernels on CUDA tensors: the arguments and
    results of `biax_time_bwd_staged`, whose six passes they run (csrc/
    biax_time.cu), then the weight-gradient and style-gradient reductions.
    The scans take `scan_route(compute_dtype)`.  With a list `marks`,
    a recorded CUDA event is appended after each pass, as (name, event),
    behind ("start", event).  With an int64 tensor `scan_prof` [2, 9] on
    the card, the cluster scans of layers 1 and 0 write their first
    block's clock cycles per phase, summed over the steps (own cell work,
    the rest of the dz exchange with its barrier, the product, the second
    barrier) and their plan (cluster size, rows and units per block, K
    parts, clusters the card holds at once).  Counts
    `biax_time_stack.bwd_launches`, and `.cluster_scans` or
    `.streamed_scans` once per scan."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("biax_time_stack", x, s0, s1, w0, b0, b1, u0, w1, u1,
                   hs0, cs0, hs1, cs1, dhs1)
    T, N, B, F = x.shape
    H = u0.shape[0]
    H4, R = 4 * H, N * B
    M = T * R
    k, _ = _row_tiling(N, B)
    x, s0, s1, w0, b0, b1, u0, w1, u1, hs0, cs0, hs1, cs1, dhs1 = (
        t.to(cdt).contiguous() for t in (x, s0, s1, w0, b0.reshape(-1),
                                         b1.reshape(-1), u0, w1, u1, hs0,
                                         cs0, hs1, cs1, dhs1))
    route = scan_route(cdt)
    scan_u = [u if route == "cluster" else _layout(u.t()) for u in (u0, u1)]
    e = lambda *shape, dt=cdt: torch.empty(*shape, dtype=dt, device=dev)
    f32 = torch.float32
    # Rows padded to 8 values (zeros): 16-byte rows for the products.
    xtot, x1 = e(T, N, B, _pad8(F)), e(T, N, B, _pad8(H))
    z0, z1 = e(T, N, B, H4), e(T, N, B, H4)       # z in, dz out
    dx = e(T, N, B, F)
    ds0r, ds1r, dmid = e(T, N, B, F, dt=f32), e(T, N, B, H, dt=f32), e(
        T, N, B, H, dt=f32)
    mats = [_layout(w) for w in (w0, u0, w1, u1, w0.t(), w1.t())]
    lib = _library("biax_time")
    bf, st = _is_bf16(cdt), _stream(dev)
    dims = (T, N, B, F, H, k)
    drop = _mask_args(dropout_p, seed, cdt)
    mark = _marker(marks)

    def scan(z, cs, ext_t, ext_f, u, layer):
        prof = None if scan_prof is None else scan_prof[1 - layer]
        _check(lib.biax_time_bwd_scan(
            bf, int(route == "cluster"), z.data_ptr(), cs.data_ptr(),
            _ptr(ext_t), _ptr(ext_f), u.data_ptr(), *dims, int(hard),
            _ptr(prof), st), f"biax_time_bwd_scan ({route})")
        if route == "cluster":
            biax_time_stack.cluster_scans += 1
        else:
            biax_time_stack.streamed_scans += 1

    with torch.cuda.device(dev):
        mark("start")
        _check(lib.biax_time_prologue(
            bf, _PRO_XTOT | _PRO_X1,
            *(t.data_ptr() for t in (x, s0, s1, hs0, xtot, x1)), *dims,
            *drop, st), "biax_time_prologue")
        mark("prologue")
        for xin, K, w, b, hs, u, z in ((xtot, F, mats[0], b0, hs0, mats[1],
                                        z0),
                                       (x1, H, mats[2], b1, hs1, mats[3],
                                        z1)):
            _check(lib.biax_time_bwd_preact(
                bf, xin.data_ptr(), xin.shape[-1], K, w.data_ptr(),
                b.data_ptr(), hs.data_ptr(), u.data_ptr(), z.data_ptr(), M,
                R, H, st), "biax_time_bwd_preact")
        mark("preact")
        scan(z1, cs1, dhs1, None, scan_u[1], 1)
        mark("scan1")
        _check(lib.biax_time_bwd_dx(
            bf, 1, z1.data_ptr(), mats[5].data_ptr(), M, H4, H, None,
            ds1r.data_ptr(), dmid.data_ptr(), *dims, *drop, st),
            "biax_time_bwd_dx")
        mark("dx1")
        scan(z0, cs0, None, dmid, scan_u[0], 0)
        mark("scan0")
        _check(lib.biax_time_bwd_dx(
            bf, 0, z0.data_ptr(), mats[4].data_ptr(), M, H4, F,
            dx.data_ptr(), ds0r.data_ptr(), None, *dims, *drop, st),
            "biax_time_bwd_dx")
        mark("dx0")
        ws = e(WGRAD_CHUNKS * max(F, H) * H4, dt=f32)
        wgrads = _layer_wgrads(lib, xtot, F, hs0, x1, hs1, z0, z1, R, ws)
        ds = []
        for rows, W in ((ds0r, F), (ds1r, H)):
            out = e(T, B, W, dt=f32)
            _check(lib.biax_time_ds(bf, rows.data_ptr(), T, N, B, W, k,
                                    out.data_ptr(), st), "biax_time_ds")
            ds.append(out)
        mark("wgrad")
    biax_time_stack.bwd_launches += 1
    return (dx, *ds, *wgrads)


class _TimeStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s0, s1, w0, b0, b1, u0, w1, u1, dropout_p, seed,
                cdt, act):
        tapes = any(ctx.needs_input_grad)
        hs0, cs0, hs1, cs1 = biax_time_fwd(x, s0, s1, w0, b0, b1, u0, w1, u1,
                                           dropout_p, seed, cdt, act, tapes)
        if tapes:
            ctx.save_for_backward(x, s0, s1, w0, b0, b1, u0, w1, u1, hs0,
                                  cs0, hs1, cs1)
            ctx.cfg = (dropout_p, seed, cdt, act)
        return hs1

    @staticmethod
    def backward(ctx, dhs1):
        saved = ctx.saved_tensors
        grads = biax_time_bwd(*saved, dhs1, *ctx.cfg)
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved)) + (
            None,) * 4


def biax_note_fwd(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, whead, bhead,
                  dropout_p: float = 0.0, seed: int = 0,
                  compute_dtype=torch.float32,
                  recurrent_activation: str = "sigmoid", tapes: bool = True,
                  marks=None, scan_prof: Optional[torch.Tensor] = None):
    """The note stack's forward kernels on CUDA tensors: (out [N, T, B, 3]
    float32, hs0, cs0, hs1, cs1 [N, T, B, H] in the compute dtype (h after
    pitch n, c before it)), the four tapes None when `tapes` is False, by
    the seven passes of `biax_note_fwd_staged` (csrc/biax_note.cu).  The
    scans take `scan_route(compute_dtype)`; without tapes hs0 and hs1 are
    scratch and cs0, cs1 are not written.  `marks` and `scan_prof` as for
    `biax_time_fwd` (the passes xtot, in0, scan0, x1, in1, scan1, heads).
    Counts `biax_note_stack.fwd_launches`, and `.fwd_cluster_scans` or
    `.fwd_streamed_scans` once per scan."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("biax_note_stack", ht, chosen, s0, s1, w0, b0, b1, u0, w1,
                   u1, whead, bhead)
    T, N, B, Ht = ht.shape
    C = chosen.shape[-1]
    H = u0.shape[0]
    D, M = Ht + C, N * T * B
    k, _ = _row_tiling(T, B)
    ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, wh = (
        t.to(cdt).contiguous() for t in (ht, chosen, s0, s1, w0,
                                         b0.reshape(-1), b1.reshape(-1), u0,
                                         w1, u1, whead))
    bh = bhead.reshape(-1).float().contiguous()
    e = lambda *shape: torch.empty(*shape, dtype=cdt, device=dev)
    # Rows padded to 8 values (zeros): 16-byte rows for the products.
    xtot, x1 = e(N, T, B, _pad8(D)), e(N, T, B, _pad8(H))
    pre = e(N, T, B, 4 * H)            # P of layer 0, then of layer 1
    hs0, hs1 = e(N, T, B, H), e(N, T, B, H)
    cs0, cs1 = (e(N, T, B, H), e(N, T, B, H)) if tapes else (None, None)
    out = torch.empty(N, T, B, 3, dtype=torch.float32, device=dev)
    w0, u0, w1, u1 = (_layout(w) for w in (w0, u0, w1, u1))
    lib = _library("biax_note")
    bf, st = _is_bf16(cdt), _stream(dev)
    drop = _mask_args(dropout_p, seed, cdt)
    mark = _marker(marks)
    run_layer = _fwd_layers(lib, "note", biax_note_stack, cdt, pre, M,
                            (T, N, B, H, k), hard, scan_prof, mark)

    def prologue(part, name):
        _check(lib.biax_note_prologue(
            bf, part, *(_ptr(t) for t in (ht, chosen, s0, s1, hs0, None, None,
                                          None, None, xtot, x1, None, None,
                                          None)),
            T, N, B, Ht, C, H, k, *drop, st), "biax_note_prologue")
        mark(name)

    with torch.cuda.device(dev):
        mark("start")
        prologue(_PRO_XTOT, "xtot")
        run_layer(0, xtot, D, w0, b0, u0, hs0, cs0)
        prologue(_PRO_X1, "x1")
        run_layer(1, x1, H, w1, b1, u1, hs1, cs1)
        _check(lib.biax_note_heads(
            bf, hs1.data_ptr(), wh.data_ptr(), bh.data_ptr(), out.data_ptr(),
            T, N, B, H, k, *drop, st), "biax_note_heads")
        mark("heads")
    biax_note_stack.fwd_launches += 1
    if not tapes:
        return out, None, None, None, None
    return out, hs0, cs0, hs1, cs1


def biax_note_bwd(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, whead, bhead,
                  hs0, cs0, hs1, cs1, dout, dropout_p: float = 0.0,
                  seed: int = 0, compute_dtype=torch.float32,
                  recurrent_activation: str = "sigmoid", marks=None,
                  scan_prof: Optional[torch.Tensor] = None):
    """The note stack's backward kernels on CUDA tensors: the arguments and
    results of `biax_note_bwd_staged`, whose seven passes they run (csrc/
    biax_note.cu): the prologue with the heads backward, the
    pre-activations, the scans, the dx products, then the weight-gradient
    and style-gradient reductions.  The scans take
    `scan_route(compute_dtype)`; `marks` and `scan_prof` as for
    `biax_time_bwd`.  Counts `biax_note_stack.bwd_launches`, and
    `.cluster_scans` or `.streamed_scans` once per scan."""
    cdt, hard = compute_dtype, recurrent_activation == "hard_sigmoid"
    dev = _on_cuda("biax_note_stack", ht, chosen, s0, s1, w0, b0, b1, u0, w1,
                   u1, whead, bhead, hs0, cs0, hs1, cs1, dout)
    T, N, B, Ht = ht.shape
    C = chosen.shape[-1]
    H = u0.shape[0]
    H4, D, R = 4 * H, Ht + C, T * B
    M = N * R
    k, _ = _row_tiling(T, B)
    (ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, wh, hs0, cs0, hs1,
     cs1) = (t.to(cdt).contiguous() for t in (
         ht, chosen, s0, s1, w0, b0.reshape(-1), b1.reshape(-1), u0, w1, u1,
         whead, hs0, cs0, hs1, cs1))
    bh = bhead.reshape(-1).float().contiguous()
    dout = dout.float().contiguous()
    route = scan_route(cdt)
    scan_u = [u if route == "cluster" else _layout(u.t()) for u in (u0, u1)]
    e = lambda *shape, dt=cdt: torch.empty(*shape, dtype=dt, device=dev)
    f32 = torch.float32
    # Rows padded to 8 values (zeros): 16-byte rows for the products.
    xtot, x1, h1d = e(N, T, B, _pad8(D)), e(N, T, B, _pad8(H)), e(N, T, B, H)
    dzh, ext1 = e(N, T, B, 3, dt=f32), e(N, T, B, H, dt=f32)
    z0, z1 = e(N, T, B, H4), e(N, T, B, H4)       # z in, dz out
    dht, dch = e(T, N, B, Ht), e(N, T, B, C)
    ds0r, ds1r, dmid = e(N, T, B, D, dt=f32), e(N, T, B, H, dt=f32), e(
        N, T, B, H, dt=f32)
    mats = [_layout(w) for w in (w0, u0, w1, u1, w0.t(), w1.t())]
    lib = _library("biax_note")
    bf, st = _is_bf16(cdt), _stream(dev)
    drop = _mask_args(dropout_p, seed, cdt)
    mark = _marker(marks)

    def scan(z, cs, ext, u, layer):
        prof = None if scan_prof is None else scan_prof[1 - layer]
        _check(lib.biax_note_bwd_scan(
            bf, int(route == "cluster"), z.data_ptr(), cs.data_ptr(),
            ext.data_ptr(), u.data_ptr(), T, N, B, H, k, int(hard),
            _ptr(prof), st), f"biax_note_bwd_scan ({route})")
        if route == "cluster":
            biax_note_stack.cluster_scans += 1
        else:
            biax_note_stack.streamed_scans += 1

    def dx(layer, z, wt, Nout, dht, dch, out_a, out_b):
        _check(lib.biax_note_bwd_dx(
            bf, layer, z.data_ptr(), wt.data_ptr(), M, H4, Nout, _ptr(dht),
            _ptr(dch), out_a.data_ptr(), _ptr(out_b), T, N, B, Ht, H, k,
            *drop, st), "biax_note_bwd_dx")

    with torch.cuda.device(dev):
        mark("start")
        _check(lib.biax_note_prologue(
            bf, _PRO_XTOT | _PRO_X1 | _PRO_HEADS,
            *(t.data_ptr() for t in (ht, chosen, s0, s1, hs0, hs1, wh, bh,
                                     dout, xtot, x1, h1d, dzh, ext1)),
            T, N, B, Ht, C, H, k, *drop, st), "biax_note_prologue")
        mark("prologue")
        for xin, K, w, b, hs, u, z in ((xtot, D, mats[0], b0, hs0, mats[1],
                                        z0),
                                       (x1, H, mats[2], b1, hs1, mats[3],
                                        z1)):
            _check(lib.biax_note_bwd_preact(
                bf, xin.data_ptr(), xin.shape[-1], K, w.data_ptr(),
                b.data_ptr(), hs.data_ptr(), u.data_ptr(), z.data_ptr(), M,
                R, H, st), "biax_note_bwd_preact")
        mark("preact")
        scan(z1, cs1, ext1, scan_u[1], 1)
        mark("scan1")
        dx(1, z1, mats[5], H, None, None, ds1r, dmid)
        mark("dx1")
        scan(z0, cs0, dmid, scan_u[0], 0)
        mark("scan0")
        dx(0, z0, mats[4], D, dht, dch, ds0r, None)
        mark("dx0")
        ws = e(WGRAD_CHUNKS * max(D, H) * H4, dt=f32)
        wgrads = _layer_wgrads(lib, xtot, D, hs0, x1, hs1, z0, z1, R, ws)
        dwh = _wgrad(lib, h1d, 0, dzh, H, ws)
        dbh = _wgrad(lib, None, 0, dzh, 1, ws).reshape(3)
        ds = []
        for rows, W in ((ds0r, D), (ds1r, H)):
            out = e(T, B, W, dt=f32)
            _check(lib.biax_note_ds(rows.data_ptr(), N, R, W, out.data_ptr(),
                                    st), "biax_note_ds")
            ds.append(out)
        mark("wgrad")
    biax_note_stack.bwd_launches += 1
    return (dht, dch, *ds, *wgrads, dwh, dbh)


class _NoteStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, whead,
                bhead, dropout_p, seed, cdt, act):
        tapes = any(ctx.needs_input_grad)
        out, *tp = biax_note_fwd(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1,
                                 whead, bhead, dropout_p, seed, cdt, act,
                                 tapes)
        if tapes:
            ctx.save_for_backward(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1,
                                  whead, bhead, *tp)
            ctx.cfg = (dropout_p, seed, cdt, act)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        grads = biax_note_bwd(*saved, dout, *ctx.cfg)
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved)) + (
            None,) * 4


def biax_time_stack(x, s0, s1, w0, b0, b1, u0, w1, u1,
                    dropout_p: float = 0.0, seed: int = 0,
                    compute_dtype=torch.float32,
                    recurrent_activation: str = "sigmoid") -> torch.Tensor:
    """The time-axis stack (pallas_biax.py:565).  x [T, N, B, F] raw
    per-note features, s0 [T, B, F] and s1 [T, B, H] the unmasked,
    unbroadcast tanh style projections; returns hs1 [T, N, B, H] in the
    compute dtype.  CPU tensors take the plain version; CUDA tensors the
    kernels."""
    check_recurrent_activation(recurrent_activation)
    args = (x.to(compute_dtype), s0, s1, w0, b0.reshape(-1), b1.reshape(-1),
            u0, w1, u1)
    if x.device.type == "cpu":
        return biax_time_stack_reference(*args, dropout_p, seed,
                                         compute_dtype, recurrent_activation)
    if x.device.type != "cuda":
        raise ValueError(f"biax_time_stack runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    return _TimeStack.apply(*args, float(dropout_p), int(seed),
                            compute_dtype, recurrent_activation)


biax_time_stack.fwd_launches = 0
biax_time_stack.bwd_launches = 0
biax_time_stack.fwd_cluster_scans = 0
biax_time_stack.fwd_streamed_scans = 0
biax_time_stack.cluster_scans = 0
biax_time_stack.streamed_scans = 0


def biax_note_stack(ht, chosen, s0, s1, w0, b0, b1, u0, w1, u1, whead,
                    bhead, dropout_p: float = 0.0, seed: int = 0,
                    compute_dtype=torch.float32,
                    recurrent_activation: str = "sigmoid") -> torch.Tensor:
    """The note-axis stack with fused heads (pallas_biax.py:1087).
    ht [T, N, B, Ht] the time stack's output (its output dropout applied
    on read), chosen [N, T, B, C] the pre-shifted conditioning, s0
    [T, B, Ht+C] and s1 [T, B, H] the style projections, w0 [Ht+C, 4H],
    whead [H, 3], bhead [3]; returns [N, T, B, 3] float32.  CPU tensors
    take the plain version; CUDA tensors the kernels."""
    check_recurrent_activation(recurrent_activation)
    args = (ht.to(compute_dtype), chosen.to(compute_dtype), s0, s1, w0,
            b0.reshape(-1), b1.reshape(-1), u0, w1, u1, whead,
            bhead.reshape(-1))
    if ht.device.type == "cpu":
        return biax_note_stack_reference(*args, dropout_p, seed,
                                         compute_dtype, recurrent_activation)
    if ht.device.type != "cuda":
        raise ValueError(f"biax_note_stack runs on CPU or CUDA tensors, "
                         f"got {ht.device}")
    return _NoteStack.apply(*args, float(dropout_p), int(seed),
                            compute_dtype, recurrent_activation)


biax_note_stack.fwd_launches = 0
biax_note_stack.bwd_launches = 0
biax_note_stack.fwd_cluster_scans = 0
biax_note_stack.fwd_streamed_scans = 0
biax_note_stack.cluster_scans = 0
biax_note_stack.streamed_scans = 0
