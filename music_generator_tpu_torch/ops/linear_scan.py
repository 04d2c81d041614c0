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
(`Config.time_axis_kind = "lstm"`).

On CUDA tensors `glru_scan` runs neither the tree nor the gates as
PyTorch operations: it takes P = xs W in the compute dtype (one cuBLAS
product, no bias) and launches `csrc/glru_scan.cu`, one kernel a
direction a layer, inside a `torch.autograd.Function`.  The kernels walk
each (row, unit) chain along t in float32 from P and the float32 bias
(gates, state and, backward, the carried gradient) and round only what
they store: hs, and dP.  That is a deliberate difference from the CPU
route: the card's linear time axis is the float32 recurrence rounded once
an output, not JAX's tree rounded at every combine.  Its plain version,
what the kernels are held to, is `glru_scan_fused_reference`
(`glru_fwd_reference`, `glru_bwd_reference`): the same arithmetic in the
same order as PyTorch operations on any device.  A CUDA tensor whose
dtype or layout the kernels do not take raises; there is no fall-back to
the tree.  Launch counters: `glru_scan.fwd_launches` / `.bwd_launches`;
the plain version counts `glru_scan_fused_reference.calls`."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import nn

from music_generator_tpu_torch.ops import _build
from music_generator_tpu_torch.ops.biax import (_check, _is_bf16, _on_cuda,
                                                _stream)
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
    the recurrence.  On CUDA tensors the kernels of csrc/glru_scan.cu
    (gates fused, float32 state; see the module docstring); elsewhere
    `glru_gates` and the log-depth tree.  Spans: `linear_scan.tree` over
    the kernel's or the tree's forward, `linear_scan.tree.bwd` over its
    backward."""
    if xs.device.type == "cuda":
        P = xs.to(compute_dtype) @ p.kernel.to(compute_dtype)
        with spans.span("linear_scan.tree"):
            return _FusedScan.apply(P, p.bias, False)
    a, b = glru_gates(p, xs, compute_dtype)
    with spans.span("linear_scan.tree"):
        hs = associative_scan(a, b)[1]
    spans.backward_span("linear_scan.tree.bwd", (hs,), (a, b))
    return hs


glru_scan.fwd_launches = 0
glru_scan.bwd_launches = 0


# -- the fused recurrence: csrc/glru_scan.cu and its plain version --------

THREADS = 256       # threads of a block (csrc/glru_scan.cu kThreads)
VEC_BYTES = 16      # bytes of one thread's load or store: VEC units of a row

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"glru_fwd": [_I, _P, _P, _P] + [_I] * 5 + [_P],
               "glru_bwd": [_I] + [_P] * 6 + [_I] * 5 + [_P],
               "glru_layout": [_P, _P, _P]}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernels, built at first use, their layout checked once."""
    global _lib
    if _lib is None:
        lib = _build.bind("glru_scan", _SIGNATURES)
        got = [ctypes.c_int() for _ in range(3)]
        lib.glru_layout(*(ctypes.byref(v) for v in got))
        got = [v.value for v in got]
        want = [VEC_BYTES // 2, VEC_BYTES // 4, THREADS]
        if got != want:
            raise RuntimeError(f"csrc/glru_scan.cu's layout (bfloat16 and "
                               f"float32 units a thread, threads a block) "
                               f"{got} is not the wrapper's {want}")
        _lib = lib
    return _lib


def launch_plan(R: int, H: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """(bx, by, block rows) of a launch over R rows of H units: blocks of
    bx threads along the units (VEC units each) by `by` rows, and the
    grid's rows of blocks, which the backward's bias sums come in.  Raises
    unless H is a multiple of VEC, the units of one 16-byte access."""
    vec = VEC_BYTES // torch.tensor([], dtype=dtype).element_size()
    if H % vec:
        raise ValueError(f"glru_scan's kernels take H a multiple of {vec} "
                         f"in {dtype}, got H={H}")
    bx = min(H // vec, 32)
    by = THREADS // bx
    return bx, by, -(-R // by)


def _operands(name: str, P: torch.Tensor, bias: torch.Tensor,
              *seqs: torch.Tensor) -> Tuple[int, int, int]:
    """Check what the kernels take: P [S, R, 2H] float32 or bfloat16, bias
    [2H] float32, each of `seqs` [S, R, H] in P's dtype, all contiguous on
    one CUDA device.  Returns (S, R, H)."""
    _on_cuda(name, P, bias, *seqs)
    _is_bf16(P.dtype)
    if P.dim() != 3 or P.shape[-1] % 2 or bias.shape != (P.shape[-1],):
        raise ValueError(f"{name}: P [S, R, 2H] and bias [2H], got "
                         f"{tuple(P.shape)} and {tuple(bias.shape)}")
    S, R, H2 = P.shape
    for t in seqs:
        if t.shape != (S, R, H2 // 2) or t.dtype != P.dtype:
            raise ValueError(f"{name}: [S, R, H] {P.dtype} expected, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"{name}: the bias must be float32, got "
                         f"{bias.dtype}")
    for t in (P, bias, *seqs):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernels take contiguous tensors")
    if S == 0 or R == 0:
        raise ValueError(f"{name}: empty P {tuple(P.shape)}")
    return S, R, H2 // 2


def glru_fwd(P: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """csrc/glru_scan.cu's forward: hs [S, R, H] in P's dtype from P [S,
    R, 2H] and the float32 bias [2H], the results of `glru_fwd_reference`.
    Counts `glru_scan.fwd_launches`."""
    S, R, H = _operands("glru_fwd", P, bias)
    bx, by, _ = launch_plan(R, H, P.dtype)
    hs = torch.empty(S, R, H, dtype=P.dtype, device=P.device)
    with torch.cuda.device(P.device):
        _check(_library().glru_fwd(
            _is_bf16(P.dtype), P.data_ptr(), bias.data_ptr(), hs.data_ptr(),
            S, R, H, bx, by, _stream(P.device)), "glru_fwd")
    glru_scan.fwd_launches += 1
    return hs


def glru_bwd(P: torch.Tensor, bias: torch.Tensor, hs: torch.Tensor,
             dhs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/glru_scan.cu's backward: (dP [S, R, 2H] in P's dtype, dbias
    [2H] float32) from the forward's P, bias and hs and the cotangent dhs
    of hs, the results of `glru_bwd_reference` (dbias summed in another
    order): one launch, then one sum of its blocks' float32 partial sums.
    Counts `glru_scan.bwd_launches`."""
    S, R, H = _operands("glru_bwd", P, bias, hs, dhs)
    bx, by, rows = launch_plan(R, H, P.dtype)
    dP = torch.empty_like(P)
    part = torch.empty(rows, 2 * H, dtype=torch.float32, device=P.device)
    with torch.cuda.device(P.device):
        _check(_library().glru_bwd(
            _is_bf16(P.dtype), P.data_ptr(), bias.data_ptr(), hs.data_ptr(),
            dhs.data_ptr(), dP.data_ptr(), part.data_ptr(),
            S, R, H, bx, by, _stream(P.device)), "glru_bwd")
    glru_scan.bwd_launches += 1
    return dP, part.sum(0)


def _gates32(P: torch.Tensor, bias: torch.Tensor):
    """(g, z) float32 of P and the float32 bias, as the kernels form them:
    pre = P widened + b, g = sigmoid(pre[:H]), z = tanh(pre[H:])."""
    H = bias.shape[0] // 2
    pre = P.float() + bias
    return torch.sigmoid(pre[..., :H]), torch.tanh(pre[..., H:])


def glru_fwd_reference(P: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """`glru_fwd` in plain PyTorch operations, step by step in the
    kernel's order: h = (1 - g) h + g z in float32 from h = 0, each h
    rounded to P's dtype where it is stored."""
    g, z = _gates32(P, bias)
    a, b = 1.0 - g, g * z
    hs = torch.empty(g.shape, dtype=P.dtype, device=P.device)
    h = torch.zeros_like(g[0])
    for t in range(g.shape[0]):
        h = a[t] * h + b[t]
        hs[t] = h
    return hs


def glru_bwd_reference(P: torch.Tensor, bias: torch.Tensor,
                       hs: torch.Tensor, dhs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`glru_bwd` in plain PyTorch operations, in the kernel's order, all
    float32: g and z again from P, dH_t = dhs_t + a_{t+1} dH_{t+1} from
    the last step back (a = 1 - g), and with h_{t-1} the stored hs[t - 1]
    (the ROUNDED value; 0 at t = 0): dP_g = ((dH (z - h_{t-1})) g) a and
    dP_z = (dH g)(1 - z z), each rounded to P's dtype; dbias the float32
    sum of the unrounded dP over every step and row."""
    g, z = _gates32(P, bias)
    a = 1.0 - g
    hp = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]).float()
    dH = torch.empty_like(g)
    carry, a_next = torch.zeros_like(g[0]), torch.zeros_like(g[0])
    for t in reversed(range(g.shape[0])):
        carry = dhs[t].float() + a_next * carry
        dH[t], a_next = carry, a[t]
    dpg = dH * (z - hp) * g * a
    dpz = dH * g * (1.0 - z * z)
    d = torch.cat([dpg, dpz], dim=-1)
    return d.to(P.dtype), d.sum(dim=(0, 1))


class _FusedScan(torch.autograd.Function):
    """hs of P and the float32 bias: the kernels, or with `plain` their
    plain versions; saves P and hs.  The backward opens the span
    `linear_scan.tree.bwd`."""

    @staticmethod
    def forward(ctx, P, bias, plain):
        hs = (glru_fwd_reference if plain else glru_fwd)(P, bias)
        ctx.save_for_backward(P, bias, hs)
        ctx.plain = plain
        return hs

    @staticmethod
    def backward(ctx, dhs):
        P, bias, hs = ctx.saved_tensors
        with spans.span("linear_scan.tree.bwd"):
            dP, dbias = (glru_bwd_reference if ctx.plain else glru_bwd)(
                P, bias, hs, dhs.to(P.dtype).contiguous())
        return dP, dbias, None


def glru_scan_fused_reference(p: GLRUParams, xs: torch.Tensor,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """What `glru_scan` computes on CUDA tensors, in plain PyTorch on any
    device, differentiable: P = xs @ W in the compute dtype, then
    `glru_fwd_reference` (its backward `glru_bwd_reference`).  The
    kernels' plain version (tests, chip_smoke.py).  At float32 it is
    `glru_scan_sequential` bit for bit."""
    glru_scan_fused_reference.calls += 1
    P = xs.to(compute_dtype) @ p.kernel.to(compute_dtype)
    return _FusedScan.apply(P, p.bias, True)


glru_scan_fused_reference.calls = 0


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
