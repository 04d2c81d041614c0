"""The generation pitch loop: one launch of the CUDA kernel `csrc/notegen.cu`
per timestep, beside its plain PyTorch version.

`note_sample` computes what the JAX package's `Sampler._note_scan` does,
at every note-axis depth L (1..8): it samples all N pitches of one
generation timestep for G streams.  For each pitch n: the L note-axis LSTM
cells, the sigmoid play/replay and linear volume heads, the division-form
temperature, the `u <= p` Bernoulli draws, replay * play and
clip(volume) * play, optionally snapped onto the k/max_velocity velocity
grid (`gen_volume_quantize`).  The chosen note n feeds pitch n + 1.  At
depth 2 that is the Pallas kernel `ops/pallas_notegen.py::
pallas_note_sample`; at other depths the JAX package runs the scan of
`note_axis_cell` in XLA.

Like the Pallas wrapper it splits W0 into its feature rows W0f [F, 4H] and
chosen rows W0c [3, 4H], and folds the per-timestep style terms of every
layer into a_l = tanh(s Ws_l + bs_l) W_l + b_l.

On a CUDA tensor `note_sample` launches the kernel of `notegen_plan` (or
raises): the cluster kernel, the weights that carry from pitch to pitch
resident in a thread-block cluster, feat W0f for every pitch computed up
front in the same launch, where a cluster holds the L layers' weights;
else the streamed kernel (one block per stream, the weights read from L2
at every pitch).  On a CPU tensor it runs `note_sample_reference`, the
plain loop equal to the JAX `Sampler._note_scan` scan branch;
`note_sample_staged` is the kernels' association of the same math in plain
PyTorch.  `note_sample_streamed` launches the streamed kernel whatever the
plan, to hold the cluster kernel to bit for bit and to time it against.
`note_sample.launches` counts the main path's launches,
`note_sample.streamed_launches` those of them the plan gave the streamed
kernel and `note_sample.bf16_launches[flavor]` those of them that ran a
bfloat16 instance; `note_sample_streamed.launches` and
`note_sample_reference.calls` count the other paths, so a run can show
which it took.

In bfloat16 (the JAX Sampler at `gen_dtype="bfloat16"`) the two JAX routes
differ, so the pitch loop takes a flavor, and the kernel has a bfloat16
instance of each (weights stored in bfloat16, every sum in float32):

  * "scan", the JAX default (`Sampler._note_scan`'s lax.scan through
    `note_axis_cell` and `heads`).  Its rounding points are the ones XLA
    on the CPU compiles that scan to, read from its optimized HLO: a
    layer's style term tanh(bf16(bf16(s Ws) + bs)) stays float32 (XLA
    hoists it out of the scan and keeps its float32 value); the input
    x + term is rounded once; each product x W and h U is a float32 sum
    of bfloat16 products rounded to bfloat16, their sum rounded, the
    bias added in float32; the gates float32; the heads' sums rounded,
    plus the rounded bias, rounded; the sigmoid 1 / (1 + exp(-s)) with
    each of its three steps rounded; then the temperature and the draws
    in float32.  With these points the plain version equals the JAX
    `_note_scan` bit for bit on the CPU at test widths (depths 1 to 3,
    both gate flavors, quantize on and off; tests/test_torch_gen_dtype.py).
    Rounding after every torch op instead (torch's own bfloat16 tanh,
    sigmoid and bias add) left 40% of the heads' outputs one bfloat16
    ULP apart (largest gap 2^-8) along one trajectory.  `fold_style`
    rounds differently, so this flavor does not fold the style terms.
  * "fused", what `pallas_note_sample(compute_dtype=bfloat16)` computes
    (`_FusedCell`): dot inputs rounded to bfloat16, float32
    accumulation, a_l and the heads' sigmoid in float32.  Against the
    Pallas kernel in interpret mode on the CPU the draws agree and
    volumes differ by at most 6.2e-4 (an h rounded the other way).

Where the kernels round h: the streamed kernel at each read; the cluster
kernel once, where a cell thread makes h and writes it to every block of
its cluster.  The fused flavor writes bf16(h), which every reader (h U,
the next layer's input, the heads) takes as it is.  The scan flavor
writes bf16(h) for its last layer (h U and the heads) and, for every
other layer l, bf16(h) and bf16(h + style term of layer l + 1) as one
pair of bfloat16 in the 4 bytes of one float32 h (the plan and its
shared memory unchanged), so h U reads one half and the input of layer
l + 1 the other.  Each product then takes the same operands in the same
order as if it rounded at the read: both kernels, and every plan, draw
bit for bit alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from music_generator_tpu_torch.ops import _build
from music_generator_tpu_torch.ops.lstm import (check_recurrent_activation,
                                                gates, lstm_step)
from music_generator_tpu_torch.ops.sampling import apply_temperature


F32, BF16 = torch.float32, torch.bfloat16
FLAVORS = ("scan", "fused")


def _linear(dense, x: torch.Tensor, dt: torch.dtype = F32) -> torch.Tensor:
    """x @ kernel + bias with every operand cast to `dt` (the JAX
    `dense_apply`, deepj.py:56-57)."""
    return x.to(dt) @ dense.kernel.to(dt) + dense.bias.to(dt)


def heads(x: torch.Tensor, note_dense, volume_dense,
          dt: torch.dtype = F32) -> torch.Tensor:
    """sigmoid(play, replay) ++ linear volume in `dt` -> [G, 3] float32
    (ref: model.py:94-95,125; deepj.py:436-442).  Below float32 the
    sigmoid is 1 / (1 + exp(-s)) with each step rounded to `dt`, as XLA on
    the CPU expands it."""
    s = _linear(note_dense, x, dt)
    p = torch.sigmoid(s) if dt == F32 else 1.0 / (1.0 + torch.exp(-s))
    return torch.cat([p, _linear(volume_dense, x, dt)], dim=-1).float()


def style_term(layer, style_emb: torch.Tensor,
               dt: torch.dtype = F32) -> torch.Tensor:
    """A layer's style term tanh(style_emb Ws + bs): the dense in `dt`,
    the tanh in float32 on its result.  XLA hoists this loop invariant out
    of the JAX generation scans and keeps its float32 value until it is
    added to the layer's input (measured on the CPU), so the sum x + term
    is rounded once, where the cell casts it."""
    return torch.tanh(_linear(layer.style_proj, style_emb, dt).float())


def note_cell(x: torch.Tensor, layers: Sequence, style_emb: torch.Tensor,
              state: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              note_dense, volume_dense, recurrent_activation: str,
              dt: torch.dtype = F32):
    """One pitch of the note axis, the plain version of what the kernel
    does per pitch: x = [feature row ++ chosen note n-1] [G, F+3] ->
    ([G, 3] heads, new per-layer (h, c)).  Each layer adds its tanh style
    projection and runs an LSTM cell, all in `dt` (the JAX
    `DeepJ.note_axis_cell`, deepj.py:613-629)."""
    new_state = []
    for layer, (h, c) in zip(layers, state):
        x = x + style_term(layer, style_emb, dt)
        h, c = lstm_step(layer.lstm, x, h, c, recurrent_activation, dt)
        new_state.append((h, c))
        x = h
    return heads(x, note_dense, volume_dense, dt), tuple(new_state)


def _zero_state(layers: Sequence, G: int, like: torch.Tensor):
    return [(like.new_zeros(G, l.lstm.recurrent.shape[0], dtype=F32),
             like.new_zeros(G, l.lstm.recurrent.shape[0], dtype=F32))
            for l in layers]


def _check_flavor(compute_dtype: torch.dtype, flavor: str) -> None:
    if compute_dtype not in (F32, BF16):
        raise ValueError(f"notegen: compute_dtype must be float32 or "
                         f"bfloat16, got {compute_dtype}")
    if flavor not in FLAVORS:
        raise ValueError(f"notegen: flavor must be one of {FLAVORS}, got "
                         f"{flavor!r}")


class _FusedCell:
    """One pitch of the fused flavor, `pallas_note_sample`'s arithmetic at
    compute dtype `cdt` (ops/pallas_notegen.py:76-107): the style terms
    folded into float32 a_l (`fold_style`), every dot's inputs (features,
    chosen note, h and the weights) rounded to `cdt` and accumulated in
    float32, z_0 = (feat W0f + chosen W0c) + a_0 + h_0 U_0 and z_l =
    h_{l-1} W_l + a_l + h_l U_l, the gates and the heads' sigmoid in
    float32."""

    def __init__(self, layers, note_dense, volume_dense, style_emb, F: int,
                 cdt: torch.dtype, recurrent_activation: str):
        r = lambda t: t.to(cdt).float()
        w0f, w0c, self.a = fold_style(layers, style_emb.float(), F)
        self.r, self.act = r, recurrent_activation
        self.w0f, self.w0c = r(w0f), r(w0c)
        self.u = [r(l.lstm.recurrent) for l in layers]
        self.w = [None] + [r(l.lstm.kernel) for l in layers[1:]]
        self.wnd, self.wvd = r(note_dense.kernel), r(volume_dense.kernel)
        self.bnd, self.bvd = note_dense.bias.float(), volume_dense.bias.float()

    def __call__(self, feat, prev, state):
        r, new_state = self.r, []
        for l, (h, c) in enumerate(state):
            if l == 0:
                z = r(feat) @ self.w0f + r(prev) @ self.w0c + self.a[0]
            else:
                z = r(x) @ self.w[l] + self.a[l]
            h, c = gates(z + r(h) @ self.u[l], c, h.shape[1], self.act)
            new_state.append((h, c))
            x = h
        pred = torch.cat([torch.sigmoid(r(x) @ self.wnd + self.bnd),
                          r(x) @ self.wvd + self.bvd], dim=-1)
        return pred, tuple(new_state)


def _pitch_cell(layers, note_dense, volume_dense, style_emb, F: int,
                recurrent_activation: str, compute_dtype: torch.dtype,
                flavor: str):
    """(feature row [G, F], chosen note n-1 [G, 3], state) -> ([G, 3]
    heads, state) of the flavor: the scan flavor is `note_cell` in the
    compute dtype (the JAX `Sampler._note_scan` scan branch), the fused
    one `_FusedCell` (its Pallas branch); at float32 they are one."""
    _check_flavor(compute_dtype, flavor)
    if compute_dtype == BF16 and flavor == "fused":
        return _FusedCell(layers, note_dense, volume_dense, style_emb, F,
                          compute_dtype, recurrent_activation)

    def scan_cell(feat, prev, state):
        x = torch.cat([feat, prev.to(feat.dtype)], dim=-1)
        return note_cell(x, layers, style_emb, state, note_dense,
                         volume_dense, recurrent_activation, compute_dtype)
    return scan_cell


def _draw(pred: torch.Tensor, temperature: torch.Tensor, u: torch.Tensor,
          velocity_grid: Optional[torch.Tensor]) -> torch.Tensor:
    """One pitch's draws from the heads pred [G, 3] and uniforms u [G, 2]:
    the chosen (play, replay, volume) [G, 3]."""
    p = apply_temperature(pred[:, :2], temperature[:, None])
    play = (u[:, 0] <= p[:, 0]).float()
    replay = (u[:, 1] <= p[:, 1]).float() * play
    # Clipped before the copy-through (the JAX package's deliberate
    # deviation from the reference's unclipped volume).
    volume = torch.clamp(pred[:, 2], 0.0, 1.0)
    if velocity_grid is not None:
        mv = velocity_grid.shape[0] - 1
        volume = velocity_grid[torch.round(volume * float(mv)).long()]
    return torch.stack([play, replay, volume * play], dim=-1)


@torch.no_grad()
def note_sample_reference(feats: torch.Tensor, uniforms: torch.Tensor,
                          temperature: torch.Tensor, layers: Sequence,
                          note_dense, volume_dense, style_emb: torch.Tensor,
                          recurrent_activation: str = "sigmoid",
                          velocity_grid: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = F32,
                          flavor: str = "scan") -> torch.Tensor:
    """The plain PyTorch pitch loop (the JAX `Sampler._note_scan`): feats
    [G, N, F], uniforms [G, N, 2], temperature [G], layers the L
    note-axis layers -> sampled (play, replay, volume) [G, N, 3], float32.
    In bfloat16 the flavor picks the arithmetic (`_pitch_cell`); the
    temperature and the draws are float32 in both."""
    note_sample_reference.calls += 1
    G, N, F = feats.shape
    cell = _pitch_cell(layers, note_dense, volume_dense, style_emb, F,
                       recurrent_activation, compute_dtype, flavor)
    state = _zero_state(layers, G, feats)
    chosen = feats.new_zeros(G, 3, dtype=F32)
    out = []
    for n in range(N):
        pred, state = cell(feats[:, n], chosen, state)
        chosen = _draw(pred, temperature, uniforms[:, n], velocity_grid)
        out.append(chosen)
    return torch.stack(out, dim=1)


note_sample_reference.calls = 0


@torch.no_grad()
def tempered_probs(feats: torch.Tensor, notes: torch.Tensor,
                   temperature: torch.Tensor, layers: Sequence, note_dense,
                   volume_dense, style_emb: torch.Tensor,
                   recurrent_activation: str = "sigmoid",
                   compute_dtype: torch.dtype = F32,
                   flavor: str = "scan") -> torch.Tensor:
    """The tempered (play, replay) probabilities [G, N, 2] along a given
    sampled trajectory `notes` [G, N, 3] (teacher-forced: pitch n sees the
    given note n-1), in the arithmetic of `note_sample_reference`'s
    dtype and flavor.  A draw whose uniform lies within a few ULPs of its
    probability may fall either way between two float32 implementations
    (within a few bfloat16 ULPs of z between two bfloat16 ones);
    `draws_agree` uses these to tell such knife edges from real faults."""
    G, N, F = feats.shape
    cell = _pitch_cell(layers, note_dense, volume_dense, style_emb, F,
                       recurrent_activation, compute_dtype, flavor)
    state = _zero_state(layers, G, feats)
    notes = notes.float()
    prev = torch.cat([notes.new_zeros(G, 1, 3), notes[:, :-1]], dim=1)
    out = []
    for n in range(N):
        pred, state = cell(feats[:, n], prev[:, n], state)
        out.append(apply_temperature(pred[:, :2], temperature[:, None]))
    return torch.stack(out, dim=1)


def draws_agree(a: torch.Tensor, b: torch.Tensor, uniforms: torch.Tensor,
                probs: torch.Tensor, edge: float = 1e-5,
                volume_atol: float = 1e-5) -> Tuple[bool, float, str]:
    """Compare two sampled pitch loops [G, N, 3] of the same inputs.

    Per stream, play and replay must be equal up to the first pitch where
    they differ; that difference is accepted only where |u - p| < edge (a
    knife edge, `probs` from `tempered_probs` on `a`), and the rest of the
    stream, which then follows another path, is not compared.  The draw
    held to the edge is the play draw where play differs, else the replay
    draw: replay is replay * play, so a play that flips flips a replay of
    1 with it, whatever the replay's own margin.  Volumes before that
    point agree within volume_atol.  Returns (ok, the largest volume
    difference compared, report)."""
    a, b = a.float().cpu(), b.float().cpu()
    u, p = uniforms.float().cpu(), probs.float().cpu()
    edges, err = 0, 0.0
    for g in range(a.shape[0]):
        diff = (a[g, :, :2] != b[g, :, :2]).any(dim=-1).nonzero()
        stop = a.shape[1]
        if diff.numel():
            stop = int(diff[0])
            k = 0 if a[g, stop, 0] != b[g, stop, 0] else 1
            gap = float((u[g, stop, k] - p[g, stop, k]).abs())
            if gap >= edge:
                return False, err, (
                    f"stream {g} pitch {stop} channel {k} differs "
                    f"with |u - p| = {gap:.3g}")
            edges += 1
        if stop:
            vd = (a[g, :stop, 2] - b[g, :stop, 2]).abs().max()
            err = max(err, float(vd))
        if err > volume_atol:
            return False, err, f"stream {g} volume differs by {err:.3g}"
    return True, err, f"{edges} knife-edge draw(s)"


def fold_style(layers: Sequence, style_emb: torch.Tensor,
               feature_width: int):
    """The per-timestep constants of the kernels: W0 split into (W0f, W0c)
    and, for every layer l, a_l = tanh(s Ws_l + bs_l) W_l + b_l.  Returns
    (W0f, W0c, [a_0, ..., a_{L-1}])."""
    w0 = layers[0].lstm.kernel
    a = [torch.tanh(_linear(l.style_proj, style_emb)) @ l.lstm.kernel
         + l.lstm.bias for l in layers]
    return w0[:feature_width], w0[feature_width:], a


class NotegenPlan(NamedTuple):
    """How the kernels cover G streams: clusters of C blocks, each serving
    Gc streams, and each block's dynamic shared memory in bytes; C = 0 is
    the streamed kernel (G blocks of one stream)."""
    C: int
    Gc: int
    clusters: int
    smem: int

    @property
    def kernel(self) -> str:
        return "streamed" if self.C == 0 else "cluster"


SMEM_MAX = 232448     # the H100's opt-in shared memory of one block
GC_MAX = 8            # streams one cluster serves, at most
PB = 16               # pitches of one staged chunk of x in the prologue
THREADS_MAX = 384     # threads of one block, at most
LMAX = 8              # note-axis layers, at most (csrc/notegen.cu NG_LMAX)


def _h_buffers(L: int) -> int:
    """[H][Gp] buffers of h: two for h_0 and two for h_{L-1} (one pair at
    L = 1), one for each middle layer."""
    return 2 if L == 1 else L + 2


def _z_buffers(L: int) -> int:
    """[Gp][COLS] buffers of z: the cells' and one (L = 2) or two (L > 2)
    for the h_l U_l of the rec warps."""
    return 1 + min(L - 1, 2)


def _smem_bytes(C: int, Gc: int, L: int, N: int, F: int, H: int,
                esize: int = 4) -> int:
    """One block's shared memory at depth L: max((2L-1)H, F) weight rows
    of its 4H/C columns (U_0, then W_l and U_l of each further layer) in
    elements of `esize` bytes (4 float32, 2 bfloat16), padded to 16
    bytes; then in float32 W0c's columns, the heads' weights, acc_F for
    every pitch, the h and z buffers, or in the prologue two staged chunks
    of x (in elements of `esize` bytes) in their place, and the chosen
    notes and head outputs; the streams padded to a multiple of 4
    (csrc/notegen.cu::ng_smem_bytes)."""
    cols, gp = 4 * (H // C), (Gc + 3) // 4 * 4
    hz = max(_h_buffers(L) * H * gp + _z_buffers(L) * gp * cols,
             -(-2 * PB * F * esize // 4))
    weights = -(-max((2 * L - 1) * H, F) * cols * esize // 16) * 16
    return weights + 4 * (3 * cols + 3 * H + N * gp * cols + hz + 8 * gp)


def _threads(C: int, Gc: int, H: int) -> int:
    """Work warps (a cell thread per unit and stream), rec warps for the
    h_l U_l (a product thread per two gate columns and four streams), and
    three head warps."""
    p0 = (H // C) * ((Gc + 3) // 4 * 4)
    return 32 * (-(-p0 // 32) + -(-(p0 // 2) // 32) + 3)


def _streamed_smem(L: int, F: int, H: int) -> int:
    """The streamed kernel's block: h and c of every layer, z, x, the
    chosen notes and head outputs (csrc/notegen.cu::ng_streamed_smem)."""
    return 4 * (2 * L * H + 4 * H + F + 8)


def _cluster_plan(G: int, L: int, F: int, H: int, N: int,
                  esize: int = 4) -> Optional[NotegenPlan]:
    for C in (8, 4, 16):
        if H % C:
            continue
        fit = [gc for gc in range(1, min(GC_MAX, G) + 1)
               if _smem_bytes(C, gc, L, N, F, H, esize) <= SMEM_MAX
               and _threads(C, gc, H) <= THREADS_MAX]
        if not fit:
            continue
        clusters = -(-G // fit[-1])
        gc = -(-G // clusters)
        return NotegenPlan(C, gc, clusters,
                           _smem_bytes(C, gc, L, N, F, H, esize))
    return None


@functools.lru_cache(maxsize=None)
def notegen_plan(G: int, L: int, F: int, H: int, N: int,
                 esize: int = 4) -> NotegenPlan:
    """The kernel and its plan for G streams at depth L and widths (F, H,
    N), with weights of `esize` bytes an element (4 for the float32
    instances, 2 for the bfloat16 ones), the same arithmetic as
    csrc/notegen.cu::ng_plan (the launch refuses any other).  The cluster
    kernel where a cluster holds the L layers' weights: C is the first of
    8, 4, 16 that divides H and fits one stream; Gc the most streams that
    fit (at most 8 and G), spread evenly over the ceil(G / Gc) clusters,
    so a cluster serves every stream it can.  Else, at widths where a
    cluster serves one layer, the streamed kernel (C = 0).  Raises
    ValueError where nothing fits."""
    if (min(G, N, F, H) <= 0 or F % 4 or not 1 <= L <= LMAX
            or esize not in (2, 4)):
        raise ValueError(f"notegen_plan: no plan for G={G}, L={L}, F={F}, "
                         f"H={H}, N={N}, esize={esize} (positive widths, F "
                         f"a multiple of 4, 1 <= L <= {LMAX}, 2- or 4-byte "
                         f"weights)")
    plan = _cluster_plan(G, L, F, H, N, esize)
    if plan is not None:
        return plan
    if (_cluster_plan(G, 1, F, H, N, esize) is not None
            and _streamed_smem(L, F, H) <= SMEM_MAX):
        return NotegenPlan(0, 1, G, _streamed_smem(L, F, H))
    raise ValueError(f"notegen_plan: F={F}, H={H}, N={N} fit no cluster of "
                     f"8, 4 or 16 blocks in {SMEM_MAX} bytes of shared "
                     f"memory a block")


@torch.no_grad()
def note_sample_staged(feats: torch.Tensor, uniforms: torch.Tensor,
                       temperature: torch.Tensor, layers: Sequence,
                       note_dense, volume_dense, style_emb: torch.Tensor,
                       recurrent_activation: str = "sigmoid",
                       velocity_grid: Optional[torch.Tensor] = None,
                       ) -> torch.Tensor:
    """The kernels' math in plain PyTorch: acc_F = feat W0f for every
    pitch in one product, then the pitch chain carrying only the recurrent
    terms, z_0 = ((acc_F + chosen W0c) + a_0) + h_0 U_0 and, for l >= 1,
    z_l = (h_{l-1} W_l + a_l) + h_l U_l, with the heads and draws from the
    full h_{L-1}.  Same arguments and result as `note_sample_reference`."""
    G, N, F = feats.shape
    w0f, w0c, a = fold_style(layers, style_emb, F)
    H = layers[0].lstm.recurrent.shape[0]
    acc_f = feats @ w0f                                 # [G, N, 4H]
    h = [feats.new_zeros(G, H) for _ in layers]
    c = [feats.new_zeros(G, H) for _ in layers]
    chosen = feats.new_zeros(G, 3)
    out = []
    for n in range(N):
        for l, layer in enumerate(layers):
            u = layer.lstm.recurrent
            if l == 0:
                z = ((acc_f[:, n] + chosen @ w0c) + a[0]) + h[0] @ u
            else:
                z = (h[l - 1] @ layer.lstm.kernel + a[l]) + h[l] @ u
            h[l], c[l] = gates(z, c[l], H, recurrent_activation)
        chosen = _draw(heads(h[-1], note_dense, volume_dense), temperature,
                       uniforms[:, n], velocity_grid)
        out.append(chosen)
    return torch.stack(out, dim=1)


_POINTERS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
# The bfloat16 instances take the style table and two ints more: the
# flavor (1 scan, 2 fused) and whether the chosen note is rounded to
# bfloat16 before its style term is added (bfloat16 features).
_BF16 = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
_SIGNATURES = {
    "notegen_launch": _POINTERS + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    "notegen_streamed_launch": _POINTERS + [ctypes.c_void_p],
    "notegen_active_clusters": [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "notegen_launch_bf16": (_POINTERS + _BF16 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p] * 2),
    "notegen_streamed_launch_bf16": _POINTERS + _BF16 + [ctypes.c_void_p],
    "notegen_active_clusters_bf16": [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_FLAVOR_CODE = {"scan": 1, "fused": 2}


def _library() -> ctypes.CDLL:
    return _build.bind("notegen", _SIGNATURES)


class _Operands(NamedTuple):
    """The kernels' operands: per-layer a_l [G, 4H], U_l [H, 4H] and W_l
    [H, 4H] (l >= 1) as tuples, the rest as in the C entries.  `flavor`
    None is the float32 instances (every operand float32); "scan" or
    "fused" the bfloat16 ones (feats, W0f, W0c, U_l, W_l and the heads'
    kernels bfloat16, the rest float32), with the scan flavor's style
    table `proj` [G, L, H] (row 0 the style terms of the chosen note's
    three inputs, row l >= 1 those of layer l's input) and `cround`."""
    feats: torch.Tensor
    uniforms: torch.Tensor
    temperature: torch.Tensor
    w0f: torch.Tensor
    w0c: torch.Tensor
    a: Tuple[torch.Tensor, ...]
    u: Tuple[torch.Tensor, ...]
    w: Tuple[torch.Tensor, ...]
    wnd: torch.Tensor
    bnd: torch.Tensor
    wvd: torch.Tensor
    bvd: torch.Tensor
    velocity_grid: Optional[torch.Tensor]
    flavor: Optional[str] = None
    proj: Optional[torch.Tensor] = None
    cround: bool = False

    @property
    def esize(self) -> int:
        return 4 if self.flavor is None else 2


def _args(ops: _Operands):
    """Check the kernels' operands (the dtypes of the instance, one CUDA
    device, the shapes of the kernels, 1 <= L <= 8) and return them
    contiguous and 16-byte aligned as the C entries take them, the layer
    table a ctypes array of 3 * 8 pointers, with (G, N, F, H, L,
    max_velocity) and the tensors to keep alive for the call."""
    feats = ops.feats
    G, N, F = feats.shape
    H = ops.u[0].shape[0]
    L = len(ops.u)
    if not 1 <= L <= LMAX or len(ops.a) != L or len(ops.w) != L - 1:
        raise ValueError(f"notegen: expected 1 to {LMAX} layers with a "
                         f"and U each and W past the first, got "
                         f"{len(ops.a)}, {L}, {len(ops.w)}")
    dev = feats.device
    expect = [
        ("feats", feats, (G, N, F)), ("uniforms", ops.uniforms, (G, N, 2)),
        ("temperature", ops.temperature, (G,)),
        ("w0f", ops.w0f, (F, 4 * H)), ("w0c", ops.w0c, (3, 4 * H)),
        ("wnd", ops.wnd, (H, 2)), ("bnd", ops.bnd, (2,)),
        ("wvd", ops.wvd, (H, 1)), ("bvd", ops.bvd, (1,)),
    ]
    expect += [(f"a{l}", t, (G, 4 * H)) for l, t in enumerate(ops.a)]
    expect += [(f"u{l}", t, (H, 4 * H)) for l, t in enumerate(ops.u)]
    expect += [(f"w{l + 1}", t, (H, 4 * H)) for l, t in enumerate(ops.w)]
    if ops.velocity_grid is not None:
        expect.append(("velocity_grid", ops.velocity_grid,
                       (ops.velocity_grid.shape[0],)))
    if ops.flavor == "scan":
        expect.append(("proj", ops.proj, (G, L, H)))
    elif ops.flavor is not None and ops.flavor != "fused":
        raise ValueError(f"notegen: flavor must be None, 'scan' or "
                         f"'fused', got {ops.flavor!r}")
    narrow = (set() if ops.flavor is None else
              {"feats", "w0f", "w0c", "wnd", "wvd"}
              | {f"u{l}" for l in range(L)}
              | {f"w{l}" for l in range(1, L)})
    ready = {}
    for name, t, shape in expect:
        dtype = BF16 if name in narrow else F32
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        t = t.contiguous()
        # The cluster kernel copies feats and the weights 16 bytes at a time.
        ready[name] = t if t.data_ptr() % 16 == 0 else t.clone()
    table = (ctypes.c_void_p * (3 * LMAX))()
    for l in range(L):
        table[l] = ready[f"a{l}"].data_ptr()
        table[LMAX + l] = ready[f"u{l}"].data_ptr()
        if l:
            table[2 * LMAX + l] = ready[f"w{l}"].data_ptr()
    vg = ready.get("velocity_grid")
    pointers = [ready["feats"].data_ptr(), ready["uniforms"].data_ptr(),
                ready["temperature"].data_ptr(), ready["w0f"].data_ptr(),
                ready["w0c"].data_ptr(), ctypes.addressof(table),
                ready["wnd"].data_ptr(), ready["bnd"].data_ptr(),
                ready["wvd"].data_ptr(), ready["bvd"].data_ptr(),
                None if vg is None else vg.data_ptr()]
    mv = 0 if vg is None else vg.shape[0] - 1
    narrow_args = ()
    if ops.flavor is not None:
        pj = ready.get("proj")
        narrow_args = (None if pj is None else pj.data_ptr(),
                       _FLAVOR_CODE[ops.flavor], int(ops.cround))
    return pointers, (G, N, F, H, L, mv), narrow_args, (ready, table)


def _run(entry: str, ops: _Operands, hard: bool, extra=(),
         lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    # `keep` holds the tensors and the table the pointers point into.
    pointers, dims, narrow_args, keep = _args(ops)
    G, N = dims[:2]
    dev = ops.feats.device
    out = torch.empty((G, N, 3), dtype=torch.float32, device=dev)
    if ops.flavor is not None:
        entry += "_bf16"
    fn = getattr(_library() if lib is None else lib, entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*pointers, out.data_ptr(), *dims[:5], int(hard), dims[5],
                *narrow_args, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return out


def _launch(ops: _Operands, hard: bool,
            prof: Optional[torch.Tensor] = None,
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """One launch of the cluster kernel on the current stream, with the
    plan of `notegen_plan` (which must be a cluster's); the float32
    instance, or the bfloat16 one of `ops.flavor`.  `prof`, an int64 [14] on
    the card or None: block 0's clock cycles summed over the pitches, [0]
    the h0 U0 product, [1] the wait for the draw with z0 and the cells, [2]
    the h0 exchange and the first barrier, [3] the products and cells of
    the layers l >= 1, [4] their h exchanges and barriers, [5] the heads
    and the draw (a head warp, beside [0]-[1]); [6] the prologue, [7] the
    whole launch; [8]-[11] C, Gc, clusters and N; [12] the prologue up to
    the acc_F chunks, [13] the chunks.  `lib`: another build of
    csrc/notegen.cu bound with _SIGNATURES (tools/notegen_ab.py),
    else the wrapper's own.  Returns the [G, N, 3] output."""
    G, N, F = ops.feats.shape
    plan = notegen_plan(G, len(ops.u), F, ops.u[0].shape[0], N, ops.esize)
    if plan.kernel != "cluster":
        raise ValueError(f"notegen: the plan at depth {len(ops.u)} is the "
                         f"streamed kernel's, not a cluster's")
    if prof is not None and (prof.dtype != torch.int64
                             or prof.device != ops.feats.device
                             or prof.numel() < 14):
        raise ValueError("prof: expected int64 [14] on the kernel's device")
    return _run("notegen_launch", ops, hard,
                (*plan, None if prof is None else prof.data_ptr()), lib)


def _launch_streamed(ops: _Operands, hard: bool) -> torch.Tensor:
    """One launch of the streamed kernel (one block per stream, the
    weights read from L2 at every pitch)."""
    return _run("notegen_streamed_launch", ops, hard)


def active_clusters(G: int, L: int, F: int, H: int, N: int,
                    esize: int = 4) -> int:
    """How many clusters of `notegen_plan(G, L, F, H, N, esize)` the
    current card holds at once (cudaOccupancyMaxActiveClusters) for the
    float32 instance (esize 4) or a bfloat16 one (2); the plan must be a
    cluster's."""
    active = ctypes.c_int(0)
    entry = ("notegen_active_clusters" if esize == 4
             else "notegen_active_clusters_bf16")
    rc = getattr(_library(), entry)(G, L, N, F, H, ctypes.addressof(active))
    if rc != 0:
        raise RuntimeError(f"notegen_active_clusters failed: CUDA error "
                           f"{rc}")
    return active.value


class NoteWeights(NamedTuple):
    """The bfloat16 instances' weights, cast once (`note_weights`): W0f
    [F, 4H], W0c [3, 4H], U_l, W_l (l >= 1) and the heads' kernels in
    bfloat16; the LSTM biases [4H] and the heads' biases rounded to
    bfloat16 and held in float32 (the scan flavor's)."""
    w0f: torch.Tensor
    w0c: torch.Tensor
    u: Tuple[torch.Tensor, ...]
    w: Tuple[torch.Tensor, ...]
    wnd: torch.Tensor
    wvd: torch.Tensor
    b: Tuple[torch.Tensor, ...]
    bnd: torch.Tensor
    bvd: torch.Tensor


@torch.no_grad()
def note_weights(layers: Sequence, note_dense, volume_dense,
                 feature_width: int) -> NoteWeights:
    """Cast the note axis's weights for the bfloat16 instances once (the
    Sampler does so once, not once a timestep)."""
    n = lambda t: t.detach().to(BF16).contiguous()
    r = lambda t: t.detach().to(BF16).float()
    w0 = layers[0].lstm.kernel
    return NoteWeights(
        n(w0[:feature_width]), n(w0[feature_width:]),
        tuple(n(l.lstm.recurrent) for l in layers),
        tuple(n(l.lstm.kernel) for l in layers[1:]),
        n(note_dense.kernel), n(volume_dense.kernel),
        tuple(r(l.lstm.bias) for l in layers), r(note_dense.bias),
        r(volume_dense.bias))


def _kernel_operands(feats, uniforms, temperature, layers, note_dense,
                     volume_dense, style_emb, velocity_grid,
                     compute_dtype: torch.dtype = F32, flavor: str = "scan",
                     weights: Optional[NoteWeights] = None) -> _Operands:
    """The kernels' operands: at float32 the float32 instances' (the
    style terms folded, `fold_style`); at bfloat16 the flavor's, with
    `weights` from `note_weights` (cast here when None)."""
    F = feats.shape[-1]
    _check_flavor(compute_dtype, flavor)
    if compute_dtype == F32:
        w0f, w0c, a = fold_style(layers, style_emb, F)
        return _Operands(feats, uniforms, temperature, w0f, w0c, tuple(a),
                         tuple(l.lstm.recurrent for l in layers),
                         tuple(l.lstm.kernel for l in layers[1:]),
                         note_dense.kernel, note_dense.bias,
                         volume_dense.kernel, volume_dense.bias,
                         velocity_grid)
    nw = weights or note_weights(layers, note_dense, volume_dense, F)
    G = feats.shape[0]
    H = nw.u[0].shape[0]
    proj, cround = None, False
    if flavor == "fused":
        # pallas_note_sample: a_l in float32 from the style embedding as
        # float32, the biases of the heads float32.
        _, _, a = fold_style(layers, style_emb.float(), F)
        x = feats.to(BF16)
        bnd, bvd = note_dense.bias.float(), volume_dense.bias.float()
    else:
        # The scan flavor: each layer's input is x + its style term,
        # rounded; layer 0's feature part here, the chosen note's part
        # and the further layers' in the kernel from `proj`.
        terms = [style_term(l, style_emb, compute_dtype) for l in layers]
        if H < 3:
            raise ValueError(f"notegen: the scan flavor's style table "
                             f"needs H >= 3, got {H}")
        x = (feats.float() + terms[0][:, None, :F]).to(BF16)
        proj = feats.new_zeros(G, len(layers), H, dtype=F32)
        proj[:, 0, :3] = terms[0][:, F:F + 3]
        for l in range(1, len(layers)):
            proj[:, l] = terms[l]
        a = [b.expand(G, -1).contiguous() for b in nw.b]
        bnd, bvd = nw.bnd, nw.bvd
        cround = feats.dtype == BF16
    return _Operands(x, uniforms, temperature, nw.w0f, nw.w0c, tuple(a),
                     nw.u, nw.w, nw.wnd, bnd, nw.wvd, bvd, velocity_grid,
                     flavor, proj, cround)


def _device(feats: torch.Tensor) -> str:
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"note_sample runs on CPU or CUDA tensors, got "
                         f"{feats.device}")
    return feats.device.type


@torch.no_grad()
def note_sample(feats: torch.Tensor, uniforms: torch.Tensor,
                temperature: torch.Tensor, layers: Sequence, note_dense,
                volume_dense, style_emb: torch.Tensor,
                recurrent_activation: str = "sigmoid",
                velocity_grid: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = F32, flavor: str = "scan",
                weights: Optional[NoteWeights] = None) -> torch.Tensor:
    """Sample one generation timestep's N pitches.

    feats: [G, N, time_units] time-axis features; uniforms: [G, N, 2]
    pre-drawn (play, replay) uniforms; temperature: [G]; layers: the L
    note-axis layers (each a `style_proj` Dense and an `lstm` with
    kernel/recurrent/bias); note_dense/volume_dense: the heads; style_emb:
    [G, style_units]; velocity_grid: the float32 k/max_velocity table to
    snap volumes onto, or None; compute_dtype: float32, or bfloat16 in
    the arithmetic of `flavor` ("scan" or "fused", `_pitch_cell`);
    weights: `note_weights(...)` for bfloat16, cast here when None.
    Returns sampled (play, replay, volume) [G, N, 3], float32.  On a CUDA
    tensor: one launch of the kernel that `notegen_plan` names, its
    float32 instance or its bfloat16 instance of the flavor (widths that
    fit no plan, a failed build or a refused launch raise).
    """
    check_recurrent_activation(recurrent_activation)
    if _device(feats) == "cpu":
        return note_sample_reference(feats, uniforms, temperature, layers,
                                     note_dense, volume_dense, style_emb,
                                     recurrent_activation, velocity_grid,
                                     compute_dtype, flavor)
    ops = _kernel_operands(feats, uniforms, temperature, layers, note_dense,
                           volume_dense, style_emb, velocity_grid,
                           compute_dtype, flavor, weights)
    G, N, F = feats.shape
    plan = notegen_plan(G, len(layers), F, ops.u[0].shape[0], N, ops.esize)
    hard = recurrent_activation == "hard_sigmoid"
    if plan.kernel == "cluster":
        out = _launch(ops, hard)
    else:
        out = _launch_streamed(ops, hard)
        note_sample.streamed_launches += 1
    if ops.flavor is not None:
        note_sample.bf16_launches[ops.flavor] += 1
    note_sample.launches += 1
    return out


note_sample.launches = 0
note_sample.streamed_launches = 0
note_sample.bf16_launches = {"scan": 0, "fused": 0}


@torch.no_grad()
def note_sample_streamed(feats: torch.Tensor, uniforms: torch.Tensor,
                         temperature: torch.Tensor, layers: Sequence,
                         note_dense, volume_dense, style_emb: torch.Tensor,
                         recurrent_activation: str = "sigmoid",
                         velocity_grid: Optional[torch.Tensor] = None,
                         compute_dtype: torch.dtype = F32,
                         flavor: str = "scan",
                         weights: Optional[NoteWeights] = None,
                         ) -> torch.Tensor:
    """`note_sample` through the streamed kernel whatever the plan, for
    comparison; `note_sample_streamed.launches` counts its launches."""
    check_recurrent_activation(recurrent_activation)
    if _device(feats) == "cpu":
        return note_sample_reference(feats, uniforms, temperature, layers,
                                     note_dense, volume_dense, style_emb,
                                     recurrent_activation, velocity_grid,
                                     compute_dtype, flavor)
    out = _launch_streamed(
        _kernel_operands(feats, uniforms, temperature, layers, note_dense,
                         volume_dense, style_emb, velocity_grid,
                         compute_dtype, flavor, weights),
        recurrent_activation == "hard_sigmoid")
    note_sample_streamed.launches += 1
    return out


note_sample_streamed.launches = 0
