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
`note_sample.launches` counts the main path's launches and
`note_sample.streamed_launches` those of them the plan gave the streamed
kernel; `note_sample_streamed.launches` and `note_sample_reference.calls`
count the other paths, so a run can show which it took.
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


def _linear(dense, x: torch.Tensor) -> torch.Tensor:
    return x @ dense.kernel + dense.bias


def heads(x: torch.Tensor, note_dense, volume_dense) -> torch.Tensor:
    """sigmoid(play, replay) ++ linear volume -> [G, 3] float32
    (ref: model.py:94-95,125)."""
    return torch.cat([torch.sigmoid(_linear(note_dense, x)),
                      _linear(volume_dense, x)], dim=-1).float()


def note_cell(x: torch.Tensor, layers: Sequence, style_emb: torch.Tensor,
              state: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              note_dense, volume_dense, recurrent_activation: str):
    """One pitch of the note axis, the plain version of what the kernel
    does per pitch: x = [feature row ++ chosen note n-1] [G, F+3] ->
    ([G, 3] heads, new per-layer (h, c)).  Each layer adds its tanh style
    projection and runs an LSTM cell (the JAX `DeepJ.note_axis_cell`)."""
    new_state = []
    for layer, (h, c) in zip(layers, state):
        x = x + torch.tanh(_linear(layer.style_proj, style_emb))
        h, c = lstm_step(layer.lstm, x, h, c, recurrent_activation)
        new_state.append((h, c))
        x = h
    return heads(x, note_dense, volume_dense), tuple(new_state)


def _zero_state(layers: Sequence, G: int, like: torch.Tensor):
    return [(like.new_zeros(G, l.lstm.recurrent.shape[0]),
             like.new_zeros(G, l.lstm.recurrent.shape[0])) for l in layers]


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
                          ) -> torch.Tensor:
    """The plain PyTorch pitch loop (the JAX `Sampler._note_scan` scan
    branch): feats [G, N, F], uniforms [G, N, 2], temperature [G],
    layers the L note-axis layers -> sampled (play, replay, volume)
    [G, N, 3], float32."""
    note_sample_reference.calls += 1
    G, N, _ = feats.shape
    state = _zero_state(layers, G, feats)
    chosen = feats.new_zeros(G, 3)
    out = []
    for n in range(N):
        x = torch.cat([feats[:, n], chosen], dim=-1)
        pred, state = note_cell(x, layers, style_emb, state, note_dense,
                                volume_dense, recurrent_activation)
        chosen = _draw(pred, temperature, uniforms[:, n], velocity_grid)
        out.append(chosen)
    return torch.stack(out, dim=1)


note_sample_reference.calls = 0


@torch.no_grad()
def tempered_probs(feats: torch.Tensor, notes: torch.Tensor,
                   temperature: torch.Tensor, layers: Sequence, note_dense,
                   volume_dense, style_emb: torch.Tensor,
                   recurrent_activation: str = "sigmoid") -> torch.Tensor:
    """The tempered (play, replay) probabilities [G, N, 2] along a given
    sampled trajectory `notes` [G, N, 3] (teacher-forced: pitch n sees the
    given note n-1).  A draw whose uniform lies within a few ULPs of its
    probability may fall either way between two float32 implementations;
    `draws_agree` uses these to tell such knife edges from real faults."""
    G, N, _ = feats.shape
    state = _zero_state(layers, G, feats)
    prev = torch.cat([feats.new_zeros(G, 1, 3), notes[:, :-1]], dim=1)
    out = []
    for n in range(N):
        x = torch.cat([feats[:, n], prev[:, n]], dim=-1)
        pred, state = note_cell(x, layers, style_emb, state, note_dense,
                                volume_dense, recurrent_activation)
        out.append(apply_temperature(pred[:, :2], temperature[:, None]))
    return torch.stack(out, dim=1)


def draws_agree(a: torch.Tensor, b: torch.Tensor, uniforms: torch.Tensor,
                probs: torch.Tensor, edge: float = 1e-5,
                volume_atol: float = 1e-5) -> Tuple[bool, float, str]:
    """Compare two sampled pitch loops [G, N, 3] of the same inputs.

    Per stream, play and replay must be equal up to the first pitch where
    they differ; that difference is accepted only where |u - p| < edge (a
    knife edge, `probs` from `tempered_probs` on `a`), and the rest of the
    stream, which then follows another path, is not compared.  Volumes
    before that point agree within volume_atol.  Returns (ok, the largest
    volume difference compared, report)."""
    a, b = a.float().cpu(), b.float().cpu()
    u, p = uniforms.float().cpu(), probs.float().cpu()
    edges, err = 0, 0.0
    for g in range(a.shape[0]):
        diff = (a[g, :, :2] != b[g, :, :2]).any(dim=-1).nonzero()
        stop = a.shape[1]
        if diff.numel():
            stop = int(diff[0])
            for k in range(2):
                if a[g, stop, k] != b[g, stop, k]:
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


def _smem_bytes(C: int, Gc: int, L: int, N: int, F: int, H: int) -> int:
    """One block's shared memory at depth L: max((2L-1)H, F) weight rows
    of its 4H/C columns (U_0, then W_l and U_l of each further layer),
    W0c's columns, the heads' weights, acc_F for every pitch, the h and z
    buffers, or in the prologue two staged chunks of x in their place, and
    the chosen notes and head outputs; the streams padded to a multiple
    of 4 (csrc/notegen.cu::ng_smem_bytes)."""
    cols, gp = 4 * (H // C), (Gc + 3) // 4 * 4
    hz = max(_h_buffers(L) * H * gp + _z_buffers(L) * gp * cols,
             2 * PB * F)
    return 4 * (max((2 * L - 1) * H, F) * cols + 3 * cols + 3 * H
                + N * gp * cols + hz + 8 * gp)


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


def _cluster_plan(G: int, L: int, F: int, H: int,
                  N: int) -> Optional[NotegenPlan]:
    for C in (8, 4, 16):
        if H % C:
            continue
        fit = [gc for gc in range(1, min(GC_MAX, G) + 1)
               if _smem_bytes(C, gc, L, N, F, H) <= SMEM_MAX
               and _threads(C, gc, H) <= THREADS_MAX]
        if not fit:
            continue
        clusters = -(-G // fit[-1])
        gc = -(-G // clusters)
        return NotegenPlan(C, gc, clusters, _smem_bytes(C, gc, L, N, F, H))
    return None


@functools.lru_cache(maxsize=None)
def notegen_plan(G: int, L: int, F: int, H: int, N: int) -> NotegenPlan:
    """The kernel and its plan for G streams at depth L and widths (F, H,
    N), the same arithmetic as csrc/notegen.cu::ng_plan (the launch
    refuses any other).  The cluster kernel where a cluster holds the L
    layers' weights: C is the first of 8, 4, 16 that divides H and fits
    one stream; Gc the most streams that fit (at most 8 and G), spread
    evenly over the ceil(G / Gc) clusters, so a cluster serves every
    stream it can.  Else, at widths where a cluster serves one layer, the
    streamed kernel (C = 0).  Raises ValueError where nothing fits."""
    if min(G, N, F, H) <= 0 or F % 4 or not 1 <= L <= LMAX:
        raise ValueError(f"notegen_plan: no plan for G={G}, L={L}, F={F}, "
                         f"H={H}, N={N} (positive widths, F a multiple of "
                         f"4, 1 <= L <= {LMAX})")
    plan = _cluster_plan(G, L, F, H, N)
    if plan is not None:
        return plan
    if (_cluster_plan(G, 1, F, H, N) is not None
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
_SIGNATURES = {
    "notegen_launch": _POINTERS + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    "notegen_streamed_launch": _POINTERS + [ctypes.c_void_p],
    "notegen_active_clusters": [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def _library() -> ctypes.CDLL:
    return _build.bind("notegen", _SIGNATURES)


class _Operands(NamedTuple):
    """The kernels' operands: per-layer a_l [G, 4H], U_l [H, 4H] and W_l
    [H, 4H] (l >= 1) as tuples, the rest as in the C entries."""
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


def _args(ops: _Operands):
    """Check the kernels' operands (float32, one CUDA device, the shapes
    of the kernels, 1 <= L <= 8) and return them contiguous and 16-byte
    aligned as the C entries take them, the layer table a ctypes array of
    3 * 8 pointers, with (G, N, F, H, L, max_velocity) and the tensors to
    keep alive for the call."""
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
    ready = {}
    for name, t, shape in expect:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
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
    return pointers, (G, N, F, H, L, mv), (ready, table)


def _run(entry: str, ops: _Operands, hard: bool, extra=(),
         lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    # `keep` holds the tensors and the table the pointers point into.
    pointers, dims, keep = _args(ops)
    G, N = dims[:2]
    dev = ops.feats.device
    out = torch.empty((G, N, 3), dtype=torch.float32, device=dev)
    fn = getattr(_library() if lib is None else lib, entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*pointers, out.data_ptr(), *dims[:5], int(hard), dims[5],
                *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return out


def _launch(ops: _Operands, hard: bool,
            prof: Optional[torch.Tensor] = None,
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """One launch of the cluster kernel on the current stream, with the
    plan of `notegen_plan` (which must be a cluster's); every tensor
    float32 on one CUDA device.  `prof`, an int64 [14] on the card or
    None: block 0's clock cycles summed over the pitches, [0] the h0 U0
    product, [1] the wait for the draw with z0 and the cells, [2] the h0
    exchange and the first barrier, [3] the products and cells of the
    layers l >= 1, [4] their h exchanges and barriers, [5] the heads and
    the draw (a head warp, beside [0]-[1]); [6] the prologue, [7] the
    whole launch; [8]-[11] C, Gc, clusters and N; [12] the prologue up to
    the acc_F chunks, [13] the chunks.  `lib`: another build of
    csrc/notegen.cu bound with _SIGNATURES (tools/notegen_depth_probe.py),
    else the wrapper's own.  Returns the [G, N, 3] output."""
    G, N, F = ops.feats.shape
    plan = notegen_plan(G, len(ops.u), F, ops.u[0].shape[0], N)
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


def active_clusters(G: int, L: int, F: int, H: int, N: int) -> int:
    """How many clusters of `notegen_plan(G, L, F, H, N)` the current card
    holds at once (cudaOccupancyMaxActiveClusters); the plan must be a
    cluster's."""
    active = ctypes.c_int(0)
    rc = _library().notegen_active_clusters(G, L, N, F, H,
                                            ctypes.addressof(active))
    if rc != 0:
        raise RuntimeError(f"notegen_active_clusters failed: CUDA error "
                           f"{rc}")
    return active.value


def _kernel_operands(feats, uniforms, temperature, layers, note_dense,
                     volume_dense, style_emb, velocity_grid) -> _Operands:
    w0f, w0c, a = fold_style(layers, style_emb, feats.shape[-1])
    return _Operands(feats, uniforms, temperature, w0f, w0c, tuple(a),
                     tuple(l.lstm.recurrent for l in layers),
                     tuple(l.lstm.kernel for l in layers[1:]),
                     note_dense.kernel, note_dense.bias, volume_dense.kernel,
                     volume_dense.bias, velocity_grid)


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
                ) -> torch.Tensor:
    """Sample one generation timestep's N pitches.

    feats: [G, N, time_units] time-axis features; uniforms: [G, N, 2]
    pre-drawn (play, replay) uniforms; temperature: [G]; layers: the L
    note-axis layers (each a `style_proj` Dense and an `lstm` with
    kernel/recurrent/bias); note_dense/volume_dense: the heads; style_emb:
    [G, style_units]; velocity_grid: the float32 k/max_velocity table to
    snap volumes onto, or None.  Returns sampled (play, replay, volume)
    [G, N, 3], float32.  On a CUDA tensor: one launch of the kernel that
    `notegen_plan` names (widths that fit no plan, a failed build or a
    refused launch raise).
    """
    check_recurrent_activation(recurrent_activation)
    if _device(feats) == "cpu":
        return note_sample_reference(feats, uniforms, temperature, layers,
                                     note_dense, volume_dense, style_emb,
                                     recurrent_activation, velocity_grid)
    ops = _kernel_operands(feats, uniforms, temperature, layers, note_dense,
                           volume_dense, style_emb, velocity_grid)
    G, N, F = feats.shape
    plan = notegen_plan(G, len(layers), F, ops.u[0].shape[0], N)
    hard = recurrent_activation == "hard_sigmoid"
    if plan.kernel == "cluster":
        out = _launch(ops, hard)
    else:
        out = _launch_streamed(ops, hard)
        note_sample.streamed_launches += 1
    note_sample.launches += 1
    return out


note_sample.launches = 0
note_sample.streamed_launches = 0


@torch.no_grad()
def note_sample_streamed(feats: torch.Tensor, uniforms: torch.Tensor,
                         temperature: torch.Tensor, layers: Sequence,
                         note_dense, volume_dense, style_emb: torch.Tensor,
                         recurrent_activation: str = "sigmoid",
                         velocity_grid: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """`note_sample` through the streamed kernel whatever the plan, for
    comparison; `note_sample_streamed.launches` counts its launches."""
    check_recurrent_activation(recurrent_activation)
    if _device(feats) == "cpu":
        return note_sample_reference(feats, uniforms, temperature, layers,
                                     note_dense, volume_dense, style_emb,
                                     recurrent_activation, velocity_grid)
    out = _launch_streamed(
        _kernel_operands(feats, uniforms, temperature, layers, note_dense,
                         volume_dense, style_emb, velocity_grid),
        recurrent_activation == "hard_sigmoid")
    note_sample_streamed.launches += 1
    return out


note_sample_streamed.launches = 0
