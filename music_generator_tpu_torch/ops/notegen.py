"""The generation pitch loop: one launch of the CUDA kernel `csrc/notegen.cu`
per timestep, beside its plain PyTorch version.

`note_sample` has the signature of the JAX package's
`ops/pallas_notegen.py::pallas_note_sample`: it samples all N pitches of
one generation timestep for G streams.  For each pitch n: two note-axis
LSTM cells, the sigmoid play/replay and linear volume heads, the
division-form temperature, the `u <= p` Bernoulli draws, replay * play and
clip(volume) * play, optionally snapped onto the k/max_velocity velocity
grid (`gen_volume_quantize`).  The chosen note n feeds pitch n + 1.

Like the Pallas wrapper it splits W0 into its feature rows W0f [F, 4H] and
chosen rows W0c [3, 4H], and folds the per-timestep style terms into
a0 = tanh(s Ws0 + bs0) W0 + b0 and a1 = tanh(s Ws1 + bs1) W1 + b1.

On a CUDA tensor `note_sample` launches the cluster kernel (or raises):
the weights that carry from pitch to pitch resident in a thread-block
cluster, feat W0f for every pitch computed up front in the same launch,
with the plan of `notegen_plan`.  On a CPU tensor it runs
`note_sample_reference`, the plain loop equal to the JAX
`Sampler._note_scan` scan branch; `note_sample_staged` is the cluster
kernel's association of the same math in plain PyTorch.
`note_sample_streamed` launches the streamed kernel (one block per stream,
the weights read from L2 at every pitch), kept only to hold the cluster
kernel to bit for bit and to time it against.  `note_sample.launches`,
`note_sample_streamed.launches` and `note_sample_reference.calls` count
each path, so a run can show which it took.
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
                          temperature: torch.Tensor, l0, l1, note_dense,
                          volume_dense, style_emb: torch.Tensor,
                          recurrent_activation: str = "sigmoid",
                          velocity_grid: Optional[torch.Tensor] = None,
                          ) -> torch.Tensor:
    """The plain PyTorch pitch loop (the JAX `Sampler._note_scan` scan
    branch): feats [G, N, F], uniforms [G, N, 2], temperature [G] ->
    sampled (play, replay, volume) [G, N, 3], float32."""
    note_sample_reference.calls += 1
    G, N, _ = feats.shape
    layers = (l0, l1)
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
                   temperature: torch.Tensor, l0, l1, note_dense,
                   volume_dense, style_emb: torch.Tensor,
                   recurrent_activation: str = "sigmoid") -> torch.Tensor:
    """The tempered (play, replay) probabilities [G, N, 2] along a given
    sampled trajectory `notes` [G, N, 3] (teacher-forced: pitch n sees the
    given note n-1).  A draw whose uniform lies within a few ULPs of its
    probability may fall either way between two float32 implementations;
    `draws_agree` uses these to tell such knife edges from real faults."""
    G, N, _ = feats.shape
    layers = (l0, l1)
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


def fold_style(l0, l1, style_emb: torch.Tensor, feature_width: int):
    """The per-timestep constants of the kernel: W0 split into (W0f, W0c)
    and a0 = tanh(s Ws0 + bs0) W0 + b0, a1 = tanh(s Ws1 + bs1) W1 + b1."""
    w0 = l0.lstm.kernel
    w0f, w0c = w0[:feature_width], w0[feature_width:]
    s0 = torch.tanh(_linear(l0.style_proj, style_emb))
    a0 = s0 @ w0 + l0.lstm.bias
    s1 = torch.tanh(_linear(l1.style_proj, style_emb))
    a1 = s1 @ l1.lstm.kernel + l1.lstm.bias
    return w0f, w0c, a0, a1


class NotegenPlan(NamedTuple):
    """How the cluster kernel covers G streams: clusters of C blocks, each
    serving Gc streams, and each block's dynamic shared memory in bytes."""
    C: int
    Gc: int
    clusters: int
    smem: int


SMEM_MAX = 232448     # the H100's opt-in shared memory of one block
GC_MAX = 8            # streams one cluster serves, at most
PB = 16               # pitches of one staged chunk of x in the prologue
THREADS_MAX = 384     # threads of one block, at most


def _smem_bytes(C: int, Gc: int, N: int, F: int, H: int) -> int:
    """One block's shared memory: max(3H, F) weight rows of its 4H/C
    columns, W0c's columns, the heads' weights, acc_F for every pitch,
    h0 and h1 (two buffers each) with z and h1 U1, or in the prologue two
    staged chunks of x in their place, and the chosen notes and head
    outputs;
    the streams padded to a multiple of 4
    (csrc/notegen.cu::ng_smem_bytes)."""
    cols, gp = 4 * (H // C), (Gc + 3) // 4 * 4
    return 4 * (max(3 * H, F) * cols + 3 * cols + 3 * H + N * gp * cols
                + max(4 * H * gp + 2 * gp * cols, 2 * PB * F) + 8 * gp)


def _threads(C: int, Gc: int, H: int) -> int:
    """Work warps (a cell thread per unit and stream), warps for h1 U1 (a
    product thread per two gate columns and four streams), and three head
    warps."""
    p0 = (H // C) * ((Gc + 3) // 4 * 4)
    return 32 * (-(-p0 // 32) + -(-(p0 // 2) // 32) + 3)


@functools.lru_cache(maxsize=None)
def notegen_plan(G: int, F: int, H: int, N: int) -> NotegenPlan:
    """The cluster kernel's plan for G streams at widths (F, H, N), the
    same arithmetic as csrc/notegen.cu::ng_plan (the launch refuses any
    other).  C is the first of 8, 4, 16 that divides H and fits one
    stream; Gc the most streams that fit (at most 8 and G), spread evenly
    over the ceil(G / Gc) clusters, so a cluster serves every stream it
    can and G <= 64 needs at most 8 clusters.  Raises ValueError for
    widths that fit no plan."""
    if min(G, N, F, H) <= 0 or F % 4:
        raise ValueError(f"notegen_plan: no plan for G={G}, F={F}, H={H}, "
                         f"N={N} (positive widths, F a multiple of 4)")
    for C in (8, 4, 16):
        if H % C:
            continue
        fit = [gc for gc in range(1, min(GC_MAX, G) + 1)
               if _smem_bytes(C, gc, N, F, H) <= SMEM_MAX
               and _threads(C, gc, H) <= THREADS_MAX]
        if not fit:
            continue
        clusters = -(-G // fit[-1])
        gc = -(-G // clusters)
        return NotegenPlan(C, gc, clusters, _smem_bytes(C, gc, N, F, H))
    raise ValueError(f"notegen_plan: F={F}, H={H}, N={N} fit no cluster of "
                     f"8, 4 or 16 blocks in {SMEM_MAX} bytes of shared "
                     f"memory a block")


@torch.no_grad()
def note_sample_staged(feats: torch.Tensor, uniforms: torch.Tensor,
                       temperature: torch.Tensor, l0, l1, note_dense,
                       volume_dense, style_emb: torch.Tensor,
                       recurrent_activation: str = "sigmoid",
                       velocity_grid: Optional[torch.Tensor] = None,
                       ) -> torch.Tensor:
    """The cluster kernel's math in plain PyTorch: acc_F = feat W0f for
    every pitch in one product, then the pitch chain carrying only the
    recurrent terms, z0 = ((acc_F + chosen W0c) + a0) + h0 U0 and
    z1 = (h0 W1 + a1) + h1 U1, with the heads and draws from the full h1.
    Same arguments and result as `note_sample_reference`."""
    G, N, F = feats.shape
    w0f, w0c, a0, a1 = fold_style(l0, l1, style_emb, F)
    u0, w1, u1 = l0.lstm.recurrent, l1.lstm.kernel, l1.lstm.recurrent
    H = u0.shape[0]
    acc_f = feats @ w0f                                 # [G, N, 4H]
    h0, c0, h1, c1 = (feats.new_zeros(G, H) for _ in range(4))
    chosen = feats.new_zeros(G, 3)
    out = []
    for n in range(N):
        z0 = ((acc_f[:, n] + chosen @ w0c) + a0) + h0 @ u0
        h0, c0 = gates(z0, c0, H, recurrent_activation)
        z1 = (h0 @ w1 + a1) + h1 @ u1
        h1, c1 = gates(z1, c1, H, recurrent_activation)
        chosen = _draw(heads(h1, note_dense, volume_dense), temperature,
                       uniforms[:, n], velocity_grid)
        out.append(chosen)
    return torch.stack(out, dim=1)


_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
_SIGNATURES = {
    "notegen_launch": _ARGTYPES + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    "notegen_streamed_launch": _ARGTYPES + [ctypes.c_void_p],
    "notegen_active_clusters": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _library() -> ctypes.CDLL:
    return _build.bind("notegen", _SIGNATURES)


def _args(feats, uniforms, temperature, w0f, w0c, a0, u0, w1, a1, u1, wnd,
          bnd, wvd, bvd, velocity_grid):
    """Check the kernels' operands (float32, one CUDA device, the shapes
    of the kernel) and return them contiguous, in the C entries' order,
    with (G, N, F, H, max_velocity)."""
    G, N, F = feats.shape
    H = u0.shape[0]
    dev = feats.device
    expect = {
        "feats": (feats, (G, N, F)), "uniforms": (uniforms, (G, N, 2)),
        "temperature": (temperature, (G,)), "w0f": (w0f, (F, 4 * H)),
        "w0c": (w0c, (3, 4 * H)), "a0": (a0, (G, 4 * H)),
        "u0": (u0, (H, 4 * H)), "w1": (w1, (H, 4 * H)),
        "a1": (a1, (G, 4 * H)), "u1": (u1, (H, 4 * H)),
        "wnd": (wnd, (H, 2)), "bnd": (bnd, (2,)), "wvd": (wvd, (H, 1)),
        "bvd": (bvd, (1,)),
    }
    if velocity_grid is not None:
        expect["velocity_grid"] = (velocity_grid, (velocity_grid.shape[0],))
    args = []
    for name, (t, shape) in expect.items():
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        t = t.contiguous()
        # The cluster kernel copies feats and the weights 16 bytes at a time.
        args.append(t if t.data_ptr() % 16 == 0 else t.clone())
    if velocity_grid is None:
        args.append(None)
    mv = 0 if velocity_grid is None else velocity_grid.shape[0] - 1
    return args, (G, N, F, H, mv)


def _run(entry: str, args, dims, hard: bool, extra) -> torch.Tensor:
    G, N = dims[:2]
    dev = args[0].device
    out = torch.empty((G, N, 3), dtype=torch.float32, device=dev)
    fn = getattr(_library(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in args),
                out.data_ptr(), *dims[:4], int(hard), dims[4], *extra,
                stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return out


def _launch(feats, uniforms, temperature, w0f, w0c, a0, u0, w1, a1, u1,
            wnd, bnd, wvd, bvd, velocity_grid, hard: bool,
            prof: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the cluster kernel on the current stream, with the
    plan of `notegen_plan`; every tensor float32 on one CUDA device.
    `prof`, an int64 [14] on the card or None: block 0's clock cycles
    summed over the pitches, [0] the h0 U0 product, [1] the wait for the
    draw with z0 and the cells, [2] the h0 exchange and barrier 1, [3]
    layer 1's product and cells, [4] the h1 exchange and barrier 2, [5]
    the heads and the draw (a head warp, beside [0]-[1]); [6] the
    prologue, [7] the whole launch; [8]-[11] C, Gc, clusters and N; [12]
    the prologue up to the acc_F chunks, [13] the chunks.  Returns the
    [G, N, 3] output."""
    args, dims = _args(feats, uniforms, temperature, w0f, w0c, a0, u0, w1,
                       a1, u1, wnd, bnd, wvd, bvd, velocity_grid)
    G, N, F, H, _ = dims
    plan = notegen_plan(G, F, H, N)
    if prof is not None and (prof.dtype != torch.int64
                             or prof.device != feats.device
                             or prof.numel() < 14):
        raise ValueError("prof: expected int64 [14] on the kernel's device")
    out = _run("notegen_launch", args, dims, hard,
               (*plan, None if prof is None else prof.data_ptr()))
    note_sample.launches += 1
    return out


def _launch_streamed(feats, uniforms, temperature, w0f, w0c, a0, u0, w1,
                     a1, u1, wnd, bnd, wvd, bvd, velocity_grid,
                     hard: bool) -> torch.Tensor:
    """One launch of the streamed kernel (one block per stream, the
    weights read from L2 at every pitch), kept to hold the cluster kernel
    to bit for bit and to time it against; the main path never takes it."""
    args, dims = _args(feats, uniforms, temperature, w0f, w0c, a0, u0, w1,
                       a1, u1, wnd, bnd, wvd, bvd, velocity_grid)
    out = _run("notegen_streamed_launch", args, dims, hard, ())
    note_sample_streamed.launches += 1
    return out


def active_clusters(G: int, F: int, H: int, N: int) -> int:
    """How many clusters of `notegen_plan(G, F, H, N)` the current card
    holds at once (cudaOccupancyMaxActiveClusters)."""
    active = ctypes.c_int(0)
    rc = _library().notegen_active_clusters(G, N, F, H,
                                            ctypes.addressof(active))
    if rc != 0:
        raise RuntimeError(f"notegen_active_clusters failed: CUDA error "
                           f"{rc}")
    return active.value


def _kernel_operands(feats, uniforms, temperature, l0, l1, note_dense,
                     volume_dense, style_emb, velocity_grid):
    w0f, w0c, a0, a1 = fold_style(l0, l1, style_emb, feats.shape[-1])
    return (feats, uniforms, temperature, w0f, w0c, a0, l0.lstm.recurrent,
            l1.lstm.kernel, a1, l1.lstm.recurrent, note_dense.kernel,
            note_dense.bias, volume_dense.kernel, volume_dense.bias,
            velocity_grid)


def _device(feats: torch.Tensor) -> str:
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"note_sample runs on CPU or CUDA tensors, got "
                         f"{feats.device}")
    return feats.device.type


@torch.no_grad()
def note_sample(feats: torch.Tensor, uniforms: torch.Tensor,
                temperature: torch.Tensor, l0, l1, note_dense, volume_dense,
                style_emb: torch.Tensor,
                recurrent_activation: str = "sigmoid",
                velocity_grid: Optional[torch.Tensor] = None,
                ) -> torch.Tensor:
    """Sample one generation timestep's N pitches.

    feats: [G, N, time_units] time-axis features; uniforms: [G, N, 2]
    pre-drawn (play, replay) uniforms; temperature: [G]; l0/l1: the two
    note-axis layers (`style_proj` Dense + `lstm` kernel/recurrent/bias);
    note_dense/volume_dense: the heads; style_emb: [G, style_units];
    velocity_grid: the float32 k/max_velocity table to snap volumes onto,
    or None.  Returns sampled (play, replay, volume) [G, N, 3], float32.
    On a CUDA tensor: one launch of the cluster kernel (a plan that does
    not fit, a failed build or a refused launch raises).
    """
    check_recurrent_activation(recurrent_activation)
    if _device(feats) == "cpu":
        return note_sample_reference(feats, uniforms, temperature, l0, l1,
                                     note_dense, volume_dense, style_emb,
                                     recurrent_activation, velocity_grid)
    return _launch(*_kernel_operands(feats, uniforms, temperature, l0, l1,
                                     note_dense, volume_dense, style_emb,
                                     velocity_grid),
                   recurrent_activation == "hard_sigmoid")


note_sample.launches = 0


@torch.no_grad()
def note_sample_streamed(feats: torch.Tensor, uniforms: torch.Tensor,
                         temperature: torch.Tensor, l0, l1, note_dense,
                         volume_dense, style_emb: torch.Tensor,
                         recurrent_activation: str = "sigmoid",
                         velocity_grid: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """`note_sample` through the streamed kernel, for comparison only;
    `note_sample_streamed.launches` counts its launches."""
    check_recurrent_activation(recurrent_activation)
    if _device(feats) == "cpu":
        return note_sample_reference(feats, uniforms, temperature, l0, l1,
                                     note_dense, volume_dense, style_emb,
                                     recurrent_activation, velocity_grid)
    return _launch_streamed(
        *_kernel_operands(feats, uniforms, temperature, l0, l1, note_dense,
                          volume_dense, style_emb, velocity_grid),
        recurrent_activation == "hard_sigmoid")


note_sample_streamed.launches = 0
