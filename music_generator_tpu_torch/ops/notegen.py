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

On a CUDA tensor `note_sample` launches the kernel (or raises); on a CPU
tensor it runs `note_sample_reference`, the plain loop equal to the JAX
`Sampler._note_scan` scan branch.  `note_sample.launches` counts kernel
launches and `note_sample_reference.calls` counts plain-version runs, so a
run can show which path it took.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from music_generator_tpu_torch.ops import _build
from music_generator_tpu_torch.ops.lstm import (check_recurrent_activation,
                                                lstm_step)
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
        p = apply_temperature(pred[:, :2], temperature[:, None])
        u = uniforms[:, n]
        play = (u[:, 0] <= p[:, 0]).float()
        replay = (u[:, 1] <= p[:, 1]).float() * play
        # Clipped before the copy-through (the JAX package's deliberate
        # deviation from the reference's unclipped volume).
        volume = torch.clamp(pred[:, 2], 0.0, 1.0)
        if velocity_grid is not None:
            mv = velocity_grid.shape[0] - 1
            volume = velocity_grid[torch.round(volume * float(mv)).long()]
        chosen = torch.stack([play, replay, volume * play], dim=-1)
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


_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = _build.load("notegen")
    fn = lib.notegen_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch(feats, uniforms, temperature, w0f, w0c, a0, u0, w1, a1, u1,
            wnd, bnd, wvd, bvd, velocity_grid, hard: bool) -> torch.Tensor:
    """One kernel launch (one block per stream) on the current stream;
    every tensor float32 on one CUDA device.  Returns the [G, N, 3]
    output."""
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
    args = {}
    for name, (t, shape) in expect.items():
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        args[name] = t.contiguous()
    out = torch.empty((G, N, 3), dtype=torch.float32, device=dev)
    lib = _library()
    vg = args.get("velocity_grid")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.notegen_launch(
            *(args[k].data_ptr() for k in (
                "feats", "uniforms", "temperature", "w0f", "w0c", "a0", "u0",
                "w1", "a1", "u1", "wnd", "bnd", "wvd", "bvd")),
            None if vg is None else vg.data_ptr(), out.data_ptr(),
            G, N, F, H, int(hard), 0 if vg is None else vg.shape[0] - 1,
            stream)
    if rc != 0:
        raise RuntimeError(f"notegen kernel launch failed: CUDA error {rc}")
    note_sample.launches += 1
    return out


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
    """
    check_recurrent_activation(recurrent_activation)
    if feats.device.type == "cpu":
        return note_sample_reference(feats, uniforms, temperature, l0, l1,
                                     note_dense, volume_dense, style_emb,
                                     recurrent_activation, velocity_grid)
    if feats.device.type != "cuda":
        raise ValueError(f"note_sample runs on CPU or CUDA tensors, got "
                         f"{feats.device}")
    w0f, w0c, a0, a1 = fold_style(l0, l1, style_emb, feats.shape[-1])
    return _launch(feats, uniforms, temperature, w0f, w0c, a0,
                   l0.lstm.recurrent, l1.lstm.kernel, a1, l1.lstm.recurrent,
                   note_dense.kernel, note_dense.bias, volume_dense.kernel,
                   volume_dense.bias, velocity_grid,
                   recurrent_activation == "hard_sigmoid")


note_sample.launches = 0
