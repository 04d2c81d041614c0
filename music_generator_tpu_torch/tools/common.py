"""What the verification tools share with chip_smoke.py: the float32 bars a
kernel is held to against its plain version, worst-leaf statistics, the
card's name and power limit, CUDA-event timing, and weights at other
note-axis depths, or of the linear time axis, built from a two-layer
checkpoint."""

from __future__ import annotations

import math
import re
import subprocess
from typing import Dict, Mapping

import numpy as np
import torch

# Kernel against plain version in float32: forward within F32_ATOL, every
# gradient within F32_GRAD_REL of the plain one (||a - b|| / ||b||, worst
# leaf).
F32_ATOL, F32_GRAD_REL = 1e-4, 1e-3


def leaf_stats(got, want):
    """(max |a - b|, worst ||a - b|| / ||b||, worst cosine) over leaves."""
    err, rel, cos = 0.0, 0.0, 1.0
    for a, b in zip(got, want):
        a, b = a.double().flatten(), b.double().flatten()
        err = max(err, float((a - b).abs().max()))
        nb, na = float(b.norm()), float(a.norm())
        rel = max(rel, float((a - b).norm()) / nb if nb else
                  (0.0 if na == 0 else float("inf")))
        if na and nb:
            cos = min(cos, float(a @ b) / (na * nb))
        elif na or nb:
            cos = 0.0
    return err, rel, cos


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of `fn` on the card: CUDA events around `reps`
    calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def notegen_inputs(model, G: int, T: float, seed: int):
    """Random pitch-loop inputs at the model's widths, on the card:
    time-axis features in (-1, 1) like an LSTM's h, uniforms in [0, 1),
    temperature T, a style embedding (chip_smoke.py phases 2 and 4,
    tools/notegen_ab.py)."""
    gen = torch.Generator().manual_seed(seed)
    F = model.cfg.time_axis_units
    N = model.cfg.num_notes
    feats = torch.rand(G, N, F, generator=gen) * 2 - 1
    us = torch.rand(G, N, 2, generator=gen)
    emb = torch.randn(G, model.cfg.style_units, generator=gen)
    temp = torch.full((G,), T)
    return [t.cuda() for t in (feats, us, temp, emb)]


def steady_epoch(history: dict, seq_len: int) -> tuple:
    """(seconds, timesteps/s) of a fit's steady epoch: the median epoch of
    `Trainer.fit`'s history without epoch 0, which builds the kernels, at
    the geometry the trainer ran."""
    steady = sorted(history["epoch_seconds"][1:]) or history["epoch_seconds"]
    secs = steady[len(steady) // 2]
    return secs, (history["steps_per_epoch"][0] * history["batch_size"]
                  * seq_len / secs)


class CheckFailed(AssertionError):
    """A tool's check missed its stated bar."""


def require(ok: bool, msg: str) -> None:
    """Raise CheckFailed(msg) unless `ok` (unlike `assert`, kept under
    python -O)."""
    if not ok:
        raise CheckFailed(msg)


_NOTE_LAYER = re.compile(r"^\.note_axis\[(\d+)\]\.")


def depth_params(params: Mapping[str, np.ndarray], L: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """A checkpoint's keystr-keyed leaves (a params.npz, two note-axis
    layers) rebuilt for note-axis depth L (1..8): every leaf outside the
    note axis kept, note layers 0 and 1 kept where L reaches them, and each
    further layer drawn with numpy from `seed` at the JAX package's leaf
    shapes and names: glorot-uniform kernels and recurrent matrix, zero
    biases with a unit forget-gate bias (its `init_params` draws the
    recurrent matrix orthogonal; a QR decomposition would tie the bits to
    the machine's LAPACK, a uniform draw gives the same bits everywhere).
    No trained checkpoint of another depth exists; the same arrays go
    through the JAX package and through params.py."""
    if not 1 <= L <= 8:
        raise ValueError(f"depth_params: L={L} is not in 1..8")
    out = {k: np.asarray(v, np.float32) for k, v in params.items()
           if not (_NOTE_LAYER.match(k)
                   and int(_NOTE_LAYER.match(k).group(1)) >= L)}
    H, S = (params[".note_axis[1].lstm.recurrent"].shape[0],
            params[".note_axis[1].style_proj.kernel"].shape[0])
    rng = np.random.default_rng(seed)

    def glorot(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    for l in range(2, L):
        bias = np.zeros(4 * H, np.float32)
        bias[H:2 * H] = 1.0
        p = f".note_axis[{l}]."
        out[p + "style_proj.kernel"] = glorot((S, H))
        out[p + "style_proj.bias"] = np.zeros(H, np.float32)
        out[p + "lstm.kernel"] = glorot((H, 4 * H))
        out[p + "lstm.recurrent"] = glorot((H, 4 * H))
        out[p + "lstm.bias"] = bias
    return out


_TIME_UNIT = re.compile(r"^\.time_axis\[(\d+)\]\.lstm\.")


def linear_params(params: Mapping[str, np.ndarray],
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """A checkpoint's keystr-keyed leaves (a params.npz of the LSTM time
    axis) rebuilt for `time_axis_kind="linear"`: every leaf outside the
    time axis's LSTMs kept, and each time layer's GLRU drawn with numpy
    from `seed` at the JAX package's leaf shapes and names:
    `.time_axis[l].lstm.kernel` [in, 2H] glorot-uniform (its `glru_init`),
    `.time_axis[l].lstm.bias` [2H] zero.  No trained checkpoint of the
    linear kind exists; the same arrays go through the JAX package and
    through params.py."""
    out = {k: np.asarray(v, np.float32) for k, v in params.items()
           if not _TIME_UNIT.match(k)}
    layers = sorted({int(_TIME_UNIT.match(k).group(1)) for k in params
                     if _TIME_UNIT.match(k)})
    rng = np.random.default_rng(seed)
    for l in layers:
        p = f".time_axis[{l}].lstm."
        d_in, h4 = params[p + "kernel"].shape
        shape = (d_in, h4 // 2)
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[p + "kernel"] = rng.uniform(-lim, lim, shape).astype(np.float32)
        out[p + "bias"] = np.zeros(shape[1], np.float32)
    return out
