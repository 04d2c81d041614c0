"""On-card validation of the fused two-layer LSTM stack (`ops/lstm2.py`,
kernels of csrc/lstm2.cu), after the JAX package's
tools/tpu_validate_lstm2.py.

    python -m music_generator_tpu_torch.tools.validate_lstm2 [--device cpu]

Checks, at the JAX tool's sizes (T = 32, B = 512, D = 94, H = 256,
float32, weights from a seeded torch.Generator):
  1. dropout 0: the stack against two layers of the plain recurrence
     (`lstm_recurrence_reference` after the input projection, as
     ops/lstm.py's `lstm_scan`): the forward, and dW0, dU0, dW1, dU1 of a
     small-slice loss.
  2. dropout 0.5: the stack's own masks written out by `dump_masks` (the
     kernel of csrc/lstm2_masks.cu, the counterpart of the JAX tool's
     `extract_masks`); their keep fraction within 4 sigma of 0.5; the plain
     rebuild `hs0 * masks + s1m` against the stack, forward and the same
     four gradients.
  3. Timing on the card (T = 128, B = 768, bfloat16, CUDA events): the
     unfused pair (two `lstm_scan`, the recurrence kernels) against the
     fused stack, forward and forward plus backward.
Checks 1-2 are held to F32_ATOL (forward) and F32_GRAD_REL (worst
gradient, ||a - b|| / ||b||) of tools/common.py; a miss raises CheckFailed.
With --device cpu every wrapper runs its plain version and the timing is
skipped.
"""

from __future__ import annotations

import argparse
import math
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from music_generator_tpu_torch.cli import _device_flag
from music_generator_tpu_torch.device import full_f32, resolve_device
from music_generator_tpu_torch.ops.lstm import lstm_scan
from music_generator_tpu_torch.ops.lstm2 import dump_masks, lstm2_stack
from music_generator_tpu_torch.ops.recurrence import lstm_recurrence_reference
from music_generator_tpu_torch.tools.common import (F32_ATOL, F32_GRAD_REL,
                                                    card_line, cuda_ms,
                                                    require, synchronize)

SEED = 7                           # the stack's mask seed
GRADS = ("dW0", "dU0", "dW1", "dU1")
_GRAD_INDEX = (0, 1, 3, 4)         # their weights in (W0, U0, b0, W1, U1, b1)


def _layer(D: int, H: int, gen: torch.Generator) -> List[torch.Tensor]:
    """Keras-default LSTM weights [kernel [D, 4H], recurrent [H, 4H], bias
    [4H]]: glorot-uniform kernel, orthogonal recurrent matrix, zero bias
    with a unit forget gate."""
    lim = math.sqrt(6.0 / (D + 4 * H))
    kernel = (torch.rand(D, 4 * H, generator=gen) * 2 - 1) * lim
    recurrent = torch.empty(H, 4 * H)
    torch.nn.init.orthogonal_(recurrent, generator=gen)
    bias = torch.zeros(4 * H)
    bias[H:2 * H] = 1.0
    return [kernel, recurrent, bias]


def inputs(T: int, B: int, D: int, H: int, device, seed: int = 0):
    """(weights [W0, U0, b0, W1, U1, b1], xs [T, B, D], s1m [T, B, H]) in
    float32 on `device`, from torch.Generator(seed)."""
    gen = torch.Generator().manual_seed(seed)
    ws = _layer(D, H, gen) + _layer(H, H, gen)
    xs = torch.randn(T, B, D, generator=gen)
    s1m = 0.1 * torch.randn(T, B, H, generator=gen)
    return [w.to(device) for w in ws], xs.to(device), s1m.to(device)


def plain_stack(ws, xs, s1m, masks: Optional[torch.Tensor] = None):
    """Two layers of the plain recurrence, float32: layer 1 reads
    hs0 + s1m, or hs0 * masks + s1m with the stack's masks."""
    W0, U0, b0, W1, U1, b1 = ws
    S, R, D = xs.shape
    H = U0.shape[0]
    z = torch.zeros(R, H, device=xs.device)
    xw0 = (xs.reshape(S * R, D) @ W0 + b0).reshape(S, R, 4 * H)
    hs0, _ = lstm_recurrence_reference(xw0, U0, z, z)
    x1 = hs0 + s1m if masks is None else hs0 * masks + s1m
    xw1 = (x1.reshape(S * R, H) @ W1 + b1).reshape(S, R, 4 * H)
    hs1, _ = lstm_recurrence_reference(xw1, U1, z, z)
    return hs1


def fused_stack(ws, xs, s1m, dropout_p: float = 0.0,
                compute_dtype=torch.float32):
    """The fused stack (kernels 6-7 on the card) from zero states."""
    W0, U0, b0, W1, U1, b1 = ws
    return lstm2_stack(xs, s1m, W0, b0, b1, U0, W1, U1, dropout_p=dropout_p,
                       seed=SEED, compute_dtype=compute_dtype)[0]


def small_loss(hs1: torch.Tensor) -> torch.Tensor:
    """The JAX tool's small-magnitude loss slice."""
    return (hs1[:2, :4, :16].float() ** 2).sum()


def forward_and_grads(fn: Callable, ws):
    """fn(weights) and the gradients of small_loss(fn) in W0, U0, W1, U1."""
    ts = [w.clone().requires_grad_(True) for w in ws]
    out = fn(ts)
    grads = torch.autograd.grad(small_loss(out), [ts[i] for i in _GRAD_INDEX])
    synchronize(out.device)
    return out.detach().float(), [g.float() for g in grads]


def _compare(tag: str, want, got, log) -> Dict[str, float]:
    """Print the JAX tool's lines (forward max diff; per gradient the max
    abs diff and the reference's max) with each gradient's relative error,
    and hold them to the bars."""
    (a, ga), (b, gb) = want, got
    fwd = float((a - b).abs().max())
    log(f"{tag} fwd max diff: {fwd:.3e}")
    worst = 0.0
    for name, x, y in zip(GRADS, ga, gb):
        d = float((x - y).abs().max())
        m = float(x.abs().max())
        rel = float((x - y).norm() / x.norm())
        worst = max(worst, rel)
        log(f"{tag} {name}: max abs diff {d:.3e} (ref max {m:.3e}), "
            f"||d||/||ref|| {rel:.3e}")
    require(fwd <= F32_ATOL,
            f"{tag}: forward differs by {fwd:.3e} > {F32_ATOL}")
    require(worst <= F32_GRAD_REL,
            f"{tag}: a gradient differs by {worst:.3e} > {F32_GRAD_REL} "
            f"relative")
    return {"fwd": fwd, "grad_rel": worst}


def check(T: int = 32, B: int = 512, D: int = 94, H: int = 256,
          device="cuda", log=print) -> Dict[str, float]:
    """Checks 1-2 at these sizes; returns their readings."""
    dev = resolve_device(device)
    full_f32()
    ws, xs, s1m = inputs(T, B, D, H, dev)
    out = {}
    # -- 1. dropout 0 -------------------------------------------------------
    want = forward_and_grads(lambda w: plain_stack(w, xs, s1m), ws)
    got = forward_and_grads(lambda w: fused_stack(w, xs, s1m), ws)
    r = _compare("p=0", want, got, log)
    out.update(p0_fwd=r["fwd"], p0_grad_rel=r["grad_rel"])
    # -- 2. dropout 0.5 with the stack's own masks --------------------------
    masks = dump_masks(SEED, T, B, H, 0.5, torch.float32, dev)
    frac = float((masks > 0).float().mean())
    sigma = math.sqrt(0.25 / masks.numel())
    log(f"mask keep fraction: {frac:.5f} (expect 0.5 within 4 sigma = "
        f"{4 * sigma:.5f})")
    require(abs(frac - 0.5) <= 4 * sigma,
            f"keep fraction {frac} is more than 4 sigma from 0.5")
    want = forward_and_grads(lambda w: plain_stack(w, xs, s1m, masks), ws)
    got = forward_and_grads(lambda w: fused_stack(w, xs, s1m, 0.5), ws)
    r = _compare("p=0.5", want, got, log)
    out.update(keep_fraction=frac, p05_fwd=r["fwd"],
               p05_grad_rel=r["grad_rel"])
    return out


def timing(device="cuda", T: int = 128, B: int = 768, D: int = 94,
           H: int = 256, reps: int = 20, log=print) -> Dict[str, float]:
    """Check 3 on the card: ms of the unfused pair and of the fused stack
    in bfloat16, forward and forward plus backward (the gradient of
    sum(hs1^2) in every weight)."""
    dev = resolve_device(device)
    card = card_line()
    bf = torch.bfloat16
    ws, xs, s1m = inputs(T, B, D, H, dev, seed=1)
    xs, s1m = xs.to(bf), s1m.to(bf)

    def unfused(w):
        p0 = SimpleNamespace(kernel=w[0], recurrent=w[1], bias=w[2])
        p1 = SimpleNamespace(kernel=w[3], recurrent=w[4], bias=w[5])
        hs0, _ = lstm_scan(p0, xs, compute_dtype=bf)
        hs1, _ = lstm_scan(p1, hs0 + s1m, compute_dtype=bf)
        return hs1

    def fused(w):
        return fused_stack(w, xs, s1m, 0.0, bf)

    out = {}
    for key, name, fn in (("unfused", "unfused (two lstm_scan, the "
                           "recurrence kernels)", unfused),
                          ("fused", "fused (lstm2_stack)", fused)):
        with torch.no_grad():
            fwd = cuda_ms(lambda: fn(ws), reps)
        wr = [w.clone().requires_grad_(True) for w in ws]

        def step():
            hs1 = fn(wr)
            torch.autograd.grad((hs1.float() ** 2).sum(), wr)

        both = cuda_ms(step, reps)
        log(f"{name} fwd: {fwd:.4f} ms (T={T}, B={B}, {D}->{H}, bfloat16; "
            f"{card})")
        log(f"{name} fwd+bwd: {both:.4f} ms ({card})")
        out[f"{key}_fwd_ms"], out[f"{key}_fwd_bwd_ms"] = fwd, both
    return out


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        description="Validates the fused two-layer LSTM stack against the "
                    "plain recurrence, with its own dropout masks.")
    _device_flag(parser, "validate")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    readings = check(device=dev)
    if dev.type == "cuda":
        readings.update(timing(dev))
    else:
        print("timing: on the card only")
    print("ALL CHECKS PASSED")
    return readings


if __name__ == "__main__":
    main()
