"""What the verification tools share with chip_smoke.py: the float32 bars a
kernel is held to against its plain version, worst-leaf statistics, the
card's name and power limit, and CUDA-event timing."""

from __future__ import annotations

import subprocess

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


class CheckFailed(AssertionError):
    """A tool's check missed its stated bar."""


def require(ok: bool, msg: str) -> None:
    """Raise CheckFailed(msg) unless `ok` (unlike `assert`, kept under
    python -O)."""
    if not ok:
        raise CheckFailed(msg)
