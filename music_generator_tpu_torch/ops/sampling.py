"""Sampling primitives of the generation loop (ref: generate.py:47-58,
81-91)."""

from __future__ import annotations

import torch


def apply_temperature(prob: torch.Tensor,
                      temperature: torch.Tensor) -> torch.Tensor:
    """Re-temper a sigmoid probability: clip to [1e-7, 1-1e-7],
    inverse-sigmoid, DIVIDE by T, re-sigmoid (ref: generate.py:81-91).
    The division form, not a multiply by 1/T: that rounds twice and moves
    draws whenever T != 1 (adaptive temperature bumps T on default runs)."""
    p = torch.clamp(prob, 1e-7, 1 - 1e-7)
    x = -torch.log(1.0 / p - 1.0)
    return torch.sigmoid(x / temperature)
