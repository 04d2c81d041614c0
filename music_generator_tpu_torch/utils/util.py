"""Shared helpers (ref: util.py) — the port's own copy."""

from __future__ import annotations

import numpy as np


def one_hot(i: int, nb_classes: int) -> np.ndarray:
    """One-hot float vector (ref: util.py:8-11)."""
    arr = np.zeros((nb_classes,))
    arr[i] = 1
    return arr
