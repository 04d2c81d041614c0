"""Shared helpers (ref: util.py) — the port's own copy."""

from __future__ import annotations

import os
from typing import List, Mapping, Sequence

import numpy as np


def one_hot(i: int, nb_classes: int) -> np.ndarray:
    """One-hot float vector (ref: util.py:8-11)."""
    arr = np.zeros((nb_classes,))
    arr[i] = 1
    return arr


def param_summary(state: Mapping) -> str:
    """Parameter-count table per top-level module plus the total — the
    rebuild of the reference's `model.summary()` printout on every build
    (ref: util.py:16).  `state` is a state dict (name -> tensor)."""
    groups: dict = {}
    for name, leaf in state.items():
        head = name.split(".", 1)[0]
        groups[head] = groups.get(head, 0) + int(np.prod(tuple(leaf.shape)))
    width = max(len(k) for k in list(groups) + ["total"])
    lines = [f"{k:<{width}}  {v:>12,}" for k, v in groups.items()]
    lines.append(f"{'total':<{width}}  {sum(groups.values()):>12,}")
    return "\n".join(lines)


def get_all_files(paths: Sequence[str]) -> List[str]:
    """Recursively collect .mid files under each path, in deterministic
    (sorted) order — the reference's os.walk order is filesystem-dependent
    (ref: util.py:25-33, and the ordering TODO at dataset.py:50)."""
    potential_files = []
    for path in paths:
        for root, _dirs, files in sorted(os.walk(path)):
            for f in sorted(files):
                fname = os.path.join(root, f)
                if os.path.isfile(fname) and fname.endswith(".mid"):
                    potential_files.append(fname)
    return potential_files
