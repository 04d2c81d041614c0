"""What the drivers share: seeds drawn from the run's seed, the program's
`Config` built from a configuration file, weights from a committed
checkpoint, and the comparison of norms leaf by leaf."""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def sub_seed(seed: int, *tags: int, bits: int = 63) -> int:
    """A seed for one use, a function of the run's seed and `tags`:
    `bits` bits of numpy's SeedSequence([seed, *tags])."""
    word = int(np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, np.uint64)[0])
    return word & ((1 << bits) - 1)


def program_config(run):
    """The program's Config of the run's configuration file: its `config`
    values, with every `derived` value checked against the Config's."""
    from music_generator_tpu_torch.config import Config
    cfg = Config(**run.config["config"])
    for k, v in run.config["derived"].items():
        if getattr(cfg, k) != v:
            raise ValueError(f"configuration {run.cell['config']}: {k} is "
                             f"{getattr(cfg, k)} in the program, {v} in "
                             f"the file")
    return cfg


def load_checkpoint(root: Path, spec: Mapping) -> Dict[str, torch.Tensor]:
    """A committed keystr-layout .npz (`.time_axis[0].lstm.kernel`) as
    float32 tensors under dotted names; its sha256 must be the one the
    file of the cell names, so that a changed checkpoint cannot move the
    cell unseen."""
    path = root / spec["path"]
    data = path.read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"{spec['path']}: sha256 {digest}, the cell "
                         f"expects {spec['sha256']}")
    out = {}
    with np.load(path) as z:
        for k in z.files:
            name = k.lstrip(".").replace("[", ".").replace("]", "")
            out[name] = torch.from_numpy(np.asarray(z[k], np.float32))
    return out


def worst_leaf_gap(got: Mapping[str, float], want: Mapping[str, float],
                   names: Sequence[str]) -> tuple:
    """The largest |got - want| over the leaves `names`, each measured
    against the larger of want's norm of that leaf and the median of
    want's norms over `names`: (gap, leaf)."""
    floor = float(np.median([want[k] for k in names]))
    worst, leaf = 0.0, ""
    for k in names:
        gap = abs(got[k] - want[k]) / max(want[k], floor)
        if not gap <= worst:      # NaN wins
            worst, leaf = gap, k
    return worst, leaf


def median_leaf_gap(got: Mapping[str, float], want: Mapping[str, float],
                    names: Sequence[str]) -> float:
    """The median over the leaves `names` of |got - want| / want."""
    return float(np.median([abs(got[k] - want[k]) / want[k]
                            for k in names]))
