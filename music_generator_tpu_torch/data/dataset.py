"""The dataset helpers generation needs (ref: dataset.py:20-26, 78-88):
own copies of the JAX package's `compute_genre`, `clamp_midi` and
`unclamp_midi`.  The training pipeline is a later slice."""

from __future__ import annotations

from typing import Optional

import numpy as np

from music_generator_tpu_torch.config import Config, default_config


def compute_genre(genre_id: int, config: Optional[Config] = None) -> np.ndarray:
    """Uniform style mass over one genre's composers (ref: dataset.py:20-26)."""
    cfg = config or default_config()
    genre_hot = np.zeros((cfg.num_styles,))
    start_index = sum(len(s) for i, s in enumerate(cfg.styles) if i < genre_id)
    styles_in_genre = len(cfg.styles[genre_id])
    genre_hot[start_index:start_index + styles_in_genre] = 1 / styles_in_genre
    return genre_hot


def clamp_midi(sequence: np.ndarray, config: Optional[Config] = None) -> np.ndarray:
    """Clamp a [T, 128, 3] roll to the modeled note range
    (ref: dataset.py:78-82)."""
    cfg = config or default_config()
    return sequence[:, cfg.min_note:cfg.max_note, :]


def unclamp_midi(sequence: np.ndarray, config: Optional[Config] = None) -> np.ndarray:
    """Left-pad the clamped pitch axis back to MIDI note numbers
    (ref: dataset.py:84-88)."""
    cfg = config or default_config()
    return np.pad(sequence, ((0, 0), (cfg.min_note, 0), (0, 0)), "constant")
