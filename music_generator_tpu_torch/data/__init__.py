from music_generator_tpu_torch.data.dataset import (
    clamp_midi,
    compute_genre,
    unclamp_midi,
)

__all__ = ["clamp_midi", "compute_genre", "unclamp_midi"]
