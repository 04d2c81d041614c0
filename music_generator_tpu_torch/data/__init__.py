from music_generator_tpu_torch.data.dataset import (
    Dataset,
    batches,
    block_epoch_permutation,
    clamp_midi,
    compute_beat,
    compute_completion,
    compute_genre,
    decode_prime,
    epoch_permutation,
    load_all,
    stagger,
    transpose_augment,
    unclamp_midi,
)

__all__ = ["Dataset", "batches", "block_epoch_permutation",
           "clamp_midi", "compute_beat",
           "compute_completion", "compute_genre", "decode_prime",
           "epoch_permutation", "load_all", "stagger", "transpose_augment",
           "unclamp_midi"]
