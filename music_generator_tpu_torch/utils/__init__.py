from music_generator_tpu_torch.utils.util import one_hot

__all__ = ["one_hot"]
