from music_generator_tpu_torch.generation.sampler import (GenerationResult,
                                                         Sampler, write_file)

__all__ = ["GenerationResult", "Sampler", "write_file"]
