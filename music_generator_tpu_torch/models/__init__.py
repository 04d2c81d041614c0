from music_generator_tpu_torch.models.deepj import (DeepJ, build_model,
                                                   feature_dim)

__all__ = ["DeepJ", "build_model", "feature_dim"]
