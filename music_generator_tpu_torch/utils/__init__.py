from music_generator_tpu_torch.utils.util import (get_all_files, one_hot,
                                                   param_summary)

__all__ = ["one_hot", "get_all_files", "param_summary"]
