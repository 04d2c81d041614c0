"""music_generator_tpu_torch — the PyTorch/CUDA port of music_generator_tpu
(DeepJ, arXiv:1801.00887) for NVIDIA Hopper.

It imports torch and numpy, never JAX and nothing of the JAX package: the
jax-free modules it needs (config, midi, data helpers) are its own copies.
Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`); with no card and no such request they
raise rather than fall back.

Layer map (this slice: streaming generation):
  config     — the Config dataclass, every field of the JAX package's
  midi       — MIDI event model, binary IO and piano-roll codec
  data       — compute_genre / unclamp_midi
  params     — keystr-layout .npz weights <-> the model's state dict
  models     — the DeepJ module: style embedding, octave conv, features,
               streaming time-axis step, note-axis cell, heads
  ops        — LSTM cell, temperature, the pitch-loop kernel wrapper and
               its build helper (csrc/notegen.cu)
  generation — threefry-exact uniforms and the streaming Sampler
  cli        — `python -m music_generator_tpu_torch.generate`
"""

from music_generator_tpu_torch.config import Config, default_config

__version__ = "0.1.0"

__all__ = ["Config", "default_config", "__version__"]
