"""music_generator_tpu_torch — the PyTorch/CUDA port of music_generator_tpu
(DeepJ, arXiv:1801.00887) for NVIDIA Hopper.

It imports torch and numpy, never JAX and nothing of the JAX package: the
jax-free modules it needs (config, midi, data helpers) are its own copies.
Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`); with no card and no such request they
raise rather than fall back.

Layer map (generation and training):
  config     — the Config dataclass, every field of the JAX package's
  midi       — MIDI event model, binary IO and piano-roll codec
  data       — the dataset pipeline (load_all, epoch_permutation, ...),
               the seeded synthetic corpus (data/synth.py) and the corpus
               statistics (data/analysis.py)
  params     — keystr-layout .npz weights <-> the model's state dict
  utils      — helpers, TensorBoard files, and a reader and writer of the
               HDF5 subset Keras 2 weight files use (utils/hdf5.py)
  models     — the DeepJ module: streaming generation paths, and the
               training forward (both axes through the biaxial stacks) and
               its masked loss
  ops        — LSTM cell, temperature, Keras-2 Nadam, the kernel wrappers
               (ops/notegen.py, ops/biax.py) and their build helper
               (csrc/*.cu)
  parallel   — the train step (dropout generator per step, the gradient
               all-reduce, Nadam update) and data parallelism over
               torch.distributed, one process per card (parallel/mesh.py)
  training   — the Trainer (replicated, sharded, segments, stream),
               best-only checkpoint, metrics, Keras 2 weight import and
               export (training/keras_import.py)
  generation — threefry-exact uniforms and the streaming Sampler (streams
               spread over the ranks of a process group)
  serving    — the HTTP generation service, and its authenticated replay
               channel across ranks (serving/multihost.py)
  tools      — the verification tools, the serving benchmark, export_keras,
               the data-parallel worker (tools/mp_worker.py)
  cli        — `python -m music_generator_tpu_torch.train`, `.generate`,
               `.visualize`, `.analyze` (and `.serve`)
"""

from music_generator_tpu_torch.config import Config, default_config

__version__ = "0.1.0"

__all__ = ["Config", "default_config", "__version__"]
