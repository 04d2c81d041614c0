"""The benchmark of the PyTorch and CUDA port (`music_generator_tpu_torch`):
see portbench/README.md and `python3 -m portbench.run --help`."""
