"""`python -m music_generator_tpu_torch.visualize [--device cpu]
[--from-keras MODEL_H5]`: write the style-embedding TSVs with the PyTorch
port (see cli.visualize_main)."""

from music_generator_tpu_torch.cli import visualize_main

if __name__ == "__main__":
    visualize_main()
