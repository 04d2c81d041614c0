"""`python -m music_generator_tpu_torch.generate [--device cpu] [--params
NPZ] ...`: generate music with the PyTorch port (see cli.generate_main)."""

from music_generator_tpu_torch.cli import generate_main

if __name__ == "__main__":
    generate_main()
