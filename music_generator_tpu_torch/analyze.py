"""`python -m music_generator_tpu_torch.analyze`: corpus statistics with
the PyTorch port (see cli.analyze_main)."""

from music_generator_tpu_torch.cli import analyze_main

if __name__ == "__main__":
    analyze_main()
