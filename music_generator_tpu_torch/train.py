"""`python -m music_generator_tpu_torch.train [--device cpu] [--epochs N]
[--seed S] [--no-resume]`: train the PyTorch port (see cli.train_main)."""

from music_generator_tpu_torch.cli import train_main

if __name__ == "__main__":
    train_main()
