"""Training: the resident-dataset trainer, best-only checkpoints, metrics."""
