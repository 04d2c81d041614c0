"""The training step and data parallelism over torch.distributed (one
process per card): `train_step`, `mesh`."""
