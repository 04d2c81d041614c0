"""Training driver (the JAX package's `training/trainer.py`, resident mode).

Mirrors the reference's loop semantics (ref: train.py:14-29): up to
`epochs` epochs over the fully loaded dataset, the per-epoch mean training
loss driving a best-only checkpoint and Keras-exact early stopping with
patience 5.  The dataset goes to the device once; each epoch takes one
[S, B] index matrix from `epoch_permutation` (the same batch stream as the
JAX trainer for the same seed), gathers each batch on the device, and keeps
the per-step losses there until the epoch ends.  The JAX trainer's
`sharded`, `segments`, `stream` and `profile` modes are not ported yet."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from music_generator_tpu_torch.data.dataset import Dataset, epoch_permutation
from music_generator_tpu_torch.models.deepj import DeepJ
from music_generator_tpu_torch.parallel.train_step import (create_train_state,
                                                           eval_step,
                                                           train_step)
from music_generator_tpu_torch.params import name_to_keystr
from music_generator_tpu_torch.training.checkpoint import (CheckpointStore,
                                                           model_path)
from music_generator_tpu_torch.training.metrics import MetricLogger
from music_generator_tpu_torch.utils import param_summary


@dataclasses.dataclass
class TrainConfig:
    epochs: Optional[int] = None          # default: cfg.epochs (1000)
    patience: Optional[int] = None        # default: cfg.early_stop_patience
    seed: int = 0
    log_every: int = 10                   # steps between metric log rows
    checkpoint: bool = True
    tensorboard: bool = True
    # Per-epoch parameter histograms to TensorBoard, matching the reference's
    # TensorBoard(histogram_freq=1) callback (ref: train.py:25).  0 disables.
    histogram_freq: int = 1


class Trainer:
    def __init__(self, model: DeepJ,
                 train_cfg: Optional[TrainConfig] = None):
        self.model = model
        self.cfg = model.cfg
        self.tc = train_cfg or TrainConfig()
        self.state = create_train_state(model, self.tc.seed)
        # The reference prints model.summary() at startup (ref: util.py:16).
        print(param_summary(model.state_dict()))
        self.store = (CheckpointStore(model_path(self.cfg))
                      if self.tc.checkpoint else None)

    def maybe_restore(self) -> bool:
        """Best-effort resume of parameters, optimizer state and step (ref:
        util.py:17-22's implicit-resume CLI behavior)."""
        if self.store is None or not self.store.exists():
            print("Unable to load model from file.")
            return False
        try:
            self.store.restore(self.state)
            print("Loaded model from file.")
            return True
        except Exception as e:
            print(f"Unable to load model from file. ({type(e).__name__})")
            return False

    def fit(self, ds: Dataset, epochs: Optional[int] = None) -> dict:
        """Train to early stop over `ds`; returns the history."""
        cfg, tc = self.cfg, self.tc
        epochs = epochs if epochs is not None else (
            tc.epochs if tc.epochs is not None else cfg.epochs)
        patience = (tc.patience if tc.patience is not None
                    else cfg.early_stop_patience)
        if len(ds) == 0:
            raise ValueError("empty dataset — nothing to train on")
        batch_size = min(cfg.batch_size, len(ds))
        seq_len = ds.notes.shape[1]
        device = self.model.device

        logger = MetricLogger(cfg.log_dir, tensorboard=tc.tensorboard)
        rng = np.random.default_rng(tc.seed)
        best_loss = float("inf")
        bad_epochs = 0
        history = {"loss": [], "epoch_seconds": [], "steps_per_epoch": [],
                   "batch_size": batch_size}
        # The dataset lives on the device for the whole fit; each epoch
        # ships only its [S, B] index matrix.
        resident = tuple(torch.from_numpy(a).to(device) for a in (
            ds.notes, ds.targets, ds.beats, ds.styles))
        try:
            for epoch in range(epochs):
                t0 = time.perf_counter()
                perm = epoch_permutation(len(ds), batch_size, rng,
                                         drop_remainder=False)
                epoch_losses = self._resident_epoch(
                    resident, torch.from_numpy(perm).to(device), logger)
                epoch_loss = float(np.mean(epoch_losses))
                history["loss"].append(epoch_loss)
                history["steps_per_epoch"].append(len(epoch_losses))
                dt = time.perf_counter() - t0
                history["epoch_seconds"].append(dt)
                rate = len(epoch_losses) * batch_size * seq_len / dt
                print(f"epoch {epoch + 1}/{epochs} loss={epoch_loss:.4f} "
                      f"({dt:.1f}s, {rate:.0f} timesteps/s)")
                logger.log(epoch + 1, {"epoch_loss": epoch_loss},
                           prefix="epoch")
                if (tc.tensorboard and tc.histogram_freq
                        and (epoch + 1) % tc.histogram_freq == 0):
                    self._log_param_histograms(logger, epoch + 1)

                # Best-only checkpoint + early stop, both on TRAIN loss
                # (ref: train.py:23-24 monitors 'loss', not val_loss).
                if epoch_loss < best_loss:
                    best_loss = epoch_loss
                    bad_epochs = 0
                    if self.store is not None:
                        self.store.save(self.state)
                else:
                    bad_epochs += 1
                    # Keras-2 EarlyStopping stops when wait >= patience.
                    if bad_epochs >= patience:
                        print(f"early stopping (no improvement for "
                              f"{bad_epochs} epochs)")
                        break
        finally:
            logger.close()
        return history

    def _resident_epoch(self, resident, perm: torch.Tensor,
                        logger: MetricLogger) -> np.ndarray:
        """One epoch over the device-resident dataset: one train step per
        row of `perm`, losses kept on the device until the end."""
        base_step = self.state.step
        t0 = time.perf_counter()
        metrics = [train_step(self.state, tuple(a[idx] for a in resident))
                   for idx in perm]
        host = {k: torch.stack([m[k] for m in metrics]).float().cpu().numpy()
                for k in metrics[0]}
        dt = time.perf_counter() - t0
        rate = perm.numel() * resident[0].shape[1] / dt
        for k in range(self.tc.log_every - 1, len(metrics),
                       self.tc.log_every):
            row = {name: float(vals[k]) for name, vals in host.items()}
            row["timesteps_per_sec"] = rate
            logger.log(base_step + k + 1, row)
        return host["loss"]

    def _log_param_histograms(self, logger: MetricLogger, epoch: int) -> None:
        """One histogram per parameter, tagged by its keystr path (ref:
        train.py:25, histogram_freq=1)."""
        for name, leaf in self.model.state_dict().items():
            logger.histogram("params" + name_to_keystr(name),
                             leaf.detach().float().cpu().numpy(), epoch)

    def evaluate(self, ds: Dataset, batch_size: Optional[int] = None) -> dict:
        """Deterministic (no-dropout) metrics over a dataset, an exact mean:
        the last batch is padded and its pad rows get weight zero."""
        if len(ds) == 0:
            raise ValueError("empty dataset — nothing to evaluate")
        batch_size = batch_size or min(self.cfg.batch_size, max(1, len(ds)))
        device = self.model.device
        n = len(ds)
        padded = -(-n // batch_size) * batch_size
        idx = np.concatenate([np.arange(n), np.zeros(padded - n, np.int64)])
        weights = np.concatenate([np.ones(n), np.zeros(padded - n)])
        sums: dict = {}
        for s in range(padded // batch_size):
            sel = idx[s * batch_size:(s + 1) * batch_size]
            w = weights[s * batch_size:(s + 1) * batch_size]
            batch = tuple(torch.from_numpy(a[sel]).to(device) for a in (
                ds.notes, ds.targets, ds.beats, ds.styles))
            metrics = eval_step(self.model, batch)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(
                    v.float().cpu().numpy() @ w)
        return {k: v / n for k, v in sums.items()}
