"""The training step (the JAX package's `parallel/train_step.py`, one
device): dropout generator derivation, forward, masked loss, backward and
the Keras-2 Nadam update.

The JAX step folds the step number into the state's key (`_step_body`,
train_step.py:56).  Here each step draws its dropout from a
`torch.Generator` on the model's device seeded from (seed, step), so a
step's masks depend only on the run's seed and the step, as there.  The
numbers differ from JAX's RBG stream; the in-kernel stack masks for a given
stack seed are the Pallas kernels' own (ops/biax.py)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from music_generator_tpu_torch.models.deepj import DeepJ, per_sample_loss
from music_generator_tpu_torch.ops.nadam import Nadam

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: DeepJ
    optimizer: Nadam
    step: int
    seed: int


def create_train_state(model: DeepJ, seed: int = 0) -> TrainState:
    """Fresh weights from `seed` on `model` and a Nadam over them (the
    config's learning rate, betas, epsilon and schedule decay)."""
    cfg = model.cfg
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.requires_grad_(True).train()
    optimizer = Nadam(model.parameters(), cfg.learning_rate, cfg.beta1,
                      cfg.beta2, cfg.eps, cfg.schedule_decay)
    return TrainState(model, optimizer, 0, seed)


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The dropout generator of one step: a function of (seed, step)."""
    word = int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(word)


def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
    """One update on `batch` = (notes, targets, beats, styles) on the
    model's device; returns the step's metrics as device scalars."""
    model = state.model
    gen = step_generator(state.seed, state.step, model.device)
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = model.loss(batch, generator=gen, train=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: DeepJ, batch: Batch) -> Dict[str, torch.Tensor]:
    """Deterministic (no-dropout) per-sample metrics {name: [B]}."""
    notes, targets, beats, styles = batch
    preds = model.forward(notes, targets, beats, styles, None, False)
    return per_sample_loss(targets, preds)
