"""The training step (the JAX package's `parallel/train_step.py`): dropout
generator derivation, forward, masked loss, backward, the gradient
all-reduce across ranks and the Keras-2 Nadam update.

The JAX step folds the step number into the state's key (`_step_body`,
train_step.py:56).  Here each step draws its dropout from a
`torch.Generator` on the model's device seeded from (seed, step), so a
step's masks depend only on the run's seed and the step, as there.  The
numbers differ from JAX's RBG stream; the in-kernel stack masks for a given
stack seed are the Pallas kernels' own (ops/biax.py).

Data parallelism (parallel/mesh.py, one process per card): each rank takes
its own rows of the global batch, and between `loss.backward()` and the
Nadam step the gradients and the step's metrics are averaged over the
ranks in ONE collective over a flat bucket.  The JAX loss is a plain mean
over the global batch (models/deepj.py:645); with equal rows on every rank
that mean is the mean of the ranks' means, so the update is the global
batch's.  Rank r > 0 keys its dropout generator by (seed, step, r), so
the ranks' rows drop out different units, as the JAX step's global masks
differ across devices; rank 0 keeps the one-process key."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from music_generator_tpu_torch.models.deepj import DeepJ, per_sample_loss
from music_generator_tpu_torch.ops.nadam import Nadam
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.utils import spans

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


@torch.no_grad()
def broadcast_state(state: TrainState, src: int = 0) -> None:
    """Rank `src`'s parameters, Nadam state and step on every rank (the
    start of a data-parallel fit: fresh or restored, every rank then
    holds the same weights)."""
    if mesh.world() == 1:
        return
    state.optimizer.init_state()
    params = list(state.model.parameters())
    moments = [st[k] for st in (state.optimizer.state[p] for p in params)
               for k in sorted(st)]
    step = torch.tensor([state.step], dtype=torch.int64,
                        device=params[0].device)
    mesh.broadcast_(params + moments + [step], src)
    state.step = int(step.item())


def step_generator(seed: int, step: int, device: torch.device,
                   rank: int = 0) -> torch.Generator:
    """The dropout generator of one step on one rank: a function of (seed,
    step) on rank 0, of (seed, step, rank) on the others."""
    entropy = [seed, step] + ([rank] if rank else [])
    word = int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(word)


def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
    """One update on `batch` = (notes, targets, beats, styles) on the
    model's device (this rank's rows of the global batch); returns the
    step's metrics, averaged over the ranks, as device scalars.  Its
    phases are the spans `train.step` > `train.zero_grad`,
    `train.forward`, `train.backward`, `train.all_reduce` (world > 1),
    `train.optimizer` (utils/spans.py)."""
    with spans.span("train.step"):
        model = state.model
        gen = step_generator(state.seed, state.step, model.device,
                             mesh.rank())
        with spans.span("train.zero_grad"):
            state.optimizer.zero_grad(set_to_none=True)
        with spans.span("train.forward"):
            loss, metrics = model.loss(batch, generator=gen, train=True)
        with spans.span("train.backward"):
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh.world() > 1:
            with spans.span("train.all_reduce"):
                grads = [p.grad for p in model.parameters()
                         if p.grad is not None]
                names = sorted(metrics)
                values = torch.stack([metrics[k] for k in names]).to(
                    grads[0].dtype)
                mesh.all_reduce_mean_(grads + [values])
                metrics = {k: values[i] for i, k in enumerate(names)}
        with spans.span("train.optimizer"):
            state.optimizer.step()
        state.step += 1
    return metrics


def sharded_train_step(state: TrainState, block: Sequence[torch.Tensor],
                       row: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One step of the sharded epoch (the JAX `make_sharded_epoch_step`'s
    body): `block` is this rank's resident rows, `row` the step's
    [world * b] block-local indices (data.block_epoch_permutation), whose
    column block `rank` this rank gathers from its own block."""
    b = row.shape[0] // mesh.world()
    idx = row[mesh.rank() * b:(mesh.rank() + 1) * b]
    return train_step(state, tuple(a[idx] for a in block))


@torch.no_grad()
def eval_step(model: DeepJ, batch: Batch) -> Dict[str, torch.Tensor]:
    """Deterministic (no-dropout) per-sample metrics {name: [B]}."""
    notes, targets, beats, styles = batch
    preds = model.forward(notes, targets, beats, styles, None, False)
    return per_sample_loss(targets, preds)
