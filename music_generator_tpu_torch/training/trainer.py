"""Training loop (the JAX package's `training/trainer.py`).

Mirrors the reference's loop semantics (ref: train.py:14-29): up to
`epochs` epochs over the fully loaded dataset, the per-epoch mean training
loss driving a best-only checkpoint and Keras-exact early stopping with
patience 5.  Every epoch takes one [S, B] index matrix from
`epoch_permutation` (the same batch stream as the JAX trainer for the same
seed) and runs one train step per row.  How the batches reach the card is
`TrainConfig.epoch_scan_mode`, picked as the JAX trainer picks it (with
one device a process): `replicated` (the dataset resident on the device,
each batch gathered there), `sharded` (each rank's shard resident on its
card, each batch gathered from every rank's block), `segments` (past the
byte budget: stream-order segments gathered on the host and copied on a
side stream while the previous one trains) or `stream` (a per-step host
feed one batch ahead, for profiling or with `epoch_scan` off; `profile`
writes a trace of steps 5-10).

Data parallelism (parallel/mesh.py, one process per card): `ds` is this
rank's `Dataset.shard`, `batch_size` the per-rank feed and the global
batch `batch_size * world` what the step averages and `Throughput`
counts.  Rank 0's weights and Nadam state reach every rank before step 0,
every step all-reduces its gradients (parallel/train_step.py), the epoch
loss is therefore the same on every rank and so is the early stop, and
only rank 0 writes checkpoints (the others wait at a barrier), metric rows
and TensorBoard."""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from music_generator_tpu_torch.data.dataset import (Dataset, batches,
                                                    block_epoch_permutation,
                                                    epoch_permutation)
from music_generator_tpu_torch.models.deepj import DeepJ
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.parallel.train_step import (broadcast_state,
                                                           create_train_state,
                                                           eval_step,
                                                           sharded_train_step,
                                                           train_step)
from music_generator_tpu_torch.params import name_to_keystr
from music_generator_tpu_torch.training.checkpoint import (CheckpointStore,
                                                           model_path)
from music_generator_tpu_torch.training.metrics import (MetricLogger,
                                                        Throughput)
from music_generator_tpu_torch.utils import param_summary, spans


@dataclasses.dataclass
class TrainConfig:
    epochs: Optional[int] = None          # default: cfg.epochs (1000)
    patience: Optional[int] = None        # default: cfg.early_stop_patience
    seed: int = 0
    log_every: int = 10                   # steps between metric log rows
    checkpoint: bool = True
    tensorboard: bool = True
    # Write a torch.profiler trace (CPU and CUDA activities, Chrome trace
    # format, with the program's spans) of steps [profile_start,
    # profile_stop) of epoch 0 under <log_dir>/profile, one file a rank
    # under data parallelism.  Profiling runs the `stream` mode.
    profile: bool = False
    profile_start: int = 5
    profile_stop: int = 10
    # Per-epoch parameter histograms to TensorBoard, matching the reference's
    # TensorBoard(histogram_freq=1) callback (ref: train.py:25).  0 disables.
    histogram_freq: int = 1
    # How each epoch's batches reach the device ("auto" picks by corpus
    # size; see fit()):
    #   replicated — the whole dataset resident on the device; an epoch
    #                ships only its [S, B] index matrix (one process)
    #   sharded    — each rank's shard resident on its card; an epoch
    #                ships the [S, world * B] block-local index matrix
    #   segments   — [M, B] segments gathered on the host in stream order,
    #                each copied on a side stream while the previous one
    #                trains (corpora past the budget)
    #   stream     — the per-step host feed, one batch staged ahead on a
    #                worker thread (profiling, or epoch_scan off)
    epoch_scan: bool = True
    epoch_scan_mode: str = "auto"
    # Device bytes a card for staged training data: the resident corpus
    # (replicated), the rank's shard (sharded) or the two segment buffers
    # (segments).  The parameters, Nadam's state and a step's activations
    # come on top of it.
    epoch_scan_max_bytes: int = 8 << 30


MODES = ("auto", "replicated", "sharded", "segments", "stream")


def prefetch(items: Iterable, fn: Callable, depth: int = 2) -> Iterator:
    """Apply `fn` (host-to-device staging) up to `depth` items ahead on a
    worker thread, so that batch t + 1's gather and copy overlap step t
    (the JAX trainer's `prefetch`)."""
    with ThreadPoolExecutor(1) as ex:
        futures = collections.deque()
        it = iter(items)
        for x in itertools.islice(it, depth):
            futures.append(ex.submit(fn, x))
        for x in it:
            out = futures.popleft().result()
            futures.append(ex.submit(fn, x))
            yield out
        while futures:
            yield futures.popleft().result()


class _SegmentStager:
    """Two [M, B, ...] buffers of each dataset array on the device and,
    on a card, two pinned host buffers and a side stream, for a whole fit.
    `stage(k, sel)` (on a worker thread) gathers segment k's windows (sel
    [M, B]) into host buffer k % 2 and copies it into device buffer k % 2
    on the side stream, after the event that `release` recorded behind
    the last step that read that buffer; `take(k)` makes the current
    stream wait for segment k's copy and returns its device buffers.  On
    the CPU the gather is the copy."""

    def __init__(self, arrays, steps: int, batch: int,
                 device: torch.device):
        self.arrays, self.steps, self.device = arrays, steps, device
        self.cuda = device.type == "cuda"
        shapes = [(steps, batch) + a.shape[1:] for a in arrays]
        if self.cuda:
            self.host = [[torch.empty(s, dtype=torch.float32,
                                      pin_memory=True) for s in shapes]
                         for _ in range(2)]
            self.dev = [[torch.empty(s, dtype=torch.float32, device=device)
                         for s in shapes] for _ in range(2)]
            self.stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.freed = [None, None]
        else:
            self.dev = [[torch.empty(s, dtype=torch.float32)
                         for s in shapes] for _ in range(2)]

    def _gather(self, sel: np.ndarray, bufs) -> None:
        # A window at a time: one contiguous copy a row, from strided
        # arrays too (np.take first copies a non-contiguous array whole,
        # a[sel] copies twice).
        rows = np.asarray(sel).reshape(-1)
        for a, buf in zip(self.arrays, bufs):
            out = buf.numpy().reshape((-1,) + a.shape[1:])
            for i, r in enumerate(rows):
                out[i] = a[r]

    def stage(self, k: int, sel: np.ndarray) -> None:
        b = k % 2
        if not self.cuda:
            self._gather(sel, self.dev[b])
            return
        # The pinned buffer's last copy (segment k - 2) must have landed
        # before the host writes into it again.
        self.copied[b].synchronize()
        self._gather(sel, self.host[b])
        with torch.cuda.stream(self.stream):
            if self.freed[b] is not None:
                self.stream.wait_event(self.freed[b])
            for h, d in zip(self.host[b], self.dev[b]):
                d.copy_(h, non_blocking=True)
            self.copied[b].record(self.stream)

    def take(self, k: int):
        b = k % 2
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.copied[b])
        return self.dev[b]

    def release(self, k: int) -> None:
        """Segment k's steps are enqueued: its buffer may be refilled once
        the current stream has run them."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.freed[k % 2] = ev


class Trainer:
    def __init__(self, model: DeepJ,
                 train_cfg: Optional[TrainConfig] = None):
        self.model = model
        self.cfg = model.cfg
        self.tc = train_cfg or TrainConfig()
        self.state = create_train_state(model, self.tc.seed)
        # The reference prints model.summary() at startup (ref: util.py:16).
        if mesh.rank() == 0:
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
        """Train to early stop over `ds` (this rank's shard under data
        parallelism: every rank must hold as many rows, as Dataset.shard
        gives them); returns the history."""
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
        world, lead = mesh.world(), mesh.rank() == 0
        if world > 1:
            # Every step is a collective: a rank with fewer rows would run
            # fewer steps and leave the others waiting for ever.
            sizes = mesh.all_gather_rows(torch.tensor([len(ds)],
                                                      device=device))
            if len(set(sizes.tolist())) != 1:
                raise ValueError(f"ranks hold {sizes.tolist()} rows: give "
                                 f"each its Dataset.shard(rank, world)")
        global_batch = batch_size * world

        logger = MetricLogger(cfg.log_dir, jsonl=lead,
                              tensorboard=tc.tensorboard and lead)
        meter = Throughput(global_batch * seq_len)
        rng = np.random.default_rng(tc.seed)
        best_loss = float("inf")
        bad_epochs = 0
        history = {"loss": [], "epoch_seconds": [], "steps_per_epoch": [],
                   "batch_size": batch_size}

        # The epoch's staging mode, as the JAX trainer picks it with one
        # device a process:
        #   replicated — one process, and the dataset fits
        #       epoch_scan_max_bytes;
        #   sharded — more than one process, and the rank's shard fits;
        #   segments — past that: two [M, B] segment buffers in the budget;
        #   stream — profiling, or epoch_scan off.
        arrays = (ds.notes, ds.targets, ds.beats, ds.styles)
        ds_bytes = sum(int(a.nbytes) for a in arrays)
        mode = tc.epoch_scan_mode
        if mode not in MODES:
            raise ValueError(f"unknown epoch_scan_mode {mode!r}")
        if not tc.epoch_scan or tc.profile:
            mode = "stream"
        elif mode == "auto":
            if ds_bytes > tc.epoch_scan_max_bytes:
                mode = "segments"
            else:
                mode = "replicated" if world == 1 else "sharded"
        if mode == "replicated" and world > 1:
            raise ValueError(
                "epoch_scan_mode='replicated' requires a single process "
                "(each rank holds only its shard); use 'sharded'")
        history["epoch_scan_mode"] = mode
        # Rank 0's fresh or restored weights and Nadam state on every rank.
        broadcast_state(self.state)

        resident = stager = None
        if mode in ("replicated", "sharded"):
            # The dataset (sharded: this rank's block of it) lives on the
            # device for the whole fit; each epoch ships only its index
            # matrix.
            resident = tuple(torch.from_numpy(a).to(device) for a in arrays)
        elif mode == "segments":
            # Two staging buffers (double buffering) fit the budget.
            per_batch = sum(int(a.nbytes) // len(ds)
                            for a in arrays) * batch_size
            seg_steps = max(1, int(tc.epoch_scan_max_bytes
                                   // max(2 * per_batch, 1)))
            stager = _SegmentStager(arrays, seg_steps, batch_size, device)
        try:
            for epoch in range(epochs):
                t0 = time.perf_counter()
                if mode == "replicated":
                    perm = epoch_permutation(len(ds), batch_size, rng,
                                             drop_remainder=False)
                    epoch_losses = self._resident_epoch(
                        resident, torch.from_numpy(perm).to(device), logger)
                elif mode == "sharded":
                    # Rank r gathers column block r of every row from its
                    # own block (the JAX trainer's device-local gather).
                    perm = block_epoch_permutation(len(ds), world,
                                                   batch_size, rng)
                    epoch_losses = self._resident_epoch(
                        resident, torch.from_numpy(perm).to(device), logger,
                        sharded=True)
                elif mode == "segments":
                    epoch_losses = self._segment_epoch(
                        ds, batch_size, stager, rng, logger)
                else:
                    epoch_losses = self._stream_epoch(
                        ds, batch_size, rng, epoch, logger, meter)
                epoch_loss = float(np.mean(epoch_losses))
                history["loss"].append(epoch_loss)
                history["steps_per_epoch"].append(len(epoch_losses))
                dt = time.perf_counter() - t0
                history["epoch_seconds"].append(dt)
                rate = len(epoch_losses) * global_batch * seq_len / dt
                if lead:
                    print(f"epoch {epoch + 1}/{epochs} "
                          f"loss={epoch_loss:.4f} ({dt:.1f}s, {rate:.0f} "
                          f"timesteps/s)")
                logger.log(epoch + 1, {"epoch_loss": epoch_loss},
                           prefix="epoch")
                if (tc.tensorboard and lead and tc.histogram_freq
                        and (epoch + 1) % tc.histogram_freq == 0):
                    self._log_param_histograms(logger, epoch + 1)

                # Best-only checkpoint + early stop, both on TRAIN loss
                # (ref: train.py:23-24 monitors 'loss', not val_loss).
                # Each step's loss is already the ranks' mean, so every
                # rank takes the same decision.
                if epoch_loss < best_loss:
                    best_loss = epoch_loss
                    bad_epochs = 0
                    if self.store is not None:
                        if lead:
                            self.store.save(self.state)
                        mesh.barrier()
                else:
                    bad_epochs += 1
                    # Keras-2 EarlyStopping stops when wait >= patience.
                    if bad_epochs >= patience:
                        if lead:
                            print(f"early stopping (no improvement for "
                                  f"{bad_epochs} epochs)")
                        break
        finally:
            logger.close()
        return history

    @staticmethod
    def _to_host(metrics: List[dict]) -> dict:
        """An epoch's per-step device metrics as [S] host arrays (one
        readback, after the epoch's last step)."""
        return {k: torch.stack([m[k] for m in metrics]).float().cpu().numpy()
                for k in metrics[0]}

    def _log_rows(self, logger: MetricLogger, base_step: int, host: dict,
                  rate: float) -> np.ndarray:
        """Every log_every-th step's metrics, with the epoch-average rate
        under the stream path's key; returns the per-step losses."""
        for k in range(self.tc.log_every - 1, len(host["loss"]),
                       self.tc.log_every):
            row = {name: float(vals[k]) for name, vals in host.items()}
            row["timesteps_per_sec"] = rate
            logger.log(base_step + k + 1, row)
        return host["loss"]

    def _resident_epoch(self, resident, perm: torch.Tensor,
                        logger: MetricLogger,
                        sharded: bool = False) -> np.ndarray:
        """One epoch over the device-resident dataset: one train step per
        row of `perm` (sharded: this rank's column block of it, indices
        into its own block), metrics kept on the device until the end."""
        base_step = self.state.step
        t0 = time.perf_counter()
        host = self._to_host([
            sharded_train_step(self.state, resident, idx) if sharded
            else train_step(self.state, tuple(a[idx] for a in resident))
            for idx in perm])
        dt = time.perf_counter() - t0
        rate = perm.numel() * resident[0].shape[1] / dt
        return self._log_rows(logger, base_step, host, rate)

    def _segment_epoch(self, ds: Dataset, batch_size: int,
                       stager: _SegmentStager, rng: np.random.Generator,
                       logger: MetricLogger) -> np.ndarray:
        """One epoch past the resident budget: the resident path's batch
        stream (epoch_permutation), gathered on the host into [seg_steps,
        B] segments, each copied to the device while the one before it
        trains; at most two segments on the device (the budget's two
        buffers).  The trailing S % seg_steps steps copy one batch each."""
        arrays = (ds.notes, ds.targets, ds.beats, ds.styles)
        device = self.model.device
        perm = epoch_permutation(len(ds), batch_size, rng,
                                 drop_remainder=False)
        S, seg_steps = perm.shape[0], stager.steps
        n_full = S // seg_steps
        base_step = self.state.step
        t0 = time.perf_counter()
        metrics = []

        def stage(k: int) -> int:
            stager.stage(k, perm[k * seg_steps:(k + 1) * seg_steps])
            return k

        # depth=1: the segment training plus one staged ahead are the two
        # buffers the budget holds; staging k + 1 (on the worker thread)
        # hides behind training k.
        for k in prefetch(range(n_full), stage, depth=1):
            seg = stager.take(k)
            metrics += [train_step(self.state, tuple(a[m] for a in seg))
                        for m in range(seg_steps)]
            stager.release(k)
        for s in range(n_full * seg_steps, S):
            batch = tuple(torch.from_numpy(a[perm[s]]).to(device)
                          for a in arrays)
            metrics.append(train_step(self.state, batch))
        host = self._to_host(metrics)
        dt = time.perf_counter() - t0
        rate = S * batch_size * ds.notes.shape[1] / dt
        return self._log_rows(logger, base_step, host, rate)

    def _stream_epoch(self, ds: Dataset, batch_size: int,
                      rng: np.random.Generator, epoch: int,
                      logger: MetricLogger,
                      meter: Throughput) -> np.ndarray:
        """The per-step host feed: each batch gathered and copied to the
        device one step ahead on a worker thread (`prefetch`).  With
        `profile`, epoch 0's steps [profile_start, profile_stop), clamped
        to the epoch, run under torch.profiler, whose Chrome trace goes
        under <log_dir>/profile (train_steps_A_B.rankR.pt.trace.json from
        each rank R when world > 1)."""
        tc = self.tc
        device = self.model.device
        n_steps = -(-len(ds) // batch_size)
        p_start = min(tc.profile_start, max(n_steps - 1, 0))
        p_stop = max(min(tc.profile_stop, n_steps), p_start + 1)
        profiling = tc.profile and epoch == 0
        prof = None

        def stage(batch):
            return tuple(torch.from_numpy(a).to(device) for a in batch)

        losses = []
        meter.reset()
        staged = prefetch(batches(ds, batch_size, rng=rng,
                                  drop_remainder=False), stage)
        for bi, batch in enumerate(staged):
            if profiling and bi == p_start:
                prof = self._start_profile()
            elif profiling and bi == p_stop:
                self._stop_profile(prof, p_start, p_stop)
                prof = None
            metrics = train_step(self.state, batch)
            meter.tick()
            losses.append(metrics["loss"])
            if len(losses) % tc.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["timesteps_per_sec"] = meter.rate()
                logger.log(self.state.step, m)
        if prof is not None:
            # The epoch ended before p_stop batches: close the trace.
            self._stop_profile(prof, p_start, p_stop)
        # float32, as the other modes return them, so that the epoch's mean
        # loss does not depend on the mode.
        return torch.stack(losses).float().cpu().numpy()

    def _start_profile(self) -> Tuple[torch.profiler.profile,
                                      spans.Recording]:
        """The profiler, and a recording of the program's spans over the
        same steps: the trace carries them, and they stay out of the
        process-wide recording (utils/spans.py)."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        rec = spans.recording().start()
        prof.start()
        return prof, rec

    def _stop_profile(self, profiling: Tuple[torch.profiler.profile,
                                             spans.Recording],
                      start: int, stop: int) -> None:
        prof, rec = profiling
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        prof.stop()
        rec.stop()
        out_dir = os.path.join(self.cfg.log_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        # Under data parallelism every rank traces its own card.
        tag = f".rank{mesh.rank()}" if mesh.world() > 1 else ""
        path = os.path.join(out_dir,
                            f"train_steps_{start}_{stop}{tag}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")

    def _log_param_histograms(self, logger: MetricLogger, epoch: int) -> None:
        """One histogram per parameter, tagged by its keystr path (ref:
        train.py:25, histogram_freq=1)."""
        for name, leaf in self.model.state_dict().items():
            logger.histogram("params" + name_to_keystr(name),
                             leaf.detach().float().cpu().numpy(), epoch)

    def evaluate(self, ds: Dataset, batch_size: Optional[int] = None) -> dict:
        """Deterministic (no-dropout) metrics over a dataset, an exact mean:
        the last batch is padded and its pad rows get weight zero.  Under
        data parallelism `ds` is this rank's shard, every rank's per-sample
        metrics are gathered (rank-major) and Dataset.shard's wrap-padded
        duplicates are weighted out too, each rank's from
        shard_validity(q), so every real window counts once (17 windows
        over 2 ranks divide by 17, not 18) and every rank returns the same
        means."""
        if len(ds) == 0:
            raise ValueError("empty dataset — nothing to evaluate")
        batch_size = batch_size or min(self.cfg.batch_size, max(1, len(ds)))
        device = self.model.device
        world = mesh.world()
        n = len(ds)
        padded = -(-n // batch_size) * batch_size
        idx = np.concatenate([np.arange(n), np.zeros(padded - n, np.int64)])
        pad = np.zeros(padded - n)
        if ds.shard_info is not None and ds.shard_info[1] == world > 1:
            masks = [ds.shard_validity(q) for q in range(world)]
        else:
            # Unsharded, or a shard evaluated outside its group.
            masks = [ds.shard_validity()] * world
        weights = [np.concatenate([m, pad]) for m in masks]
        sums: dict = {}
        for s in range(padded // batch_size):
            sel = idx[s * batch_size:(s + 1) * batch_size]
            w = np.concatenate([rw[s * batch_size:(s + 1) * batch_size]
                                for rw in weights])
            batch = tuple(torch.from_numpy(a[sel]).to(device) for a in (
                ds.notes, ds.targets, ds.beats, ds.styles))
            metrics = eval_step(self.model, batch)
            names = sorted(metrics)
            rows = mesh.all_gather_rows(torch.stack(
                [metrics[k] for k in names], dim=1)).float().cpu().numpy()
            for i, k in enumerate(names):
                sums[k] = sums.get(k, 0.0) + float(rows[:, i] @ w)
        denom = float(sum(rw.sum() for rw in weights))
        return {k: v / denom for k, v in sums.items()}
