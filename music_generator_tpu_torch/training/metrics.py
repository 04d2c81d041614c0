"""Metric logging: console, JSONL, and TensorBoard event files (the port's
copy of the JAX package's `training/metrics.py`).

Replaces the reference's Keras fit progress + TensorBoard callback
(ref: train.py:25, SURVEY.md §5 "Metrics / logging") with a writer that emits
the loss AND its three components (worth splitting, per SURVEY.md §5) plus
throughput in piano-roll timesteps/sec — the BASELINE metric.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from music_generator_tpu_torch.utils.tboard import SummaryWriter


class MetricLogger:
    def __init__(self, log_dir: str, jsonl: bool = True,
                 tensorboard: bool = True):
        if jsonl or tensorboard:
            os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a") \
            if jsonl else None
        self._tb = SummaryWriter(log_dir) if tensorboard else None

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "train") -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            record[f"{prefix}/{k}"] = float(v)
            if self._tb is not None:
                self._tb.scalar(f"{prefix}/{k}", float(v), int(step))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def histogram(self, tag: str, values, step: int) -> None:
        """TensorBoard-only histogram (ref: train.py:25 histogram_freq=1 —
        Keras wrote per-epoch weight histograms; JSONL stays scalar)."""
        if self._tb is not None:
            self._tb.histogram(tag, values, int(step))
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Throughput:
    """Steps→timesteps/sec meter over a sliding window."""

    def __init__(self, timesteps_per_batch: int):
        self.timesteps_per_batch = timesteps_per_batch
        self._t0: Optional[float] = None
        self._batches = 0

    def tick(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._batches = 0
        else:
            self._batches += 1

    def rate(self) -> float:
        if self._t0 is None or self._batches == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._batches * self.timesteps_per_batch / dt

    def reset(self) -> None:
        self._t0 = None
        self._batches = 0
