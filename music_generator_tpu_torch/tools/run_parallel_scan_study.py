"""The throughput half of the parallel-scan time-axis study (the JAX
package's tools/run_parallel_scan_study.py:40-160): steady training-step
timesteps/s of the LSTM time axis against the linear one, on the card.

    python -m music_generator_tpu_torch.tools.run_parallel_scan_study \\
        [--batches 16 64] [--steps 60] [--out runs/parallel_scan_study.json]

At `default_config()` widths, fresh weights from seed 0, one seeded batch
(`random_batch(cfg, seed=0, rolled_targets=True)`), dropout on, for each
batch size and route:

  * `lstm_biax`: the shipped route, the biaxial stacks (kernels 2-5);
  * `lstm_per_layer`: `fused_biax_v3=False, fused_axis_kernel=False`, one
    recurrence per layer (kernels 8 and 9);
  * `linear`: `time_axis_kind="linear"`, the time axis one `glru_scan` per
    layer (on the card one launch of `csrc/glru_scan.cu` a direction; on
    the CPU the associative scan's tree) and the note axis one fused
    two-layer stack (kernels 6 and 7).

Each route runs WARMUP steps, then three runs of `steps` steps timed on
the host clock around a synchronised run; the median run gives host ms a
step and timesteps/s = B * T / step.  A profiled run of 5 steps gives the
device ms a step (the sum of its CUDA kernels, and the largest by name)
and the busy share, device ms over host ms: the host's share of a step
moves with the host, not the code.  The kernels' launches a step are read
from the wrappers' counters.
The quality half of the JAX tool trains on a corpus this repository does
not hold and is not ported.  On the CPU (--device cpu) it runs the same
code with no device time."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Dict, Optional, Sequence

import torch

from music_generator_tpu_torch.config import Config, default_config
from music_generator_tpu_torch.data.synth import random_batch
from music_generator_tpu_torch.device import DeviceLike, resolve_device
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.parallel.train_step import (create_train_state,
                                                           train_step)

ROUTES = {
    "lstm_biax": {},
    "lstm_per_layer": dict(fused_biax_v3=False, fused_axis_kernel=False),
    "linear": dict(time_axis_kind="linear"),
}
WARMUP = 3        # untimed steps before the timed runs
PROFILED_STEPS = 5
TOP = 8           # kernels listed by device ms a step


def _wrappers():
    from music_generator_tpu_torch.ops import (biax, linear_scan, lstm2,
                                               recurrence)
    return {"biax_time": biax.biax_time_stack,
            "biax_note": biax.biax_note_stack,
            "lstm2": lstm2.lstm2_stack,
            "lstm_rec": recurrence.lstm_recurrence,
            "glru_scan": linear_scan.glru_scan}


def launch_counts() -> Dict[str, int]:
    """The training kernels' launches so far, by kernel name."""
    out = {}
    for name, fn in _wrappers().items():
        out[f"{name}_fwd"] = fn.fwd_launches
        out[f"{name}_bwd"] = fn.bwd_launches
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_route(cfg: Config, device: DeviceLike = None,
                steps: int = 60) -> dict:
    """One route's readings at `cfg` (its batch size): timesteps/s, host
    ms a step (median of 3 runs, and each run), device ms a step, busy
    share and the TOP kernels by device ms a step (None and {} on the
    CPU), the training kernels' launches a step."""
    dev = resolve_device(device)
    state = create_train_state(build_model(cfg, dev), seed=0)
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in random_batch(cfg, seed=0, rolled_targets=True))
    for _ in range(WARMUP):
        train_step(state, batch)
    _sync(dev)
    before = launch_counts()
    runs = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(steps):
            metrics = train_step(state, batch)
        float(metrics["loss"])
        _sync(dev)
        runs.append((time.perf_counter() - t) * 1e3 / steps)
    per_step = {k: (v - before[k]) / (3 * steps)
                for k, v in launch_counts().items() if v != before[k]}
    host_ms = statistics.median(runs)
    device_ms, top = None, {}
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                train_step(state, batch)
            _sync(dev)
        by_kernel = {
            e.key: e.self_device_time_total / 1e3 / PROFILED_STEPS
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
        device_ms = sum(by_kernel.values())
        top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP])
    if not torch.isfinite(metrics["loss"]):
        raise FloatingPointError(f"non-finite loss on {cfg}")
    return {"timesteps_per_sec": cfg.batch_size * cfg.seq_len
            / (host_ms / 1e3),
            "host_ms": host_ms, "host_ms_runs": runs,
            "device_ms": device_ms,
            "busy_share": None if device_ms is None else device_ms / host_ms,
            "launches_per_step": per_step,
            "device_ms_top_kernels": top,
            "loss": float(metrics["loss"])}


def study(batches: Sequence[int] = (16, 64), steps: int = 60,
          device: DeviceLike = None, base: Optional[Config] = None,
          log=print) -> dict:
    """Every route at every batch size: {"B16": {route: readings}, ...}."""
    base = base or default_config()
    out = {}
    for B in batches:
        rows = out[f"B{B}"] = {}
        for route, overrides in ROUTES.items():
            r = rows[route] = bench_route(
                base.replace(batch_size=B, **overrides), device, steps)
            device_text = ("" if r["device_ms"] is None else
                           f"; device {r['device_ms']:.4f} ms/step, busy "
                           f"share {r['busy_share']:.3f}")
            log(f"study B={B} {route}: {r['timesteps_per_sec']:.1f} "
                f"timesteps/s, host {r['host_ms']:.4f} ms/step (runs "
                f"{', '.join(f'{x:.4f}' for x in r['host_ms_runs'])})"
                f"{device_text}; launches a step {r['launches_per_step']}")
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Training throughput of the LSTM and linear time axes")
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 64])
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--out", default=os.path.join(
        "runs", "parallel_scan_study.json"))
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    card = None
    if dev.type == "cuda":
        from music_generator_tpu_torch.device import full_f32
        from music_generator_tpu_torch.tools.common import card_line
        full_f32()
        card = card_line()
        print("card:", card)
    report = {"card": card, "device": str(dev),
              "routes": ROUTES,
              "steps": args.steps, "warmup": WARMUP,
              "throughput": study(args.batches, args.steps, dev)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
