"""Train the port on a large synthetic corpus in its resident and segment
modes and write the rates as JSON (the JAX package's
tools/run_big_corpus.py).

    python -m music_generator_tpu_torch.tools.run_big_corpus \
        [--gb 4.3] [--epochs 4] [--seg-epochs 2] [--seg-budget-gb 1.0] \
        [--out runs/big_corpus.json] [--device cuda]

It measures, on the device it runs on:

  1. the host-to-device copy rate, pageable (how the resident corpus is
     staged) and pinned (how the segments are), one 256 MB buffer each;
  2. resident epochs on a --gb corpus through the stock Trainer.fit, whose
     `auto` mode must come out `replicated` (the corpus within
     TrainConfig.epoch_scan_max_bytes);
  3. segment epochs on the same corpus with the budget forced below it
     (--seg-budget-gb): each epoch gathers and copies the whole corpus
     again, segment by segment, while the previous segment trains.

The segment rate beside the resident rate says what staging past the
budget costs.  The corpus is random rolls at the config's geometry (the
rate does not depend on the content), built in chunks so that host memory
stays near half of its logical bytes (notes and targets are views into one
buffer).  On the CPU (--device cpu) it runs at small sizes as a smoke
test of the same code.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.data.dataset import Dataset
from music_generator_tpu_torch.device import resolve_device
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.tools.common import card_line, synchronize
from music_generator_tpu_torch.training.trainer import TrainConfig, Trainer


def build_corpus(gb: float, cfg, seed: int = 0) -> Dataset:
    """About `gb` GiB of training windows at the config's geometry, from
    `seed`: random plays at 8% density with volumes in [0.3, 1), beats in
    order, style 0."""
    T, N = cfg.seq_len, cfg.num_notes
    per_window = (2 * T * N * 3 + T * cfg.notes_per_bar
                  + T * cfg.num_styles) * 4
    n = max(cfg.batch_size, int(gb * (1 << 30) / per_window))
    rng = np.random.default_rng(seed)
    rolls = np.empty((n, T + 1, N, 3), np.float32)
    for lo in range(0, n, 2048):
        hi = min(lo + 2048, n)
        play = (rng.random((hi - lo, T + 1, N)) < 0.08).astype(np.float32)
        vol = play * rng.uniform(0.3, 1.0, play.shape).astype(np.float32)
        rolls[lo:hi, ..., 0] = play
        rolls[lo:hi, ..., 1] = 0.0
        rolls[lo:hi, ..., 2] = vol
    beats = np.zeros((n, T, cfg.notes_per_bar), np.float32)
    beats[:, np.arange(T), np.arange(T) % cfg.notes_per_bar] = 1
    styles = np.zeros((n, T, cfg.num_styles), np.float32)
    styles[..., 0] = 1
    return Dataset(rolls[:, :-1], rolls[:, 1:], beats, styles)


def probe_h2d(device: torch.device, mb: int = 256, reps: int = 3) -> dict:
    """Median host-to-device copy rates in MB/s, from pageable and from
    pinned host memory (fresh values each rep)."""
    out = {}
    for kind in ("pageable", "pinned"):
        rates = []
        for rep in range(reps):
            buf = torch.full(((mb << 20) // 4,), float(rep + 1),
                             pin_memory=kind == "pinned"
                             and device.type == "cuda")
            synchronize(device)
            t0 = time.perf_counter()
            dev = buf.to(device)
            synchronize(device)
            rates.append(mb / (time.perf_counter() - t0))
            del dev
        out[kind] = sorted(rates)[reps // 2]
    return out


def run_epochs(ds: Dataset, cfg, device: torch.device, mode_cfg: dict,
               epochs: int, tag: str) -> dict:
    """`epochs` epochs through the stock Trainer.fit: the mode it chose
    and the rate of each epoch (the first carries the set-up: staging the
    resident corpus, building the kernels)."""
    trainer = Trainer(build_model(cfg, device, trainable=True),
                      TrainConfig(checkpoint=False, tensorboard=False,
                                  **mode_cfg))
    t0 = time.perf_counter()
    h = trainer.fit(ds, epochs=epochs)
    total = time.perf_counter() - t0
    T = ds.notes.shape[1]
    rates = [s * h["batch_size"] * T / dt
             for s, dt in zip(h["steps_per_epoch"], h["epoch_seconds"])]
    steady = rates[1:] or rates
    out = {
        "tag": tag,
        "epoch_scan_mode": h["epoch_scan_mode"],
        "epochs": epochs,
        "steps_per_epoch": h["steps_per_epoch"][0],
        "epoch_seconds": h["epoch_seconds"],
        "timesteps_per_sec_per_epoch": rates,
        "steady_timesteps_per_sec": sorted(steady)[len(steady) // 2],
        "total_seconds": total,
        "losses": h["loss"],
    }
    print(tag, json.dumps(out))
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Resident and segment training rates on a large "
                    "synthetic corpus.")
    parser.add_argument("--gb", type=float, default=4.3,
                        help="corpus size in GiB (default 4.3)")
    parser.add_argument("--epochs", type=int, default=4,
                        help="resident epochs (the first carries set-up)")
    parser.add_argument("--seg-epochs", type=int, default=2,
                        help="epochs of the forced segment run")
    parser.add_argument("--seg-budget-gb", type=float, default=1.0,
                        help="epoch_scan_max_bytes in GiB for the segment "
                             "run (below --gb)")
    parser.add_argument("--skip-segments", action="store_true")
    parser.add_argument("--out", default=os.path.join("runs",
                                                      "big_corpus.json"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on (default: cuda; a missing "
                             "card is an error, pass cpu to run on the CPU)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = default_config()
    t0 = time.perf_counter()
    ds = build_corpus(args.gb, cfg)
    ds_bytes = sum(int(a.nbytes) for a in
                   (ds.notes, ds.targets, ds.beats, ds.styles))
    print(f"corpus: {len(ds)} windows, {ds_bytes / (1 << 30):.3f} GiB "
          f"({time.perf_counter() - t0:.1f} s to build)")
    results = {
        "device": card_line() if device.type == "cuda" else "cpu",
        "corpus_gib": ds_bytes / (1 << 30),
        "windows": len(ds),
        "batch_size": cfg.batch_size,
        "h2d_MBps": probe_h2d(device),
    }
    print("host-to-device copy:", results["h2d_MBps"], "MB/s")

    resident = run_epochs(ds, cfg, device, {}, args.epochs, "resident")
    if resident["epoch_scan_mode"] != "replicated":
        raise SystemExit(f"the resident run chose "
                         f"{resident['epoch_scan_mode']!r}, not "
                         f"'replicated'")
    results["resident"] = resident
    if not args.skip_segments:
        budget = int(args.seg_budget_gb * (1 << 30))
        if budget >= ds_bytes:
            raise SystemExit(f"--seg-budget-gb {args.seg_budget_gb} does "
                             f"not force segments on a "
                             f"{ds_bytes / (1 << 30):.3f} GiB corpus")
        seg = run_epochs(ds, cfg, device,
                         {"epoch_scan_max_bytes": budget},
                         args.seg_epochs, "segments")
        if seg["epoch_scan_mode"] != "segments":
            raise SystemExit(f"the segment run chose "
                             f"{seg['epoch_scan_mode']!r}")
        seg["vs_resident"] = (seg["steady_timesteps_per_sec"]
                              / resident["steady_timesteps_per_sec"])
        results["segments"] = seg

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
