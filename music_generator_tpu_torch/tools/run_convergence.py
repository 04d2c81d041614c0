"""Train to early stop on the synthetic corpus, generate from the best
checkpoint and score the samples (the JAX package's
tools/run_convergence.py).

    python -m music_generator_tpu_torch.tools.run_convergence \
        [--run-dir runs/convergence_torch] [--styles 0 1 3 4 9 10] \
        [--files-per-style 3] [--bars 16] [--epochs 200] [--patience 5] \
        [--sample-bars 16] [--temperature 0.75] [--device cuda]

Writes a deterministic synthetic corpus (data/synth.py) into the run
directory, trains `default_config()` there (or the `cfg` a caller of `main`
passes) until early stop with the best-loss checkpoint, generates
--sample-bars bars per style from that checkpoint at --temperature, seed 0,
and scores each sample's pitch-class histogram against its own style's
corpus piece and the others'.  Everything lands under --run-dir:

  out/logs/metrics.jsonl   per-step and per-epoch losses
  out/model.pt             the best-loss checkpoint
  out/samples/*.mid        one generated piece per style
  report.json              the loss curve, the fidelity scores, the
                           throughput, and the card's name and power limit

A fresh run directory trains from scratch; one that holds a checkpoint
resumes from it, as the train entry point does.  Runs on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from music_generator_tpu_torch.config import Config


def fidelity_record(style_id: int, gen: np.ndarray, styles, bars: int,
                    cfg: Config, sample: str) -> dict:
    """One style's scores for a generated roll `gen` [T, N, 3]: its
    pitch-class overlap with its own style's corpus piece (seed 0, `bars`
    bars) and the largest with any other style's, its note count, and the
    replay rates of the sample and of the corpus piece, both on the raw
    rolls (a decoded .mid reads no replays: the codec's same-instant
    off/on pairs land on one frame)."""
    from music_generator_tpu_torch.data.synth import (pitch_class_histogram,
                                                      synth_piece)

    def corpus(s):
        return synth_piece(s, bars=bars, seed=0,
                           config=cfg)[:, cfg.min_note:cfg.max_note]

    h_gen = pitch_class_histogram(gen)
    own = corpus(style_id)
    others = [float(np.minimum(h_gen, pitch_class_histogram(corpus(s))).sum())
              for s in styles if s != style_id]
    return {
        "style": int(style_id),
        "notes": int(gen[..., 0].sum()),
        "own_overlap": float(np.minimum(h_gen,
                                        pitch_class_histogram(own)).sum()),
        "max_other_overlap": max(others) if others else None,
        "replay_rate": float(gen[..., 1].sum()
                             / max(1, (gen[..., 0] > 0).sum())),
        "corpus_replay_rate": float(own[..., 1].sum()
                                    / max(1, (own[..., 0] > 0).sum())),
        "sample": sample,
    }


def main(argv=None, cfg: Optional[Config] = None) -> dict:
    """Run the tool; `cfg` replaces default_config() (the tests pass a small
    one).  Returns the report."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--run-dir", default="runs/convergence_torch")
    parser.add_argument("--styles", type=int, nargs="*",
                        default=[0, 1, 3, 4, 9, 10])   # 2 per genre
    parser.add_argument("--files-per-style", type=int, default=3)
    parser.add_argument("--bars", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--patience", type=int, default=5)
    parser.add_argument("--sample-bars", type=int, default=16)
    parser.add_argument("--temperature", type=float, default=0.75)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.data.dataset import load_all
    from music_generator_tpu_torch.data.synth import write_synth_corpus
    from music_generator_tpu_torch.device import resolve_device
    from music_generator_tpu_torch.generation.sampler import (Sampler,
                                                              write_file)
    from music_generator_tpu_torch.models.deepj import DeepJ
    from music_generator_tpu_torch.tools.common import (card_line,
                                                        steady_epoch)
    from music_generator_tpu_torch.training.checkpoint import build_or_load
    from music_generator_tpu_torch.training.trainer import (TrainConfig,
                                                            Trainer)
    from music_generator_tpu_torch.utils import one_hot

    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else None
    print("device:", dev, card or "")
    cfg = cfg or default_config()

    run_dir = os.path.abspath(args.run_dir)
    os.makedirs(run_dir, exist_ok=True)
    here = os.getcwd()
    os.chdir(run_dir)
    try:
        write_synth_corpus(".", styles=args.styles,
                           files_per_style=args.files_per_style,
                           bars=args.bars, config=cfg)
        t0 = time.time()
        ds = load_all(config=cfg)
        print(f"{len(ds)} training windows (loaded in "
              f"{time.time() - t0:.1f}s)")

        trainer = Trainer(DeepJ(cfg, dev),
                          TrainConfig(epochs=args.epochs,
                                      patience=args.patience))
        trainer.maybe_restore()
        t0 = time.time()
        history = trainer.fit(ds)
        train_s = time.time() - t0
        epochs_run = len(history["loss"])
        median_epoch_s, steady_rate = steady_epoch(history, cfg.seq_len)
        print(f"trained {epochs_run} epochs in {train_s:.0f}s; loss "
              f"{history['loss'][0]:.4f} -> {min(history['loss']):.4f}")

        # -- generate from the best checkpoint ------------------------------
        model, loaded = build_or_load(cfg, dev)
        if not loaded:
            raise RuntimeError("the best checkpoint did not restore")
        result = Sampler(model).generate(
            [one_hot(s, cfg.num_styles) for s in args.styles],
            num_bars=args.sample_bars, seed=0, temperature=args.temperature)
        paths = write_file("trained", result, cfg)

        fidelity = []
        for i, style_id in enumerate(args.styles):
            rec = fidelity_record(style_id, result.notes[i], args.styles,
                                  args.bars, cfg, paths[i])
            fidelity.append(rec)
            print(f"style {style_id}: own={rec['own_overlap']:.3f} "
                  f"max_other={rec['max_other_overlap']} "
                  f"notes={rec['notes']} replay={rec['replay_rate']:.4f} "
                  f"(corpus {rec['corpus_replay_rate']:.4f})")

        report = {
            "backend": dev.type,
            "card": card,
            "config": ("default_config (flagship dims)"
                       if cfg == default_config() else "caller's config"),
            "windows": len(ds),
            "epochs_run": epochs_run,
            "first_loss": history["loss"][0],
            "best_loss": min(history["loss"]),
            "loss_curve": history["loss"],
            "train_seconds": train_s,
            "median_epoch_seconds": median_epoch_s,
            "steady_epoch_timesteps_per_sec": steady_rate,
            "epoch_scan_mode": history["epoch_scan_mode"],
            "fidelity": fidelity,
        }
        with open("report.json", "w") as f:
            json.dump(report, f, indent=2)
        print("report written to", os.path.join(run_dir, "report.json"))
    finally:
        os.chdir(here)
    return report


if __name__ == "__main__":
    main()
