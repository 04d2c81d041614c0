"""Transpose-augmentation study (the JAX package's
tools/run_augment_study.py): train the same geometry twice on one synthetic
corpus, once plain and once with `Config.transpose_augment` k adding the
+-1..k-semitone copies of every window, and evaluate both best checkpoints
on a (model x family x shift) matrix.

    python -m music_generator_tpu_torch.tools.run_augment_study \
        [--run-dir runs/augment_torch] [--styles 0 1 3] \
        [--files-per-style 3] [--bars 16] [--epochs 120] [--patience 5] \
        [--augment 1] [--device cuda]

The two eval families, each at shifts -1, 0 and +1 semitones (the
transform the augmentation applies):

  train    the training pieces themselves, shifted: the music held fixed,
           so the row reads pitch invariance;
  heldout  pieces of the same styles from disjoint seeds (EVAL_SEED),
           shifted: generalization to new music, which on a corpus this
           small is mostly memorization.

Everything lands under --run-dir: the training corpus in corpus/, the six
eval corpora in eval_<family>_shift<+d>/, each run's checkpoint and logs in
<name>/out/, and report.json with both loss curves, the steady epoch
throughput, the eval matrix and the card's name and power limit.  Runs on
the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

from music_generator_tpu_torch.config import Config

# Disjoint from the training pieces' seeds (0 .. files_per_style - 1): the
# heldout family is new music, not transposed copies of the training set.
EVAL_SEED = 100
SHIFTS = (-1, 0, 1)
FAMILIES = (("train", 0), ("heldout", EVAL_SEED))


def main(argv=None, cfg: Optional[Config] = None) -> dict:
    """Run the study; `cfg` replaces default_config() (the tests pass a
    small one).  Returns the report."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--run-dir", default="runs/augment_torch")
    parser.add_argument("--styles", type=int, nargs="*", default=[0, 1, 3])
    parser.add_argument("--files-per-style", type=int, default=3)
    parser.add_argument("--bars", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("--patience", type=int, default=5)
    parser.add_argument("--augment", type=int, default=1,
                        help="transpose_augment k of the augmented run "
                             "(adds shifts -k..k)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.data.dataset import load_all
    from music_generator_tpu_torch.data.synth import write_synth_corpus
    from music_generator_tpu_torch.device import resolve_device
    from music_generator_tpu_torch.models.deepj import DeepJ
    from music_generator_tpu_torch.tools.common import (card_line,
                                                        steady_epoch)
    from music_generator_tpu_torch.training.trainer import (TrainConfig,
                                                            Trainer)

    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else None
    print("device:", dev, card or "")
    base_cfg = cfg or default_config()
    run_dir = os.path.abspath(args.run_dir)

    # -- corpora: the training set, and both eval families at each shift --
    train_root = os.path.join(run_dir, "corpus")
    corpus = dict(styles=args.styles, files_per_style=args.files_per_style,
                  bars=args.bars, config=base_cfg)
    write_synth_corpus(train_root, **corpus)
    eval_roots = {}
    for family, seed in FAMILIES:
        for shift in SHIFTS:
            root = os.path.join(run_dir, f"eval_{family}_shift{shift:+d}")
            write_synth_corpus(root, seed=seed, shift=shift, **corpus)
            eval_roots[(family, shift)] = root

    here = os.getcwd()
    try:
        # -- both variants on the same corpus ------------------------------
        runs, trainers = {}, {}
        for name, k in (("baseline", 0), ("augmented", args.augment)):
            cfg_k = base_cfg.replace(
                out_dir=os.path.join(run_dir, name, "out"),
                transpose_augment=k)
            os.chdir(train_root)
            ds = load_all(config=cfg_k)
            print(f"[{name}] {len(ds)} training windows "
                  f"(transpose_augment={k})")
            trainer = Trainer(DeepJ(cfg_k, dev),
                              TrainConfig(epochs=args.epochs,
                                          patience=args.patience))
            t0 = time.time()
            history = trainer.fit(ds)
            train_s = time.time() - t0
            # Evaluate the best checkpoint, not the final state that early
            # stop left behind.
            if not trainer.maybe_restore():
                raise RuntimeError(f"[{name}] the best checkpoint did not "
                                   f"restore")
            losses = history["loss"]
            runs[name] = {
                "transpose_augment": k,
                "windows": len(ds),
                "epochs_run": len(losses),
                "first_loss": losses[0],
                "best_loss": min(losses),
                "train_seconds": train_s,
                "steady_epoch_timesteps_per_sec":
                    steady_epoch(history, cfg_k.seq_len)[1],
                "loss_curve": losses,
            }
            trainers[name] = trainer
            print(f"[{name}] loss {losses[0]:.4f} -> {min(losses):.4f} in "
                  f"{len(losses)} epochs, {train_s:.1f} s")

        # -- the (model x family x shift) eval matrix ----------------------
        matrix = {name: {family: {} for family, _ in FAMILIES}
                  for name in trainers}
        for (family, shift), root in sorted(eval_roots.items()):
            os.chdir(root)
            ds_eval = load_all(config=base_cfg.replace(
                out_dir=os.path.join(root, "out")))
            for name, trainer in trainers.items():
                loss = trainer.evaluate(ds_eval)["loss"]
                matrix[name][family][f"shift{shift:+d}"] = loss
                print(f"[{name}] eval {family} shift{shift:+d}: "
                      f"loss={loss:.4f}")
    finally:
        os.chdir(here)

    report = {
        "backend": dev.type,
        "card": card,
        "config": ("default_config (flagship dims)"
                   if base_cfg == default_config() else "caller's config"),
        "styles": args.styles,
        "runs": runs,
        "eval_loss": matrix,
    }
    path = os.path.join(run_dir, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print("report written to", path)
    return report


if __name__ == "__main__":
    main()
