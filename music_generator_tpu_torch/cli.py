"""Command-line entry points of the port: `train`, `generate`,
`visualize` and `analyze`.

`train` takes the flags of the JAX package's `train_main` that apply
(--epochs, --seed, --no-resume, --profile, --from-keras) plus `--device`;
it trains on the corpus under the config's style directories and keeps
the best checkpoint in `out/model.pt`.  `generate` has the flags of the JAX
package's `generate_main` (ref: generate.py:137-148), among them
`--from-keras`, `--prime`, `--prime-bars` and `--continuation-only`
(primed continuation), plus `--device` and `--params`.  `visualize`
writes the style-embedding TSVs (ref: visualize.py:11-43); `analyze`
prints the corpus statistics of `data/analysis.py`.

Orbax checkpoints cannot be read without JAX, so weights come from a
reference Keras 2 `model.h5` (`--from-keras`, training/keras_import.py,
read by the port's own HDF5 reader), or a keystr-layout `.npz`
(`--params`, params.py), else from `out/model.pt` when a training run left
one (printing "Loaded model from file.", as the JAX package's
`build_or_load` does), else fresh weights drawn from a seeded
torch.Generator.  `--from-keras` and `--params` exclude each other.

Under `torchrun --nproc_per_node=N` (one process per card, parallel/
mesh.py) `train` joins the process group before any CUDA call, trains on
its `Dataset.shard` with the gradients all-reduced every step, and rank 0
alone writes the checkpoint; `generate` spreads the streams over the ranks
and rank 0 alone writes the .mid files (the bytes of the one-process run).
Each rank's device is then `cuda:LOCAL_RANK` unless `--device` names one.
Without torchrun an entry point runs on one card in one process.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.data.analysis import analyze_corpus
from music_generator_tpu_torch.data.dataset import (compute_genre,
                                                    decode_prime, load_all)
from music_generator_tpu_torch.device import resolve_device
from music_generator_tpu_torch.generation.sampler import (GenerationResult,
                                                          Sampler,
                                                          prepend_prime,
                                                          write_file)
from music_generator_tpu_torch.models.deepj import DeepJ, build_model
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.params import load_params_npz
from music_generator_tpu_torch.training.checkpoint import (build_or_load,
                                                           model_path)
from music_generator_tpu_torch.training.keras_import import load_keras_weights
from music_generator_tpu_torch.training.trainer import TrainConfig, Trainer
from music_generator_tpu_torch.utils import one_hot


def _device_flag(parser: argparse.ArgumentParser, what: str) -> None:
    parser.add_argument("--device", type=str, default=None,
                        help=f"Device to {what} on (default: cuda, under "
                             f"torchrun cuda:LOCAL_RANK; a missing card is "
                             f"an error, pass cpu to run on the CPU)")


def _join(device_flag) -> torch.device:
    """Join the process group a launcher describes (before any CUDA
    call), then resolve the entry point's device: --device, else this
    rank's card under torchrun, else cuda."""
    if mesh.maybe_init_distributed(device_flag) and device_flag is None:
        return resolve_device(mesh.local_device())
    return resolve_device(device_flag)


def train_main(argv=None) -> dict:
    """Train on the corpus under the config's style directories; returns
    the fit history."""
    parser = argparse.ArgumentParser(description="Trains the model.")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Max epochs (default: config value, 1000)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-resume", action="store_true",
                        help="Skip loading an existing checkpoint")
    parser.add_argument("--profile", action="store_true",
                        help="Write a profiler trace of early steps (steps "
                             "5-10 of epoch 0, a Chrome trace under "
                             "out/logs/profile)")
    parser.add_argument("--from-keras", type=str, default=None,
                        metavar="MODEL_H5",
                        help="Warm-start from a reference (Keras 2) "
                             "model.h5 (optimizer state starts fresh, step "
                             "0; takes precedence over resuming)")
    _device_flag(parser, "train")
    args = parser.parse_args(argv)

    device = _join(args.device)
    cfg = default_config()
    model = DeepJ(cfg, device)

    print("Loading data")
    ds = load_all(cfg.styles, cfg.seq_len, cfg)
    print(f"{len(ds)} training windows")
    if mesh.world() > 1:
        ds = ds.shard(mesh.rank(), mesh.world())
        print(f"rank {mesh.rank()} of {mesh.world()}: {len(ds)} windows "
              f"of the shard on {device}")
    trainer = Trainer(model, TrainConfig(seed=args.seed,
                                         profile=args.profile))
    if args.from_keras:
        model.load_state_dict(load_keras_weights(args.from_keras, cfg))
        print(f"Warm-started from Keras weights: {args.from_keras}")
    elif not args.no_resume:
        trainer.maybe_restore()
    print("Training on", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu")
    return trainer.fit(ds, epochs=args.epochs)


def generate_main(argv=None) -> list:
    """Generate and write one .mid per style mixture; returns the paths."""
    parser = argparse.ArgumentParser(description="Generates music.")
    parser.add_argument("--bars", default=32, type=int,
                        help="Number of bars to generate")
    parser.add_argument("--styles", default=None, type=int, nargs="+",
                        help="Styles to mix together")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--out", type=str, default="output",
                        help="Output file name prefix")
    parser.add_argument("--sweep", type=int, nargs=3, default=None,
                        metavar=("STYLE_A", "STYLE_B", "N"),
                        help="Generate N samples interpolating the style "
                             "mixture from STYLE_A to STYLE_B in parallel")
    parser.add_argument("--quantize-volume", action="store_true",
                        help="Snap sampled volumes to the 1/127 MIDI "
                             "velocity grid (opt-in deviation #9; changes "
                             "the sampled bytes)")
    parser.add_argument("--keras2-gates", action="store_true",
                        help="Run LSTM gates with Keras 2's hard_sigmoid "
                             "(clip(0.2x+0.5,0,1)) instead of sigmoid "
                             "(deviation #12)")
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--params", type=str, default=None, metavar="NPZ",
                         help="Weights as a keystr-layout .npz (e.g. "
                              "artifacts/trained_model_r4/params.npz; not "
                              "with --from-keras).  Without either the "
                              "model loads out/model.pt when a training "
                              "run left one, else starts from fresh "
                              "Keras-default weights drawn from a "
                              "torch.Generator seeded with --seed: the same "
                              "distributions as the JAX package's "
                              "init_params, not its bits")
    weights.add_argument("--from-keras", type=str, default=None,
                         metavar="MODEL_H5",
                         help="Load weights from a reference (Keras 2) "
                              "model.h5 instead of out/model.pt (not with "
                              "--params)")
    parser.add_argument("--prime", type=str, default=None, metavar="MIDI",
                        help="Continue composing from an existing .mid "
                             "file: the streaming state is teacher-forced "
                             "through it, then --bars NEW bars are "
                             "generated from where it leaves off")
    parser.add_argument("--prime-bars", type=int, default=None,
                        help="Use only the first K bars of --prime")
    parser.add_argument("--continuation-only", action="store_true",
                        help="With --prime: write only the newly generated "
                             "bars instead of prime + continuation")
    _device_flag(parser, "generate")
    args = parser.parse_args(argv)

    device = _join(args.device)
    cfg = default_config()
    if args.quantize_volume:
        cfg = cfg.replace(gen_volume_quantize=True)
    if args.keras2_gates:
        cfg = cfg.replace(lstm_recurrent_activation="hard_sigmoid")
    if args.from_keras:
        model = build_model(cfg, device, state=load_keras_weights(
            args.from_keras, cfg))
        print(f"Loaded Keras weights from {args.from_keras}")
    elif args.params:
        model = build_model(cfg, device, state=load_params_npz(args.params))
        print(f"Loaded weights from {args.params}")
    elif os.path.isfile(model_path(cfg)):
        model, _ = build_or_load(cfg, device, seed=args.seed)
    else:
        model = build_model(cfg, device, seed=args.seed)
        print(f"Fresh weights from torch seed {args.seed}")

    # Default: one generation per genre's uniform composer mixture;
    # --styles: a single mean-of-one-hots mixture (ref: generate.py:144-148);
    # --sweep: N parallel generations interpolating two styles' weights.
    styles = [compute_genre(i, cfg) for i in range(len(cfg.genres))]
    if args.styles:
        styles = [np.mean([one_hot(i, cfg.num_styles) for i in args.styles],
                          axis=0)]
    elif args.sweep:
        a, b, n = args.sweep
        sa, sb = one_hot(a, cfg.num_styles), one_hot(b, cfg.num_styles)
        ws = np.linspace(0.0, 1.0, max(2, n))
        styles = [(1 - w) * sa + w * sb for w in ws]

    print("Generating with styles:", [int(np.argmax(s)) for s in styles],
          "on", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu")
    if mesh.world() > 1:
        print(f"Sharding {len(styles)} generations over {mesh.world()} "
              f"ranks (rank {mesh.rank()} on {device})")
    sampler = Sampler(model, default_temp=args.temperature)
    prime = None
    if args.prime:
        try:
            prime = decode_prime(args.prime, args.prime_bars, config=cfg)
        except ValueError as e:
            raise SystemExit(f"--prime {args.prime}: {e}")
        print(f"Priming with {prime.shape[0]} steps "
              f"({prime.shape[0] / cfg.notes_per_bar:g} bars) "
              f"from {args.prime}")
    result = sampler.generate(styles, num_bars=args.bars, seed=args.seed,
                              prime=prime)
    if prime is not None and not args.continuation_only:
        # The whole piece: the clamped prime, then the continuation.
        result = GenerationResult(prepend_prime(result.notes, prime),
                                  result.styles)
    if mesh.rank() != 0:
        return []            # every rank holds the notes; rank 0 writes
    return write_file(args.out, result, cfg)


def analyze_main(argv=None) -> dict:
    """Corpus statistics of the config's style directories, printed as
    JSON and written under `out/analysis/` (numpy only: no device)."""
    parser = argparse.ArgumentParser(
        description="Corpus statistics (note/length distributions, "
                    "autocorrelation) — the working rebuild of the "
                    "reference's distribution.py.")
    parser.parse_args(argv)
    cfg = default_config()
    stats = analyze_corpus(cfg.styles, cfg)
    print(json.dumps(stats, indent=2))
    return stats


def visualize_main(argv=None) -> tuple:
    """Write the style embeddings and their labels as TSVs for
    projector.tensorflow.org; returns the two paths."""
    parser = argparse.ArgumentParser(
        description="Exports style embeddings for projector.tensorflow.org.")
    parser.add_argument("--from-keras", type=str, default=None,
                        metavar="MODEL_H5",
                        help="Visualize a reference (Keras 2) model.h5's "
                             "style embeddings instead of out/model.pt")
    _device_flag(parser, "compute the embeddings")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = default_config()
    if args.from_keras:
        model = build_model(cfg, device, state=load_keras_weights(
            args.from_keras, cfg))
        print(f"Loaded Keras weights from {args.from_keras}")
    else:
        model, _ = build_or_load(cfg, device)

    # The 'style' Dense layer on the identity over all styles (ref:
    # visualize.py:16-23), as the JAX package's `DeepJ.style_embedding`
    # computes it on a Keras file's weights: input, kernel and bias rounded
    # to the config's compute dtype (bfloat16 by default), the product and
    # the sum in float32 (those weights are numpy arrays, and numpy's
    # bfloat16 matmul returns float32).
    dt, layer = model._dt(), model.style_embed
    identity = torch.eye(cfg.num_styles, device=model.device)
    with torch.no_grad():
        embedding = (identity.to(dt).float() @ layer.kernel.to(dt).float()
                     + layer.bias.to(dt).float())
    embedding = embedding.cpu().numpy()

    os.makedirs(cfg.out_dir, exist_ok=True)
    vec_path = os.path.join(cfg.out_dir, "style_embedding_vec.tsv")
    np.savetxt(vec_path, embedding, delimiter="\t")

    # Labels TSV: genre + artist columns with header (ref: visualize.py:26-43).
    labels = [[g] * len(cfg.styles[i]) for i, g in enumerate(cfg.genres)]
    labels = [y for x in labels for y in x]
    style_labels = [os.path.basename(y) for x in cfg.styles for y in x]
    rows = [["Genre", "Artist"]] + list(map(list, zip(labels, style_labels)))
    label_path = os.path.join(cfg.out_dir, "style_embedding_labels.tsv")
    with open(label_path, "w") as f:
        for row in rows:
            f.write("\t".join(row) + "\n")
    print("Wrote", vec_path, "and", label_path)
    return vec_path, label_path
