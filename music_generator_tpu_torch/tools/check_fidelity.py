"""Card-against-CPU certificate of the port's generation (after the JAX
package's tools/check_fidelity.py): .mid files generated on the card at a
fixed seed must hold the same notes as the port's own CPU run with the
same weights and seed, byte identity reported beside event identity.

    python -m music_generator_tpu_torch.tools.check_fidelity \
        --out runs/fidelity_torch [--seeds 0 1 ...] [--bars 4]

The first invocation copies the weights to <out>/params.npz (the trained
r4 checkpoint unless told otherwise; a pre-seeded <out>/params.npz wins
only for that default), generates the seed/style matrix on --device under
<out>/<device>-unpadded/ and <out>/<device>-padded/, then runs itself
again in a child process with `--phase cpu-child --device cpu` (every
wrapper's plain version, the oracle) into <out>/cpu/, compares the files
and writes <out>/FIDELITY.json.

Variants:
  unpadded  the main path: on the card every pitch loop is one launch of
            the notegen kernel (ops/notegen.py);
  padded    the same with every batch padded to 8 streams (the serving
            bucket shape); equal to the unpadded run since the uniforms
            are keyed by stream index (deviation #10);
  bf16      the control: generation at gen_dtype="bfloat16" (the pitch
            loop on the kernel's bfloat16 instance), held against the same
            float32 CPU run, which measures what the float32 discipline
            buys (the JAX tool's bf16 variant, docs/FIDELITY.md).
Each variant's matrix: per seed a solo stream (G = 1), the 3 genres, and a
primed continuation of the solo run's first half (teacher-forced, then
continued at absolute steps).  The report's `<device>_vs_cpu`,
`padded_vs_cpu` and `bf16_vs_cpu` hold file counts, byte mismatches and
event (play and replay) mismatches.

The JAX tool's other variants do not apply: `mesh8` (its 8 virtual CPU
devices; the port's data parallelism is one process a card, which
chip_smoke.py phase 3m holds to one process) and `fused` (in float32 the
notegen kernel is the only pitch loop, so it is the unpadded variant).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from music_generator_tpu_torch.cli import _device_flag
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.data.dataset import compute_genre, unclamp_midi
from music_generator_tpu_torch.device import resolve_device
from music_generator_tpu_torch.generation.sampler import Sampler
from music_generator_tpu_torch.midi import (midi_decode, midi_encode,
                                            read_midifile, write_midifile)
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import (load_params_npz,
                                              save_params_npz)
from music_generator_tpu_torch.utils import one_hot

SEEDS = (0, 1, 2, 3, 4, 5, 6, 7)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAINED_PARAMS = os.path.join(ROOT, "artifacts", "trained_model_r4",
                              "params.npz")


def generate_suite(out_dir: str, variant: str, params_npz: str,
                   temperature: float = 1.0, bars: int = 4,
                   quantize_volume: bool = False, seeds=SEEDS,
                   device="cuda") -> None:
    """Generate the seed/style matrix into out_dir on `device`: variant
    'unpadded', 'padded' (every batch padded to 8 streams) or 'bf16'
    (gen_dtype="bfloat16").  Without params_npz, fresh weights from torch
    seed 0 are drawn and saved there first, so the child reads the same
    ones."""
    dev = resolve_device(device)
    cfg = default_config().replace(gen_volume_quantize=quantize_volume)
    if variant == "bf16":
        cfg = cfg.replace(gen_dtype="bfloat16")
    if os.path.exists(params_npz):
        state = load_params_npz(params_npz)
    else:
        state = build_model(cfg, "cpu", seed=0).state_dict()
        save_params_npz(state, params_npz)
    sampler = Sampler(build_model(cfg, dev, state=state))
    pad_to = 8 if variant == "padded" else None
    os.makedirs(out_dir, exist_ok=True)
    print(f"[{dev.type}/{variant}] generating into {out_dir}", flush=True)

    def write(roll, name):
        write_midifile(os.path.join(out_dir, name),
                       midi_encode(unclamp_midi(roll, cfg), config=cfg))

    for seed in seeds:
        # A single stream (G = 1) and the CLI's 3-genre batch (G = 3).
        solo = None
        for tag, styles in (("solo", [one_hot(0, cfg.num_styles)]),
                            ("genres", [compute_genre(g, cfg)
                                        for g in range(3)])):
            result = sampler.generate(styles, num_bars=bars, seed=seed,
                                      temperature=temperature, pad_to=pad_to)
            if tag == "solo":
                solo = result.notes
            for i in range(result.notes.shape[0]):
                write(result.notes[i], f"{tag}_{seed}_{i}.mid")
        # Primed continuation: teacher-forced through the solo run's first
        # half (certified by the solo row), then continued.
        prime = solo[0, :(bars // 2) * cfg.notes_per_bar]
        result = sampler.generate([one_hot(0, cfg.num_styles)],
                                  num_bars=bars - bars // 2, seed=seed,
                                  temperature=temperature, pad_to=pad_to,
                                  prime=prime)
        write(np.concatenate([prime, result.notes[0]]),
              f"primed_{seed}_0.mid")


def _events_equal(fa: str, fb: str) -> bool:
    """Event-level identity: the play and replay planes of both decoded
    files (the notes), ignoring volume bytes."""
    cfg = default_config()
    try:
        ra = midi_decode(read_midifile(fa), cfg.midi_max_notes, config=cfg)
        rb = midi_decode(read_midifile(fb), cfg.midi_max_notes, config=cfg)
    except Exception:
        return False
    return ra.shape == rb.shape and bool(
        np.array_equal(ra[..., :2], rb[..., :2]))


def compare_dirs(a: str, b: str) -> dict:
    files = sorted(os.listdir(a))
    if files != sorted(os.listdir(b)):
        raise ValueError(f"file sets differ: {a}, {b}")
    mismatches = [f for f in files
                  if open(os.path.join(a, f), "rb").read()
                  != open(os.path.join(b, f), "rb").read()]
    # Byte-identical files are event-identical; only byte mismatches need
    # the decode-level comparison.
    event_mismatches = [f for f in mismatches
                        if not _events_equal(os.path.join(a, f),
                                             os.path.join(b, f))]
    return {"files": len(files), "mismatches": mismatches,
            "identical": not mismatches,
            "event_mismatches": event_mismatches,
            "event_identical": not event_mismatches}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Certifies the card's generated .mid files against the "
                    "port's CPU run.")
    parser.add_argument("--out", default="runs/fidelity_torch")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="sampling temperature for the whole suite")
    parser.add_argument("--bars", type=int, default=4,
                        help="piece length per generation")
    parser.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS),
                        help="seeds of the matrix (default 0-7)")
    parser.add_argument("--params", default=TRAINED_PARAMS,
                        help="params .npz to certify (default: the "
                             "committed trained checkpoint, "
                             "artifacts/trained_model_r4/params.npz); a "
                             "pre-seeded <out>/params.npz always wins")
    parser.add_argument("--random-init", action="store_true",
                        help="certify fresh weights (torch seed 0) instead "
                             "of a trained checkpoint")
    parser.add_argument("--quantize-volume", action="store_true",
                        help="certify with Config.gen_volume_quantize "
                             "(deviation #9)")
    parser.add_argument("--phase", default="main",
                        choices=["main", "cpu-child"])
    _device_flag(parser, "generate the certified files")
    args = parser.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    params_npz = os.path.join(out, "params.npz")
    suite = dict(temperature=args.temperature, bars=args.bars,
                 quantize_volume=args.quantize_volume, seeds=args.seeds)

    if args.phase == "cpu-child":
        generate_suite(os.path.join(out, "cpu"), "unpadded", params_npz,
                       device="cpu", **suite)
        return {}

    # A params.npz already in <out> is kept only for the default params
    # selection: under an explicit --random-init or --params it would be
    # certified under the wrong params_source.
    preseeded = os.path.exists(params_npz)
    params_source = ("random-init" if args.random_init
                     else f"{params_npz} (pre-seeded)" if preseeded
                     else args.params)
    if preseeded and (args.random_init or args.params != TRAINED_PARAMS):
        raise SystemExit(
            f"{params_npz} already exists and would override the explicit "
            f"--{'random-init' if args.random_init else 'params'}: remove "
            f"it or choose a fresh --out")
    if not preseeded and not args.random_init:
        if not os.path.exists(args.params):
            raise SystemExit(f"--params file not found: {args.params}")
        shutil.copy(args.params, params_npz)
        print(f"certifying trained params from {args.params}")

    dev = resolve_device(args.device)
    for variant in ("unpadded", "padded", "bf16"):
        generate_suite(os.path.join(out, f"{dev.type}-{variant}"), variant,
                       params_npz, device=dev, **suite)
    child = [sys.executable, "-m", "music_generator_tpu_torch.tools."
             "check_fidelity", "--out", out, "--temperature",
             str(args.temperature), "--bars", str(args.bars), "--seeds",
             *map(str, args.seeds), "--phase", "cpu-child", "--device",
             "cpu"] + (["--quantize-volume"] if args.quantize_volume else [])
    subprocess.run(child, check=True, cwd=ROOT)

    report = {"device": dev.type, "seeds": list(args.seeds),
              "bars": args.bars, "temperature": args.temperature,
              "quantize_volume": args.quantize_volume,
              "params_source": params_source,
              f"{dev.type}_vs_cpu": compare_dirs(
                  os.path.join(out, f"{dev.type}-unpadded"),
                  os.path.join(out, "cpu")),
              "padded_vs_cpu": compare_dirs(
                  os.path.join(out, f"{dev.type}-padded"),
                  os.path.join(out, "cpu")),
              "bf16_vs_cpu": compare_dirs(
                  os.path.join(out, f"{dev.type}-bf16"),
                  os.path.join(out, "cpu"))}
    with open(os.path.join(out, "FIDELITY.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
