"""Time the pitch-loop kernel's depth-2 instance against its run-time
layer loop on the card, and write the readings as JSON.

    python -m music_generator_tpu_torch.tools.notegen_depth_probe \
        [--reps 100] [--rounds 3] [--out runs/notegen_depth_probe.json]

csrc/notegen.cu instantiates the cluster kernel twice for the float32
instance and for each bfloat16 flavor: with the depth fixed at 2 at
compile time (the a_1 terms, every layer's c and the scan flavor's style
terms in registers), and with a loop to the run-time depth that every
other depth runs.  A build with -DNG_FIXED_DEPTH=0 sends depth 2 through
that loop too.  This tool builds both libraries (the two nvcc processes
together), checks that at depth 2 they draw bit for bit alike (float32,
"scan" and "fused"; both gate flavors), and times one launch of each at
G = 3 and 64 at default_config()'s widths on weights drawn from --seed: in
turns fixed, loop, loop, fixed, --rounds times, each turn the mean of
--reps launches (CUDA events).  The ratio of the loop's time to the fixed
instance's is what the depth-2 instance saves.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.generation.sampler import _velocity_grid
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import _build, notegen
from music_generator_tpu_torch.tools.common import card_line, cuda_ms
from music_generator_tpu_torch.tools.notegen_ab import other_libraries

LOOP_FLAGS = ("-DNG_FIXED_DEPTH=0",)
# The float32 instance and the bfloat16 instances' two flavors.
KINDS = ("float32", "scan", "fused")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("notegen_depth_probe times CUDA kernels: no card")
    cfg = default_config()
    model = build_model(cfg, "cuda", seed=args.seed)
    loop = other_libraries(
        {"loop": (_build.CSRC / "notegen.cu", LOOP_FLAGS)})["loop"]
    heads = (model.note_dense, model.volume_dense)
    F, N = cfg.time_axis_units, cfg.num_notes
    vgrid = torch.from_numpy(_velocity_grid(cfg.max_velocity)).cuda()
    out = {"card": card_line(), "depth": cfg.note_axis_layers,
           "reps": args.reps, "rounds": args.rounds, "G": {}}
    weights = notegen.note_weights(model.note_axis, *heads, F)
    for G in (3, 64):
        gen = torch.Generator().manual_seed(args.seed + G)
        feats = (torch.rand(G, N, F, generator=gen) * 2 - 1).cuda()
        us = torch.rand(G, N, 2, generator=gen).cuda()
        emb = torch.randn(G, cfg.style_units, generator=gen).cuda()
        temp = torch.full((G,), 1.0).cuda()

        def operands(kind, grid):
            if kind == "float32":
                return notegen._kernel_operands(
                    feats, us, temp, model.note_axis, *heads, emb, grid)
            return notegen._kernel_operands(
                feats, us, temp, model.note_axis, *heads,
                emb.to(torch.bfloat16), grid, torch.bfloat16, kind, weights)

        out["G"][str(G)] = {}
        for kind in KINDS:
            for hard, grid in ((False, None), (True, vgrid)):
                ops = operands(kind, grid)
                a = notegen._launch(ops, hard)
                b = notegen._launch(ops, hard, lib=loop)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise SystemExit(f"{kind} G={G} hard={hard}: the "
                                     f"run-time loop draws differently "
                                     f"from the fixed instance")
            ops = operands(kind, None)
            fixed, looped = [], []
            for _ in range(args.rounds):
                for lib, times in ((None, fixed), (loop, looped),
                                   (loop, looped), (None, fixed)):
                    times.append(cuda_ms(
                        lambda: notegen._launch(ops, False, lib=lib),
                        args.reps))
            f_ms, l_ms = float(np.mean(fixed)), float(np.mean(looped))
            out["G"][str(G)][kind] = {
                "fixed_ms": fixed, "loop_ms": looped, "fixed_mean_ms": f_ms,
                "loop_mean_ms": l_ms, "loop_over_fixed": l_ms / f_ms}
            print(f"notegen depth 2, {kind}, G={G}: fixed instance "
                  f"{', '.join(f'{t:.4f}' for t in fixed)} ms/launch, "
                  f"run-time loop {', '.join(f'{t:.4f}' for t in looped)}; "
                  f"loop / fixed {l_ms / f_ms:.4f} (draws bit for bit "
                  f"alike; {out['card']})", flush=True)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return out


if __name__ == "__main__":
    main()
