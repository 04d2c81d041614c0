"""The readings that a cell's limits are set from: for each seed, the
numbers that a run compares, read for the program, for the control (the
reference in the precision below the configuration's) and for planted
faults, each against the float32 reference.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 \
        [--out chiprun_out/control.json]

Training cells: the program's first three steps (set-up of a run), the
control in float8 e4m3 products (the configuration trains in bfloat16),
and the fault "half of the batch left out, the loss the mean over the
rest" planted in the reference.  A step that returns its state unchanged
reads 1 on `change_gap` by that number's measure and needs no run.
Generation cells: one call at the cell's size, the control with TF32 on
(the configuration generates in float32 with TF32 off) choosing the
draws, and the fault "a note altered where it is produced": one draw of
each sampled stream flipped, at a place drawn from the seed.  Served
cells: a window of `--seconds` of the cell's arrivals, the control and
the same fault on the pieces decoded from the service's answers.

The benchmark's runs do not run this; `portbench/tests/` holds it as a
test on the card.  Each seed's readings are one JSON line on stdout."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from portbench import run as pr
from portbench.drivers import generate as gd
from portbench.drivers import serve as sd
from portbench.drivers import train as td
from portbench.drivers.common import sub_seed
from portbench.reference import deepj as ref


def _run(root: Path, workload: str, seed: int, device) -> pr.Run:
    bench = pr.load_json(root / "BENCHMARK.json")
    cell = pr._cell(bench, workload)
    pb = root / "portbench"
    return pr.Run(root, cell,
                  pr.load_json(pb / "configs" / f"{cell['config']}.json"),
                  pr.load_json(pb / "traffic" / f"{cell['traffic']}.json"),
                  seed, 0.0, False, device, 0.0)


def train_readings(r: pr.Run) -> dict:
    ctx = td.setup(r)
    got, weights, batches = ctx.readings, ctx.weights, ctx.batches
    half = ctx.B // 2
    del ctx
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    seed = sub_seed(r.seed, 3)
    want = ref.train_readings(weights, r.model, batches, seed, ref.Arith())
    ctrl = ref.train_readings(weights, r.model, batches, seed,
                              ref.Arith("fp8"))
    halved = ref.train_readings(weights, r.model, batches, seed,
                                ref.Arith(), loss_rows=half)
    return {"program": td.train_gaps(got, want, r.log),
            "control": td.train_gaps(ctrl, want),
            "half_batch": td.train_gaps(halved, want)}


def generate_readings(r: pr.Run) -> dict:
    ctx = gd.setup(r)
    notes = gd.one_call(r, ctx, 0)
    weights = ctx.weights
    del ctx
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(sub_seed(r.seed, 12))
    streams = sorted(rng.choice(len(notes), r.traffic["check_streams"],
                                replace=False))
    sample = [(0, int(g), notes[g]) for g in streams]
    altered = []
    for c, g, n in sample:
        n = n.copy()
        t, p = rng.integers(n.shape[0]), rng.integers(n.shape[1])
        n[t, p, 0] = 1.0 - n[t, p, 0]
        n[t, p, 1:] = 0.0 if n[t, p, 0] == 0 else n[t, p, 1:]
        altered.append((c, g, n))
    return {"program": gd.gaps(r, weights, sample, ref.Arith()),
            "control": gd.gaps(r, weights, sample, ref.Arith(),
                               decide=ref.Arith("tf32")),
            "altered_note": gd.gaps(r, weights, altered, ref.Arith())}


def serve_readings(r: pr.Run) -> dict:
    ctx = sd.start(r)
    reqs = sd.schedule(r.traffic, r.model, r.seed, r.seconds)
    w = sd.window(r, ctx, reqs)
    weights = ctx.weights
    sd.stop(ctx)
    sample = sd.pick(r, reqs, w.done)
    rng = np.random.default_rng(sub_seed(r.seed, 12))

    def alter(play, replay, vel):
        for i, q in enumerate(sample):
            t = rng.integers(q["bars"] * r.model["notes_per_bar"])
            n = rng.integers(play.shape[2])
            play[i, t, n] = 1 - play[i, t, n]
            replay[i, t, n], vel[i, t, n] = (-1, -1) if play[i, t, n] \
                else (0, -1)
    return {"p95_ms": sd.p95(w.lat), "failed": len(reqs) - len(w.done),
            "program": sd.served_readings(r, weights, sample, w.done,
                                          ref.Arith()),
            "control": sd.served_readings(r, weights, sample, w.done,
                                          ref.Arith(),
                                          decide=ref.Arith("tf32")),
            "altered_note": sd.served_readings(r, weights, sample, w.done,
                                               ref.Arith(), alter=alter)}


def readings(root: Path, workload: str, seed: int, device,
             seconds: float = 0.0) -> dict:
    r = _run(root, workload, seed, device)
    r.seconds = seconds
    fn = {"train": train_readings, "generate": generate_readings,
          "serve": serve_readings}[r.traffic["driver"]]
    return {"workload": workload, "seed": seed, **fn(r)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the arrivals' span of a served cell's window")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = []
    for seed in args.seeds:
        line = readings(Path.cwd(), args.workload, seed, device,
                        args.seconds)
        print(json.dumps(line), flush=True)
        out.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
