"""Hold other builds of the pitch-loop kernel's source to this tree's on the
card: every phase-2b case bit for bit, then depth-2 times in turns.

    python -m music_generator_tpu_torch.tools.notegen_ab \
        --other parent=path/to/notegen.cu [--other NAME=PATH ...] \
        [--reps 50] [--rounds 2] [--out runs/notegen_ab.json]

Each `--other` source (for example csrc/notegen.cu of another commit,
unpacked with `git archive`) is compiled with the wrapper's nvcc flags
beside the wrapper's own build, all nvcc processes at once, and bound
with ops/notegen.py's signatures.  Then, on the r4 weights
(tools/common.py::depth_params) at default_config()'s widths:

  * bits: the cases of chip_smoke.py phase 2b (depths 1, 2, 3 and 6,
    G = 3 and 64, both bfloat16 flavors, both gate flavors, quantize on
    and off, at depth 2 also bfloat16 features; the same seeded inputs)
    through the cluster kernel of this tree and of every other build:
    the count of outputs equal bit for bit, of all of them;
  * times: at depth 2, G = 3 and 64, the float32 instance and both
    bfloat16 flavors on one set of inputs, each build in turns (the
    builds in order, then in reverse, --rounds times, each turn the mean
    of --reps launches by CUDA events), with block 0's clock cycles per
    pitch by phase from one profiled launch of each build.

Exits non-zero when an output differs.  The card's name and power limit
head the JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.generation.sampler import _velocity_grid
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import _build, notegen
from music_generator_tpu_torch.params import params_from_numpy
from music_generator_tpu_torch.tools.common import (card_line, cuda_ms,
                                                    depth_params,
                                                    notegen_inputs)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
R4 = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
PHASES = ("h0 U0", "wait for the draw, z0 and cells", "h0 exchange and "
          "barrier 1", "layer 1 with cells", "h1 exchange and barrier 2",
          "heads and draw beside layer 0")


def other_libraries(sources: dict) -> dict:
    """{name: CDLL} of each {name: (source, extra nvcc flags)} built with
    the wrapper's nvcc flags beside the wrapper's own library (every nvcc
    process started first; a library named by a hash of its source and
    flags is built once), bound with notegen's signatures."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in sources.items():
        cmd = [*_build.NVCC_FLAGS, *flags]
        digest = hashlib.sha256(Path(src).read_bytes()
                                + " ".join(cmd).encode())
        path = _build.BUILD_DIR / (f"libnotegen_{name}-"
                                   f"{digest.hexdigest()[:12]}.so")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = None if path.exists() else subprocess.Popen(
            [_build.nvcc(), *cmd, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (path, tmp, proc)
    notegen._library()
    libs = {}
    for name, (path, tmp, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {sources[name][0]}:\n"
                                   f"{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for fn, args in notegen._SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = list(args)
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cycles(ops, lib) -> list:
    """Block 0's cycles per pitch by phase (PHASES), then the prologue's
    and the whole launch's cycles, from one launch with `prof`."""
    prof = torch.zeros(14, dtype=torch.int64, device="cuda")
    notegen._launch(ops, False, prof=prof, lib=lib)
    torch.cuda.synchronize()
    pr = prof.tolist()
    return [c / pr[11] for c in pr[:6]] + [pr[6], pr[7]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another notegen.cu")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("notegen_ab runs CUDA kernels: no card")
    others = dict(o.split("=", 1) for o in args.other)
    if not others or "this" in others:
        raise SystemExit("notegen_ab: give --other NAME=PATH (not 'this')")
    libs = {"this": None,
            **other_libraries({n: (p, ()) for n, p in others.items()})}
    cfg = default_config()
    bf16 = torch.bfloat16
    with np.load(R4) as data:
        r4 = {k: data[k] for k in data.files}
    F = cfg.time_axis_units
    vgrid = torch.from_numpy(_velocity_grid(cfg.max_velocity)).cuda()
    out = {"card": card_line(), "others": others, "reps": args.reps,
           "rounds": args.rounds, "phases": PHASES, "cases": [],
           "times": {}}
    equal = {n: 0 for n in others}
    total = 0
    for L in (2, 1, 3, 6):
        model = build_model(cfg.replace(note_axis_layers=L), "cuda",
                            state=params_from_numpy(depth_params(r4, L)))
        heads = (model.note_dense, model.volume_dense)
        weights = notegen.note_weights(model.note_axis, *heads, F)
        for G in (3, 64):
            kinds = [("sigmoid", None, 1.0, torch.float32),
                     ("hard_sigmoid", vgrid, 0.9, torch.float32)]
            if L == 2:
                kinds.append(("sigmoid", None, 1.1, bf16))
            for flavor in ("scan", "fused"):
                for i, (act, grid, T, fdt) in enumerate(kinds):
                    feats, us, temp, emb = notegen_inputs(
                        model, G, T, 3000 + 100 * L + 2 * G + i)
                    ops = notegen._kernel_operands(
                        feats.to(fdt), us, temp, model.note_axis, *heads,
                        emb.to(bf16), grid, bf16, flavor, weights)
                    hard = act == "hard_sigmoid"
                    got = {n: notegen._launch(ops, hard, lib=lib)
                           for n, lib in libs.items()}
                    torch.cuda.synchronize()
                    case = {"L": L, "G": G, "flavor": flavor, "act": act,
                            "quantize": grid is not None,
                            "features": str(fdt)[6:],
                            "outputs": got["this"].numel(),
                            "finite": bool(torch.isfinite(
                                got["this"]).all()),
                            "equal": {}}
                    for n in others:
                        same = int((got[n] == got["this"]).sum())
                        case["equal"][n] = same
                        equal[n] += same
                    total += case["outputs"]
                    out["cases"].append(case)
                    print(f"bits depth {L} G={G} {flavor} {act} quantize="
                          f"{case['quantize']} features "
                          f"{case['features']}: " + ", ".join(
                              f"{n} {s}/{case['outputs']}"
                              for n, s in case["equal"].items()),
                          flush=True)
        if L != 2:
            continue
        for G in (3, 64):
            feats, us, temp, emb = notegen_inputs(model, G, 1.0, 100 + G)
            kinds = {"float32": notegen._kernel_operands(
                feats, us, temp, model.note_axis, *heads, emb, None)}
            for flavor in ("scan", "fused"):
                kinds[flavor] = notegen._kernel_operands(
                    feats, us, temp, model.note_axis, *heads, emb.to(bf16),
                    None, bf16, flavor, weights)
            for kind, ops in kinds.items():
                ms = {n: [] for n in libs}
                order = list(libs) + list(libs)[::-1]
                for _ in range(args.rounds):
                    for n in order:
                        ms[n].append(cuda_ms(
                            lambda: notegen._launch(ops, False, lib=libs[n]),
                            args.reps))
                cyc = {n: cycles(ops, lib) for n, lib in libs.items()}
                out["times"][f"{kind} G={G}"] = {
                    "ms": ms, "mean_ms": {n: float(np.mean(v))
                                          for n, v in ms.items()},
                    "cycles": cyc}
                print(f"times depth 2 G={G} {kind}: " + "; ".join(
                    f"{n} {', '.join(f'{t:.4f}' for t in v)} ms" for n, v
                    in ms.items()) + "; cycles a pitch " + "; ".join(
                        f"{n} [{', '.join(f'{c:.0f}' for c in v[:6])}], "
                        f"prologue {v[6]}, launch {v[7]}"
                        for n, v in cyc.items()), flush=True)
    out["equal"], out["outputs"] = equal, total
    print(f"bits: " + ", ".join(f"{n} {s}/{total}" for n, s in
                                equal.items()) + f" outputs equal to this "
          f"tree's ({out['card']})", flush=True)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if any(s != total for s in equal.values()):
        raise SystemExit("notegen_ab: outputs differ from this tree's")
    return out


if __name__ == "__main__":
    main()
