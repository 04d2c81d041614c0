"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. build every CUDA kernel of the main path from csrc/ (nvcc, all sources
     at once) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's widths;
  3. drive the main path through the CLI's code (generate_main): the
     trained flagship weights, 3 genres, 8 bars, seeds 0 and 1, and check
     the written .mid files against artifacts/short_samples_r4 (event
     identity required, byte identity reported) and that every timestep
     went through the kernel;
     then regenerate more committed samples (real_corpus_r3, the 64-bar
     long_samples_r4) the same way;
  4. time the generation step (and, from a profiled bar, the device's
     share of it), each kernel and its plain version.
The line before the last holds the per-kernel JSON; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
SHORT = os.path.join(ROOT, "artifacts", "short_samples_r4")
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s on the
# CUDA cores (the kernels run float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# More TPU-generated samples the card must reproduce, as each one's
# PROVENANCE/report records it: (weights, style one-hots or None for the 3
# genre mixtures, bars, temperature, committed file pattern); seed 0.
MORE_SAMPLES = [
    ("real_corpus_r3/params.npz", (0, 3, 9), 16, 0.75,
     "real_corpus_r3/real_trained_{}.mid"),
    ("trained_model_r4/params.npz", None, 64, None,
     "long_samples_r4/long_{}.mid"),
]

EDGE = 1e-5          # a draw with |u - p| below this may fall either way
VOLUME_ATOL = 1e-5   # float32 sums in another order: ULP-scale drift


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    log("FAIL:", msg)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check_sample(path: str, ref: str) -> bool:
    """Fail unless the .mid at `path` holds the same note events (play and
    replay) as the committed `ref`; return whether the bytes are equal."""
    from music_generator_tpu_torch.midi import midi_decode, read_midifile
    got = midi_decode(read_midifile(path))
    want = midi_decode(read_midifile(ref))
    same_bytes = open(path, "rb").read() == open(ref, "rb").read()
    events = (got.shape == want.shape
              and bool((got[..., :2] == want[..., :2]).all()))
    log(f"{os.path.relpath(ref, ROOT)}: bytes identical={same_bytes}, "
        f"events identical={events}, {got.shape[0]} steps")
    if not events:
        fail(f"{ref}: the notes differ from the committed sample")
    return same_bytes


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of `fn` on the card: CUDA events around `reps`
    calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def notegen_inputs(model, G: int, T: float, seed: int):
    """Random pitch-loop inputs at the model's widths: time-axis features
    in (-1, 1) like an LSTM's h, uniforms in [0, 1), a style embedding."""
    gen = torch.Generator().manual_seed(seed)
    F = model.cfg.time_axis_units
    N = model.cfg.num_notes
    feats = torch.rand(G, N, F, generator=gen) * 2 - 1
    us = torch.rand(G, N, 2, generator=gen)
    emb = torch.randn(G, model.cfg.style_units, generator=gen)
    temp = torch.full((G,), T)
    return [t.cuda() for t in (feats, us, temp, emb)]


def notegen_bound_ms(G: int, N: int, F: int, H: int):
    """Least time for one pitch loop, and what sets it: every input read
    once and the output written once at HBM rate, or its multiply-adds at
    the float32 peak.  Returns (ms, "bytes" or "operations")."""
    H4 = 4 * H
    floats = (G * N * F + G * N * 2 + G          # feats, uniforms, T
              + F * H4 + 3 * H4 + 3 * H * H4      # W0f, W0c, U0, W1, U1
              + 2 * G * H4                        # a0, a1
              + 3 * H + 3                         # heads
              + G * N * 3)                        # output
    flops = 2 * G * N * (F * H4 + 3 * H4 + 3 * H * H4 + 3 * H)
    t_bytes = 4 * floats / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a machine with a GPU")
        sys.exit(2)

    from music_generator_tpu_torch.cli import generate_main
    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.data.dataset import compute_genre
    from music_generator_tpu_torch.device import full_f32
    from music_generator_tpu_torch.generation.sampler import (
        Sampler, _velocity_grid, write_file)
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.ops import _build, notegen
    from music_generator_tpu_torch.params import load_params_npz
    from music_generator_tpu_torch.utils import one_hot

    log(sys.version.split()[0], "torch", torch.__version__, "cuda",
        torch.version.cuda)
    card = card_line()
    log("card:", card)

    # -- 1. build ----------------------------------------------------------
    t = time.perf_counter()
    (lib,) = _build.build(["notegen"])
    log(f"build: notegen in {time.perf_counter() - t:.1f} s")
    log(open(str(lib) + ".log").read().strip())

    # -- 2. kernel against its plain version --------------------------------
    full_f32()
    cfg = default_config()
    model = build_model(cfg, "cuda", state=load_params_npz(PARAMS))
    l0, l1 = model.note_axis
    heads = (model.note_dense, model.volume_dense)
    vgrid = torch.from_numpy(_velocity_grid(cfg.max_velocity)).cuda()
    max_err = 0.0
    case = 0
    for G in (1, 3, 8, 64):
        for T in (1.0, 0.9):
            for act in ("sigmoid", "hard_sigmoid"):
                for grid in (None, vgrid):
                    case += 1
                    feats, us, temp, emb = notegen_inputs(model, G, T, case)
                    args = (feats, us, temp, l0, l1, *heads, emb, act, grid)
                    got = notegen.note_sample(*args)
                    torch.cuda.synchronize()
                    want = notegen.note_sample_reference(*args)
                    probs = notegen.tempered_probs(feats, got, temp, l0, l1,
                                                   *heads, emb, act)
                    ok, err, report = notegen.draws_agree(
                        got, want, us, probs, EDGE, VOLUME_ATOL)
                    max_err = max(max_err, err)
                    log(f"notegen G={G} T={T} {act} quantize="
                        f"{grid is not None}: max|dv|={err:.3g}, {report}")
                    if not ok or not torch.isfinite(got).all():
                        fail(f"notegen disagrees with its plain version: "
                             f"{report}")
    log(f"notegen: {case} cases agree with the plain version "
        f"(|u-p| edge {EDGE}, volume atol {VOLUME_ATOL})")

    # -- 3. main path --------------------------------------------------------
    os.makedirs(WORK, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(WORK)
    notegen.note_sample.launches = 0
    notegen.note_sample_reference.calls = 0
    paths = {}
    try:
        for seed in (0, 1):
            paths[seed] = generate_main([
                "--params", PARAMS, "--bars", "8", "--seed", str(seed),
                "--out", f"short_s{seed}"])
    finally:
        os.chdir(cwd)
    launches = notegen.note_sample.launches
    plain_calls = notegen.note_sample_reference.calls
    steps = 2 * 8 * cfg.notes_per_bar
    log(f"main path: notegen launches {launches} for {steps} timesteps, "
        f"plain version calls {plain_calls}")
    if launches != steps or plain_calls != 0:
        fail("the main path did not run every timestep through the kernel")
    n_bytes = 0
    for seed, ps in paths.items():
        for i, p in enumerate(ps):
            ref = os.path.join(SHORT, f"short_s{seed}_{i}.mid")
            n_bytes += check_sample(os.path.join(WORK, p), ref)
    log(f"main path: {n_bytes}/6 files byte-identical, 6/6 event-identical")

    # -- 3b. more committed TPU samples, regenerated on the card -------------
    for npz, mix, bars, temp, pattern in MORE_SAMPLES:
        m = build_model(cfg, "cuda", state=load_params_npz(
            os.path.join(ROOT, "artifacts", npz)))
        styles = ([compute_genre(i, cfg) for i in range(3)] if mix is None
                  else [one_hot(s, cfg.num_styles) for s in mix])
        res = Sampler(m).generate(styles, num_bars=bars, seed=0,
                                  temperature=temp)
        out = write_file("more", res, cfg.replace(out_dir=WORK))
        for i, p in enumerate(out):
            check_sample(p, os.path.join(ROOT, "artifacts",
                                         pattern.format(i)))

    # -- 4. times ------------------------------------------------------------
    sampler = Sampler(model)
    for G in (3, 64):
        styles = [compute_genre(i % 3, cfg) for i in range(G)]
        sampler.generate(styles, num_bars=1)          # warm-up
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = sampler.generate(styles, num_bars=16)
            reps.append((time.perf_counter() - t) * 1e3 / res.notes.shape[1])
            if not np.isfinite(res.notes).all():
                fail("non-finite generated notes")
        step = float(np.median(reps))
        # Device time per step from a profiled bar; its share of the
        # unprofiled step time is the device's busy share.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sampler.generate(styles, num_bars=1)
        kernels_us = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels_us[e.key] = e.self_device_time_total
        steps = cfg.notes_per_bar
        device = sum(kernels_us.values()) / 1e3 / steps
        note = sum(v for k, v in kernels_us.items()
                   if "notegen" in k) / 1e3 / steps
        log(f"generate: G={G}, 16 bars: {step:.4f} ms/timestep (median of "
            f"{', '.join(f'{r:.4f}' for r in reps)}); device "
            f"{device:.4f} ms/step (notegen {note:.4f}, rest "
            f"{device - note:.4f}), busy share {device / step:.3f} "
            f"({card})")

    times = {}
    for G in (3, 64):
        feats, us, temp, emb = notegen_inputs(model, G, 1.0, 100 + G)
        args = (feats, us, temp, l0, l1, *heads, emb, "sigmoid", None)
        w0f, w0c, a0, a1 = notegen.fold_style(l0, l1, emb, feats.shape[-1])
        kernel_args = (feats, us, temp, w0f, w0c, a0, l0.lstm.recurrent,
                       l1.lstm.kernel, a1, l1.lstm.recurrent,
                       model.note_dense.kernel, model.note_dense.bias,
                       model.volume_dense.kernel, model.volume_dense.bias,
                       None, False)
        ms = cuda_ms(lambda: notegen._launch(*kernel_args), 50)
        plain = cuda_ms(lambda: notegen.note_sample_reference(*args), 5)
        bound, bound_by = notegen_bound_ms(
            G, cfg.num_notes, cfg.time_axis_units, cfg.note_axis_units)
        times[G] = (ms, plain, bound, bound_by)
        log(f"notegen G={G}: kernel {ms:.4f} ms/launch, plain version "
            f"{plain:.4f} ms, bound {bound:.6f} ms by {bound_by} ({card})")

    ms, plain, bound, bound_by = times[3]
    kernels = [{
        "name": "notegen",
        "route": "cuda",
        "source": "music_generator_tpu_torch/csrc/notegen.cu",
        "replaces": "music_generator_tpu/ops/pallas_notegen.py:35",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
