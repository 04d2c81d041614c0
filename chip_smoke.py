"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. build every CUDA kernel from csrc/ (nvcc, one process per source, all
     started together) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' widths: the generation pitch loop (the cluster kernel
     also bit for bit against the streamed kernel in all 32 cases, and its
     plan printed with the clusters the card holds at once, one wave
     required at G <= 64), the four biaxial training kernels (time and
     note stack, forward and backward) and the four per-axis kernels (the
     fused two-layer stack and the single-layer recurrence, forward and
     backward, at the time and note axes' shapes)
     in float32 and bfloat16, both gate flavors, dropout 0 and 0.5, forward
     outputs, terminal states and every input, weight and initial-state
     gradient, also at small odd widths; each biaxial forward (the time
     stack's six passes, the note stack's seven) and each biaxial backward
     (the time stack's six passes, the note stack's seven) against its
     staged plain version, which repeats those passes, with the scan route
     each dtype takes (bfloat16: U resident in a thread-block cluster, one
     block for the note stack; float32: U streamed); the recurrence's
     forward (kernel 8: the stacks' forward scan with initial and terminal
     states) against its staged plain version with nonzero h0 and c0 (hs,
     the c tape with tapes on and off, h_T, c_T) and its backward (kernel
     9: tapes, pre-activation GEMM, scan, dU) against its staged plain
     version on kernel 8's tapes, at both axes' shapes and small odd
     widths, with the same scan routes; the fused stack's forward (kernel
     6: x0 padded, two input GEMMs, two forward scans with initial and
     terminal states, x1 with the mask) against its staged plain version
     with nonzero initial states, dropout 0 and 0.5, tapes on and off, all
     eight results, at both axes' shapes and small odd widths, on both
     scan routes in bfloat16; the fused stack's backward
     (kernel 7: tapes, prologue, two pre-activation GEMMs, two reversed
     scans with initial and terminal states, dx1 with the mask, dx0,
     reductions) against its staged plain version on kernel 6's tapes,
     with nonzero initial states, dropout 0 and 0.5, every result, at
     both axes' shapes and small odd widths, with the same scan routes;
     and the lstm2 mask dump (kernel 10) against its plain version, bit
     for bit;
  3. drive the generation main path through the CLI's code (generate_main):
     the trained flagship weights, 3 genres, 8 bars, seeds 0 and 1, and
     check the written .mid files against artifacts/short_samples_r4 (event
     identity required, byte identity reported) and that every timestep
     went through the cluster kernel (the streamed one never); then
     regenerate more committed samples (real_corpus_r3, the 64-bar
     long_samples_r4) the same way;
  3c. drive the training main path through the CLI's code (train_main at
     default_config(), 2 epochs on a synthetic corpus of all 23 styles),
     and check that every step launched each training kernel once (each
     biaxial forward's and backward's two scans on the cluster route) and
     no plain version ran, that the losses are
     finite, and that generate_main picks up the checkpoint and writes 3
     files;
  3d. one dropout-0 training step on a seeded batch: kernels against the
     plain stacks in float32 (loss, every gradient, the parameters after
     one Nadam step), and the bfloat16 kernels against the float32 plain
     path (loss, worst-leaf gradient cosine, post-update loss gap), held
     to a stated bar on fresh weights and read on the trained weights;
  3e. drive the per-axis training routes through the trainer the CLI uses
     (Trainer.fit, 1 epoch of the 3c corpus at default_config() widths):
     fused_biax_v3=False (the fused two-layer stack per axis),
     fused_axis_kernel=False as well (one recurrence per layer) and a
     3 + 3 layer stack, checking the exact launch counts of each step, no
     plain version and no biaxial launch, every bfloat16 recurrence
     forward's and backward's scan and both scans of every bfloat16
     fused-stack forward and backward on the cluster route, finite
     losses, evaluate()
     and the checkpoint;
  3f. the dropout-0 step of 3d on the two per-axis routes;
  3g. the port's validators as a user runs them (music_generator_tpu_torch/
     tools): validate_lstm2 (the fused stack against the plain recurrence,
     at dropout 0.5 with its own masks from kernel 10, and its timing) and
     validate_biax on both gate flavors;
  3h. primed generation: generate_main --prime, the committed primed demos
     regenerated from their own first 8 bars (event identity required,
     byte identity reported), a self-consistency run, and check_fidelity
     at seeds 0 and 1 (event identity required on every file); every
     kernel must have been launched in 3g-3h;
  4. time the generation step (and, from a profiled bar, the device's
     share of it), the training step of each route, the 3 + 3 layer stack
     included (and its busy share),
     each kernel and its plain version (the pitch loop's cluster and
     streamed kernels in turns at G = 3, 64 and 256, with the cluster
     kernel's clock cycles per pitch by phase), each pass of the time and
     note forwards and of the time and note backwards and of the
     recurrence's backward and the fused stack's forward (beside cuDNN's
     two-layer forward) and backward at both axes, and the
     recurrence's forward scan a launch at both axes (both scan routes,
     with the cluster scans' clock cycles per phase and a check that each
     plan is one wave),
     cuDNN's LSTM beside the recurrence (and the weight copy it repeats at
     every bfloat16 call), and the mask dump (its device time a launch
     from the profiler, bit for bit stack_masks again, against the larger
     of its bytes and its row loop's instructions, counted from the SASS,
     at the card's issue rate; the loop must hold no division).
The line before the last holds the per-kernel JSON; the last line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from music_generator_tpu_torch.tools.common import (F32_ATOL, F32_GRAD_REL,
                                                    CheckFailed, card_line,
                                                    cuda_ms, leaf_stats)
from music_generator_tpu_torch.tools.validate_biax import (PARITY_BAR,
                                                           STEP_ATOL,
                                                           step_bars,
                                                           step_readings)

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
SHORT = os.path.join(ROOT, "artifacts", "short_samples_r4")
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s on the
# CUDA cores, dense bfloat16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TRAIN_WORK = os.path.join(WORK, "train")

# The biaxial training kernels: (name, TPU kernel it replaces, source).
BIAX_KERNELS = [
    ("biax_time_fwd", "music_generator_tpu/ops/pallas_biax.py:166",
     "music_generator_tpu_torch/csrc/biax_time.cu"),
    ("biax_time_bwd", "music_generator_tpu/ops/pallas_biax.py:244",
     "music_generator_tpu_torch/csrc/biax_time.cu"),
    ("biax_note_fwd", "music_generator_tpu/ops/pallas_biax.py:610",
     "music_generator_tpu_torch/csrc/biax_note.cu"),
    ("biax_note_bwd", "music_generator_tpu/ops/pallas_biax.py:715",
     "music_generator_tpu_torch/csrc/biax_note.cu"),
]
# The per-axis training kernels: (name, TPU kernel it replaces, source).
LSTM_KERNELS = [
    ("lstm2_fwd", "music_generator_tpu/ops/pallas_lstm2.py:109",
     "music_generator_tpu_torch/csrc/lstm2.cu"),
    ("lstm2_bwd", "music_generator_tpu/ops/pallas_lstm2.py:180",
     "music_generator_tpu_torch/csrc/lstm2.cu"),
    ("lstm_rec_fwd", "music_generator_tpu/ops/pallas_lstm.py:95",
     "music_generator_tpu_torch/csrc/lstm_recurrence.cu"),
    ("lstm_rec_bwd", "music_generator_tpu/ops/pallas_lstm.py:139",
     "music_generator_tpu_torch/csrc/lstm_recurrence.cu"),
]
# Kernel 10: the fused stack's inter-layer masks written out (the JAX
# tool's `extract_masks`), checked at the validator's shape, the time and
# note axes' shapes and an odd one, (S, R, H).
MASK_KERNEL = ("lstm2_masks", "tools/tpu_validate_lstm2.py:30",
               "music_generator_tpu_torch/csrc/lstm2_masks.cu")
MASK_SHAPES = [(32, 512, 256), (128, 768, 256), (48, 2048, 128),
               (5, 37, 19)]
# The per-axis routes of phases 3e, 3f and 4: config overrides, and the
# launches of each kernel in one training step.
ROUTES = {
    "axis_fused": (dict(fused_biax_v3=False),
                   {"lstm2_fwd": 2, "lstm2_bwd": 2}),
    "per_layer": (dict(fused_biax_v3=False, fused_axis_kernel=False),
                  {"lstm_rec_fwd": 4, "lstm_rec_bwd": 4}),
    "depth_3_3": (dict(time_axis_layers=3, note_axis_layers=3),
                  {"lstm_rec_fwd": 6, "lstm_rec_bwd": 6}),
}
CHECK_T = 32        # timesteps of the kernel checks (the plain loop's sake)
# Kernel against plain version: float32 forward within F32_ATOL and every
# gradient within F32_GRAD_REL of the plain one (||a - b|| / ||b||, worst
# leaf; tools/common.py); bfloat16 forward within BF16_ATOL, gradients
# within BF16_GRAD_REL and a cosine of at least BF16_COS.  In bfloat16 a
# float32 sum taken in another order (tensor cores against the plain
# version's matmul) can move a rounding to bfloat16 by one ulp, which the
# recurrence carries on:
# BF16_ATOL is 4 ulps at 1 (outputs are h in (-1, 1) and probabilities).
# The plain version's autograd rounds each intermediate gradient to
# bfloat16 where the kernel keeps float32, so the gradients differ by
# bfloat16 rounding.
BF16_ATOL, BF16_GRAD_REL, BF16_COS = 2.0 ** -5, 0.1, 0.995
# One dropout-0 training step on random_batch(seed=0, rolled_targets=True)
# (tools/validate_biax.py: `step_readings`, STEP_ATOL, PARITY_BAR): float32
# kernels against the float32 plain path, bfloat16 kernels against
# PARITY_BAR beside the TPU's readings in artifacts/kernel_validation_r5.
# Both are held on fresh weights from a seed, as the TPU's validation tool
# (tools/tpu_validate_biax.py) drew them.  The trained r4 weights are read
# too, without a bar: near their minimum the loss gradient is small and
# bfloat16 rounding, in the plain path as much as in the kernels, moves the
# loss by about 20% and turns the gradient's direction, so no bfloat16 path
# can meet a bar there.

# More TPU-generated samples the card must reproduce, as each one's
# PROVENANCE/report records it: (weights, style one-hots or None for the 3
# genre mixtures, bars, temperature, committed file pattern); seed 0.
MORE_SAMPLES = [
    ("real_corpus_r3/params.npz", (0, 3, 9), 16, 0.75,
     "real_corpus_r3/real_trained_{}.mid"),
    ("trained_model_r4/params.npz", None, 64, None,
     "long_samples_r4/long_{}.mid"),
]

# The committed primed demos (artifacts/primed_demos_r4/provenance.json):
# file stem and style slot; each continues its own first 8 bars for 8 bars
# with the real_corpus_r3 weights, seed 0, temperature 0.75.
PRIMED_DEMOS = (("Baroque", 0), ("Classical", 3), ("Romantic", 9))
DEMOS = os.path.join(ROOT, "artifacts", "primed_demos_r4")

EDGE = 1e-5          # a draw with |u - p| below this may fall either way
VOLUME_ATOL = 1e-5   # float32 sums in another order: ULP-scale drift


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    log("FAIL:", msg)
    sys.exit(1)


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


def stack_inputs(kind: str, cfg, T: int, seed: int):
    """Random float32 inputs of one biaxial stack at the model's widths, on
    the card: features and style terms of unit scale, weights of Glorot
    scale, a sparse 0/1 chosen-note stream."""
    from music_generator_tpu_torch.models.deepj import feature_dim
    gen = torch.Generator().manual_seed(seed)
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen) * sc
    B, N = cfg.batch_size, cfg.num_notes
    if kind == "time":
        F, H = feature_dim(cfg), cfg.time_axis_units
        xs = [n(T, N, B, F), n(T, B, F, sc=0.3), n(T, B, H, sc=0.3),
              n(F, 4 * H, sc=0.1), n(4 * H, sc=0.1), n(4 * H, sc=0.1),
              n(H, 4 * H, sc=0.06), n(H, 4 * H, sc=0.06),
              n(H, 4 * H, sc=0.06)]
    else:
        Ht, H = cfg.time_axis_units, cfg.note_axis_units
        D = Ht + cfg.note_units
        chosen = (torch.rand(N, T, B, cfg.note_units, generator=gen)
                  < 0.2).float()
        xs = [n(T, N, B, Ht, sc=0.5), chosen, n(T, B, D, sc=0.3),
              n(T, B, H, sc=0.3), n(D, 4 * H, sc=0.06), n(4 * H, sc=0.1),
              n(4 * H, sc=0.1), n(H, 4 * H, sc=0.08), n(H, 4 * H, sc=0.08),
              n(H, 4 * H, sc=0.08), n(H, 3, sc=0.2), n(3, sc=0.1)]
    return [x.cuda() for x in xs]


def stack_grads(fn, args, cot, **kw):
    """Forward of one stack and the gradients of <out, cot> with respect to
    every input (float32 copies), synchronised."""
    ts = [a.clone().requires_grad_(True) for a in args]
    out = fn(*ts, **kw)
    grads = torch.autograd.grad(out.float(), ts, cot)
    torch.cuda.synchronize()
    return out.detach().float(), [g.float() for g in grads]


def check_biax_kernels(cfg):
    """Each biaxial kernel against its plain version at the main path's
    widths (T cut to CHECK_T), and at small odd widths (T = 6, B = 8,
    H = 12), where the bfloat16 weight-gradient reduction takes its
    CUDA-core path; returns the float32 max |error| of each kernel at the
    main path's widths: the forward output for the forward kernels, the
    gradients for the backward kernels."""
    from music_generator_tpu_torch.ops import biax
    errs = {name: 0.0 for name, _, _ in BIAX_KERNELS}
    small = cfg.replace(batch_size=8, octave_units=8, style_units=8,
                        time_axis_units=12, note_axis_units=12)
    cases = 0
    for c, T, label in ((cfg, CHECK_T, "main widths"),
                        (small, 6, "small widths")):
        for kind in ("time", "note"):
            kernel = getattr(biax, f"biax_{kind}_stack")
            plain = getattr(biax, f"biax_{kind}_stack_reference")
            args = stack_inputs(kind, c, T, 10 if kind == "time" else 11)
            shape = ((T, c.num_notes, c.batch_size, c.time_axis_units)
                     if kind == "time" else
                     (c.num_notes, T, c.batch_size, 3))
            for cdt in (torch.float32, torch.bfloat16):
                for p in (0.0, 0.5):
                    for act in ("sigmoid", "hard_sigmoid"):
                        kw = dict(dropout_p=p, seed=1234, compute_dtype=cdt,
                                  recurrent_activation=act)
                        gen = torch.Generator("cuda").manual_seed(cases)
                        cot = torch.randn(shape, device="cuda", generator=gen)
                        o1, g1 = stack_grads(kernel, args, cot, **kw)
                        o2, g2 = stack_grads(plain, args, cot, **kw)
                        cases += 1
                        fe = float((o1 - o2).abs().max())
                        ge, rel, cos = leaf_stats(g1, g2)
                        finite = bool(torch.isfinite(o1).all()) and all(
                            bool(torch.isfinite(g).all()) for g in g1)
                        dt = "f32" if cdt == torch.float32 else "bf16"
                        log(f"biax_{kind} {label} {dt} p={p} {act}: forward "
                            f"max|d|={fe:.3g}; gradients max|d|={ge:.3g}, "
                            f"worst rel={rel:.3g}, worst cos={cos:.6f}")
                        if cdt == torch.float32:
                            if c is cfg:
                                errs[f"biax_{kind}_fwd"] = max(
                                    errs[f"biax_{kind}_fwd"], fe)
                                errs[f"biax_{kind}_bwd"] = max(
                                    errs[f"biax_{kind}_bwd"], ge)
                            ok = fe <= F32_ATOL and rel <= F32_GRAD_REL
                        else:
                            ok = (fe <= BF16_ATOL and rel <= BF16_GRAD_REL
                                  and cos >= BF16_COS)
                        if not ok or not finite:
                            fail(f"biax_{kind} {label} {dt} p={p} {act} "
                                 f"disagrees with its plain version")
    log(f"biax: {cases} cases agree with the plain versions (float32 "
        f"forward atol {F32_ATOL}, gradients rel {F32_GRAD_REL}; bfloat16 "
        f"forward atol {BF16_ATOL}, gradients rel {BF16_GRAD_REL}, cosine "
        f">= {BF16_COS})")
    return errs


def check_bwd_staged(cfg, kind: str):
    """A stack's backward kernels (`biax_{kind}_bwd`: the time stack's six
    passes, the note stack's seven) against their staged plain version
    (`biax_{kind}_bwd_staged`) on the same forward tapes and cotangent, at
    the main widths (T = CHECK_T) and at small odd widths, both dtypes,
    dropout 0 and 0.5, both gate flavors, with the tolerances of
    check_biax_kernels; each backward must take its dtype's scan route
    (two cluster scans in bfloat16, two streamed in float32)."""
    from music_generator_tpu_torch.ops import biax
    fwd, bwd, staged = (getattr(biax, f"biax_{kind}_{s}")
                        for s in ("fwd", "bwd", "bwd_staged"))
    small = cfg.replace(batch_size=8, octave_units=8, style_units=8,
                        time_axis_units=12, note_axis_units=12)
    cases = 0
    for c, T, label in ((cfg, CHECK_T, "main widths"),
                        (small, 6, "small widths")):
        args = stack_inputs(kind, c, T, 12)
        shape = ((T, c.num_notes, c.batch_size, c.time_axis_units)
                 if kind == "time" else (c.num_notes, T, c.batch_size, 3))
        for cdt in (torch.float32, torch.bfloat16):
            for p in (0.0, 0.5):
                for act in ("sigmoid", "hard_sigmoid"):
                    kw = dict(dropout_p=p, seed=4321, compute_dtype=cdt,
                              recurrent_activation=act)
                    tapes = fwd(*args, **kw)
                    if kind == "note":
                        tapes = tapes[1:]         # the tapes after out
                    cot = torch.randn(shape, device="cuda", generator=(
                        torch.Generator("cuda").manual_seed(cases)))
                    before = scan_counts(kind)
                    got = bwd(*args, *tapes, cot, **kw)
                    torch.cuda.synchronize()
                    ran = tuple(a - b for a, b in zip(scan_counts(kind),
                                                      before))
                    want = staged(*args, *tapes, cot, **kw)
                    cases += 1
                    err, rel, cos = leaf_stats([g.float() for g in got],
                                               [w.float() for w in want])
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    dt = "f32" if cdt == torch.float32 else "bf16"
                    log(f"biax_{kind}_bwd vs staged {label} {dt} p={p} "
                        f"{act}: max|d|={err:.3g}, worst rel={rel:.3g}, "
                        f"worst cos={cos:.6f}; scans (cluster, streamed) "
                        f"{ran}")
                    if cdt == torch.float32:
                        ok = rel <= F32_GRAD_REL and ran == (0, 2)
                    else:
                        ok = (rel <= BF16_GRAD_REL and cos >= BF16_COS
                              and ran == (2, 0))
                    if not ok or not finite:
                        fail(f"biax_{kind}_bwd {label} {dt} p={p} {act} "
                             f"disagrees with its staged version")
    log(f"biax_{kind}_bwd: {cases} cases agree with the staged plain "
        f"version")


def check_fwd_staged(cfg, kind: str):
    """A stack's forward kernels (`biax_{kind}_fwd`: the time stack's six
    passes, the note stack's seven) against their staged plain version
    (`biax_{kind}_fwd_staged`), every result (the note stack's out and all
    four tapes), at the main widths (T = CHECK_T) and at small odd widths,
    both dtypes, dropout 0 and 0.5, both gate flavors: max |d| relative to
    the result's largest magnitude where that exceeds 1 (c grows past 1)
    within F32_ATOL in float32 and BF16_ATOL in bfloat16.  Each forward
    must take its dtype's scan route (two cluster scans in bfloat16, two
    streamed in float32)."""
    from music_generator_tpu_torch.ops import biax
    fwd, staged = (getattr(biax, f"biax_{kind}_{s}")
                   for s in ("fwd", "fwd_staged"))
    small = cfg.replace(batch_size=8, octave_units=8, style_units=8,
                        time_axis_units=12, note_axis_units=12)
    cases = 0
    for c, T, label in ((cfg, CHECK_T, "main widths"),
                        (small, 6, "small widths")):
        args = stack_inputs(kind, c, T, 13)
        for cdt in (torch.float32, torch.bfloat16):
            for p in (0.0, 0.5):
                for act in ("sigmoid", "hard_sigmoid"):
                    kw = dict(dropout_p=p, seed=4321, compute_dtype=cdt,
                              recurrent_activation=act)
                    before = fwd_scan_counts(kind)
                    got = fwd(*args, **kw)
                    torch.cuda.synchronize()
                    ran = tuple(a - b for a, b in zip(fwd_scan_counts(kind),
                                                      before))
                    want = staged(*args, **kw)
                    cases += 1
                    err = max(float((a.float() - b.float()).abs().max())
                              / max(1.0, float(b.float().abs().max()))
                              for a, b in zip(got, want))
                    _, rel, cos = leaf_stats([g.float() for g in got],
                                             [w.float() for w in want])
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    dt = "f32" if cdt == torch.float32 else "bf16"
                    log(f"biax_{kind}_fwd vs staged {label} {dt} p={p} "
                        f"{act}: results max|d| (scaled)={err:.3g}, worst "
                        f"rel={rel:.3g}, worst cos={cos:.6f}; scans "
                        f"(cluster, streamed) {ran}")
                    if cdt == torch.float32:
                        ok = err <= F32_ATOL and ran == (0, 2)
                    else:
                        ok = err <= BF16_ATOL and ran == (2, 0)
                    if not ok or not finite:
                        fail(f"biax_{kind}_fwd {label} {dt} p={p} {act} "
                             f"disagrees with its staged version")
    log(f"biax_{kind}_fwd: {cases} cases agree with the staged plain "
        f"version")


def axis_shapes(cfg, T: int):
    """(axis, S, R, F, H) of the time and note axes' scans at cfg's widths
    with T timesteps: the time axis scans T over rows (b, n), the note axis
    the notes over rows (b, t)."""
    from music_generator_tpu_torch.models.deepj import feature_dim
    B, N = cfg.batch_size, cfg.num_notes
    return [("time", T, N * B, feature_dim(cfg), cfg.time_axis_units),
            ("note", N, T * B, cfg.time_axis_units + cfg.note_units,
             cfg.note_axis_units)]


def lstm_inputs(kind: str, S: int, R: int, F: int, H: int, seed: int):
    """Random float32 inputs on the card: for "lstm2" x0, s1m, w0, b0, b1,
    u0, w1, u1 and four initial states; for "lstm_rec" xw, u, h0, c0.  Features
    of unit scale, weights of 1/sqrt(fan-in) scale, initial states of 0.3."""
    gen = torch.Generator().manual_seed(seed)
    n = lambda *s, sc=1.0: torch.randn(*s, generator=gen) * sc
    wh = H ** -0.5
    states = [n(R, H, sc=0.3) for _ in range(4 if kind == "lstm2" else 2)]
    if kind == "lstm2":
        xs = [n(S, R, F), n(S, R, H, sc=0.3), n(F, 4 * H, sc=F ** -0.5),
              n(4 * H, sc=0.1), n(4 * H, sc=0.1), n(H, 4 * H, sc=wh),
              n(H, 4 * H, sc=wh), n(H, 4 * H, sc=wh)]
    else:
        xs = [n(S, R, 4 * H), n(H, 4 * H, sc=wh)]
    return [x.cuda() for x in xs + states]


def outputs_and_grads(fn, args, cots, **kw):
    """The outputs of one kernel wrapper (flattened: the sequence, then the
    terminal states) and the gradients of sum <output, cot> with respect
    to every input, as float32, synchronised."""
    ts = [a.clone().requires_grad_(True) for a in args]
    seq, fin = fn(*ts, **kw)
    outs = [seq, *fin]
    loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(loss, ts)
    torch.cuda.synchronize()
    return ([o.detach().float() for o in outs], [g.float() for g in grads])


def check_lstm_kernels(cfg):
    """The per-axis kernels against their plain versions at the time and
    note axes' shapes (T cut to CHECK_T) and at small odd widths (T = 6,
    B = 8, H = 12): outputs and terminal states (max |d| relative to the
    output's largest magnitude where that exceeds 1: c grows past 1), and
    every gradient, with nonzero initial states and cotangents on every
    output (the h0T cotangent of lstm2 is ignored by both versions).
    Returns the float32 max |error| of each kernel at the main widths."""
    from music_generator_tpu_torch.ops import lstm2, recurrence
    errs = {name: 0.0 for name, _, _ in LSTM_KERNELS}
    small = cfg.replace(batch_size=8, octave_units=8, style_units=8,
                        time_axis_units=12, note_axis_units=12)
    cases = 0
    for c, T, label in ((cfg, CHECK_T, "main widths"),
                        (small, 6, "small widths")):
        for axis, S, R, F, H in axis_shapes(c, T):
            for kind, fn, plain in (
                    ("lstm2", lstm2.lstm2_stack, lstm2.lstm2_stack_reference),
                    ("lstm_rec", recurrence.lstm_recurrence,
                     recurrence.lstm_recurrence_reference)):
                args = lstm_inputs(kind, S, R, F, H, 20 + cases)
                n_fin = 4 if kind == "lstm2" else 2
                gen = torch.Generator("cuda").manual_seed(cases)
                cots = [torch.randn(S, R, H, device="cuda", generator=gen)] + [
                    torch.randn(R, H, device="cuda", generator=gen)
                    for _ in range(n_fin)]
                for cdt in (torch.float32, torch.bfloat16):
                    for p in ((0.0, 0.5) if kind == "lstm2" else (0.0,)):
                        for act in ("sigmoid", "hard_sigmoid"):
                            kw = dict(compute_dtype=cdt,
                                      recurrent_activation=act)
                            if kind == "lstm2":
                                kw.update(dropout_p=p, seed=4321)
                            o1, g1 = outputs_and_grads(fn, args, cots, **kw)
                            o2, g2 = outputs_and_grads(plain, args, cots,
                                                       **kw)
                            cases += 1
                            fe = max(float((a - b).abs().max())
                                     / max(1.0, float(b.abs().max()))
                                     for a, b in zip(o1, o2))
                            ge, rel, cos = leaf_stats(g1, g2)
                            finite = all(bool(torch.isfinite(t).all())
                                         for t in o1 + g1)
                            dt = "f32" if cdt == torch.float32 else "bf16"
                            name = f"{kind} {axis} {label} {dt} p={p} {act}"
                            log(f"{name}: outputs max|d|={fe:.3g}; gradients "
                                f"max|d|={ge:.3g}, worst rel={rel:.3g}, "
                                f"worst cos={cos:.6f}")
                            if cdt == torch.float32:
                                if c is cfg:
                                    errs[f"{kind}_fwd"] = max(
                                        errs[f"{kind}_fwd"], max(
                                            float((a - b).abs().max())
                                            for a, b in zip(o1, o2)))
                                    errs[f"{kind}_bwd"] = max(
                                        errs[f"{kind}_bwd"], ge)
                                ok = fe <= F32_ATOL and rel <= F32_GRAD_REL
                            else:
                                ok = (fe <= BF16_ATOL and rel <= BF16_GRAD_REL
                                      and cos >= BF16_COS)
                            if not ok or not finite:
                                fail(f"{name} disagrees with its plain "
                                     f"version")
    log(f"lstm2, lstm_rec: {cases} cases agree with the plain versions "
        f"(the tolerances of the biaxial checks)")
    return errs


def rec_scan_counts():
    """(cluster, streamed) scans launched by the recurrence's backward."""
    from music_generator_tpu_torch.ops import recurrence
    rec = recurrence.lstm_recurrence
    return rec.cluster_scans, rec.streamed_scans


def rec_fwd_scan_counts():
    """(cluster, streamed) scans launched by the recurrence's forward."""
    from music_generator_tpu_torch.ops import recurrence
    rec = recurrence.lstm_recurrence
    return rec.fwd_cluster_scans, rec.fwd_streamed_scans


def rec_check_shapes(cfg):
    """(label, S, R, F, H) of the recurrence's staged checks: the time and
    note axes' shapes (T cut to CHECK_T), small odd widths (T = 6, B = 8,
    H = 12) and (S, R, H) = (5, 37, 12)."""
    small = cfg.replace(batch_size=8, octave_units=8, style_units=8,
                        time_axis_units=12, note_axis_units=12)
    shapes = [(f"{axis} {label}", S, R, F, H)
              for c, T, label in ((cfg, CHECK_T, "main widths"),
                                  (small, 6, "small widths"))
              for axis, S, R, F, H in axis_shapes(c, T)]
    return shapes + [("odd rows", 5, 37, 12, 12)]


def check_rec_fwd_staged(cfg):
    """Kernel 8 (`lstm_recurrence_fwd`) against its staged plain version
    (`lstm_recurrence_fwd_staged`) with nonzero initial states, at
    rec_check_shapes, both dtypes, both gate flavors, tapes on and off: hs,
    cs, h_T and c_T, max |d| relative to the result's largest magnitude
    where that exceeds 1 (c grows past 1) within F32_ATOL in float32 and
    BF16_ATOL in bfloat16.  Each forward must take its dtype's scan route
    (one cluster scan in bfloat16, one streamed in float32)."""
    from music_generator_tpu_torch.ops import recurrence
    cases = 0
    for label, S, R, F, H in rec_check_shapes(cfg):
        xw, u, h0, c0 = lstm_inputs("lstm_rec", S, R, F, H, 60 + cases)
        for cdt in (torch.float32, torch.bfloat16):
            for act in ("sigmoid", "hard_sigmoid"):
                for tapes in (True, False):
                    kw = dict(compute_dtype=cdt, recurrent_activation=act,
                              tapes=tapes)
                    before = rec_fwd_scan_counts()
                    got = recurrence.lstm_recurrence_fwd(xw, u, h0, c0, **kw)
                    torch.cuda.synchronize()
                    ran = tuple(a - b for a, b in zip(rec_fwd_scan_counts(),
                                                      before))
                    want = recurrence.lstm_recurrence_fwd_staged(
                        xw, u, h0, c0, **kw)
                    cases += 1
                    pairs = [(a, b) for a, b in zip(got, want)
                             if b is not None]
                    same = ((got[1] is None) != tapes and all(
                        a.shape == b.shape and a.dtype == b.dtype
                        for a, b in pairs))
                    err = max(float((a.float() - b.float()).abs().max())
                              / max(1.0, float(b.float().abs().max()))
                              for a, b in pairs)
                    finite = all(bool(torch.isfinite(a).all())
                                 for a, _ in pairs)
                    dt = "f32" if cdt == torch.float32 else "bf16"
                    log(f"lstm_rec_fwd vs staged {label} (S={S}, R={R}, "
                        f"H={H}) {dt} {act} tapes={tapes}: hs, cs, h_T, c_T "
                        f"max|d| (scaled)={err:.3g}; scans (cluster, "
                        f"streamed) {ran}")
                    if cdt == torch.float32:
                        ok = err <= F32_ATOL and ran == (0, 1)
                    else:
                        ok = err <= BF16_ATOL and ran == (1, 0)
                    if not ok or not finite or not same:
                        fail(f"lstm_rec_fwd {label} {dt} {act} tapes={tapes} "
                             f"disagrees with its staged version")
    log(f"lstm_rec_fwd: {cases} cases agree with the staged plain version")


def check_rec_bwd_staged(cfg):
    """Kernel 9's passes (`lstm_recurrence_bwd`) against their staged plain
    version (`lstm_recurrence_bwd_staged`) on the same tapes, those of
    kernel 8 (`lstm_recurrence_fwd`), with nonzero initial states and
    cotangents of hs, h_T and c_T, at rec_check_shapes, both dtypes and
    both gate flavors, with the tolerances of check_biax_kernels on (dxw,
    dU, dh0, dc0).  Each backward must take its dtype's scan route (one
    cluster scan in bfloat16, one streamed in float32)."""
    from music_generator_tpu_torch.ops import recurrence
    cases = 0
    for label, S, R, F, H in rec_check_shapes(cfg):
        xw, u, h0, c0 = lstm_inputs("lstm_rec", S, R, F, H, 40 + cases)
        gen = torch.Generator("cuda").manual_seed(cases)
        cots = [torch.randn(S, R, H, device="cuda", generator=gen),
                torch.randn(R, H, device="cuda", generator=gen),
                torch.randn(R, H, device="cuda", generator=gen)]
        for cdt in (torch.float32, torch.bfloat16):
            for act in ("sigmoid", "hard_sigmoid"):
                kw = dict(compute_dtype=cdt, recurrent_activation=act)
                hs, cs, _, _ = recurrence.lstm_recurrence_fwd(xw, u, h0, c0,
                                                              **kw)
                before = rec_scan_counts()
                got = recurrence.lstm_recurrence_bwd(xw, u, h0, hs, cs,
                                                     *cots, **kw)
                torch.cuda.synchronize()
                ran = tuple(a - b for a, b in zip(rec_scan_counts(), before))
                want = recurrence.lstm_recurrence_bwd_staged(
                    xw, u, h0, hs, cs, *cots, **kw)
                cases += 1
                err, rel, cos = leaf_stats([g.float() for g in got],
                                           [w.float() for w in want])
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                dt = "f32" if cdt == torch.float32 else "bf16"
                log(f"lstm_rec_bwd vs staged {label} (S={S}, R={R}, H={H}) "
                    f"{dt} {act}: max|d|={err:.3g}, worst rel={rel:.3g}, "
                    f"worst cos={cos:.6f}; scans (cluster, streamed) {ran}")
                if cdt == torch.float32:
                    ok = rel <= F32_GRAD_REL and ran == (0, 1)
                else:
                    ok = (rel <= BF16_GRAD_REL and cos >= BF16_COS
                          and ran == (1, 0))
                if not ok or not finite:
                    fail(f"lstm_rec_bwd {label} {dt} {act} disagrees with "
                         f"its staged version")
    log(f"lstm_rec_bwd: {cases} cases agree with the staged plain version")


def lstm2_scan_counts():
    """(cluster, streamed) scans launched by the fused stack's backward."""
    from music_generator_tpu_torch.ops import lstm2
    return lstm2.lstm2_stack.cluster_scans, lstm2.lstm2_stack.streamed_scans


def lstm2_fwd_scan_counts():
    """(cluster, streamed) scans launched by the fused stack's forward."""
    from music_generator_tpu_torch.ops import lstm2
    stack = lstm2.lstm2_stack
    return stack.fwd_cluster_scans, stack.fwd_streamed_scans


def check_lstm2_fwd_staged(cfg):
    """Kernel 6's passes (`lstm2_fwd`) against their staged plain version
    (`lstm2_fwd_staged`) with nonzero initial states, at rec_check_shapes
    (the odd one with F = 13), both dtypes, both gate flavors, dropout 0
    and 0.5, tapes on and off, on both scan routes in bfloat16 (cluster,
    the main path's, and streamed) and the streamed route in float32: all
    eight results (hs0, cs0, hs1, cs1, h0T, c0T, h1T, c1T), max |d|
    relative to the result's largest magnitude where that exceeds 1 (c
    grows past 1) within F32_ATOL in float32 and BF16_ATOL in bfloat16,
    with the relative error and cosine logged.  Each forward must run two
    scans on its route."""
    from music_generator_tpu_torch.ops import lstm2
    cases, worst = 0, {"f32 max|d|": 0.0, "bf16 rel": 0.0, "bf16 cos": 1.0}
    runs = [(torch.float32, "streamed"), (torch.bfloat16, "cluster"),
            (torch.bfloat16, "streamed")]
    for label, S, R, F, H in rec_check_shapes(cfg):
        F = 13 if label == "odd rows" else F
        args = lstm_inputs("lstm2", S, R, F, H, 100 + cases)
        for (cdt, route), act, p, tapes in itertools.product(
                runs, ("sigmoid", "hard_sigmoid"), (0.0, 0.5), (True, False)):
            kw = dict(dropout_p=p, seed=4321, compute_dtype=cdt,
                      recurrent_activation=act, tapes=tapes)
            before = lstm2_fwd_scan_counts()
            with forced_scan_route(route):
                got = lstm2.lstm2_fwd(*args, **kw)
            torch.cuda.synchronize()
            ran = tuple(a - b for a, b in zip(lstm2_fwd_scan_counts(),
                                              before))
            want = lstm2.lstm2_fwd_staged(*args, **kw)
            cases += 1
            pairs = [(a, b) for a, b in zip(got, want) if b is not None]
            same = ((got[0] is None) != tapes and all(
                a.shape == b.shape and a.dtype == b.dtype for a, b in pairs))
            err = max(float((a.float() - b.float()).abs().max())
                      / max(1.0, float(b.float().abs().max()))
                      for a, b in pairs)
            _, rel, cos = leaf_stats([a.float() for a, _ in pairs],
                                     [b.float() for _, b in pairs])
            finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
            dt = "f32" if cdt == torch.float32 else "bf16"
            log(f"lstm2_fwd vs staged {label} (S={S}, R={R}, F={F}, H={H}) "
                f"{dt} {route} {act} p={p} tapes={tapes}: max|d| (scaled)="
                f"{err:.3g}, worst rel={rel:.3g}, worst cos={cos:.6f}; scans "
                f"(cluster, streamed) {ran}")
            if cdt == torch.float32:
                ok = err <= F32_ATOL
                worst["f32 max|d|"] = max(worst["f32 max|d|"], err)
            else:
                ok = err <= BF16_ATOL
                worst["bf16 rel"] = max(worst["bf16 rel"], rel)
                worst["bf16 cos"] = min(worst["bf16 cos"], cos)
            want_ran = (2, 0) if route == "cluster" else (0, 2)
            if not ok or not finite or not same or ran != want_ran:
                fail(f"lstm2_fwd {label} {dt} {route} {act} p={p} "
                     f"tapes={tapes} disagrees with its staged version")
    log(f"lstm2_fwd: {cases} cases agree with the staged plain version; "
        f"worst {worst}")


def lstm2_bwd_args(S: int, R: int, F: int, H: int, seed: int, ones=False):
    """The inputs of kernel 7 that are not tapes: (x0, s1m, w0, b0, b1, u0,
    w1, u1, h00, h10) of lstm_inputs("lstm2", ...), its c00 and c10 for
    the forward, and the cotangents of hs1, h1T, c0T, c1T (random, or all
    ones with `ones`)."""
    args = lstm_inputs("lstm2", S, R, F, H, seed)
    gen = torch.Generator("cuda").manual_seed(seed)
    shapes = [(S, R, H)] + [(R, H)] * 3
    cots = [torch.ones(*s, device="cuda") if ones else
            torch.randn(*s, device="cuda", generator=gen) for s in shapes]
    return args[:9] + args[10:11], (args[9], args[11]), cots


def check_lstm2_bwd_staged(cfg):
    """Kernel 7's passes (`lstm2_bwd`) against their staged plain version
    (`lstm2_bwd_staged`) on the same tapes, those of kernel 6
    (`lstm2_fwd`), with nonzero initial states and cotangents of hs1, h1T,
    c0T and c1T, at rec_check_shapes (the odd one with F = 13), both
    dtypes, both gate flavors, dropout 0 and 0.5, with the tolerances of
    check_biax_kernels on all twelve results.  Each backward must take its
    dtype's scan route (two cluster scans in bfloat16, two streamed in
    float32)."""
    from music_generator_tpu_torch.ops import lstm2
    cases = 0
    for label, S, R, F, H in rec_check_shapes(cfg):
        F = 13 if label == "odd rows" else F
        args, (c00, c10), cots = lstm2_bwd_args(S, R, F, H, 80 + cases)
        x0, s1m, w0, b0, b1, u0, w1, u1, h00, h10 = args
        for cdt in (torch.float32, torch.bfloat16):
            for act in ("sigmoid", "hard_sigmoid"):
                for p in (0.0, 0.5):
                    kw = dict(dropout_p=p, seed=4321, compute_dtype=cdt,
                              recurrent_activation=act)
                    hs0, cs0, hs1, cs1, *_ = lstm2.lstm2_fwd(
                        x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10,
                        **kw)
                    tapes = (hs0, cs0, hs1, cs1)
                    before = lstm2_scan_counts()
                    got = lstm2.lstm2_bwd(*args, *tapes, *cots, **kw)
                    torch.cuda.synchronize()
                    ran = tuple(a - b for a, b in zip(lstm2_scan_counts(),
                                                      before))
                    want = lstm2.lstm2_bwd_staged(*args, *tapes, *cots, **kw)
                    cases += 1
                    same = all(a.shape == b.shape and a.dtype == b.dtype
                               for a, b in zip(got, want))
                    err, rel, cos = leaf_stats([g.float() for g in got],
                                               [w.float() for w in want])
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    dt = "f32" if cdt == torch.float32 else "bf16"
                    log(f"lstm2_bwd vs staged {label} (S={S}, R={R}, F={F}, "
                        f"H={H}) {dt} {act} p={p}: max|d|={err:.3g}, worst "
                        f"rel={rel:.3g}, worst cos={cos:.6f}; scans "
                        f"(cluster, streamed) {ran}")
                    if cdt == torch.float32:
                        ok = rel <= F32_GRAD_REL and ran == (0, 2)
                    else:
                        ok = (rel <= BF16_GRAD_REL and cos >= BF16_COS
                              and ran == (2, 0))
                    if not ok or not finite or not same:
                        fail(f"lstm2_bwd {label} {dt} {act} p={p} disagrees "
                             f"with its staged version")
    log(f"lstm2_bwd: {cases} cases agree with the staged plain version")


def _training_wrappers():
    """(name prefix, wrapper, plain version) of every training kernel."""
    from music_generator_tpu_torch.ops import biax, lstm2, recurrence
    return [("biax_time", biax.biax_time_stack,
             biax.biax_time_stack_reference),
            ("biax_note", biax.biax_note_stack,
             biax.biax_note_stack_reference),
            ("lstm2", lstm2.lstm2_stack, lstm2.lstm2_stack_reference),
            ("lstm_rec", recurrence.lstm_recurrence,
             recurrence.lstm_recurrence_reference)]


def reset_counts():
    from music_generator_tpu_torch.ops import biax, lstm2, recurrence
    for _, fn, plain in _training_wrappers():
        fn.fwd_launches = fn.bwd_launches = 0
        plain.calls = 0
    lstm2.lstm2_stack.cluster_scans = lstm2.lstm2_stack.streamed_scans = 0
    lstm2.lstm2_stack.fwd_cluster_scans = 0
    lstm2.lstm2_stack.fwd_streamed_scans = 0
    for stack in (biax.biax_time_stack, biax.biax_note_stack):
        stack.cluster_scans = stack.streamed_scans = 0
        stack.fwd_cluster_scans = stack.fwd_streamed_scans = 0
    rec = recurrence.lstm_recurrence
    rec.cluster_scans = rec.streamed_scans = 0
    rec.fwd_cluster_scans = rec.fwd_streamed_scans = 0


def scan_counts(kind: str):
    """(cluster, streamed) scans launched by the time or note backward."""
    from music_generator_tpu_torch.ops import biax
    stack = getattr(biax, f"biax_{kind}_stack")
    return stack.cluster_scans, stack.streamed_scans


def fwd_scan_counts(kind: str):
    """(cluster, streamed) scans launched by the time or note forward."""
    from music_generator_tpu_torch.ops import biax
    stack = getattr(biax, f"biax_{kind}_stack")
    return stack.fwd_cluster_scans, stack.fwd_streamed_scans


def read_counts():
    """({kernel name: launches} of every training kernel, plain calls)."""
    launches, plain = {}, 0
    for name, fn, ref in _training_wrappers():
        launches[f"{name}_fwd"] = fn.fwd_launches
        launches[f"{name}_bwd"] = fn.bwd_launches
        plain += ref.calls
    return launches, plain


def train_main_path(cfg):
    """train_main for 2 epochs at default_config() on a synthetic corpus of
    every style, then generate_main from its checkpoint.  Returns the
    kernel launch counts of the training run."""
    from music_generator_tpu_torch.cli import generate_main, train_main
    from music_generator_tpu_torch.data.synth import write_synth_corpus
    from music_generator_tpu_torch.midi import midi_decode, read_midifile
    from music_generator_tpu_torch.training.checkpoint import build_or_load
    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    os.makedirs(TRAIN_WORK)
    write_synth_corpus(TRAIN_WORK, files_per_style=1, bars=16, config=cfg)
    cwd = os.getcwd()
    os.chdir(TRAIN_WORK)
    try:
        t = time.perf_counter()
        reset_counts()
        hist = train_main(["--epochs", "2"])
        launches, plain = read_counts()
        scans = {}
        for kind in ("time", "note"):
            scans[f"{kind} forward"] = fwd_scan_counts(kind)
            scans[f"{kind} backward"] = scan_counts(kind)
        train_s = time.perf_counter() - t
        paths = generate_main(["--bars", "2"])
        model, loaded = build_or_load(cfg, "cuda")
    finally:
        os.chdir(cwd)
    steps = sum(hist["steps_per_epoch"])
    log(f"train main path: {steps} steps in 2 epochs, losses {hist['loss']}, "
        f"{train_s:.1f} s; kernel launches {launches}, plain version calls "
        f"{plain}; scans (cluster, streamed) {scans}")
    if not np.isfinite(hist["loss"]).all():
        fail("non-finite training loss")
    if (any(v != (steps if k.startswith("biax") else 0)
            for k, v in launches.items()) or plain != 0):
        fail("the training main path did not run every step through each "
             "biaxial kernel, and only through them")
    for kind, ran in scans.items():
        if cfg.compute_dtype == "bfloat16" and ran != (2 * steps, 0):
            fail(f"the bfloat16 {kind} ran scans {ran}, not "
                 f"{(2 * steps, 0)} on the cluster route")
    if not loaded or not os.path.isfile(os.path.join(TRAIN_WORK, "out",
                                                     "model.pt")):
        fail("the training checkpoint was not written and reloaded")
    for p in paths:
        roll = midi_decode(read_midifile(os.path.join(TRAIN_WORK, p)))
        if roll.ndim != 3 or roll.shape[1:] != (128, 3):
            fail(f"{p}: not a piano roll")
    if len(paths) != 3:
        fail(f"generate_main wrote {len(paths)} files, not 3")
    log(f"train main path: checkpoint reloaded, generate_main wrote "
        f"{len(paths)} .mid files from it")
    return launches


def train_routes(cfg):
    """Phase 3e: Trainer.fit, the trainer train_main runs, for 1 epoch of
    the 3c corpus on each per-axis route at cfg's widths; every count is
    set to 0 just before each fit and read just after.  Checks the exact
    launches of each step, no plain call and no other kernel, finite
    losses, evaluate() (the primal-only forwards) and the checkpoint.
    Returns the launch counts of each route's fit."""
    from music_generator_tpu_torch.data.dataset import load_all
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.training.checkpoint import build_or_load
    from music_generator_tpu_torch.training.trainer import (TrainConfig,
                                                            Trainer)
    styles = [[os.path.join(TRAIN_WORK, d) for d in g] for g in cfg.styles]
    ds = load_all(styles, cfg.seq_len, cfg)
    counts = {}
    for route, (overrides, per_step) in ROUTES.items():
        rc = cfg.replace(out_dir=os.path.join(TRAIN_WORK, f"out_{route}"),
                         **overrides)
        trainer = Trainer(build_model(rc, "cuda"),
                          TrainConfig(seed=0, tensorboard=False))
        t = time.perf_counter()
        reset_counts()
        hist = trainer.fit(ds, epochs=1)
        launches, plain = read_counts()
        scans = {"fwd": rec_fwd_scan_counts(), "bwd": rec_scan_counts()}
        stack_scans = lstm2_scan_counts()
        stack_fwd_scans = lstm2_fwd_scan_counts()
        fit_s = time.perf_counter() - t
        steps = hist["steps_per_epoch"][0]
        log(f"route {route}: Trainer.fit {steps} steps, loss {hist['loss']}, "
            f"{fit_s:.1f} s; kernel launches {launches}, plain version "
            f"calls {plain}; lstm_rec scans (cluster, streamed) {scans}; "
            f"lstm2_fwd scans {stack_fwd_scans}, lstm2_bwd scans "
            f"{stack_scans}")
        want = {k: per_step.get(k, 0) * steps for k in launches}
        if launches != want or plain != 0:
            fail(f"route {route}: launches {launches}, expected {want} and "
                 f"no plain call")
        for d, ran in scans.items():
            if (rc.compute_dtype == "bfloat16"
                    and ran != (launches[f"lstm_rec_{d}"], 0)):
                fail(f"route {route}: the bfloat16 recurrence {d} ran scans "
                     f"{ran}, not {(launches[f'lstm_rec_{d}'], 0)} on the "
                     f"cluster route")
        for d, ran in (("fwd", stack_fwd_scans), ("bwd", stack_scans)):
            want = (2 * launches[f"lstm2_{d}"], 0)
            if rc.compute_dtype == "bfloat16" and ran != want:
                fail(f"route {route}: the bfloat16 lstm2 {d} ran scans "
                     f"{ran}, not {want} on the cluster route")
        if not np.isfinite(hist["loss"]).all():
            fail(f"route {route}: non-finite training loss")
        reset_counts()
        metrics = trainer.evaluate(ds)
        ev, _ = read_counts()
        fwd_only = all(v == 0 for k, v in ev.items() if k.endswith("bwd"))
        if not np.isfinite(metrics["loss"]) or not fwd_only:
            fail(f"route {route}: evaluate() failed: {metrics}, {ev}")
        model, loaded = build_or_load(rc, "cuda")
        same = all(torch.equal(v, trainer.model.state_dict()[k])
                   for k, v in model.state_dict().items())
        if not loaded or not same:
            fail(f"route {route}: the checkpoint did not reload")
        log(f"route {route}: evaluate() loss {metrics['loss']:.6f} "
            f"(forward launches {ev}), checkpoint reloaded")
        counts[route] = launches
    return counts


def parity_step(cfg, r4, batch):
    """Phase 3d: the dropout-0 step, kernels against the plain stacks, held
    to the bar on fresh weights and read on the trained r4 weights."""
    from music_generator_tpu_torch.models.deepj import build_model
    fresh = build_model(cfg, "cpu", seed=0).state_dict()
    log(f"step on fresh weights (seed 0), bar {PARITY_BAR}:")
    for act in ("sigmoid", "hard_sigmoid"):
        d_loss, g_rel, p_err, b_loss, b_cos, gap, _, _ = step_readings(
            cfg, fresh, batch, act, log=log)
        if d_loss > 1e-5 or g_rel > F32_GRAD_REL or p_err > STEP_ATOL:
            fail(f"float32 step with {act} gates: kernels and plain "
                 f"stacks disagree")
        if (b_loss > PARITY_BAR[0] or b_cos < PARITY_BAR[1]
                or gap > PARITY_BAR[2]):
            fail(f"bfloat16 step with {act} gates misses the bar")
    log("step on the trained r4 weights (read, no bar):")
    step_readings(cfg, r4, batch, "sigmoid", log=log)


def route_parity_step(cfg, batch):
    """Phase 3f: the dropout-0 step of 3d on each per-axis route, on fresh
    weights.  Float32 kernels against the float32 plain path as in 3d;
    bfloat16 kernels against the float32 plain path held to PARITY_BAR,
    unless the bfloat16 plain path misses the bar too: then both readings
    are printed and the kernels are held to the bfloat16 plain step
    (post-update loss gap <= PARITY_BAR[2])."""
    from music_generator_tpu_torch.models.deepj import build_model
    for route in ("axis_fused", "per_layer"):
        rc = cfg.replace(**ROUTES[route][0])
        fresh = build_model(rc, "cpu", seed=0).state_dict()
        log(f"route {route}: step on fresh weights (seed 0), bar "
            f"{PARITY_BAR}:")
        for act in ("sigmoid", "hard_sigmoid"):
            readings = step_readings(rc, fresh, batch, act, log=log)
            try:
                step_bars(readings, f"route {route} {act}", log)
            except CheckFailed as e:
                fail(str(e))


def biax_bound_ms(name: str, cfg, T: int, bf16: bool):
    """Least time of one launch at these shapes: every input read once and
    every output written once at HBM rate, or its operations (the Pallas
    kernels' CostEstimate counts) at the peak of the compute dtype.
    Returns (ms, "bytes" or "operations")."""
    from music_generator_tpu_torch.models.deepj import feature_dim
    it = 2 if bf16 else 4
    N, B, C = cfg.num_notes, cfg.batch_size, cfg.note_units
    if name.startswith("biax_time"):
        Fin, H = feature_dim(cfg), cfg.time_axis_units
        ins = T * N * B * Fin * it + T * B * (Fin + H) * it
        ws = (Fin + 3 * H) * 4 * H * it + 2 * 4 * H * it
        ew = 20
    else:
        Ht, H = cfg.time_axis_units, cfg.note_axis_units
        Fin = Ht + C
        ins = (T * N * B * Fin * it + T * B * (Fin + H) * it)
        ws = (Fin + 3 * H) * 4 * H * it + 2 * 4 * H * it + H * 3 * it + 12
        ew = 0
    R, H4 = T * N * B, 4 * H
    tapes = 4 * R * H * it
    grads = ((Fin + 3 * H) * H4 + 2 * H4) * 4 + T * B * (Fin + H) * 4
    if name.endswith("fwd"):
        flops = 2 * R * (Fin + 3 * H) * H4 + ew * R * H4
        out = R * H * it if name.startswith("biax_time") else R * 3 * 4
        nbytes = ins + ws + out + tapes
    else:
        flops = 6 * R * (Fin + 3 * H) * H4 + 2 * ew * R * H4
        dout = R * H * it if name.startswith("biax_time") else R * 3 * 4
        nbytes = 2 * ins + ws + tapes + dout + grads
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_biax(cfg, card):
    """ms per launch of each biaxial kernel and of its plain version, at
    the training main path's shapes (bfloat16, sigmoid gates, dropout as
    configured); cuDNN's two-layer LSTM at the time stack's shapes is
    logged for orientation only (it computes another function)."""
    from music_generator_tpu_torch.ops import biax
    T = cfg.seq_len
    times = {}
    kw = dict(dropout_p=cfg.dropout, seed=99, compute_dtype=torch.bfloat16,
              recurrent_activation="sigmoid")
    for kind in ("time", "note"):
        args = [a.requires_grad_(True) for a in stack_inputs(kind, cfg, T, 5)]
        for label, fn, reps in (("kernel", getattr(biax, f"biax_{kind}_stack"),
                                 10),
                                ("plain", getattr(
                                    biax, f"biax_{kind}_stack_reference"), 2)):
            out = fn(*args, **kw)
            cot = torch.ones_like(out)
            fwd = cuda_ms(lambda: fn(*args, **kw), reps)
            bwd = cuda_ms(lambda: torch.autograd.grad(
                out, args, cot, retain_graph=True), reps)
            times[(kind, label)] = (fwd, bwd)
            del out
        for d in ("fwd", "bwd"):
            name = f"biax_{kind}_{d}"
            i = 0 if d == "fwd" else 1
            bound, by = biax_bound_ms(name, cfg, T, True)
            log(f"{name}: kernel {times[(kind, 'kernel')][i]:.4f} ms/launch, "
                f"plain version {times[(kind, 'plain')][i]:.4f} ms, bound "
                f"{bound:.6f} ms by {by} (T={T}, B={cfg.batch_size}, "
                f"bfloat16; {card})")
    for kind in ("time", "note"):
        fwd_passes(cfg, card, kind)
        bwd_passes(cfg, card, kind)
    rec_fwd_scans(cfg, card)
    rec_bwd_passes(cfg, card)
    lstm2_fwd_passes(cfg, card)
    lstm2_bwd_passes(cfg, card)
    H, N, B = cfg.time_axis_units, cfg.num_notes, cfg.batch_size
    from music_generator_tpu_torch.models.deepj import feature_dim
    lstm = torch.nn.LSTM(feature_dim(cfg), H, num_layers=2).cuda().to(
        torch.bfloat16)
    lstm.flatten_parameters()
    x = torch.randn(T, N * B, feature_dim(cfg), device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    y, _ = lstm(x)
    fwd = cuda_ms(lambda: lstm(x), 10)
    bwd = cuda_ms(lambda: torch.autograd.grad(
        y, [x] + list(lstm.parameters()), torch.ones_like(y),
        retain_graph=True), 10)
    log(f"for orientation only: cuDNN nn.LSTM(num_layers=2) at the time "
        f"stack's shapes (T={T}, batch {N * B}, {feature_dim(cfg)}->{H}, "
        f"bfloat16; no style terms, masks or hard gates): forward {fwd:.4f} "
        f"ms, backward {bwd:.4f} ms ({card})")
    return {f"biax_{k}_{d}": (times[(k, "kernel")][i], times[(k, "plain")][i])
            for k in ("time", "note") for i, d in enumerate(("fwd", "bwd"))}


@contextlib.contextmanager
def forced_scan_route(route: str):
    """Run the scans of the biaxial stacks, of the recurrence and of the
    fused stack on `route` whatever the dtype."""
    from music_generator_tpu_torch.ops import biax
    saved = biax.scan_route
    biax.scan_route = lambda cdt: route
    try:
        yield
    finally:
        biax.scan_route = saved


def pass_ms(runs):
    """{pass name: mean ms} from the marks of runs queued back to back,
    the first run dropped."""
    return {name: float(np.mean([m[i][1].elapsed_time(m[i + 1][1])
                                 for m in runs[1:]]))
            for i, (name, _) in enumerate(runs[0][1:])}


def check_plan(what: str, R: int, row) -> None:
    """Fail unless a cluster scan's plan (its scan_prof row: rows a
    cluster at 5, clusters resident at 8) takes one wave over R rows."""
    clusters = -(-R // row[5])
    if clusters > row[8]:
        fail(f"the {what}'s plan needs {clusters} clusters, more than the "
             f"{row[8]} resident: two waves")


def fwd_passes(cfg, card, kind: str, reps: int = 6):
    """ms of each pass of a stack's forward (`biax_{kind}_fwd`, bfloat16,
    the training shapes, tapes on): CUDA events between the passes of
    `reps` forwards queued back to back, the first dropped; on the cluster
    route (the main path's) and on the streamed route (the float32
    route's scans, run in bfloat16 for comparison).  Logs the cluster
    scans' clock cycles per step and phase (block 0) and their plan, and
    fails unless the plan's clusters are all resident at once."""
    from music_generator_tpu_torch.ops import biax
    T = cfg.seq_len
    args = stack_inputs(kind, cfg, T, 5)
    kw = dict(dropout_p=cfg.dropout, seed=99, compute_dtype=torch.bfloat16,
              recurrent_activation="sigmoid")
    S, R = ((T, cfg.num_notes * cfg.batch_size) if kind == "time" else
            (cfg.num_notes, T * cfg.batch_size))
    fwd = getattr(biax, f"biax_{kind}_fwd")
    for route in ("cluster", "streamed"):
        prof = torch.zeros(2, 9, dtype=torch.int64, device="cuda")
        with forced_scan_route(route):
            runs = []
            for _ in range(reps):
                marks = []
                fwd(*args, **kw, marks=marks, scan_prof=prof)
                runs.append(marks)
            torch.cuda.synchronize()
        per = pass_ms(runs)
        log(f"biax_{kind}_fwd passes, {route} scans (ms, mean of "
            f"{reps - 1}): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         per.items())
            + f"; sum {sum(per.values()):.4f} ({card})")
        if route == "cluster":
            for layer, row in enumerate(prof.cpu().tolist()):
                log(f"{kind} forward cluster scan layer {layer}: clock "
                    f"cycles per step of block 0: product with block "
                    f"barrier {row[0] / S:.0f}, own cell work "
                    f"{row[1] / S:.0f}, cluster barrier {row[2] / S:.0f}; "
                    f"cluster {row[4]} blocks, {row[5]} rows, {row[6]} "
                    f"units a block, {row[7]} K parts, {-(-R // row[5])} "
                    f"clusters of {row[8]} resident")
                check_plan(f"{kind} forward cluster scan", R, row)


def bwd_passes(cfg, card, kind: str, reps: int = 6):
    """ms of each pass of a stack's backward (`biax_{kind}_bwd`, bfloat16,
    the training shapes): CUDA events between the passes of `reps`
    backwards queued back to back, the first dropped; on the cluster route
    (the main path's) and on the streamed route (the float32 route's
    scans, run in bfloat16 for comparison).  Logs the cluster scans' clock
    cycles per step and phase (block 0) and their plan, and fails unless
    the plan's clusters are all resident at once (one wave)."""
    from music_generator_tpu_torch.ops import biax
    T = cfg.seq_len
    args = stack_inputs(kind, cfg, T, 5)
    kw = dict(dropout_p=cfg.dropout, seed=99, compute_dtype=torch.bfloat16,
              recurrent_activation="sigmoid")
    tapes = getattr(biax, f"biax_{kind}_fwd")(*args, **kw)
    if kind == "time":
        S, R = T, cfg.num_notes * cfg.batch_size
        cot = torch.ones(T, cfg.num_notes, cfg.batch_size,
                         cfg.time_axis_units, device="cuda")
    else:
        S, R = cfg.num_notes, T * cfg.batch_size
        cot = torch.ones(cfg.num_notes, T, cfg.batch_size, 3, device="cuda")
        tapes = tapes[1:]
    bwd = getattr(biax, f"biax_{kind}_bwd")
    for route in ("cluster", "streamed"):
        prof = torch.zeros(2, 9, dtype=torch.int64, device="cuda")
        with forced_scan_route(route):
            runs = []
            for _ in range(reps):
                marks = []
                bwd(*args, *tapes, cot, **kw, marks=marks, scan_prof=prof)
                runs.append(marks)
            torch.cuda.synchronize()
        per = pass_ms(runs)
        log(f"biax_{kind}_bwd passes, {route} scans (ms, mean of "
            f"{reps - 1}): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         per.items())
            + f"; sum {sum(per.values()):.4f} ({card})")
        if route == "cluster":
            for layer, row in zip((1, 0), prof.cpu().tolist()):
                clusters = -(-R // row[5])
                log(f"{kind} cluster scan layer {layer}: clock cycles per "
                    f"step of block 0: own cell work {row[0] / S:.0f}, dz "
                    f"exchange and barrier {row[1] / S:.0f}, product "
                    f"{row[2] / S:.0f}, second barrier {row[3] / S:.0f}; "
                    f"cluster {row[4]} blocks, {row[5]} rows, {row[6]} "
                    f"units a block, {row[7]} K parts, {clusters} clusters "
                    f"of {row[8]} resident")
                check_plan(f"{kind} cluster scan", R, row)


def rec_bwd_passes(cfg, card, reps: int = 6):
    """ms of each pass of kernel 9 (`lstm_recurrence_bwd`: tapes, preact,
    scan, wgrad) at the time and note axes' shapes (T = seq_len, bfloat16,
    sigmoid gates) on kernel 8's tapes: CUDA events between the passes of
    `reps` backwards queued back to back, the first dropped; on the
    cluster route (the main path's) and on the streamed route (the float32
    route's scan, run in bfloat16 for comparison).  Logs the cluster scan's
    clock cycles per step and phase (block 0) and its plan, and fails
    unless the plan's clusters are all resident at once (one wave).
    Returns {axis: {pass: ms}} of the cluster route."""
    from music_generator_tpu_torch.ops import recurrence
    kw = dict(compute_dtype=torch.bfloat16, recurrent_activation="sigmoid")
    out = {}
    for axis, S, R, F, H in axis_shapes(cfg, cfg.seq_len):
        xw, u, h0, c0 = lstm_inputs("lstm_rec", S, R, F, H, 7)
        hs, cs, _, _ = recurrence.lstm_recurrence_fwd(xw, u, h0, c0, **kw)
        cots = [torch.ones(S, R, H, device="cuda"),
                torch.ones(R, H, device="cuda"),
                torch.ones(R, H, device="cuda")]
        for route in ("cluster", "streamed"):
            prof = torch.zeros(9, dtype=torch.int64, device="cuda")
            with forced_scan_route(route):
                runs = []
                for _ in range(reps):
                    marks = []
                    recurrence.lstm_recurrence_bwd(xw, u, h0, hs, cs, *cots,
                                                   **kw, marks=marks,
                                                   scan_prof=prof)
                    runs.append(marks)
                torch.cuda.synchronize()
            per = pass_ms(runs)
            log(f"lstm_rec_bwd {axis} axis passes, {route} scan (ms, mean "
                f"of {reps - 1}; S={S}, R={R}, H={H}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
                + f"; sum {sum(per.values()):.4f} ({card})")
            if route == "cluster":
                out[axis] = per
                row = prof.cpu().tolist()
                log(f"lstm_rec_bwd {axis} cluster scan: clock cycles per "
                    f"step of block 0: own cell work {row[0] / S:.0f}, dz "
                    f"exchange and barrier {row[1] / S:.0f}, product "
                    f"{row[2] / S:.0f}, second barrier {row[3] / S:.0f}; "
                    f"cluster {row[4]} blocks, {row[5]} rows, {row[6]} "
                    f"units a block, {row[7]} K parts, {-(-R // row[5])} "
                    f"clusters of {row[8]} resident")
                check_plan(f"lstm_rec_bwd {axis} cluster scan", R, row)
    return out


def lstm2_bwd_passes(cfg, card, reps: int = 6):
    """ms of each pass of kernel 7 (`lstm2_bwd`: tapes, prologue, preact,
    scan1, dx1, scan0, dx0, wgrad) at the time and note axes' shapes (T =
    seq_len, bfloat16, sigmoid gates, the configured dropout) on kernel
    6's tapes: CUDA events between the passes of `reps` backwards queued
    back to back, the first dropped; on the cluster route (the main
    path's) and on the streamed route (the float32 route's scans, run in
    bfloat16 for comparison).  Logs both cluster scans' clock cycles per
    step and phase (block 0) and their plans, and fails unless each plan's
    clusters are all resident at once (one wave)."""
    from music_generator_tpu_torch.ops import lstm2
    kw = dict(dropout_p=cfg.dropout, seed=99, compute_dtype=torch.bfloat16,
              recurrent_activation="sigmoid")
    for axis, S, R, F, H in axis_shapes(cfg, cfg.seq_len):
        args, (c00, c10), cots = lstm2_bwd_args(S, R, F, H, 7, ones=True)
        x0, s1m, w0, b0, b1, u0, w1, u1, h00, h10 = args
        tapes = lstm2.lstm2_fwd(x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00,
                                h10, c10, **kw)[:4]
        for route in ("cluster", "streamed"):
            prof = torch.zeros(2, 9, dtype=torch.int64, device="cuda")
            with forced_scan_route(route):
                runs = []
                for _ in range(reps):
                    marks = []
                    lstm2.lstm2_bwd(*args, *tapes, *cots, **kw, marks=marks,
                                    scan_prof=prof)
                    runs.append(marks)
                torch.cuda.synchronize()
            per = pass_ms(runs)
            log(f"lstm2_bwd {axis} axis passes, {route} scans (ms, mean of "
                f"{reps - 1}; S={S}, R={R}, F={F}, H={H}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
                + f"; sum {sum(per.values()):.4f} ({card})")
            if route == "cluster":
                for layer, row in zip((1, 0), prof.cpu().tolist()):
                    log(f"lstm2_bwd {axis} cluster scan layer {layer}: clock "
                        f"cycles per step of block 0: own cell work "
                        f"{row[0] / S:.0f}, dz exchange and barrier "
                        f"{row[1] / S:.0f}, product {row[2] / S:.0f}, second "
                        f"barrier {row[3] / S:.0f}; cluster {row[4]} blocks, "
                        f"{row[5]} rows, {row[6]} units a block, {row[7]} K "
                        f"parts, {-(-R // row[5])} clusters of {row[8]} "
                        f"resident")
                    check_plan(f"lstm2_bwd {axis} cluster scan layer {layer}",
                               R, row)


def lstm2_fwd_passes(cfg, card, reps: int = 6):
    """ms of each pass of kernel 6 (`lstm2_fwd`: xp, in0, scan0, x1, in1,
    scan1) at the time and note axes' shapes (T = seq_len, bfloat16,
    sigmoid gates, the configured dropout, tapes on): CUDA events between
    the passes of `reps` forwards queued back to back, the first dropped;
    on the cluster route (the main path's) and on the streamed route (the
    float32 route's scans, run in bfloat16 for comparison), beside cuDNN's
    two-layer forward at the same shapes (for orientation: no s1m, masks
    or initial states of its own).  Logs both cluster scans' clock cycles
    per step and phase (block 0) and their plans, and fails unless each
    plan's clusters are all resident at once (one wave)."""
    from music_generator_tpu_torch.ops import lstm2
    kw = dict(dropout_p=cfg.dropout, seed=99, compute_dtype=torch.bfloat16,
              recurrent_activation="sigmoid")
    for axis, S, R, F, H in axis_shapes(cfg, cfg.seq_len):
        args = lstm_inputs("lstm2", S, R, F, H, 7)
        cudnn = torch.nn.LSTM(F, H, num_layers=2).cuda().to(torch.bfloat16)
        cudnn.flatten_parameters()
        x = torch.randn(S, R, F, device="cuda", dtype=torch.bfloat16)
        with torch.no_grad():
            lib = cuda_ms(lambda: cudnn(x), 10)
        for route in ("cluster", "streamed"):
            prof = torch.zeros(2, 9, dtype=torch.int64, device="cuda")
            with forced_scan_route(route):
                runs = []
                for _ in range(reps):
                    marks = []
                    lstm2.lstm2_fwd(*args, **kw, marks=marks, scan_prof=prof)
                    runs.append(marks)
                torch.cuda.synchronize()
            per = pass_ms(runs)
            log(f"lstm2_fwd {axis} axis passes, {route} scans (ms, mean of "
                f"{reps - 1}; S={S}, R={R}, F={F}, H={H}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
                + f"; sum {sum(per.values()):.4f}; cuDNN nn.LSTM("
                f"num_layers=2) forward, no grad, {lib:.4f} ({card})")
            if route == "cluster":
                for layer, row in enumerate(prof.cpu().tolist()):
                    log(f"lstm2_fwd {axis} cluster scan layer {layer}: clock "
                        f"cycles per step of block 0: product with block "
                        f"barrier {row[0] / S:.0f}, own cell work "
                        f"{row[1] / S:.0f}, cluster barrier {row[2] / S:.0f}; "
                        f"cluster {row[4]} blocks, {row[5]} rows, {row[6]} "
                        f"units a block, {-(-R // row[5])} clusters of "
                        f"{row[8]} resident")
                    check_plan(f"lstm2_fwd {axis} cluster scan layer {layer}",
                               R, row)


def rec_fwd_scans(cfg, card, reps: int = 10):
    """ms a launch of kernel 8 (`lstm_recurrence_fwd`: one forward scan
    with its ends) at the time and note axes' shapes (T = seq_len, xw in
    bfloat16 as lstm_scan gives it, sigmoid gates, tapes on): CUDA events
    around `reps` launches after a warm-up, on the cluster route (the main
    path's) and on the streamed route (the float32 route's scan, run in
    bfloat16 for comparison).  Logs the cluster scan's clock cycles per
    step and phase (block 0) and its plan, and fails unless the plan's
    clusters are all resident at once (one wave)."""
    from music_generator_tpu_torch.ops import recurrence
    kw = dict(compute_dtype=torch.bfloat16, recurrent_activation="sigmoid")
    for axis, S, R, F, H in axis_shapes(cfg, cfg.seq_len):
        xw, u, h0, c0 = lstm_inputs("lstm_rec", S, R, F, H, 7)
        xw = xw.to(torch.bfloat16)
        bound, by = lstm_bound_ms("lstm_rec_fwd", S, R, F, H)
        for route in ("cluster", "streamed"):
            prof = torch.zeros(9, dtype=torch.int64, device="cuda")
            with forced_scan_route(route):
                ms = cuda_ms(lambda: recurrence.lstm_recurrence_fwd(
                    xw, u, h0, c0, **kw, scan_prof=prof), reps)
            log(f"lstm_rec_fwd {axis} axis, {route} scan: {ms:.4f} ms a "
                f"launch (mean of {reps}; S={S}, R={R}, H={H}, bfloat16; "
                f"bound {bound:.6f} ms by {by}; {card})")
            if route == "cluster":
                row = prof.cpu().tolist()
                log(f"lstm_rec_fwd {axis} cluster scan: clock cycles per "
                    f"step of block 0: product with block barrier "
                    f"{row[0] / S:.0f}, own cell work {row[1] / S:.0f}, "
                    f"cluster barrier {row[2] / S:.0f}; cluster {row[4]} "
                    f"blocks, {row[5]} rows, {row[6]} units a block, "
                    f"{-(-R // row[5])} clusters of {row[8]} resident")
                check_plan(f"lstm_rec_fwd {axis} cluster scan", R, row)


def lstm_bound_ms(name: str, S: int, R: int, F: int, H: int):
    """Least time of one bfloat16 launch at these shapes: every input read
    once and every output (and tape) written once at HBM rate, or the
    Pallas kernels' CostEstimate operations at the bfloat16 peak.  Returns
    (ms, "bytes" or "operations")."""
    it, H4 = 2, 4 * H
    seq = S * R * H * it                  # one [S, R, H] tape
    st = R * H * 4                        # one float32 state
    if name.startswith("lstm2"):
        ws = (F + 3 * H) * H4 * it + 2 * H4 * it
        ins = S * R * F * it + seq        # x0, s1m
        if name.endswith("fwd"):
            flops = 2 * S * R * (F + 3 * H) * H4 + 20 * S * R * H4
            nbytes = ins + ws + 4 * st + 4 * seq + 4 * st
        else:
            flops = 6 * S * R * (F + 3 * H) * H4 + 40 * S * R * H4
            grads = ((F + 3 * H) * H4 + 2 * H4) * 4
            nbytes = 2 * ins + ws + 5 * seq + 2 * st + grads + 4 * st
    else:
        xw = S * R * H4 * it
        if name.endswith("fwd"):
            flops = 2 * S * R * H * H4 + 10 * S * R * H4
            nbytes = xw + H * H4 * it + 2 * st + 2 * seq + 2 * st
        else:
            flops = 6 * S * R * H * H4 + 30 * S * R * H4
            nbytes = (xw + H * H4 * it + 2 * seq + 2 * seq + st + xw
                      + H * H4 * 4 + 2 * st)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_lstm(cfg, card):
    """ms per launch of each per-axis kernel and of its plain version at
    the flagship's time- and note-axis shapes (T = seq_len, bfloat16,
    sigmoid gates, lstm2 at the configured dropout), with each bound;
    cuDNN's one-layer nn.LSTM against the port's whole lstm_scan
    (projection + recurrence) at each axis's first-layer shapes, the
    recurrence's library time; cuDNN's two-layer LSTM beside lstm2 for
    orientation only (it lacks s1m and the masks).  Returns {(kernel,
    axis): (ms, plain ms, library ms or None)}."""
    from music_generator_tpu_torch.ops import lstm2, recurrence
    from music_generator_tpu_torch.ops.lstm import lstm_scan
    out = {}
    bf = torch.bfloat16
    for axis, S, R, F, H in axis_shapes(cfg, cfg.seq_len):
        for kind, fn, plain, kw in (
                ("lstm2", lstm2.lstm2_stack, lstm2.lstm2_stack_reference,
                 dict(dropout_p=cfg.dropout, seed=99)),
                ("lstm_rec", recurrence.lstm_recurrence,
                 recurrence.lstm_recurrence_reference, {})):
            kw = dict(kw, compute_dtype=bf, recurrent_activation="sigmoid")
            args = [a.requires_grad_(True)
                    for a in lstm_inputs(kind, S, R, F, H, 7)]
            times = {}
            for label, f, reps in (("kernel", fn, 10), ("plain", plain, 2)):
                seq, fin = f(*args, **kw)
                outs = [o for o in (seq, *fin) if o.requires_grad]
                cots = [torch.ones_like(o) for o in outs]
                fwd = cuda_ms(lambda: f(*args, **kw), reps)
                bwd = cuda_ms(lambda: torch.autograd.grad(
                    outs, args, cots, retain_graph=True), reps)
                times[label] = (fwd, bwd)
                del seq, fin, outs
            lib = (None, None)
            if kind == "lstm_rec":
                x = torch.randn(S, R, F, device="cuda", dtype=bf,
                                requires_grad=True)
                cudnn = torch.nn.LSTM(F, H, device="cuda", dtype=bf)
                cudnn.flatten_parameters()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    y, _ = cudnn(x)
                    lib = (cuda_ms(lambda: cudnn(x), 10), cuda_ms(
                        lambda: torch.autograd.grad(
                            y, [x, *cudnn.parameters()], torch.ones_like(y),
                            retain_graph=True), 10))
                # The copy cuDNN repeats at every call when it compacts:
                # the 4H (F + H) + 8H weight values into one buffer.
                flat = torch.empty(sum(p.numel() for p in cudnn.parameters()),
                                   device="cuda", dtype=bf)
                copy = cuda_ms(lambda: torch.cat(
                    [p.detach().reshape(-1) for p in cudnn.parameters()],
                    out=flat), 10)
                compacted = any("compacted" in str(w.message) for w in caught)
                params = torch.nn.Module()
                for pname, shape in (("kernel", (F, 4 * H)),
                                     ("recurrent", (H, 4 * H)),
                                     ("bias", (4 * H,))):
                    setattr(params, pname, torch.nn.Parameter(
                        torch.randn(*shape, device="cuda") * 0.05))
                hs, _ = lstm_scan(params, x, compute_dtype=bf)
                scan = (cuda_ms(lambda: lstm_scan(params, x,
                                                  compute_dtype=bf), 10),
                        cuda_ms(lambda: torch.autograd.grad(
                            hs, [x, *params.parameters()],
                            torch.ones_like(hs), retain_graph=True), 10))
                log(f"lstm_scan {axis} axis (S={S}, R={R}, {F}->{H}, "
                    f"bfloat16): port forward {scan[0]:.4f} ms, backward "
                    f"{scan[1]:.4f} ms; cuDNN nn.LSTM forward {lib[0]:.4f} "
                    f"ms, backward {lib[1]:.4f} ms; the weight copy "
                    f"({flat.numel()} values) {copy:.4f} ms, cuDNN less it "
                    f"forward {lib[0] - copy:.4f}, backward "
                    f"{lib[1] - copy:.4f} (cuDNN compacted its weights at "
                    f"every call: {compacted}; {card})")
                del y, hs
            else:
                x = torch.randn(S, R, F, device="cuda", dtype=bf,
                                requires_grad=True)
                cudnn = torch.nn.LSTM(F, H, num_layers=2).cuda().to(bf)
                cudnn.flatten_parameters()
                y, _ = cudnn(x)
                o_f = cuda_ms(lambda: cudnn(x), 10)
                o_b = cuda_ms(lambda: torch.autograd.grad(
                    y, [x, *cudnn.parameters()], torch.ones_like(y),
                    retain_graph=True), 10)
                log(f"for orientation only: cuDNN nn.LSTM(num_layers=2) at "
                    f"the {axis} axis's shapes (S={S}, R={R}, {F}->{H}, "
                    f"bfloat16; no s1m, masks or hard gates): forward "
                    f"{o_f:.4f} ms, backward {o_b:.4f} ms ({card})")
                del y
            for i, d in enumerate(("fwd", "bwd")):
                bound, by = lstm_bound_ms(f"{kind}_{d}", S, R, F, H)
                out[(f"{kind}_{d}", axis)] = (times["kernel"][i],
                                              times["plain"][i], lib[i])
                log(f"{kind}_{d} {axis} axis: kernel "
                    f"{times['kernel'][i]:.4f} ms/launch, plain version "
                    f"{times['plain'][i]:.4f} ms, bound {bound:.6f} ms by "
                    f"{by} (S={S}, R={R}, F={F}, H={H}, bfloat16; {card})")
    return out


def time_train_step(cfg, state, batch, card):
    """ms per training step at the flagship (bfloat16, dropout on): median
    of 12 steps after 3 warm-up steps, host clock around synchronised
    steps; the device's busy share from one profiled step."""
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.parallel.train_step import (
        create_train_state, train_step)
    model = build_model(cfg, "cuda")
    st = create_train_state(model, 0)
    model.load_state_dict(state)
    for _ in range(3):
        train_step(st, batch)
    reps = []
    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = train_step(st, batch)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t) * 1e3)
        if not torch.isfinite(m["loss"]):
            fail("non-finite training loss while timing")
    step = float(np.median(reps))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_step(st, batch)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = e.self_device_time_total / 1e3
    device = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    rate = cfg.batch_size * cfg.seq_len / (step / 1e3)
    log(f"train step: B={cfg.batch_size}, T={cfg.seq_len}, bfloat16: "
        f"{step:.4f} ms (median of {', '.join(f'{r:.4f}' for r in reps)}), "
        f"{rate:.1f} timesteps/s; device {device:.4f} ms/step, busy share "
        f"{device / step:.3f} ({card})")
    log("train step device time by kernel (ms): " + "; ".join(
        f"{k[:60]} {v:.4f}" for k, v in top))
    return step, rate


def check_mask_kernel():
    """Kernel 10 (`dump_masks`) against its plain version (`stack_masks`)
    with torch.equal, bit for bit: float32 and bfloat16, dropout 0.1 and
    0.5, two seeds, at MASK_SHAPES.  Returns the largest |difference|."""
    from music_generator_tpu_torch.ops import lstm2
    err, cases = 0.0, 0
    for S, R, H in MASK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for p in (0.1, 0.5):
                for seed in (7, 1234):
                    got = lstm2.dump_masks(seed, S, R, H, p, dt, "cuda")
                    want = lstm2.stack_masks(seed, S, R, H, 1.0 - p, dt,
                                             "cuda")
                    torch.cuda.synchronize()
                    cases += 1
                    err = max(err, float((got.float() - want.float())
                                         .abs().max()))
                    if not torch.equal(got, want):
                        fail(f"lstm2_masks S={S} R={R} H={H} {dt} p={p} "
                             f"seed={seed} differs from stack_masks")
    log(f"lstm2_masks: {cases} cases equal to stack_masks bit for bit "
        f"(shapes {MASK_SHAPES}, float32 and bfloat16, p 0.1 and 0.5, "
        f"seeds 7 and 1234)")
    return err


def slice_counts():
    """{kernel name: launches} of every kernel, the pitch loop and the
    mask dump included."""
    from music_generator_tpu_torch.ops import lstm2, notegen
    launches, _ = read_counts()
    launches["notegen"] = notegen.note_sample.launches
    launches["lstm2_masks"] = lstm2.dump_masks.launches
    return launches


def reset_slice_counts():
    from music_generator_tpu_torch.ops import lstm2, notegen
    reset_counts()
    notegen.note_sample.launches = 0
    notegen.note_sample_streamed.launches = 0
    notegen.note_sample_reference.calls = 0
    lstm2.dump_masks.launches = 0


def validators():
    """Phase 3g: the port's validators on the card, as a user runs them:
    validate_lstm2 at its sizes (kernels 6-10) and validate_biax on both
    gate flavors (kernels 2-5).  A missed bar fails."""
    from music_generator_tpu_torch.tools import validate_biax, validate_lstm2
    try:
        log("validate_lstm2:")
        validate_lstm2.main(["--device", "cuda"])
        for gates in ("sigmoid", "hard_sigmoid"):
            log(f"validate_biax --gates {gates}:")
            validate_biax.main(["--gates", gates, "--device", "cuda"])
    except CheckFailed as e:
        fail(f"validator: {e}")


def primed_generation(cfg):
    """Phase 3h: primed continuation on the card.  generate_main --prime
    writes the prime and its continuation; the committed primed demos
    regenerate from their own first 8 bars (events required, bytes
    reported); priming with a run's own first K steps (K not bar-aligned)
    continues it bit for bit; check_fidelity at seeds 0 and 1 certifies
    the card's files against the CPU (events required on every file)."""
    from music_generator_tpu_torch.cli import generate_main
    from music_generator_tpu_torch.data.dataset import (compute_genre,
                                                        decode_prime)
    from music_generator_tpu_torch.generation.sampler import (
        GenerationResult, Sampler, prepend_prime, write_file)
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.params import load_params_npz
    from music_generator_tpu_torch.tools import check_fidelity
    from music_generator_tpu_torch.utils import one_hot
    npb = cfg.notes_per_bar
    work = os.path.join(WORK, "primed")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        baroque = os.path.join(DEMOS, "primed_Baroque.mid")
        paths = generate_main(["--params", PARAMS, "--prime", baroque,
                               "--prime-bars", "8", "--bars", "2"])
    finally:
        os.chdir(cwd)
    prime = decode_prime(baroque, 8, config=cfg)
    for p in paths:
        head = decode_prime(os.path.join(work, p), 8, config=cfg)
        if not np.array_equal(head[..., :2], prime[..., :2]):
            fail(f"{p}: the written piece does not start with the prime")
    if len(paths) != 3:
        fail(f"generate_main --prime wrote {len(paths)} files, not 3")
    log(f"generate_main --prime: {len(paths)} files of 8 prime + 2 bars")

    m = build_model(cfg, "cuda", state=load_params_npz(
        os.path.join(ROOT, "artifacts", "real_corpus_r3", "params.npz")))
    n_bytes = 0
    for genre, slot in PRIMED_DEMOS:
        ref = os.path.join(DEMOS, f"primed_{genre}.mid")
        prime = decode_prime(ref, 8, config=cfg).astype(np.float32)
        res = Sampler(m).generate([one_hot(slot, cfg.num_styles)],
                                  num_bars=8, seed=0, temperature=0.75,
                                  prime=prime)
        (out,) = write_file(f"demo_{genre}", GenerationResult(
            prepend_prime(res.notes, prime), res.styles),
            cfg.replace(out_dir=work))
        n_bytes += check_sample(out, ref)
    log(f"primed demos: {n_bytes}/3 byte-identical, 3/3 event-identical")

    sampler = Sampler(build_model(cfg, "cuda", state=load_params_npz(PARAMS)))
    styles = [compute_genre(i, cfg) for i in range(3)]
    K = 2 * npb + 5
    full = sampler.generate(styles, num_bars=5, seed=5)
    cont = sampler.generate(styles, num_bars=2, seed=5,
                            prime=full.notes[:, :K])
    same = (cont.notes.shape[1] == 2 * npb
            and np.array_equal(cont.notes, full.notes[:, K:K + 2 * npb]))
    log(f"self-consistency: priming with the run's own first {K} steps "
        f"continues it bit for bit: {same}")
    if not same:
        fail("the primed continuation differs from the run it continues")

    fid = os.path.join(work, "fidelity")
    report = check_fidelity.main(["--out", fid, "--seeds", "0", "1",
                                  "--bars", "4"])
    for key in ("cuda_vs_cpu", "padded_vs_cpu"):
        r = report[key]
        log(f"check_fidelity {key}: {r['files'] - len(r['mismatches'])}/"
            f"{r['files']} byte-identical, "
            f"{r['files'] - len(r['event_mismatches'])}/{r['files']} "
            f"event-identical; byte mismatches {r['mismatches']}")
        if not r["event_identical"]:
            fail(f"check_fidelity {key}: notes differ in "
                 f"{r['event_mismatches']}")
    return report


def check_notegen_plans(cfg):
    """Print the cluster pitch-loop kernel's plan at G = 1, 3, 8, 64 and
    256 beside the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters); fail if a plan at G <= 64 needs two
    waves."""
    from music_generator_tpu_torch.ops import notegen
    F, H, N = cfg.time_axis_units, cfg.note_axis_units, cfg.num_notes
    for G in (1, 3, 8, 64, 256):
        p = notegen.notegen_plan(G, F, H, N)
        active = notegen.active_clusters(G, F, H, N)
        waves = -(-p.clusters // active) if active else 0
        log(f"notegen plan G={G}: C={p.C} blocks a cluster, Gc={p.Gc} "
            f"streams a cluster, {p.clusters} cluster(s), {p.smem} bytes "
            f"a block; {active} clusters resident at once: {waves} "
            f"wave(s)")
        if G <= 64 and (active == 0 or p.clusters > active):
            fail(f"notegen plan at G={G} needs more than one wave")


def time_notegen(model, card):
    """Kernel 1 at G = 3, 64 and 256: the cluster kernel and the streamed
    kernel on one card in turns (cluster, streamed, streamed, cluster;
    CUDA events, mean of 50 launches each), the plain version at G = 3 and
    64, the bound, and block 0's clock cycles per pitch by phase.  Returns
    {G: (ms, streamed ms, plain ms or None, bound ms, bound_by)}."""
    from music_generator_tpu_torch.ops import notegen
    cfg = model.cfg
    l0, l1 = model.note_axis
    heads = (model.note_dense, model.volume_dense)
    times = {}
    for G in (3, 64, 256):
        feats, us, temp, emb = notegen_inputs(model, G, 1.0, 100 + G)
        args = (feats, us, temp, l0, l1, *heads, emb, "sigmoid", None)
        ops = notegen._kernel_operands(*args[:8], None)
        runs = [cuda_ms(lambda: notegen._launch(*ops, False), 50),
                cuda_ms(lambda: notegen._launch_streamed(*ops, False), 50),
                cuda_ms(lambda: notegen._launch_streamed(*ops, False), 50),
                cuda_ms(lambda: notegen._launch(*ops, False), 50)]
        plain = (cuda_ms(lambda: notegen.note_sample_reference(*args), 5)
                 if G <= 64 else None)
        prof = torch.zeros(14, dtype=torch.int64, device="cuda")
        notegen._launch(*ops, False, prof=prof)
        torch.cuda.synchronize()
        pr = prof.tolist()
        per = [c / pr[11] for c in pr[:6]]
        bound, bound_by = notegen_bound_ms(
            G, cfg.num_notes, cfg.time_axis_units, cfg.note_axis_units)
        ms, streamed = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        times[G] = (ms, streamed, plain, bound, bound_by)
        log(f"notegen G={G}: cluster kernel {runs[0]:.4f} / {runs[3]:.4f} "
            f"ms/launch, streamed kernel {runs[1]:.4f} / {runs[2]:.4f}, "
            f"plain version {'-' if plain is None else f'{plain:.4f}'} ms, "
            f"bound {bound:.6f} ms by {bound_by} ({card})")
        log(f"notegen G={G} block 0 (C={pr[8]}, Gc={pr[9]}, {pr[10]} "
            f"clusters), cycles per pitch: layer 0 h0 U0 {per[0]:.0f}, wait "
            f"for the draw with z0 and cells {per[1]:.0f}, h0 exchange and "
            f"barrier 1 {per[2]:.0f}, layer 1 with cells {per[3]:.0f}, h1 "
            f"exchange and barrier 2 {per[4]:.0f} (sum "
            f"{sum(per[:5]):.0f}); heads and draw, beside layer 0, "
            f"{per[5]:.0f}; prologue {pr[6]} cycles ({pr[12]} before the "
            f"acc_F chunks, {pr[13]} in them), launch {pr[7]} cycles")
    return times


# Kernel 10's instances in the SASS of its library: (dtype, units a 16-byte
# store, pieces of the mangled name), and the immediates of the hash's
# per-step base (seed and step multipliers, as unsigned and signed 32-bit
# values), which must not appear in its row loop.
MASK_SASS = {torch.float32: (4, ("stack_masks_kernelIfLi4E",)),
             torch.bfloat16: (8, ("stack_masks_kernelI", "bfloat16",
                                  "Li8E"))}
MASK_BASE_IMMEDIATES = ("0x9e3779b1", "-0x61c8864f", "0x27d4eb2f")


def sass_functions(lib_path: str) -> dict:
    """{mangled name: [(address, instruction)]} of a built library, from
    `cuobjdump -sass` of the toolkit that built it."""
    from music_generator_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def mask_loop_ops(funcs: dict, dt) -> dict:
    """Kernel 10's row loop in the SASS of its vector instance for `dt`:
    the innermost loop (a branch back to a lower address) that holds a
    16-byte store.  Returns its instructions (NOPs aside), the elements
    its stores write, instructions an element, and whether it holds an
    integer division (I2F, MUFU or a CALL) or a multiply by the hash's
    per-step constants.  Fails when no such loop is found."""
    units, pieces = MASK_SASS[dt]
    names = [n for n in funcs if all(p in n for p in pieces)]
    if len(names) != 1:
        fail(f"lstm2_masks: found {names} for {dt} in the SASS")
    code = funcs[names[0]]
    best = None
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [i for a, i in code if int(m.group(1), 16) <= a <= addr
                and not i.startswith("NOP")]
        stores = sum(1 for i in body if re.search(r"\bSTG\S*\.128\b", i))
        if stores and (best is None or len(body) < len(best[0])):
            best = (body, stores)
    if best is None:
        fail(f"lstm2_masks: no row loop with a 16-byte store in {names[0]}")
    body, stores = best
    elements = stores * units
    division = any(re.search(r"\b(I2F|MUFU|CALL)", i) for i in body)
    base = any(c in i.lower() for i in body for c in MASK_BASE_IMMEDIATES)
    return {"instructions": len(body), "elements": elements,
            "per_element": len(body) / elements, "division": division,
            "per_element_base": base}


def sm_clock_mhz() -> tuple:
    """(current, maximum) SM clock in MHz, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


def device_ms(fn, name: str, reps: int = 20) -> float:
    """Mean device ms a launch of the kernel whose name holds `name`, from
    a profiled run of `reps` calls of `fn` after a warm-up call: the
    kernel's own time, without the host's time between launches.  The
    profiler may miss the first launches of a window (18 or 19 of 20 in a
    full chip_smoke.py run), so the mean is over the launches it shows,
    at least half of them."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and name in e.key]
    count = sum(e.count for e in evs)
    if not reps // 2 <= count <= reps:
        fail(f"the profile shows {count} launches of {name} for {reps}")
    return sum(e.self_device_time_total for e in evs) / count / 1e3


def time_masks(card):
    """ms of kernel 10 (its device time a launch, from the profiler: the
    wrapper's call, timed by CUDA events and logged beside it, is the
    host's) and of its plain version at the time and note axes' shapes
    (float32, as the validator dumps, and bfloat16), with the bound: the
    larger of the bytes written at HBM rate and the row loop's
    instructions (counted from the SASS, `mask_loop_ops`) for every
    element at the card's issue rate, 132 SMs x 4 schedulers x 32 lanes a
    clock at its maximum SM clock.  Fails if the row loop holds a division
    or the hash's per-step base.  Returns {(shape label, dtype name): (ms,
    plain ms, bound ms, "bytes" or "operations")}."""
    from music_generator_tpu_torch.ops import _build, lstm2
    funcs = sass_functions(str(_build.library_path("lstm2_masks")))
    cur, top = sm_clock_mhz()
    issue = 132 * 4 * 32 * top * 1e6
    loops = {}
    for dt in (torch.float32, torch.bfloat16):
        loops[dt] = mask_loop_ops(funcs, dt)
        log(f"lstm2_masks {dt} row loop (SASS): {loops[dt]}; SM clock "
            f"{cur:.0f} MHz now, {top:.0f} MHz at most")
        if loops[dt]["division"] or loops[dt]["per_element_base"]:
            fail(f"lstm2_masks: the {dt} row loop holds a division or the "
                 f"hash's per-step base")
    out = {}
    for label, (S, R, H) in (("time", MASK_SHAPES[1]),
                             ("note", MASK_SHAPES[2])):
        for dt, name in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
            dump = lambda: lstm2.dump_masks(7, S, R, H, 0.5, dt, "cuda")
            plain_fn = lambda: lstm2.stack_masks(7, S, R, H, 0.5, dt,
                                                 "cuda")
            call = cuda_ms(dump, 50)
            ms = device_ms(dump, "stack_masks_kernel")
            plain = cuda_ms(plain_fn, 10)
            if not torch.equal(dump(), plain_fn()):
                fail(f"lstm2_masks {label} {name} differs from stack_masks")
            n = S * R * H
            t_bytes = n * (4 if dt == torch.float32 else 2) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = n * loops[dt]["per_element"] / issue * 1e3
            bound = max(t_bytes, t_ops)
            by = "operations" if t_ops >= t_bytes else "bytes"
            out[(label, name)] = (ms, plain, bound, by)
            log(f"lstm2_masks {label} axis (S={S}, R={R}, H={H}, {name}): "
                f"kernel {ms:.4f} ms/launch on the device (profiler; the "
                f"wrapper's call {call:.4f} ms by CUDA events, the host's "
                f"time between launches included), plain version "
                f"{plain:.4f} ms, "
                f"bound {bound:.6f} ms by {by} (bytes {t_bytes:.6f}, "
                f"operations {t_ops:.6f}: "
                f"{loops[dt]['per_element']:.3f} instructions an element); "
                f"{bound / ms:.3f} of the bound, bit for bit stack_masks "
                f"({card})")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a machine with a GPU")
        sys.exit(2)

    from music_generator_tpu_torch.cli import generate_main
    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.data.dataset import compute_genre
    from music_generator_tpu_torch.data.synth import random_batch
    from music_generator_tpu_torch.device import full_f32
    from music_generator_tpu_torch.generation.sampler import (
        Sampler, _velocity_grid, write_file)
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.ops import _build, notegen
    from music_generator_tpu_torch.params import load_params_npz
    from music_generator_tpu_torch.utils import one_hot

    started = time.perf_counter()
    log(sys.version.split()[0], "torch", torch.__version__, "cuda",
        torch.version.cuda)
    card = card_line()
    log("card:", card)

    # -- 1. build ----------------------------------------------------------
    t = time.perf_counter()
    names = ["notegen", "biax_time", "biax_note", "lstm_recurrence", "lstm2",
             "lstm2_masks"]
    libs = _build.build(names)
    log(f"build: {', '.join(names)} in {time.perf_counter() - t:.1f} s")
    for lib in libs:
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
                    streamed = notegen.note_sample_streamed(*args)
                    torch.cuda.synchronize()
                    if not torch.equal(got, streamed):
                        fail(f"notegen G={G} T={T} {act} quantize="
                             f"{grid is not None}: the cluster kernel "
                             f"differs from the streamed kernel")
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
    log(f"notegen: {case} cases of the cluster kernel equal the streamed "
        f"kernel bit for bit and agree with the plain version (|u-p| edge "
        f"{EDGE}, volume atol {VOLUME_ATOL})")
    check_notegen_plans(cfg)
    biax_errs = check_biax_kernels(cfg)
    for kind in ("time", "note"):
        check_fwd_staged(cfg, kind)
        check_bwd_staged(cfg, kind)
    lstm_errs = check_lstm_kernels(cfg)
    check_rec_fwd_staged(cfg)
    check_rec_bwd_staged(cfg)
    check_lstm2_fwd_staged(cfg)
    check_lstm2_bwd_staged(cfg)
    mask_err = check_mask_kernel()

    # -- 3. main path --------------------------------------------------------
    os.makedirs(WORK, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(WORK)
    notegen.note_sample.launches = 0
    notegen.note_sample_streamed.launches = 0
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
    streamed_launches = notegen.note_sample_streamed.launches
    steps = 2 * 8 * cfg.notes_per_bar
    log(f"main path: notegen launches {launches} for {steps} timesteps, "
        f"streamed kernel launches {streamed_launches}, plain version calls "
        f"{plain_calls}")
    if launches != steps or plain_calls != 0 or streamed_launches != 0:
        fail("the main path did not run every timestep through the cluster "
             "kernel")
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

    # -- 3c. training main path ----------------------------------------------
    train_launches = train_main_path(cfg)

    # -- 3e. the per-axis training routes ------------------------------------
    route_launches = train_routes(cfg)

    # -- 3d. one dropout-0 training step, kernels against plain stacks -------
    r4 = load_params_npz(PARAMS)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in random_batch(cfg, seed=0, rolled_targets=True))
    parity_step(cfg, r4, batch)

    # -- 3f. the dropout-0 step on the per-axis routes -----------------------
    route_parity_step(cfg, batch)

    # -- 3g, 3h. this slice's path: the validators and primed generation ----
    reset_slice_counts()
    validators()
    primed_generation(cfg)
    slice_launches = slice_counts()
    log(f"validators and primed generation: kernel launches "
        f"{slice_launches}")
    idle = [k for k, v in slice_launches.items() if v == 0]
    if idle:
        fail(f"kernels not launched on the validators' and primed "
             f"generation's path: {idle}")
    if notegen.note_sample_streamed.launches:
        fail("the streamed pitch-loop kernel ran on the validators' and "
             "primed generation's path")

    # -- 4. times ------------------------------------------------------------
    time_train_step(cfg, r4, batch, card)
    for route in ROUTES:
        rc = cfg.replace(**ROUTES[route][0])
        # The r4 weights have two layers an axis; deeper stacks start fresh.
        state = (r4 if route != "depth_3_3"
                 else build_model(rc, "cpu", seed=0).state_dict())
        log(f"route {route}:")
        time_train_step(rc, state, batch, card)
    biax_times = time_biax(cfg, card)
    lstm_times = time_lstm(cfg, card)
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

    times = time_notegen(model, card)
    ms, _, plain, bound, bound_by = times[3]
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
    for name, replaces, source in BIAX_KERNELS:
        ms, plain = biax_times[name]
        bound, bound_by = biax_bound_ms(name, cfg, cfg.seq_len, True)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": biax_errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        })
    # The per-axis kernels' times at the time axis's shapes; the note
    # axis's are logged above.
    _, S, R, F, H = axis_shapes(cfg, cfg.seq_len)[0]
    for name, replaces, source in LSTM_KERNELS:
        route = "axis_fused" if name.startswith("lstm2") else "per_layer"
        ms, plain, lib = lstm_times[(name, "time")]
        bound, bound_by = lstm_bound_ms(name, S, R, F, H)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": route_launches[route][name],
            "max_abs_err": lstm_errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib,
        })
    mask_times = time_masks(card)
    ms, plain, bound, bound_by = mask_times[("time", "float32")]
    name, replaces, source = MASK_KERNEL
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": slice_launches[name],
        "max_abs_err": mask_err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
    })
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
