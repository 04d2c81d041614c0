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
     for bit; and Nadam's multi-tensor update (kernel 11) against the plain
     per-leaf update over 20 steps on DeepJ's leaves at both time axes'
     widths, bit for bit, two launches a step; and the linear time axis's
     fused recurrence (kernel 12, `glru_scan` on the card) against its
     plain version through autograd at the linear cell's shapes (S 128,
     R 3,072, H 256, each layer's input width), float32 and bfloat16: hs
     bit for bit, the gradients within 1e-5, one launch a direction;
  2b. kernel 1's bfloat16 instances, both flavors ("scan", the JAX
     Sampler's default arithmetic, and "fused", pallas_note_sample's at
     compute_dtype=bfloat16), against their bfloat16 plain versions
     (draws_agree, edge 2^-6, volumes within 2^-8 -- one bfloat16 ULP
     below 1 -- with quantize off and 2^-6 with it on) at note depths 1,
     2, 3 and 6 (8- and 16-block clusters), G = 3 and 64, both gate
     flavors, quantize on and off, and at depth 2 on bfloat16 features
     (the linear time axis's), each also against the streamed kernel bit
     for bit; with quantize off each must be nearer its own flavor's
     plain version than the other flavor's (mean volume gap at most a
     quarter), so an instance wired to the other arithmetic fails; their
     plans; ms a launch at depth 2 beside the float32 instance's on the
     same inputs (in turns), the plain version and the bound with 2-byte
     weights at the bfloat16 rate, and block 0's cycles per pitch by phase;
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
     no plain version ran, that every step updated every leaf on Nadam's
     kernels (two launches) and none on its plain update, that the losses
     are
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
     plain version and no biaxial launch, every leaf of every step on
     Nadam's kernels, every bfloat16 recurrence
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
     at seeds 0 and 1 (event identity required on every file; its bf16
     control printed); every kernel must have been launched in 3g-3h;
  3i. serving: the HTTP service (music_generator_tpu_torch/serving) at
     default_config() with the r4 weights, every batch bucket warmed up,
     over a real socket: /healthz, solo requests, 16 concurrent ones
     (fewer than 16 device calls), a /generate_batch of 16, two 64-bar
     requests time-sliced beside 1-bar riders (which must finish first),
     a primed request, 32 and 48 requests queued behind the execution
     lock (each lot one device call at bucket 32 and 64) and
     /generate_batch of 64 and 24 (buckets 64 and 32), each response
     byte-identical to its solo run through the port's Sampler; a burst
     past max_pending=2 must shed with 503 and Retry-After; the cluster
     pitch-loop kernel launched at every timestep the service ran, the
     streamed kernel and the plain version never; latencies logged;
  3j. the Keras 2 interchange, with the port's own HDF5 reader and writer
     (no h5py): both committed model.h5 files equal to their params.npz
     bit for bit (the import's host time printed), generate_main
     --from-keras writing phase 3's bytes on the cluster kernel,
     train_main --from-keras (1 epoch of the 3c corpus) starting from the
     file's weights with a fresh Nadam at step 0 and each biaxial kernel
     launched once a step, tools/export_keras.py of that checkpoint read
     back bit for bit, a --from-keras service answering with the bytes of
     a --params one, visualize_main --from-keras writing on the card the
     TSV text it writes on the CPU, and analyze_main on the 3c corpus;
  3k. the trainer's staging modes (training/trainer.py) on the 3c corpus
     at default_config(), 2 epochs each from the same weights and seed:
     replicated, segments (at least 3 segments and a tail) and stream,
     each biaxial kernel once a step and no plain version, equal batch
     checksums, losses and final parameters bit for bit, the device ms a
     step over 5 profiled steps and the busy share; train_main --profile
     writing a trace that holds device rows of the biaxial kernels in
     steps 5-10; tools/run_big_corpus at 0.5 GiB (copy rates, resident and
     segment rates);
  3l. generation at note depths 1-8 (the r4 weights rebuilt by
     tools/common.py::depth_params): at G = 3 and 64 the plan (one wave
     required at depths 1-2), the kernel against its plain version and,
     where the plan is a cluster's (depths 1-5 at flagship widths), the
     cluster kernel against the streamed kernel bit for bit, each
     launch timed beside its bound; Sampler.generate at depths 1 and 3
     against artifacts/note_depth_r17 (events required, bytes reported)
     and at depth 6 on the streamed kernel, with its launches counted; a
     depth-3 service's /generate equal to its solo run;
  3m. data parallelism: two ranks of music_generator_tpu_torch/tools/
     mp_worker.py on this card over gloo (named explicitly: NCCL refuses
     two ranks on one card), at default_config() dropout 0: one step of a
     B 32 batch, 16 rows a rank, against the one-process step (loss and
     worst-leaf update cosine within phase 3d's bars), `sharded` fit steps
     over a Dataset.shard split with both ranks' parameters bit-equal
     after every step and each biaxial kernel once a step on each rank, no
     plain version; generation at G = 64 (32 streams a rank), phase 3's
     G = 3 (padded to 4), a primed batch and begin / advance against the
     one-process run (note events required, .mid bytes counted) and the
     committed samples; a leader and a follower serving over the
     authenticated replay channel (buckets 1, 4 and 16, a /generate_batch,
     a time-sliced job) byte-equal to a one-process service, the
     follower's pitch-loop launches equal to the leader's; the readings
     (a step with one rank alone and with two sharing the card, the
     all-reduce's ms) on a line of their own; with two cards or more the
     training and generation again over NCCL, one rank a card;
  3n. the linear time axis (time_axis_kind="linear") at default_config()
     on the r4 weights rebuilt by tools/common.py::linear_params: phase
     3d's dropout-0 step (float32 kernels against the plain path, bfloat16
     kernels held to 3d's bars on fresh weights, both gate flavors, and
     read on the rebuilt weights), Trainer.fit for 1 epoch of the 3c
     corpus with kernels 6 and 7 once a step, kernel 12 once a direction
     a time layer, and no other kernel or plain version, every leaf of
     every step on Nadam's kernels, the checkpoint
     reloaded; Sampler.generate at G = 3 and 64
     with kernel 1 once a timestep, streams 0-2 event-identical to
     artifacts/linear_time_r19 (bytes reported); a linear-kind /generate
     equal to its solo run; tools/run_parallel_scan_study.py's three
     routes at B = 16 (host ms, device ms, busy share);
  3o. the host tools: the native MIDI decoder built on this machine,
     bit for bit the Python codec on every committed .mid (ms a file for
     both), `python -m music_generator_tpu_torch.midi` round-tripping a
     phase-3 file, and tools/analyze_divergence.py on the card naming the
     flipped cell of a phase-3 file's copy;
  3p. generation at gen_dtype="bfloat16" through generate_main (the r4
     weights, 3 genres, 8 bars, seed 0), once for each flavor (the
     default config, and fused_gen_kernel with lstm_kernel="pallas"):
     every timestep one launch of that flavor's bfloat16 instance, no
     plain version, no float32 instance; the notes held to the same
     generate_main run on the CPU (the plain version, which the tests tie
     to the JAX package): each stream's first differing draw within
     BF16_EDGE of its probability, replayed on the CPU in the flavor's
     arithmetic, and volumes before it within BF16_VOLUME_ATOL; the
     files' byte and event matches against the float32 samples of phase
     3 printed (the control: no threshold);
  3q. tools/run_convergence.py at default_config() on a small corpus (2
     styles, 1 file of 16 bars each, --epochs 3 --patience 1, 2-bar
     samples): training stops, the best checkpoint is written, reloaded
     and generated from, the samples and report.json are written;
  3r. tools/run_augment_study.py at default_config() on a small corpus (2
     styles, 1 file of 16 bars each, --epochs 3 --patience 1 --augment 1):
     three times the windows in the augmented run, a checkpoint a run,
     twelve finite eval entries, each fit's steps one launch of each
     biaxial kernel and no plain version; tools/render_audio.py on the
     host rendering artifacts/short_samples_r2/short_s0_{0,1,2}.mid to the
     committed .wav bytes;
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
     at the card's issue rate; the loop must hold no division), and
     Nadam's update a step on both time axes' leaves (device time with the
     L2 cache rewritten before every step, as a step's backward leaves it)
     against the plain per-leaf update's and one pass over the leaves'
     bytes at HBM rate; and kernel 12 a direction at the linear cell's
     shapes in bfloat16 (device time with the L2 rewritten before every
     call) against one pass over its tensors' bytes, its plain version and
     the gates and tree it replaced.
The line before the last holds the per-kernel JSON (kernel 1 with the
note depths it ran; kernels 1, 6, 7 and 11 with phase 3n's launches under
"linear_time", kernel 12 as glru_scan_fwd and glru_scan_bwd with phase
3n's launches and the tree's ms, kernel 11 with its times on the linear kind's leaves; kernels 2-5 with phase 3r's launches under
"augment_study"; kernel 1's bfloat16 instances as notegen_bf16_scan and
notegen_bf16_fused with phase 3p's launches), the one before it phase
3m's readings; the last
line is
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is available.
"""

from __future__ import annotations

import base64
import contextlib
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from music_generator_tpu_torch.tools.common import (F32_ATOL, F32_GRAD_REL,
                                                    CheckFailed, card_line,
                                                    cuda_ms, leaf_stats,
                                                    notegen_inputs)
from music_generator_tpu_torch.tools.validate_biax import (
    PARITY_BAR, STEP_ATOL, bf16_against_plain, step_bars, step_readings,
    steps)

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
R4_H5 = os.path.join(ROOT, "artifacts", "trained_model_r4", "model.h5")
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
# Kernel 11: Nadam's update, which XLA fuses under jit in the JAX package.
NADAM_KERNEL = ("nadam", "music_generator_tpu/ops/nadam.py:41",
                "music_generator_tpu_torch/csrc/nadam.cu")
NADAM_STEPS = 20            # steps phase 2 holds the kernels to the plain loop
NADAM_BYTES_PER_ELEMENT = 28    # p, g, mu, nu read; p, mu, nu written
L2_FLUSH_BYTES = 256 * 2**20    # rewritten before each timed step: 5x the L2
L2_FLUSH_KERNEL = "bitwise_not"  # the rewrite's kernel, which Nadam never runs
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
# The pitch loop's bfloat16 instances: a float32 sum taken in another order
# can round a product, h or a head to the other bfloat16 neighbour.
BF16_EDGE = 2.0 ** -6
BF16_VOLUME_ATOL = 2.0 ** -6
# With quantize off, one bfloat16 ULP at the top of the volume's [0, 1].
BF16_VOLUME_ULP = 2.0 ** -8


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    log("FAIL:", msg)
    sys.exit(1)


def _notegen_counts():
    """The pitch loop's counts: (note_sample launches, of them streamed,
    note_sample_streamed launches, plain version calls)."""
    from music_generator_tpu_torch.ops import notegen
    return (notegen.note_sample.launches,
            notegen.note_sample.streamed_launches,
            notegen.note_sample_streamed.launches,
            notegen.note_sample_reference.calls)


def _reset_notegen_counts():
    from music_generator_tpu_torch.ops import notegen
    notegen.note_sample.launches = 0
    notegen.note_sample.streamed_launches = 0
    notegen.note_sample.bf16_launches = {"scan": 0, "fused": 0}
    notegen.note_sample_streamed.launches = 0
    notegen.note_sample_reference.calls = 0


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


def notegen_bound_ms(G: int, N: int, F: int, H: int, L: int = 2,
                     esize: int = 4):
    """Least time for one pitch loop at note depth L, and what sets it:
    every input read once and the output written once at HBM rate, or its
    multiply-adds at the card's peak for their inputs' type (float32, or
    bfloat16 with float32 sums for the bfloat16 instances).  `esize`: the
    bytes of a weight and a feature (4 float32, 2 bfloat16; the bfloat16
    scan flavor's style table [G, L, H] is float32).  Returns (ms,
    "bytes" or "operations")."""
    H4 = 4 * H
    R = 2 * L - 1                                 # U_0, and W_l, U_l
    narrow = (G * N * F                           # feats
              + F * H4 + 3 * H4 + R * H * H4      # W0f, W0c, U, W
              + 3 * H)                            # heads' kernels
    floats = (G * N * 2 + G                       # uniforms, T
              + L * G * H4                        # a_l
              + 3                                 # heads' biases
              + (G * L * H if esize == 2 else 0)  # style table
              + G * N * 3)                        # output
    flops = 2 * G * N * (F * H4 + 3 * H4 + R * H * H4 + 3 * H)
    t_bytes = (esize * narrow + 4 * floats) / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOP_PER_S if esize == 2 else F32_FLOP_PER_S)
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
    from music_generator_tpu_torch.ops import (biax, linear_scan, lstm2,
                                               recurrence)
    return [("biax_time", biax.biax_time_stack,
             biax.biax_time_stack_reference),
            ("biax_note", biax.biax_note_stack,
             biax.biax_note_stack_reference),
            ("lstm2", lstm2.lstm2_stack, lstm2.lstm2_stack_reference),
            ("lstm_rec", recurrence.lstm_recurrence,
             recurrence.lstm_recurrence_reference),
            ("glru_scan", linear_scan.glru_scan,
             linear_scan.glru_scan_fused_reference)]


def reset_counts():
    from music_generator_tpu_torch.ops import biax, lstm2, nadam, recurrence
    nadam.nadam_update.launches = nadam.nadam_update.tensors = 0
    nadam.nadam_update_reference.calls = 0
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


def nadam_counts():
    """(launches, leaves updated) of Nadam's kernels, plain update calls."""
    from music_generator_tpu_torch.ops import nadam
    return (nadam.nadam_update.launches, nadam.nadam_update.tensors,
            nadam.nadam_update_reference.calls)


def check_nadam_fit(what: str, steps: int, model) -> int:
    """Fail unless the fit just counted (counts set to 0 before it) made
    two Nadam launches a step, each step updating every leaf of `model`
    that holds a gradient (the last step's) on the kernels and none on the
    plain update.  Returns the launches."""
    launches, tensors, plain = nadam_counts()
    leaves = sum(p.grad is not None for p in model.parameters())
    log(f"{what}: Nadam launches {launches}, leaves updated {tensors} "
        f"({leaves} leaves with a gradient), plain update calls {plain}")
    if (launches, tensors, plain) != (2 * steps, leaves * steps, 0) or (
            leaves == 0):
        fail(f"{what}: Nadam counted {(launches, tensors, plain)} in "
             f"{steps} steps, not {(2 * steps, leaves * steps, 0)}")
    return launches


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
        nadam = nadam_counts()
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
    # train_main's model is gone; the reloaded one has its leaves, and
    # every DeepJ leaf takes a gradient at every step.
    leaves = len(list(model.parameters()))
    log(f"train main path: Nadam (launches, leaves updated, plain update "
        f"calls) {nadam} for {leaves} leaves")
    if nadam != (2 * steps, leaves * steps, 0):
        fail(f"the training main path's Nadam counted {nadam}, not "
             f"{(2 * steps, leaves * steps, 0)}")
    launches["nadam"] = nadam[0]
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
        check_nadam_fit(f"route {route}", steps, trainer.model)
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


def parity_step(cfg, r4, batch, r4_name="the trained r4 weights",
                hold_r4=False):
    """Phase 3d (and 3n on the linear kind): the dropout-0 step, kernels
    against the plain stacks, held to the bar on fresh weights and read on
    `r4` (r4_name says what they are).  With hold_r4 the step on `r4` is
    held too: the float32 kernels as on fresh weights, and the bfloat16
    kernels against the bfloat16 plain step (bf16_against_plain: loss
    within PARITY_BAR[0] relative, worst-leaf cosine at least
    PARITY_BAR[1], the post-update gap's evaluation part within
    PARITY_BAR[2]); its update part is read, as it measures the weights'
    conditioning, not the kernels."""
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
    if not hold_r4:
        log(f"step on {r4_name} (read, no bar):")
        step_readings(cfg, r4, batch, "sigmoid", log=log)
        return
    log(f"step on {r4_name}, float32 held as above, bfloat16 kernels held "
        f"to the bfloat16 plain step:")
    runs = steps(cfg, r4, batch, "sigmoid")
    d_loss, g_rel, p_err = step_readings(cfg, r4, batch, "sigmoid",
                                         runs=runs, log=log)[:3]
    if d_loss > 1e-5 or g_rel > F32_GRAD_REL or p_err > STEP_ATOL:
        fail(f"float32 step on {r4_name}: kernels and plain stacks "
             f"disagree")
    loss, cos, _, evaluation, _ = bf16_against_plain(cfg, batch, "sigmoid",
                                                     runs, log=log)
    if (loss > PARITY_BAR[0] or cos < PARITY_BAR[1]
            or evaluation > PARITY_BAR[2]):
        fail(f"bfloat16 step on {r4_name}: the kernels and the bfloat16 "
             f"plain step disagree")


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


def nadam_leaves(cfg, kind: str, seed: int):
    """(leaves, their Nadam, a copy of the leaves, its Nadam): DeepJ's
    leaves at cfg's widths with time axis `kind`, drawn from `seed`, on
    the card."""
    from music_generator_tpu_torch.models.deepj import DeepJ
    from music_generator_tpu_torch.ops.nadam import Nadam
    shapes = [p.shape for p in
              DeepJ(cfg.replace(time_axis_kind=kind), "cpu").parameters()]
    gen = torch.Generator().manual_seed(seed)
    a = [torch.randn(s, generator=gen).cuda() for s in shapes]
    b = [p.clone() for p in a]
    return a, Nadam(a), b, Nadam(b)


def nadam_grads(a, b, gen) -> None:
    """The same fresh gradients, drawn from `gen`, on leaves `a` and `b`."""
    for p, q in zip(a, b):
        p.grad = torch.randn(p.shape, generator=gen).cuda()
        q.grad = p.grad.clone()


def check_nadam(cfg) -> float:
    """Kernel 11 (`Nadam.step` on the card) against the plain per-leaf
    update (`plain_step`) over NADAM_STEPS steps of fresh gradients on
    DeepJ's leaves at cfg's widths, time axes "lstm" (the deepj cell's 28
    leaves) and "linear" (26): p, mu, nu, count and m_schedule of every
    leaf bit for bit after every step, two launches a step and every leaf
    on the kernels.  Returns the largest |difference|."""
    from music_generator_tpu_torch.ops.nadam import plain_step
    err = 0.0
    for kind in ("lstm", "linear"):
        a, opt, b, ref = nadam_leaves(cfg, kind, seed=0)
        gen = torch.Generator().manual_seed(1)
        reset_counts()
        for step in range(NADAM_STEPS):
            nadam_grads(a, b, gen)
            opt.step()
            plain_step(ref)
            torch.cuda.synchronize()
            for i, (p, q) in enumerate(zip(a, b)):
                pairs = [("p", p, q)] + [(k, opt.state[p][k], ref.state[q][k])
                                         for k in ("mu", "nu", "count",
                                                   "m_schedule")]
                for what, x, y in pairs:
                    err = max(err, float((x - y).abs().max()))
                    if not torch.equal(x, y):
                        fail(f"nadam {kind}: step {step} leaf {i} {what} "
                             f"differs from the plain update")
        counts = nadam_counts()
        want = (2 * NADAM_STEPS, len(a) * NADAM_STEPS, len(a) * NADAM_STEPS)
        if counts != want:
            fail(f"nadam {kind}: (launches, leaves on the kernels, plain "
                 f"calls of the yardstick) {counts}, not {want}")
        log(f"nadam {kind}: {len(a)} leaves, "
            f"{sum(p.numel() for p in a)} elements, {NADAM_STEPS} steps bit "
            f"for bit the plain update; (launches, leaves on the kernels, "
            f"plain calls of the yardstick) {counts}")
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
    the card's files against the CPU (events required on every file; its
    bf16 control is printed, with no threshold)."""
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
    r = report["bf16_vs_cpu"]
    log(f"check_fidelity bf16_vs_cpu (the control, no threshold): "
        f"{r['files'] - len(r['mismatches'])}/{r['files']} byte-identical, "
        f"{r['files'] - len(r['event_mismatches'])}/{r['files']} "
        f"event-identical")
    return report


def _post(url: str, payload: dict, path: str = "/generate"):
    """POST `payload` as JSON; returns (status, headers, body), an HTTP
    error status included."""
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _in_threads(fn, args_list):
    """Call fn(*args) for every args in its own thread, all started
    together; returns the results in order (an exception fails)."""
    out, errs = [None] * len(args_list), []

    def run(i):
        try:
            out[i] = fn(*args_list[i])
        except Exception as e:      # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errs or any(t.is_alive() for t in threads):
        fail(f"serving: requests failed or hung: {errs[:3]}")
    return out


def serving(cfg, card):
    """Phase 3i: the HTTP service on the card at default_config() with the
    r4 weights, over a real socket on 127.0.0.1, every bucket warmed up.
    Every response must equal, byte for byte, its solo run: the port's
    Sampler.generate([mixture], seed, stream_indices=[index]) written
    through the service's encoder (computed before the traffic): solo
    requests, 16 concurrent ones (fewer than 16 device calls), a
    /generate_batch of 16, two 64-bar requests time-sliced beside 1-bar
    riders (which must finish before the long pieces), a primed request,
    32 and 48 requests queued while the test holds the execution lock
    (each lot one device call, at bucket 32 and 64) and /generate_batch
    of 64 and 24 (buckets 64 and 32); a burst past max_pending=2 must
    shed with 503 and
    Retry-After.  The pitch loop must launch the cluster kernel at every
    timestep the service ran, and nothing else.  Times are logged."""
    from music_generator_tpu_torch.data.dataset import (compute_genre,
                                                        decode_prime)
    from music_generator_tpu_torch.generation.sampler import (Sampler,
                                                              prepend_prime)
    from music_generator_tpu_torch.midi import read_midifile
    from music_generator_tpu_torch.ops import notegen
    from music_generator_tpu_torch.params import load_params_npz
    from music_generator_tpu_torch.serving import (DeepJHTTPServer,
                                                   GenerationService,
                                                   make_handler)
    from music_generator_tpu_torch.utils import one_hot
    t0 = time.perf_counter()
    service = GenerationService(config=cfg, params=load_params_npz(PARAMS),
                                warmup_buckets=64)
    log(f"serving: service built and 7 buckets warmed up in "
        f"{time.perf_counter() - t0:.1f} s")
    genre = [compute_genre(g, cfg) for g in range(3)]
    solo_reqs = [(g, s) for s in (0, 1) for g in range(3)]
    conc_reqs = [(i % 3, 100 + i) for i in range(16)]
    riders = [(0, 300 + i) for i in range(4)]
    longs = [(0, 200), (1, 201)]
    prime_file = os.path.join(DEMOS, "primed_Baroque.mid")
    prime = decode_prime(prime_file, 8, config=cfg)

    # The solo runs, before the traffic and its counts.
    sampler = Sampler(service.model)

    def ref(mix, bars, seed, index=0, prime=None):
        notes = sampler.generate([mix], num_bars=bars, seed=seed,
                                 stream_indices=[index], prime=prime).notes
        if prime is not None:
            notes = prepend_prime(notes, prime)
        return service._encode_midi(notes[0])

    # The larger buckets: requests coalesced into one call of 32 (bucket
    # 32) and of 48 (bucket 64, 16 rows padding), /generate_batch of 64
    # (bucket 64) and of 24 (bucket 32, 8 rows padding).
    held = {32: [(i % 3, 500 + i) for i in range(32)],
            48: [(i % 3, 600 + i) for i in range(48)]}
    batches = {64: 9, 24: 10}                   # size -> seed
    t0 = time.perf_counter()
    want = {
        "solo": [ref(genre[g], 8, s) for g, s in solo_reqs],
        "concurrent16": [ref(genre[g], 8, s) for g, s in conc_reqs],
        "batch16": [ref(one_hot(i, cfg.num_styles), 8, 7, index=i)
                    for i in range(16)],
        "longs": [ref(genre[g], 64, s) for g, s in longs],
        "riders": [ref(genre[g], 1, s) for g, s in riders],
        "primed": [ref(genre[0], 8, 11, prime=prime)],
    }
    for n, reqs in held.items():
        want[f"coalesced{n}"] = [ref(genre[g], 8, s) for g, s in reqs]
    for n, seed in batches.items():
        want[f"batch{n}"] = [ref(one_hot(i % cfg.num_styles,
                                         cfg.num_styles), 8, seed, index=i)
                             for i in range(n)]
    log(f"serving: {sum(len(v) for v in want.values())} solo reference "
        f"runs in {time.perf_counter() - t0:.1f} s")
    prime_b64 = base64.b64encode(open(prime_file, "rb").read()).decode()

    httpd = DeepJHTTPServer(("127.0.0.1", 0), make_handler(service))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    steps = [0]
    buckets = []                # the batch rows of every chunk
    run_chunk = service._sampler._chunk

    def counted_chunk(style_emb, state, num_steps, t0):
        steps[0] += num_steps
        buckets.append(style_emb.shape[0])
        return run_chunk(style_emb, state, num_steps, t0)

    service._sampler._chunk = counted_chunk
    notegen.note_sample.launches = 0
    notegen.note_sample_streamed.launches = 0
    notegen.note_sample_reference.calls = 0
    calls0 = service.device_calls
    got, times = {}, {}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                fail("serving: /healthz did not answer ok")

        def timed(payload, path="/generate"):
            t = time.perf_counter()
            status, headers, body = _post(url, payload, path)
            ms = (time.perf_counter() - t) * 1e3
            if status != 200:
                fail(f"serving: {path} {payload} answered {status}: "
                     f"{body[:200]}")
            return body, ms, time.perf_counter()

        solo = [timed({"genre": g, "bars": 8, "seed": s})
                for g, s in solo_reqs]
        got["solo"] = [b for b, _, _ in solo]
        times["solo"] = [ms for _, ms, _ in solo]

        c0 = service.device_calls
        t = time.perf_counter()
        conc = _in_threads(timed, [({"genre": g, "bars": 8, "seed": s},)
                                   for g, s in conc_reqs])
        times["concurrent16"] = (time.perf_counter() - t) * 1e3
        conc_calls = service.device_calls - c0
        got["concurrent16"] = [b for b, _, _ in conc]
        if conc_calls >= 16:
            fail(f"serving: 16 concurrent requests took {conc_calls} "
                 f"device calls: nothing coalesced")

        body, times["batch16"], _ = timed(
            {"styles_list": [[i] for i in range(16)], "bars": 8, "seed": 7},
            "/generate_batch")
        got["batch16"] = [base64.b64decode(f)
                          for f in json.loads(body)["files"]]

        long_threads = []
        long_out = [None, None]

        def long_request(i):
            long_out[i] = timed({"genre": longs[i][0], "bars": 64,
                                 "seed": longs[i][1]})

        c0 = service.device_calls
        for i in range(2):
            long_threads.append(threading.Thread(target=long_request,
                                                 args=(i,)))
            long_threads[-1].start()
        deadline = time.perf_counter() + 60
        while service.device_calls == c0 and time.perf_counter() < deadline:
            time.sleep(0.001)
        if service.device_calls == c0:
            fail("serving: the 64-bar requests never ran a slice")
        rider_out = [timed({"genre": g, "bars": 1, "seed": s})
                     for g, s in riders]
        for th in long_threads:
            th.join(timeout=600)
        if any(o is None for o in long_out):
            fail("serving: a 64-bar request failed")
        got["longs"] = [b for b, _, _ in long_out]
        got["riders"] = [b for b, _, _ in rider_out]
        times["riders"] = sorted(ms for _, ms, _ in rider_out)
        last_rider = max(done for _, _, done in rider_out)
        first_long = min(done for _, _, done in long_out)
        if last_rider >= first_long:
            fail("serving: a 1-bar rider finished after a 64-bar job")

        body, times["primed"], _ = timed({
            "genre": 0, "bars": 8, "seed": 11, "prime_midi": prime_b64,
            "prime_bars": 8})
        got["primed"] = [body]

        for n, reqs in held.items():
            # Hold the execution lock until all n requests are queued, so
            # the next pass coalesces them into one call at their bucket.
            c0, b0 = service.device_calls, len(buckets)
            payloads = [({"genre": g, "bars": 8, "seed": s},)
                        for g, s in reqs]
            queued = False
            with service._lock:
                traffic = threading.Thread(
                    target=lambda: got.__setitem__(f"coalesced{n}", [
                        b for b, _, _ in _in_threads(timed, payloads)]))
                traffic.start()
                deadline = time.perf_counter() + 120
                while not queued and time.perf_counter() < deadline:
                    time.sleep(0.001)
                    with service._pending_lock:
                        queued = len(service._pending) == n
            traffic.join(timeout=600)
            if not queued or f"coalesced{n}" not in got:
                fail(f"serving: {n} requests were not all queued and "
                     f"served")
            ran = buckets[b0:]
            log(f"serving: {n} held requests ran in "
                f"{service.device_calls - c0} device call(s) at batch "
                f"rows {ran}")
            if service.device_calls - c0 != 1 or ran != [
                    service._bucket(n)]:
                fail(f"serving: {n} queued requests did not run as one "
                     f"call at bucket {service._bucket(n)}")
        for n, seed in batches.items():
            b0 = len(buckets)
            body, times[f"batch{n}"], _ = timed(
                {"styles_list": [[i % cfg.num_styles] for i in range(n)],
                 "bars": 8, "seed": seed}, "/generate_batch")
            got[f"batch{n}"] = [base64.b64decode(f)
                                for f in json.loads(body)["files"]]
            if buckets[b0:] != [service._bucket(n)]:
                fail(f"serving: a batch of {n} ran at rows "
                     f"{buckets[b0:]}, not bucket {service._bucket(n)}")
    finally:
        service._sampler._chunk = run_chunk
    launches = notegen.note_sample.launches
    calls = service.device_calls - calls0
    log(f"serving: {calls} device calls ran {steps[0]} timesteps: notegen "
        f"launches {launches}, streamed kernel launches "
        f"{notegen.note_sample_streamed.launches}, plain version calls "
        f"{notegen.note_sample_reference.calls}")
    if (launches != steps[0] or notegen.note_sample_streamed.launches
            or notegen.note_sample_reference.calls):
        fail("serving: the service's timesteps did not all go through "
             "the cluster kernel")

    # A burst past max_pending=2 (outside the counted traffic).
    service.max_pending = 2
    try:
        burst = _in_threads(_post, [(url, {"genre": 0, "bars": 8,
                                           "seed": 400 + i},)
                                    for i in range(12)])
    finally:
        service.max_pending = 256
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    shed = [h for s, h, _ in burst if s == 503]
    served = [b for s, _, b in burst if s == 200]
    if not shed or any(not h.get("Retry-After") for h in shed):
        fail(f"serving: the burst was not shed with 503 and Retry-After "
             f"({[s for s, _, _ in burst]})")
    if len(shed) + len(served) != len(burst):
        fail(f"serving: the burst got other answers than 200 and 503 "
             f"({[s for s, _, _ in burst]})")
    for b in served:
        read_midifile(io.BytesIO(b))
    log(f"serving: burst of {len(burst)} past max_pending=2: {len(shed)} "
        f"shed with 503 + Retry-After, {len(served)} valid .mid")

    n_same = n_all = 0
    for key, files in want.items():
        same = [a == b for a, b in zip(got[key], files)]
        n_same += sum(same)
        n_all += len(files)
        log(f"serving {key}: {sum(same)}/{len(files)} byte-identical to "
            f"their solo runs")
    if n_same != n_all:
        fail(f"serving: {n_all - n_same} of {n_all} responses differ from "
             f"their solo runs")
    log(f"serving: first solo request {times['solo'][0]:.1f} ms, the "
        f"other five {', '.join(f'{t:.1f}' for t in times['solo'][1:])} ms "
        f"(8 bars, G = 1); concurrent16 {times['concurrent16']:.1f} ms "
        f"wall in {conc_calls} device calls; batch16 "
        f"{times['batch16']:.1f} ms; riders beside two 64-bar jobs p50 "
        f"{times['riders'][len(times['riders']) // 2]:.1f} ms, p95 "
        f"{times['riders'][-1]:.1f} ms; primed (8 + 8 bars) "
        f"{times['primed']:.1f} ms; batch64 {times['batch64']:.1f} ms, "
        f"batch24 (bucket 32) {times['batch24']:.1f} ms; buckets run "
        f"{sorted(set(buckets))} ({card})")
    return launches


def keras_slice(cfg, card, short_paths):
    """Phase 3j: the Keras 2 weight interchange and the inspection entry
    points on the card, with the port's own HDF5 reader and writer (no
    h5py on this machine): (a) both committed model.h5 files equal their
    params.npz bit for bit; (b) generate_main --from-keras writes phase
    3's bytes, every timestep on the cluster pitch-loop kernel; (c)
    train_main --from-keras (1 epoch of the 3c corpus) starts from the
    file's weights with a fresh Nadam at step 0 and runs each biaxial
    kernel once a step, no plain version; (d) tools/export_keras.py of the
    checkpoint (c) wrote reads back bit for bit; (e) a service built from
    the file answers /generate with the bytes of one built from the .npz;
    (f) visualize_main --from-keras writes on the card the TSV text it
    writes with --device cpu, and analyze_main runs on the 3c corpus."""
    from music_generator_tpu_torch.cli import (analyze_main, generate_main,
                                               train_main, visualize_main)
    from music_generator_tpu_torch.ops import notegen
    from music_generator_tpu_torch.params import (load_params_npz,
                                                  params_from_numpy)
    from music_generator_tpu_torch.serving import (DeepJHTTPServer,
                                                   GenerationService,
                                                   make_handler)
    from music_generator_tpu_torch.tools import export_keras
    from music_generator_tpu_torch.training import trainer
    from music_generator_tpu_torch.training.checkpoint import (
        CheckpointStore, model_path)
    from music_generator_tpu_torch.training.keras_import import (
        load_keras_weights)

    def equal(got, want) -> bool:
        return sorted(got) == sorted(want) and all(
            torch.equal(got[k].cpu(), want[k].cpu()) for k in want)

    # (a) the committed files.
    for run in ("r4", "r3"):
        base = os.path.join(ROOT, "artifacts", f"trained_model_{run}")
        t = time.perf_counter()
        state = load_keras_weights(os.path.join(base, "model.h5"), cfg)
        ms = (time.perf_counter() - t) * 1e3
        if not equal(state, load_params_npz(os.path.join(base,
                                                         "params.npz"))):
            fail(f"keras: trained_model_{run}/model.h5 differs from its "
                 f"params.npz")
        log(f"keras: trained_model_{run}/model.h5 ("
            f"{os.path.getsize(os.path.join(base, 'model.h5'))} bytes) "
            f"imported in {ms:.1f} ms host time, {len(state)} leaves equal "
            f"to params.npz bit for bit ({card})")

    work = os.path.join(WORK, "keras")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.symlink(os.path.join(TRAIN_WORK, "data"), os.path.join(work, "data"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # (b) generate --from-keras against phase 3's --params files.
        notegen.note_sample.launches = 0
        notegen.note_sample_streamed.launches = 0
        notegen.note_sample_reference.calls = 0
        same = 0
        for seed, want in short_paths.items():
            got = generate_main(["--from-keras", R4_H5, "--bars", "8",
                                 "--seed", str(seed), "--out",
                                 f"short_s{seed}"])
            for p, q in zip(got, want):
                same += (open(p, "rb").read()
                         == open(os.path.join(WORK, q), "rb").read())
        steps = 2 * 8 * cfg.notes_per_bar
        streamed = notegen.note_sample_streamed.launches
        log(f"keras generate: {same}/6 files byte-identical to the --params "
            f"run; notegen launches {notegen.note_sample.launches} for "
            f"{steps} timesteps, streamed {streamed}, plain "
            f"{notegen.note_sample_reference.calls}")
        if same != 6:
            fail("generate --from-keras wrote other bytes than --params")
        if (notegen.note_sample.launches != steps or streamed
                or notegen.note_sample_reference.calls):
            fail("generate --from-keras did not run every timestep through "
                 "the cluster kernel")

        # (c) train --from-keras: a warm start.
        seen = {}
        fit = trainer.Trainer.fit

        def first_fit(self, ds, epochs=None):
            seen["params"] = {k: v.detach().clone()
                              for k, v in self.model.state_dict().items()}
            seen["optimizer"] = len(self.state.optimizer.state)
            seen["step"] = self.state.step
            return fit(self, ds, epochs)

        trainer.Trainer.fit = first_fit
        reset_counts()
        try:
            hist = train_main(["--epochs", "1", "--from-keras", R4_H5])
        finally:
            trainer.Trainer.fit = fit
        launches, plain = read_counts()
        n = sum(hist["steps_per_epoch"])
        r4 = load_keras_weights(R4_H5, cfg)
        log(f"keras train: {n} steps, losses {hist['loss']}; before the "
            f"first step: weights equal to the file "
            f"{equal(seen['params'], r4)}, optimizer state entries "
            f"{seen['optimizer']}, step {seen['step']}; kernel launches "
            f"{launches}, plain version calls {plain}")
        if not equal(seen["params"], r4):
            fail("train --from-keras did not start from the file's weights")
        if seen["optimizer"] or seen["step"]:
            fail("train --from-keras did not start a fresh Nadam at step 0")
        if (any(v != (n if k.startswith("biax") else 0)
                for k, v in launches.items()) or plain):
            fail("train --from-keras did not run every step through each "
                 "biaxial kernel, and only through them")
        if not np.isfinite(hist["loss"]).all():
            fail("train --from-keras: non-finite loss")

        # (d) export the checkpoint (c) wrote, read it back.
        export_keras.main(["--out", "exported.h5"])
        ckpt = CheckpointStore(model_path(cfg)).load()["params"]
        want = params_from_numpy({k: v.numpy() for k, v in ckpt.items()})
        if not equal(load_keras_weights("exported.h5", cfg), want):
            fail("export_keras -> import is not bit for bit")
        log(f"keras export: {os.path.getsize('exported.h5')} bytes, read "
            f"back equal to out/model.pt bit for bit")

        # (e) one service from the file, one from the .npz.
        bodies = []
        for params in (r4, load_params_npz(PARAMS)):
            service = GenerationService(config=cfg, params=params,
                                        warmup=False)
            httpd = DeepJHTTPServer(("127.0.0.1", 0), make_handler(service))
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                status, _, body = _post(
                    f"http://127.0.0.1:{httpd.server_port}",
                    {"genre": 1, "bars": 8, "seed": 21})
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=60)
            if status != 200:
                fail(f"keras serve: /generate answered {status}")
            bodies.append(body)
        log(f"keras serve: --from-keras and --params services answered "
            f"{len(bodies[0])} and {len(bodies[1])} bytes, identical "
            f"{bodies[0] == bodies[1]}")
        if bodies[0] != bodies[1]:
            fail("the --from-keras service answered other bytes")

        # (f) visualize on the card and on the CPU; analyze.
        names = ("style_embedding_vec.tsv", "style_embedding_labels.tsv")
        texts = {}
        for device in ("cuda", "cpu"):
            os.makedirs(device)
            os.chdir(device)
            try:
                visualize_main(["--device", device, "--from-keras", R4_H5])
                texts[device] = [open(os.path.join("out", n)).read()
                                 for n in names]
            finally:
                os.chdir(work)
        log(f"keras visualize: card and CPU TSVs identical "
            f"{texts['cuda'] == texts['cpu']}")
        if texts["cuda"] != texts["cpu"]:
            fail("visualize on the card wrote other text than on the CPU")
        stats = analyze_main([])
        if stats["num_files"] != cfg.num_styles or not np.isfinite(
                stats["notes_per_timestep"]):
            fail(f"analyze: {stats['num_files']} files, "
                 f"{stats['notes_per_timestep']} notes a step")
        log(f"analyze: {stats['num_files']} files, "
            f"{stats['total_timesteps']} timesteps, notes per step "
            f"{stats['notes_per_timestep']:.4f}")
    finally:
        os.chdir(cwd)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("h5py", "jax",
                                           "music_generator_tpu"))
    if loaded:
        fail(f"the port loaded {loaded}")


# Phase 3k: each mode's device time a step from the profiler over epoch
# 1's steps [10, 15) (parsing a whole fit's events takes ~18 s a mode);
# its busy share against epoch 2's unprofiled ms a step.
MODE_PROFILED = (10, 15)
# The biaxial training kernels' names, each of which must have device rows
# in the `train --profile` trace.
PROFILED_KERNELS = ("time_prologue_kernel", "note_prologue_kernel",
                    "note_heads_kernel", "fwd_scan_cluster_kernel",
                    "scan_cluster_kernel", "gemm_mma_kernel")


def _segment_budget(ds, batch: int):
    """An epoch_scan_max_bytes giving at least 3 segments and a nonzero
    tail on `ds`: (bytes, steps a segment, steps an epoch)."""
    S = -(-len(ds) // batch)
    per_batch = sum(int(a.nbytes) // len(ds) for a in (
        ds.notes, ds.targets, ds.beats, ds.styles)) * batch
    for seg in range(S // 3, 1, -1):
        if S % seg:
            return 2 * seg * per_batch, seg, S
    fail(f"trainer modes: {S} steps an epoch leave no segment length with "
         f"3 segments and a tail")


def trainer_modes(cfg, card):
    """Phase 3k: the trainer's staging modes on the 3c corpus at cfg
    (bfloat16, dropout on): 2 epochs from the same weights and seed in
    each of replicated, segments (a budget of at least 3 segments and a
    tail) and stream.  Each run: every count set to 0 just before the fit
    and read just after (each biaxial kernel once a step, no plain
    version), a CUDA profile of steps MODE_PROFILED (device ms a step;
    the busy share against epoch 2's ms a step), and per step the loss
    and a checksum of the batch on the card.  The modes must
    give equal batch checksums, and losses and final parameters bit for
    bit (the biaxial kernels have no atomics: the same batches in the same
    order make the same arithmetic).  Then train_main --profile must write a trace
    holding device rows of the biaxial kernels in steps 5-10, and
    tools/run_big_corpus runs resident and segment epochs on 0.5 GiB."""
    from music_generator_tpu_torch.cli import train_main
    from music_generator_tpu_torch.data.dataset import load_all
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.tools import run_big_corpus
    from music_generator_tpu_torch.training import trainer as trainer_mod
    t0 = time.perf_counter()
    styles = [[os.path.join(TRAIN_WORK, d) for d in g] for g in cfg.styles]
    ds = load_all(styles, cfg.seq_len, cfg)
    B = min(cfg.batch_size, len(ds))
    budget, seg, S = _segment_budget(ds, B)
    log(f"trainer modes: {len(ds)} windows, {S} steps an epoch; segments "
        f"of {seg} steps ({S // seg} and a tail of {S % seg}) from a "
        f"budget of {budget} bytes")
    real_step = trainer_mod.train_step
    runs = {}
    for mode, kw in (("replicated", {}),
                     ("segments", {"epoch_scan_max_bytes": budget}),
                     ("stream", {"epoch_scan": False})):
        trainer = trainer_mod.Trainer(
            build_model(cfg, "cuda"),
            trainer_mod.TrainConfig(seed=0, checkpoint=False,
                                    tensorboard=False, **kw))
        losses, sums, window = [], [], []

        def recording(state, batch):
            if len(losses) in MODE_PROFILED:
                torch.cuda.synchronize()
                if window:
                    window[0].stop()
                else:
                    window.append(profile(activities=[ProfilerActivity.CUDA]))
                    window[0].start()
            metrics = real_step(state, batch)
            rows = torch.arange(1, batch[0].shape[0] + 1, device="cuda",
                                dtype=torch.float64)
            sums.append(torch.stack([(t.double().flatten(1).sum(1) * rows)
                                     .sum() for t in batch]))
            losses.append(metrics["loss"])
            return metrics

        trainer_mod.train_step = recording
        try:
            torch.cuda.synchronize()
            reset_counts()
            hist = trainer.fit(ds, epochs=2)
            launches, plain = read_counts()
        finally:
            trainer_mod.train_step = real_step
        n_prof = MODE_PROFILED[1] - MODE_PROFILED[0]
        events = window[0].key_averages()
        device = sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        device /= 1e3 * n_prof
        steps = sum(hist["steps_per_epoch"])
        rates = [n * B * cfg.seq_len / dt for n, dt in
                 zip(hist["steps_per_epoch"], hist["epoch_seconds"])]
        step_ms = hist["epoch_seconds"][1] * 1e3 / hist["steps_per_epoch"][1]
        loss_v = torch.stack(losses).float().cpu()
        log(f"trainer mode {mode} ({time.perf_counter() - t0:.1f} s into "
            f"the phase): epoch_scan_mode "
            f"{hist['epoch_scan_mode']}, {steps} steps, per-step losses "
            f"{[round(float(v), 6) for v in loss_v]}; epoch timesteps/s "
            f"{', '.join(f'{r:.1f}' for r in rates)} (epoch 1 with {n_prof} "
            f"profiled steps); device {device:.4f} ms a step (steps "
            f"{MODE_PROFILED[0]}-{MODE_PROFILED[1] - 1}), epoch 2 "
            f"{step_ms:.4f} ms a step, busy share {device / step_ms:.3f} "
            f"({card}); launches {launches}, plain calls {plain}")
        if hist["epoch_scan_mode"] != mode:
            fail(f"trainer modes: asked for {mode}, ran "
                 f"{hist['epoch_scan_mode']}")
        if (any(v != (steps if k.startswith("biax") else 0)
                for k, v in launches.items()) or plain != 0):
            fail(f"trainer mode {mode}: not every step ran each biaxial "
                 f"kernel once, and only them")
        if not torch.isfinite(loss_v).all():
            fail(f"trainer mode {mode}: non-finite loss")
        runs[mode] = (torch.stack(sums).cpu(), loss_v,
                      {k: v.detach().clone()
                       for k, v in trainer.model.state_dict().items()})
    want_sums, want_loss, want_state = runs["replicated"]
    for mode in ("segments", "stream"):
        sums, loss_v, state = runs[mode]
        if not torch.equal(sums, want_sums):
            fail(f"trainer mode {mode}: the batch stream differs from "
                 f"replicated")
        same_loss = torch.equal(loss_v, want_loss)
        differ = sorted(k for k, v in state.items()
                        if not torch.equal(v, want_state[k]))
        rel = float(((loss_v - want_loss).abs()
                     / want_loss.abs()).max())
        log(f"trainer mode {mode} against replicated: batch checksums "
            f"equal; losses bit for bit {same_loss} (max rel {rel:.3g}); "
            f"final parameters bit for bit {not differ} "
            f"({len(differ)} of {len(state)} tensors differ)")
        if not same_loss or differ:
            fail(f"trainer mode {mode}: losses or final parameters differ "
                 f"from replicated (the kernels have no atomics, so the "
                 f"modes must agree bit for bit): {differ[:4]}")

    # train --profile through the CLI, on the 3c corpus.
    cwd = os.getcwd()
    os.chdir(TRAIN_WORK)
    try:
        reset_counts()
        hist = train_main(["--epochs", "1", "--profile", "--no-resume"])
        launches, _ = read_counts()
        trace = os.path.join(TRAIN_WORK, "out", "logs", "profile",
                             "train_steps_5_10.pt.trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.chdir(cwd)
    rows = [e for e in events if e.get("cat") == "kernel"]
    found = {k: sum(1 for e in rows if k in e.get("name", ""))
             for k in PROFILED_KERNELS}
    log(f"train --profile ({time.perf_counter() - t0:.1f} s into the "
        f"phase): mode {hist['epoch_scan_mode']}, "
        f"{hist['steps_per_epoch'][0]} steps, launches {launches}; trace "
        f"{os.path.getsize(trace)} bytes, {len(rows)} device kernel rows, "
        f"biaxial kernel rows {found}")
    if (hist["epoch_scan_mode"] != "stream" or not all(found.values())
            or found["note_heads_kernel"] != 5):
        fail("train --profile: the trace lacks device rows of the biaxial "
             "training kernels in steps 5-10")

    # The ported big-corpus tool at 0.5 GiB, 1 epoch each.
    big = run_big_corpus.main([
        "--gb", "0.5", "--epochs", "1", "--seg-epochs", "1",
        "--seg-budget-gb", "0.125", "--out",
        os.path.join(WORK, "big_corpus.json")])
    res, sg = big["resident"], big["segments"]
    log(f"run_big_corpus ({time.perf_counter() - t0:.1f} s into the "
        f"phase): {big['corpus_gib']:.3f} GiB, {big['windows']} "
        f"windows; host-to-device copy {big['h2d_MBps']} MB/s; resident "
        f"{res['steady_timesteps_per_sec']:.1f} timesteps/s "
        f"({res['steps_per_epoch']} steps), segments "
        f"{sg['steady_timesteps_per_sec']:.1f} timesteps/s "
        f"({sg['vs_resident']:.3f} of resident) ({card})")
    if not (np.isfinite(res["losses"]).all()
            and np.isfinite(sg["losses"]).all()):
        fail("run_big_corpus: non-finite loss")


def _divergence(path: str, ref: str) -> dict:
    """Where two .mid files with the same note events differ: the
    (step, pitch) cells whose volume differs, with both values."""
    from music_generator_tpu_torch.midi import midi_decode, read_midifile
    got = midi_decode(read_midifile(path))
    want = midi_decode(read_midifile(ref))
    cells = np.argwhere(got[..., 2] != want[..., 2])
    return {"file": os.path.relpath(ref, ROOT),
            "differing_volume_cells": len(cells),
            "first": [[int(t), int(n), float(got[t, n, 2]),
                       float(want[t, n, 2])] for t, n in cells[:8]]}

# Phase 3m: two ranks of tools/mp_worker.py.  Two ranks share one card only
# over gloo (NCCL refuses two ranks on one device); with two cards or more
# the phase runs again over NCCL, one rank a card.
MP_WORLD = 2
MP_WINDOWS = 32          # the global batch of the step: B 32, 16 a rank
MP_GEN = "3x8s0,3x8s1,64x2s0"
MP_BATCHES = (4, 16)


def _spawn_ranks(out: str, modes: str, backend: str, flags) -> list:
    """Start MP_WORLD worker ranks (gloo: all on cuda:0; nccl: rank r on
    cuda:r) and return each rank's (json, npz); a rank that fails or
    hangs fails the phase, and every rank is stopped either way."""
    port = _free_port()
    procs = []
    for r in range(MP_WORLD):
        dev = "cuda:0" if backend == "gloo" else f"cuda:{r}"
        with open(f"{out}.{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "music_generator_tpu_torch.tools.mp_worker", str(r),
                 str(MP_WORLD), str(port), out, modes, "--device", dev,
                 "--backend", backend, *map(str, flags)],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + 400
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        fail(f"multi-rank ({backend}): a rank hung")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            text = open(f"{out}.{r}.log").read()
            fail(f"multi-rank ({backend}) rank {r} failed:\n{text[-3000:]}")
    return [(json.load(open(f"{out}.{r}.json")), np.load(f"{out}.{r}.npz"))
            for r in range(MP_WORLD)]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_notes(what: str, got: np.ndarray, want: np.ndarray) -> bool:
    """Fail unless play and replay are identical; return whether the
    notes are identical bit for bit, and print where volumes differ."""
    if got.shape != want.shape or not np.array_equal(got[..., :2],
                                                     want[..., :2]):
        fail(f"multi-rank {what}: the note events differ from the "
             f"one-process run")
    if np.array_equal(got, want):
        return True
    cells = np.argwhere(got[..., 2] != want[..., 2])
    first = [[*map(int, c), float(got[tuple(c)][2]),
              float(want[tuple(c)][2])] for c in cells[:4]]
    log(f"multi-rank {what}: same events, {len(cells)} volume cells "
        f"differ, first (stream, step, pitch, got, want) {first}")
    return False


def _midi_bytes(roll: np.ndarray, cfg) -> bytes:
    """A [T, N, 3] roll as the .mid bytes write_file would write."""
    from music_generator_tpu_torch.data.dataset import unclamp_midi
    from music_generator_tpu_torch.midi.codec import midi_encode
    from music_generator_tpu_torch.midi.io import write_midifile
    buf = io.BytesIO()
    write_midifile(buf, midi_encode(unclamp_midi(roll, cfg), config=cfg))
    return buf.getvalue()


def _check_training(backend: str, ranks, init: dict, one: dict,
                    loss: float) -> tuple:
    """Phase 3m (a) on one backend's ranks: the worker's step against the
    one-process step from the same weights `init` (its loss `loss`, its
    parameters `one`): the loss within PARITY_BAR[0] relative and the
    worst-leaf cosine of the update at least PARITY_BAR[1]; the ranks'
    parameters bit-equal after the step and after every fit step, and
    their fit losses equal; the four biaxial kernels launched once a step
    on each rank, no plain version.  Returns (loss rel, cosine, fit
    steps)."""
    (r0, npz0), (r1, _) = ranks
    d_loss = abs(r0["step_loss"] - loss) / abs(loss)
    _, _, cos = leaf_stats(
        [torch.from_numpy(npz0["step." + k] - init[k]) for k in one],
        [torch.from_numpy(one[k] - init[k]) for k in one])
    log(f"multi-rank ({backend}) step: loss {r0['step_loss']:.6f} against "
        f"one process {loss:.6f} (rel {d_loss:.3g}), worst-leaf update "
        f"cosine {cos:.6f}; kernels {r0['step_counts']} / "
        f"{r1['step_counts']}")
    if d_loss > PARITY_BAR[0] or cos < PARITY_BAR[1]:
        fail(f"multi-rank ({backend}) step: against the one-process step "
             f"the loss is {d_loss:.3g} relative (bar {PARITY_BAR[0]}) and "
             f"the update cosine {cos:.6f} (bar {PARITY_BAR[1]})")
    if r0["step_hash"] != r1["step_hash"]:
        fail(f"multi-rank ({backend}) step: the ranks' parameters differ")
    fit0, fit1 = r0["fit"]["sharded"], r1["fit"]["sharded"]
    steps = sum(fit0["steps_per_epoch"])
    log(f"multi-rank ({backend}) fit: {fit0['epoch_scan_mode']}, {steps} "
        f"steps, losses {fit0['loss']}; kernels rank 0 {fit0['counts']}, "
        f"rank 1 {fit1['counts']}")
    if (fit0["hashes"] != fit1["hashes"] or len(fit0["hashes"]) != steps
            or fit0["loss"] != fit1["loss"]):
        fail(f"multi-rank ({backend}) fit: the ranks' parameters or losses "
             f"differ")
    for counts, n in ((r0["step_counts"], 1), (r1["step_counts"], 1),
                      (fit0["counts"], steps), (fit1["counts"], steps)):
        if any(v != (0 if k.endswith("plain") else n)
               for k, v in counts.items()):
            fail(f"multi-rank ({backend}) training: kernel counts {counts}, "
                 f"not {n} launches of each biaxial kernel and no plain "
                 f"call")
    return d_loss, cos, steps


def multi_rank(cfg, card) -> dict:
    """Phase 3m: data parallelism with two ranks of tools/mp_worker.py on
    the card (gloo, named here because both share cuda:0), at
    default_config() dropout 0: (a) one step of a B 32 batch, 16 rows a
    rank, against the one-process step (loss within PARITY_BAR[0]
    relative, worst-leaf cosine of the update at least PARITY_BAR[1]),
    and `sharded` fit steps over a synthetic corpus split by
    Dataset.shard with both ranks' parameters bit-equal after every step,
    the four biaxial kernels launched once a step on each rank and no
    plain version; (b) generation with 32 of G = 64 streams a rank and
    phase 3's G = 3 (padded to 4), a primed batch and begin / advance,
    against the one-process run (note events required; the .mid bytes and
    the floats' bit-equality counted, and where volumes differ printed)
    and phase 3's files against the committed samples; (c) a leader and a follower serving over the
    replay channel at buckets 1, 4 and 16, a /generate_batch and a
    time-sliced job, byte-equal to a one-process service, the follower's
    pitch-loop launches equal to the leader's.  With two cards or more,
    (a) and (b) again over NCCL.  Returns the readings."""
    from music_generator_tpu_torch.data.dataset import Dataset
    from music_generator_tpu_torch.data.synth import random_batch
    from music_generator_tpu_torch.generation.sampler import (
        GenerationResult, Sampler, write_file)
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.params import (load_params_npz,
                                                  params_to_numpy)
    from music_generator_tpu_torch.parallel.train_step import (
        create_train_state, train_step)
    from music_generator_tpu_torch.serving import GenerationService
    from music_generator_tpu_torch.tools.mp_worker import (generation_cases,
                                                           serving_requests)
    t0 = time.perf_counter()
    tcfg = cfg.replace(dropout=0.0, input_dropout=0.0)
    out = os.path.join(WORK, "mp", "gloo")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    flags = ["--config", "default", "--no-dropout", "--windows", MP_WINDOWS,
             "--time-steps", 5, "--fit-modes", "sharded", "--split", "shard",
             "--epochs", 3, "--params", PARAMS, "--gen", MP_GEN]
    serve = ["--serve-port", _free_port(), "--max-batch", max(MP_BATCHES),
             "--warmup-buckets", max(MP_BATCHES), "--batch-sizes",
             ",".join(map(str, MP_BATCHES))]
    ranks = _spawn_ranks(out, "step,fit,generate,serve", "gloo",
                         flags + serve)
    spawn_s = time.perf_counter() - t0
    (r0, npz0), (r1, npz1) = ranks

    # (a) training.  The one-process step on the whole batch, from the
    # same fresh weights.
    model = build_model(tcfg, "cuda")
    st = create_train_state(model, 0)
    model.load_state_dict(build_model(tcfg, "cpu", seed=0).state_dict())
    init = {k: v.copy() for k, v in params_to_numpy(
        model.state_dict()).items()}
    batch = tuple(torch.from_numpy(a).cuda() for a in random_batch(
        tcfg, batch_size=MP_WINDOWS, seed=0))
    loss = float(train_step(st, batch)["loss"])
    one = params_to_numpy(model.state_dict())
    d_loss, cos, steps = _check_training("gloo", ranks, init, one, loss)

    # One rank alone on the card: the worker's timed steps at B 16.
    half = tuple(a[:MP_WINDOWS // MP_WORLD] for a in batch)
    for _ in range(2):
        train_step(st, half)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        train_step(st, half)
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t) * 1e3 / 5

    # (b) generation against one process and the committed samples.
    r4 = load_params_npz(PARAMS)
    model = build_model(cfg, "cuda", state=r4)
    want = generation_cases(Sampler(model), cfg, MP_GEN.split(","))
    same, files, n_files = {}, 0, 0
    for k, v in want.items():
        want_files = [_midi_bytes(roll, cfg) for roll in v]
        for r, npz in enumerate((npz0, npz1)):
            got = npz["gen." + k]
            same[f"{k}@{r}"] = _same_notes(f"{k} rank {r}", got, v)
            files += sum(_midi_bytes(roll, cfg) == f
                         for roll, f in zip(got, want_files))
            n_files += len(want_files)
    n_bytes = 0
    for seed in (0, 1):
        res = GenerationResult(npz0[f"gen.3x8s{seed}"], None)
        paths = write_file(f"mp_s{seed}", res, cfg.replace(
            out_dir=os.path.join(WORK, "mp")))
        for i, p in enumerate(paths):
            ref = os.path.join(SHORT, f"short_s{seed}_{i}.mid")
            if not check_sample(p, ref):
                log(json.dumps(_divergence(p, ref)))
            n_bytes += open(p, "rb").read() == open(ref, "rb").read()
    log(f"multi-rank generation: note events identical to one process in "
        f"every case on both ranks, {files}/{n_files} streams' .mid bytes "
        f"equal, {sum(same.values())}/{len(same)} cases bit-equal as "
        f"floats; {n_bytes}/6 phase-3 files byte-identical to "
        f"short_samples_r4; launches {r0['gen_launches']} / "
        f"{r1['gen_launches']}")
    if not r0["gen_launches"] or r0["gen_launches"] != r1["gen_launches"]:
        fail("multi-rank generation: the ranks' pitch-loop launches differ")

    # (c) serving against a one-process service with the same flags.
    service = GenerationService(config=cfg, params=r4,
                                max_batch=max(MP_BATCHES),
                                warmup_buckets=max(MP_BATCHES))
    solo = serving_requests(service, cfg, MP_BATCHES)
    from music_generator_tpu_torch.midi import midi_decode, read_midifile
    n_same = 0
    for k, v in solo.items():
        got = bytes.fromhex(r0["responses"][k])
        if got == v:
            n_same += 1
            continue
        a, b = (midi_decode(read_midifile(io.BytesIO(x))) for x in (got, v))
        _same_notes(f"serving {k}", a, b)
    log(f"multi-rank serving: {n_same}/{len(solo)} responses byte-equal to "
        f"one process, {r1['replayed']} calls replayed; pitch-loop launches "
        f"leader {r0['serve_launches']}, follower {r1['serve_launches']}")
    if (r0["serve_launches"] != r1["serve_launches"]
            or not r0["serve_launches"] or r1["replayed"] < len(MP_BATCHES)):
        fail("multi-rank serving: the follower did not replay the leader")

    readings = {
        "card": card, "backend": r0["backend"], "world": MP_WORLD,
        "step_ms_one_rank_alone_b16": alone_ms,
        "step_ms_two_ranks_sharing_b16": [r0["step_ms"], r1["step_ms"]],
        "all_reduce_ms": [r0["all_reduce_ms"], r1["all_reduce_ms"]],
        "bucket_floats": r0["bucket_floats"],
        "step_loss_rel": d_loss, "update_cos": cos,
        "fit_steps": steps, "gen_bit_equal": sum(same.values()),
        "gen_cases": len(same), "gen_midi_equal": files,
        "gen_midi": n_files, "short_bytes": n_bytes,
        "serving_bytes": n_same, "serving_responses": len(solo),
        "spawn_s": spawn_s}
    if torch.cuda.device_count() >= MP_WORLD:
        nout = os.path.join(WORK, "mp", "nccl")
        n0, n1 = _spawn_ranks(nout, "step,fit,generate", "nccl", flags)
        n_loss, n_cos, _ = _check_training("nccl", (n0, n1), init, one,
                                           loss)
        if n0[0]["step_hash"] != r0["step_hash"]:
            log("multi-rank nccl: parameters differ from gloo's (the sums "
                "run in another order)")
        readings.update(nccl_step_loss_rel=n_loss, nccl_update_cos=n_cos)
        for k in want:
            for r, npz in enumerate((n0[1], n1[1])):
                _same_notes(f"nccl {k} rank {r}", npz["gen." + k], want[k])
        if (not n0[0]["gen_launches"]
                or n0[0]["gen_launches"] != n1[0]["gen_launches"]):
            fail("multi-rank nccl generation: the ranks' pitch-loop "
                 "launches differ")
        readings["nccl_all_reduce_ms"] = [n0[0]["all_reduce_ms"],
                                          n1[0]["all_reduce_ms"]]
        readings["nccl_step_ms"] = [n0[0]["step_ms"], n1[0]["step_ms"]]
    else:
        log(f"multi-rank: NCCL not run on this machine "
            f"({torch.cuda.device_count()} card)")
    readings["phase_s"] = time.perf_counter() - t0
    return readings



def note_depths(cfg, card):
    """Phase 3l: the pitch loop at note depths 1-8 (the r4 weights rebuilt
    by tools/common.py::depth_params).  For each depth at G = 3 and 64:
    the plan (and, for a cluster plan, the clusters resident at once: one
    wave required at depths 1-2, two accepted at 3-5), `note_sample`
    against its plain version (draws_agree, both gate flavors) and, where
    the plan is a cluster's, against the streamed kernel bit for bit (at
    a streamed plan note_sample runs that kernel), and the plan's kernel
    timed beside
    its bound.  Then Sampler.generate (G = 3, every count set to 0 just
    before and read just after) at depths 1 and 3, 2 bars, against
    artifacts/note_depth_r17 (events required, bytes reported, a
    diagnosis logged where only volumes differ), and at depth 6, 1 bar, on
    the streamed kernel; and a depth-3 service's /generate equal to its
    solo run.  Returns {depth: {G: (kernel, ms, bound ms, bound_by)}} and
    the launches of the generate runs."""
    from music_generator_tpu_torch.data.dataset import compute_genre
    from music_generator_tpu_torch.generation.sampler import (
        Sampler, _velocity_grid, write_file)
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.ops import notegen
    from music_generator_tpu_torch.params import params_from_numpy
    from music_generator_tpu_torch.serving import (DeepJHTTPServer,
                                                   GenerationService,
                                                   make_handler)
    from music_generator_tpu_torch.tools.common import depth_params
    with np.load(PARAMS) as data:
        r4 = {k: data[k] for k in data.files}
    F, H, N = cfg.time_axis_units, cfg.note_axis_units, cfg.num_notes
    vgrid = torch.from_numpy(_velocity_grid(cfg.max_velocity)).cuda()
    models = {L: build_model(cfg.replace(note_axis_layers=L), "cuda",
                             state=params_from_numpy(depth_params(r4, L)))
              for L in range(1, 9)}
    times, max_err = {}, 0.0
    for L, model in models.items():
        heads = (model.note_dense, model.volume_dense)
        times[L] = {}
        for G in (3, 64):
            plan = notegen.notegen_plan(G, L, F, H, N)
            note = ""
            if plan.kernel == "cluster":
                active = notegen.active_clusters(G, L, F, H, N)
                waves = -(-plan.clusters // active) if active else 0
                note = f"; {active} clusters resident at once: {waves} wave(s)"
                if waves == 0 or (L <= 2 and waves > 1):
                    fail(f"notegen depth {L} G={G}: {waves} waves")
            log(f"notegen depth {L} G={G}: plan {plan.kernel} kernel, "
                f"C={plan.C}, Gc={plan.Gc}, {plan.clusters} "
                f"{'clusters' if plan.C else 'blocks'}, {plan.smem} bytes "
                f"a block{note}")
            for i, (act, grid, T) in enumerate((
                    ("sigmoid", None, 1.0), ("hard_sigmoid", vgrid, 0.9))):
                feats, us, temp, emb = notegen_inputs(
                    model, G, T, 1000 + 100 * L + 2 * G + i)
                args = (feats, us, temp, model.note_axis, *heads, emb, act,
                        grid)
                got = notegen.note_sample(*args)
                # Where the plan is the streamed kernel, note_sample runs it
                # too: only the plain version is a comparison there.
                if plan.kernel == "cluster" and not torch.equal(
                        got, notegen.note_sample_streamed(*args)):
                    fail(f"notegen depth {L} G={G} {act}: the cluster "
                         f"kernel differs from the streamed kernel")
                want = notegen.note_sample_reference(*args)
                probs = notegen.tempered_probs(feats, got, temp,
                                               model.note_axis, *heads, emb,
                                               act)
                ok, err, report = notegen.draws_agree(got, want, us, probs,
                                                      EDGE, VOLUME_ATOL)
                max_err = max(max_err, err)
                if not ok or not torch.isfinite(got).all():
                    fail(f"notegen depth {L} G={G} {act}: disagrees with "
                         f"the plain version: {report}")
            feats, us, temp, emb = notegen_inputs(model, G, 1.0,
                                                  2000 + 10 * L + G)
            ops = notegen._kernel_operands(feats, us, temp, model.note_axis,
                                           *heads, emb, None)
            if plan.kernel == "cluster":
                ms = cuda_ms(lambda: notegen._launch(ops, False), 30)
                st = cuda_ms(lambda: notegen._launch_streamed(ops, False), 30)
            else:
                ms = st = cuda_ms(
                    lambda: notegen._launch_streamed(ops, False), 30)
            bound, bound_by = notegen_bound_ms(G, N, F, H, L)
            times[L][G] = (plan.kernel, ms, bound, bound_by)
            same = ("cluster = streamed bit for bit and "
                    if plan.kernel == "cluster" else "")
            log(f"notegen depth {L} G={G}: {plan.kernel} kernel {ms:.4f} "
                f"ms/launch (streamed kernel {st:.4f}), bound {bound:.6f} "
                f"ms by {bound_by}; {same}both gate cases agree with the "
                f"plain version ({card})")
    log(f"notegen depths 1-8: max|dv| {max_err:.3g} against the plain "
        f"version")

    # Sampler.generate at depths 1 and 3 (committed bytes) and 6.
    gen_dir = os.path.join(WORK, "depths")
    launches = {}
    for L, bars in ((1, 2), (3, 2), (6, 1)):
        dcfg = cfg.replace(note_axis_layers=L, out_dir=gen_dir)
        styles = [compute_genre(i, dcfg) for i in range(3)]
        _reset_notegen_counts()
        res = Sampler(models[L]).generate(styles, num_bars=bars, seed=0)
        counts = _notegen_counts()
        steps = bars * cfg.notes_per_bar
        kernel = notegen.notegen_plan(3, L, F, H, N).kernel
        log(f"generate depth {L}: {steps} timesteps; notegen launches "
            f"{counts[0]} ({counts[1]} of them the streamed kernel, the "
            f"plan's {kernel}), comparison launches {counts[2]}, plain "
            f"calls {counts[3]}")
        want = (steps, steps if kernel == "streamed" else 0, 0, 0)
        if counts != want or not np.isfinite(res.notes).all():
            fail(f"generate depth {L}: counts {counts}, expected {want}")
        launches[L] = counts[0]
        if L == 6:
            continue
        for i, p in enumerate(write_file(f"depth{L}", res, dcfg)):
            ref = os.path.join(ROOT, "artifacts", "note_depth_r17",
                               "samples", f"depth{L}_{i}.mid")
            if not check_sample(p, ref):
                log("divergence: " + json.dumps(_divergence(p, ref)))

    # A depth-3 service: /generate equal to its solo run.
    service = GenerationService(
        config=cfg.replace(note_axis_layers=3),
        params=params_from_numpy(depth_params(r4, 3)), warmup=False)
    solo = service._encode_midi(Sampler(service.model).generate(
        [compute_genre(1, cfg)], num_bars=2, seed=21,
        stream_indices=[0]).notes[0])
    httpd = DeepJHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, _, body = _post(f"http://127.0.0.1:{httpd.server_port}",
                                {"genre": 1, "bars": 2, "seed": 21})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    log(f"serve depth 3: /generate answered {status}, {len(body)} bytes, "
        f"equal to its solo run {body == solo}")
    if status != 200 or body != solo:
        fail("serve depth 3: the response differs from its solo run")
    return times, launches, max_err


def flavor_gaps(got, own, other):
    """The mean |volume| gap of the kernel's notes `got` [G, N, 3] from
    its own flavor's plain version and from the other flavor's, over the
    played pitches before each stream's first pitch where any two of the
    three draw differently.  Returns (own gap, other gap, pitches)."""
    got, own, other = (t.float().cpu() for t in (got, own, other))
    same = ((got[..., :2] == own[..., :2]).all(-1)
            & (got[..., :2] == other[..., :2]).all(-1))
    keep = same.int().cumprod(dim=1).bool() & (got[..., 0] > 0)
    v = got[..., 2][keep]
    if not v.numel():
        return 0.0, 0.0, 0
    return (float((v - own[..., 2][keep]).abs().mean()),
            float((v - other[..., 2][keep]).abs().mean()), v.numel())


def check_notegen_bf16(cfg, card):
    """Phase 2b: kernel 1's bfloat16 instances against their plain
    versions (ops/notegen.py: `note_sample_reference` at bfloat16 in the
    flavor's arithmetic) at depths 1, 2, 3 and 6 on the r4 weights
    (tools/common.py::depth_params), G = 3 and 64, both gate flavors,
    quantize on and off, at depth 2 also on bfloat16 features (the
    linear time axis's, which the scan flavor's chosen note is rounded
    to), and bit for bit against the streamed kernel.  With quantize off
    the volumes are held to one bfloat16 ULP (BF16_VOLUME_ULP) and the
    kernel must lie nearer its own flavor's plain version than the other
    flavor's (`flavor_gaps`: its mean gap at most a quarter of the
    other's).  Then each flavor's ms a launch at depth 2 beside the
    float32 instance's on the same inputs (in turns), its plain version,
    its bound and block 0's cycles per pitch by phase (`notegen_cycles`).
    Returns {flavor: (max |dv|, {G: (ms, plain ms, bound ms, bound_by,
    float32 ms, cycles)})}."""
    from music_generator_tpu_torch.generation.sampler import _velocity_grid
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.ops import notegen
    from music_generator_tpu_torch.params import params_from_numpy
    from music_generator_tpu_torch.tools.common import depth_params
    bf16 = torch.bfloat16
    with np.load(PARAMS) as data:
        r4 = {k: data[k] for k in data.files}
    F, H, N = cfg.time_axis_units, cfg.note_axis_units, cfg.num_notes
    vgrid = torch.from_numpy(_velocity_grid(cfg.max_velocity)).cuda()
    out = {"scan": [0.0, {}], "fused": [0.0, {}]}
    cases = 0
    for L in (2, 1, 3, 6):
        model = build_model(cfg.replace(note_axis_layers=L), "cuda",
                            state=params_from_numpy(depth_params(r4, L)))
        heads = (model.note_dense, model.volume_dense)
        weights = notegen.note_weights(model.note_axis, *heads, F)
        for G in (3, 64):
            plan = notegen.notegen_plan(G, L, F, H, N, 2)
            note = ""
            if plan.kernel == "cluster":
                active = notegen.active_clusters(G, L, F, H, N, 2)
                note = (f"; {active} clusters resident at once: "
                        f"{-(-plan.clusters // max(active, 1))} wave(s)")
            log(f"notegen bf16 depth {L} G={G}: plan {plan.kernel} kernel, "
                f"C={plan.C}, Gc={plan.Gc}, {plan.clusters} "
                f"{'clusters' if plan.C else 'blocks'}, {plan.smem} bytes "
                f"a block{note}")
            kinds = [("sigmoid", None, 1.0, torch.float32),
                     ("hard_sigmoid", vgrid, 0.9, torch.float32)]
            if L == 2:
                kinds.append(("sigmoid", None, 1.1, bf16))
            for flavor in ("scan", "fused"):
                other = "fused" if flavor == "scan" else "scan"
                for i, (act, grid, T, fdt) in enumerate(kinds):
                    cases += 1
                    feats, us, temp, emb = notegen_inputs(
                        model, G, T, 3000 + 100 * L + 2 * G + i)
                    feats = feats.to(fdt)
                    args = (feats, us, temp, model.note_axis, *heads,
                            emb.to(bf16), act, grid, bf16, flavor)
                    got = notegen.note_sample(*args, weights)
                    if not torch.equal(got, notegen.note_sample_streamed(
                            *args, weights)):
                        fail(f"notegen bf16 {flavor} depth {L} G={G} {act}: "
                             f"the cluster kernel differs from the streamed "
                             f"kernel")
                    want = notegen.note_sample_reference(*args)
                    probs = notegen.tempered_probs(
                        feats, got, temp, model.note_axis, *heads,
                        emb.to(bf16), act, bf16, flavor)
                    tol = BF16_VOLUME_ULP if grid is None else BF16_VOLUME_ATOL
                    ok, err, report = notegen.draws_agree(
                        got, want, us, probs, BF16_EDGE, tol)
                    out[flavor][0] = max(out[flavor][0], err)
                    what = (f"notegen bf16 {flavor} depth {L} G={G} {act} "
                            f"quantize={grid is not None} features "
                            f"{str(fdt)[6:]}")
                    log(f"{what}: max|dv|={err:.3g} (atol {tol}), {report}")
                    if not ok or not torch.isfinite(got).all():
                        fail(f"{what} disagrees with its plain version: "
                             f"{report}")
                    if grid is not None:
                        continue
                    # The other flavor's arithmetic on the same inputs:
                    # its probabilities along the kernel's trajectory
                    # differ, and the kernel's volumes lie nearer its own.
                    want_o = notegen.note_sample_reference(
                        *args[:-1], other)
                    probs_o = notegen.tempered_probs(
                        feats, got, temp, model.note_axis, *heads,
                        emb.to(bf16), act, bf16, other)
                    dp = float((probs - probs_o).abs().max())
                    own, oth, n = flavor_gaps(got, want, want_o)
                    log(f"{what}: mean |dv| over {n} played pitches "
                        f"{own:.3g} from its own flavor's plain version, "
                        f"{oth:.3g} from the {other} flavor's; max|dp| "
                        f"between the flavors {dp:.3g}")
                    if not (n and dp > 0 and 4 * own < oth):
                        fail(f"{what}: the kernel is not told apart from "
                             f"the {other} flavor (mean |dv| {own:.3g} "
                             f"against {oth:.3g} over {n} pitches, "
                             f"max|dp| {dp:.3g})")
            if L != 2:
                continue
            feats, us, temp, emb = notegen_inputs(model, G, 1.0, 100 + G)
            ops32 = notegen._kernel_operands(feats, us, temp,
                                             model.note_axis, *heads, emb,
                                             None)
            for flavor in ("scan", "fused"):
                args = (feats, us, temp, model.note_axis, *heads,
                        emb.to(bf16), "sigmoid", None, bf16, flavor)
                ops = notegen._kernel_operands(*args[:7], None, bf16,
                                               flavor, weights)
                # The flavor and the float32 instance on the same inputs,
                # in turns (flavor, float32, float32, flavor).
                runs = [cuda_ms(lambda: notegen._launch(o, False), 50)
                        for o in (ops, ops32, ops32, ops)]
                ms, ms32 = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
                plain = cuda_ms(lambda: notegen.note_sample_reference(*args),
                                5)
                bound, bound_by = notegen_bound_ms(G, N, F, H, 2, 2)
                log(f"notegen bf16 {flavor} depth 2 G={G}: {runs[0]:.4f} / "
                    f"{runs[3]:.4f} ms/launch, the float32 instance on the "
                    f"same inputs {runs[1]:.4f} / {runs[2]:.4f} (ratio "
                    f"{ms / ms32:.4f}), plain version {plain:.4f} ms, bound "
                    f"{bound:.6f} ms by {bound_by} ({card})")
                cycles = notegen_cycles(
                    ops, f"notegen bf16 {flavor} depth 2 G={G}")
                out[flavor][1][G] = (ms, plain, bound, bound_by, ms32,
                                     cycles)
    log(f"notegen bf16: {cases} cases of both flavors agree with their "
        f"plain versions (|u-p| edge {BF16_EDGE}, volume atol "
        f"{BF16_VOLUME_ULP} with quantize off, {BF16_VOLUME_ATOL} on), "
        f"each unquantized case nearer its own flavor than the other, and "
        f"the cluster kernel equals the streamed kernel bit for bit")
    return out


def check_notegen_plans(cfg):
    """Print the cluster pitch-loop kernel's plan at G = 1, 3, 8, 64 and
    256 beside the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters); fail if a plan at G <= 64 needs two
    waves."""
    from music_generator_tpu_torch.ops import notegen
    F, H, N = cfg.time_axis_units, cfg.note_axis_units, cfg.num_notes
    for G in (1, 3, 8, 64, 256):
        p = notegen.notegen_plan(G, 2, F, H, N)
        active = notegen.active_clusters(G, 2, F, H, N)
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
    heads = (model.note_dense, model.volume_dense)
    times = {}
    for G in (3, 64, 256):
        feats, us, temp, emb = notegen_inputs(model, G, 1.0, 100 + G)
        args = (feats, us, temp, model.note_axis, *heads, emb, "sigmoid",
                None)
        ops = notegen._kernel_operands(*args[:7], None)
        runs = [cuda_ms(lambda: notegen._launch(ops, False), 50),
                cuda_ms(lambda: notegen._launch_streamed(ops, False), 50),
                cuda_ms(lambda: notegen._launch_streamed(ops, False), 50),
                cuda_ms(lambda: notegen._launch(ops, False), 50)]
        plain = (cuda_ms(lambda: notegen.note_sample_reference(*args), 5)
                 if G <= 64 else None)
        bound, bound_by = notegen_bound_ms(
            G, cfg.num_notes, cfg.time_axis_units, cfg.note_axis_units)
        ms, streamed = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        times[G] = (ms, streamed, plain, bound, bound_by)
        log(f"notegen G={G}: cluster kernel {runs[0]:.4f} / {runs[3]:.4f} "
            f"ms/launch, streamed kernel {runs[1]:.4f} / {runs[2]:.4f}, "
            f"plain version {'-' if plain is None else f'{plain:.4f}'} ms, "
            f"bound {bound:.6f} ms by {bound_by} ({card})")
        notegen_cycles(ops, f"notegen G={G}")
    return times


def notegen_cycles(ops, what: str) -> list:
    """Block 0's clock cycles per pitch by phase at depth 2, from one
    launch of the cluster kernel on `ops` with `prof`
    (ops/notegen.py::_launch), logged after `what`.  Returns [h0 U0, the
    wait for the draw with z0 and cells, h0 exchange and barrier 1, layer
    1 with cells, h1 exchange and barrier 2, heads and draw]."""
    from music_generator_tpu_torch.ops import notegen
    prof = torch.zeros(14, dtype=torch.int64, device="cuda")
    notegen._launch(ops, False, prof=prof)
    torch.cuda.synchronize()
    pr = prof.tolist()
    per = [c / pr[11] for c in pr[:6]]
    log(f"{what} block 0 (C={pr[8]}, Gc={pr[9]}, {pr[10]} "
        f"clusters), cycles per pitch: layer 0 h0 U0 {per[0]:.0f}, wait "
        f"for the draw with z0 and cells {per[1]:.0f}, h0 exchange and "
        f"barrier 1 {per[2]:.0f}, layer 1 with cells {per[3]:.0f}, h1 "
        f"exchange and barrier 2 {per[4]:.0f} (sum "
        f"{sum(per[:5]):.0f}); heads and draw, beside layer 0, "
        f"{per[5]:.0f}; prologue {pr[6]} cycles ({pr[12]} before the "
        f"acc_F chunks, {pr[13]} in them), launch {pr[7]} cycles")
    return per


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


PROFILE_WINDOWS = 3


def device_ms(fn, name: str, reps: int = 20) -> float:
    """Mean device ms a launch of the kernel whose name holds `name`, from
    a profiled run of `reps` calls of `fn` after a warm-up call: the
    kernel's own time, without the host's time between launches.  The
    profiler may miss the first launches of a window (18 or 19 of 20 in a
    full chip_smoke.py run) and, rarely, a whole window (0 of 20), so the
    mean is over the launches a window shows, at least half of them, from
    the first of PROFILE_WINDOWS windows that shows that many."""
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.key]
        count = sum(e.count for e in evs)
        counts.append(count)
        if reps // 2 <= count <= reps:
            return sum(e.self_device_time_total for e in evs) / count / 1e3
        log(f"the profile shows {count} launches of {name} for {reps}")
    fail(f"the profiles show {counts} launches of {name} for {reps} each")


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


def profiled_kernels(fn, reps: int, flush=None) -> dict:
    """{kernel name: (device us, launches)} over a profiled run of `reps`
    calls of `fn` after a warm-up call; `flush`, when given, runs before
    every call and its kernel (L2_FLUSH_KERNEL) is left out."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not (flush is not None and L2_FLUSH_KERNEL in e.key)}


def time_nadam(cfg, card, reps: int = 200) -> dict:
    """ms a step of kernel 11 (its two kernels' device time a launch, from
    the profiler, summed) and of the plain per-leaf update (the device
    time of all its launches a step), with the L2 cache rewritten before
    every step, as a training step's backward leaves p, mu and nu; the
    bound: one pass over the leaves' bytes (NADAM_BYTES_PER_ELEMENT) at
    HBM rate; on DeepJ's leaves at cfg's widths, time axes "lstm" and
    "linear".  Returns {kind: (ms, plain ms, bound ms)}."""
    from music_generator_tpu_torch.ops.nadam import plain_step
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda").bitwise_not_
    plain_reps = reps // 10
    out = {}
    for kind in ("lstm", "linear"):
        a, opt, b, ref = nadam_leaves(cfg, kind, seed=2)
        nadam_grads(a, b, torch.Generator().manual_seed(3))
        kern = profiled_kernels(opt.step, reps, flush)
        if sorted(k for k in kern if "nadam" in k) != sorted(kern) or (
                len(kern) != 2):
            fail(f"nadam {kind}: the kernels' step ran {sorted(kern)}, not "
                 f"the update and scalar kernels alone")
        ms = sum(us / n for us, n in kern.values()) / 1e3
        warm = sum(us / n for us, n in
                   profiled_kernels(opt.step, reps).values()) / 1e3
        plain_k = profiled_kernels(lambda: plain_step(ref), plain_reps, flush)
        plain = sum(us for us, _ in plain_k.values()) / plain_reps / 1e3
        plain_launches = sum(n for _, n in plain_k.values()) / plain_reps
        call = cuda_ms(opt.step, 50)
        plain_call = cuda_ms(lambda: plain_step(ref), 5)
        elements = sum(p.numel() for p in a)
        bound = elements * NADAM_BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e3
        out[kind] = (ms, plain, bound)
        log(f"nadam {kind} ({len(a)} leaves, {elements} elements): kernels "
            f"{ms:.6f} ms/step on the device with L2 rewritten (profiler; "
            + "; ".join(f"{k} {us / n / 1e3:.6f} ms" for k, (us, n)
                        in sorted(kern.items()))
            + f"), {warm:.6f} ms with L2 warm, the call {call:.4f} ms by "
            f"CUDA events; plain update {plain:.6f} ms/step on the device "
            f"in {plain_launches:.1f} launches, the call {plain_call:.4f} "
            f"ms; bound {bound:.6f} ms by bytes; {bound / ms:.3f} of the "
            f"bound ({card})")
    return out


GLRU_KERNEL = ("glru_scan",
               "none: `jax.lax.associative_scan`, elementwise under XLA",
               "music_generator_tpu_torch/csrc/glru_scan.cu")


GLRU_BATCH = 64     # the linear cell's batch (portbench/traffic/train_b64)


def glru_shapes(cfg):
    """(S, R, [each time-axis layer's input width], H) of the linear time
    axis at the linear cell's batch: S timesteps over R = B N rows."""
    from music_generator_tpu_torch.models.deepj import build_model
    lc = cfg.replace(time_axis_kind="linear")
    model = build_model(lc, "cpu", seed=0)
    widths = [layer.lstm.kernel.shape[0] for layer in model.time_axis]
    return lc.seq_len, GLRU_BATCH * lc.num_notes, widths, lc.time_axis_units


def check_glru(cfg) -> float:
    """Kernel 12 (`glru_scan` on CUDA tensors, csrc/glru_scan.cu) against
    its plain version (`glru_scan_fused_reference`) through autograd, at
    the linear cell's shapes (S 128, R = B N, H 256, each layer's input
    width), float32 and bfloat16: hs equal bit for bit, the gradients of
    xs, W and b within 1e-5 relative (b's float32 sum runs in blocks of
    rows), one launch a direction.  Returns the largest gradient gap."""
    from music_generator_tpu_torch.ops.linear_scan import (
        GLRUParams, glru_scan, glru_scan_fused_reference)
    S, R, widths, H = glru_shapes(cfg)
    worst = 0.0
    for layer, d_in in enumerate(widths):
        p = GLRUParams(d_in, H).cuda()
        gen = torch.Generator(device="cuda").manual_seed(layer)
        with torch.no_grad():
            p.kernel.uniform_(-1.0, 1.0, generator=gen).mul_(d_in ** -0.5)
            p.bias.uniform_(-0.5, 0.5, generator=gen)
        xs = torch.randn(S, R, d_in, device="cuda", generator=gen)
        cot = torch.randn(S, R, H, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            runs = {}
            for name, fn in (("kernel", glru_scan),
                             ("plain", glru_scan_fused_reference)):
                p.zero_grad()
                x = xs.clone().requires_grad_(True)
                launches = (glru_scan.fwd_launches, glru_scan.bwd_launches)
                hs = fn(p, x, dt)
                (hs.float() * cot).sum().backward()
                torch.cuda.synchronize()
                runs[name] = (hs.detach(), x.grad, p.kernel.grad.clone(),
                              p.bias.grad.clone(), (
                                  glru_scan.fwd_launches - launches[0],
                                  glru_scan.bwd_launches - launches[1]))
            k, r = runs["kernel"], runs["plain"]
            gaps = [float((a.float() - b.float()).norm() / b.float().norm())
                    for a, b in zip(k[1:4], r[1:4])]
            same = torch.equal(k[0], r[0])
            worst = max(worst, *gaps)
            log(f"glru_scan layer {layer} (in {d_in}) {dt}: S {S}, R {R}, H "
                f"{H}: hs equal {same} (max|d| "
                f"{float((k[0].float() - r[0].float()).abs().max()):.3g}), "
                f"gradient gaps xs / W / b "
                + " / ".join(f"{g:.3g}" for g in gaps)
                + f"; launches {k[4]} (plain {r[4]})")
            if (not same or max(gaps) > 1e-5 or k[4] != (1, 1)
                    or r[4] != (0, 0)):
                fail(f"glru_scan layer {layer} {dt}: the kernels and their "
                     f"plain version disagree")
    return worst


def time_glru(cfg, card, reps: int = 20) -> dict:
    """ms a launch of kernel 12 by direction at the linear cell's shapes
    in bfloat16 (S 128, R = B N, H 256), device time by the profiler with
    the L2 rewritten before every call (the backward's time includes the
    sum of its blocks' bias partials); beside it the bound (the bytes of
    each tensor read or written once at HBM rate), the plain version's
    device time, and the tree it replaced (the parent's gates and
    associative_scan from the same P, and their autograd backward).
    Returns {"fwd"/"bwd": (ms, plain ms, bound ms, tree ms)}."""
    from music_generator_tpu_torch.ops import linear_scan as ls
    S, R, _, H = glru_shapes(cfg)
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    P = (torch.randn(S, R, 2 * H, device="cuda", generator=gen)
         * 1.5).to(dt)
    bias = torch.randn(2 * H, device="cuda", generator=gen) * 0.3
    dhs = torch.randn(S, R, H, device="cuda", generator=gen).to(dt)
    hs = ls.glru_fwd(P, bias)
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda").bitwise_not_

    def ms_of(fn, n):
        k = profiled_kernels(fn, n, flush)
        return sum(us for us, _ in k.values()) / n / 1e3, k

    def tree_fwd(Pt):
        pre = Pt + bias.to(dt)
        g = torch.sigmoid(pre[..., :H])
        z = torch.tanh(pre[..., H:])
        return ls.associative_scan(1.0 - g, g * z)[1]

    Pg = P.clone().requires_grad_(True)
    tree_hs = tree_fwd(Pg)
    es = P.element_size()
    bounds = {"fwd": (3 * S * R * H * es + 2 * H * 4) / HBM_BYTES_PER_S,
              "bwd": (6 * S * R * H * es + 4 * H * 4) / HBM_BYTES_PER_S}
    cases = {
        "fwd": (lambda: ls.glru_fwd(P, bias),
                lambda: ls.glru_fwd_reference(P, bias),
                lambda: tree_fwd(P)),
        "bwd": (lambda: ls.glru_bwd(P, bias, hs, dhs),
                lambda: ls.glru_bwd_reference(P, bias, hs, dhs),
                lambda: torch.autograd.grad(tree_hs, Pg, dhs,
                                            retain_graph=True)),
    }
    out = {}
    for way, (kern, plain, tree) in cases.items():
        ms, k = ms_of(kern, reps)
        plain_ms, _ = ms_of(plain, 2)
        tree_ms, tk = ms_of(tree, 3)
        bound = bounds[way] * 1e3
        out[way] = (ms, plain_ms, bound, tree_ms)
        log(f"glru_scan {way} (S {S}, R {R}, H {H}, bfloat16, L2 rewritten): "
            f"{ms:.5f} ms a launch on the device ("
            + "; ".join(f"{n[:48]} {us / reps / 1e3:.5f} ms"
                        for n, (us, _) in sorted(k.items()))
            + f"); bound {bound:.5f} ms by bytes, {bound / ms:.3f} of it; "
            f"plain version {plain_ms:.3f} ms; the tree {tree_ms:.4f} ms in "
            f"{sum(c for _, c in tk.values()) / 3:.0f} launches "
            f"({tree_ms / ms:.1f}x) ({card})")
    return out


# Phase 3n: the linear time axis (time_axis_kind="linear") at
# default_config() widths on the r4 weights rebuilt by
# tools/common.py::linear_params(r4, seed=0).  Its training kernels a step
# (the note axis's fused two-layer stack, and csrc/glru_scan.cu once a
# direction for each of the time axis's two layers) and the JAX-CPU samples
# of artifacts/linear_time_r19.
LINEAR_STEP = {"lstm2_fwd": 1, "lstm2_bwd": 1, "glru_scan_fwd": 2,
               "glru_scan_bwd": 2}
LINEAR_SAMPLES = os.path.join(ROOT, "artifacts", "linear_time_r19",
                              "samples")


def sample_margins(lc, state, n_steps: int) -> None:
    """How strong a yardstick the committed samples are: every play and
    replay draw behind each file of artifacts/linear_time_r19, replayed on
    the card (tools/analyze_divergence.py::draw_margins, gen_dtype), and
    how many sat within 1e-2, 1e-3 and 1e-4 of falling the other way.
    Every play draw must fall as the file has it."""
    from music_generator_tpu_torch import midi
    from music_generator_tpu_torch.data.dataset import (clamp_midi,
                                                        compute_genre)
    from music_generator_tpu_torch.generation.sampler import Sampler
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.tools.analyze_divergence import (
        draw_margins)
    model = build_model(lc.replace(compute_dtype=lc.gen_dtype), "cuda",
                        state=state)
    play, replay = [], []
    for i in range(3):
        roll = midi.midi_decode(midi.read_midifile(os.path.join(
            LINEAR_SAMPLES, f"linear_{i}.mid")), lc.midi_max_notes)
        notes = clamp_midi(roll, lc)[:n_steps]
        style = torch.as_tensor(compute_genre(i, lc)[None],
                                dtype=torch.float32, device="cuda")
        p, r = draw_margins(model, Sampler(model), style, notes, seed=0,
                            stream_offset=i)
        if ((p >= 0) != (notes[:, :, 0] > 0)).any():
            fail(f"linear: a play draw of linear_{i}.mid replays the other "
                 f"way")
        play.append(np.abs(p).ravel())
        replay.append(np.abs(r))
    play, replay = np.concatenate(play), np.concatenate(replay)
    log("linear: the committed samples' draws within 1e-2 / 1e-3 / 1e-4 of "
        "flipping: play " + " / ".join(
            str(int((play < m).sum())) for m in (1e-2, 1e-3, 1e-4))
        + f" of {play.size} (closest {play.min():.4g}), replay "
        + " / ".join(str(int((replay < m).sum())) for m in (1e-2, 1e-3,
                                                             1e-4))
        + f" of {replay.size} (closest {replay.min():.4g})")


def linear_time(cfg, card) -> dict:
    """Phase 3n.  (a) phase 3d's dropout-0 step on the linear kind: on
    fresh weights (seed 0), both gate flavors, float32 kernels against
    the float32 plain path (loss 1e-5 relative, gradients F32_GRAD_REL,
    parameters STEP_ATOL) and bfloat16 kernels against the float32 plain
    path held to PARITY_BAR; on linear_params(r4) read without a bar, as
    3d reads r4 (its untrained time axis under a trained note axis is a
    regime where bfloat16 moves the plain path as far as the kernels);
    (b) Trainer.fit for 1 epoch of the 3c corpus (every count set to 0
    just before and read just after): kernels 6 and 7 once a step, kernels
    2-5 and 8-9 never, no plain version; the checkpoint reloads bit for
    bit; (c) Sampler.generate, 2 bars, seed
    0, at G = 3 and 64: kernel 1 once a timestep, and the note events of
    streams 0-2 those of artifacts/linear_time_r19 (bytes reported); a
    linear-kind /generate equal to its solo run; (d) the study tool's
    three routes at B = 16.  Returns the launches of kernels 1, 6, 7 and
    11."""
    from music_generator_tpu_torch.data.dataset import compute_genre, load_all
    from music_generator_tpu_torch.data.synth import random_batch
    from music_generator_tpu_torch.generation.sampler import (Sampler,
                                                              write_file)
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.params import params_from_numpy
    from music_generator_tpu_torch.serving import (DeepJHTTPServer,
                                                   GenerationService,
                                                   make_handler)
    from music_generator_tpu_torch.tools import run_parallel_scan_study
    from music_generator_tpu_torch.tools.common import linear_params
    from music_generator_tpu_torch.training.checkpoint import build_or_load
    from music_generator_tpu_torch.training.trainer import (TrainConfig,
                                                            Trainer)
    started = time.perf_counter()
    lc = cfg.replace(time_axis_kind="linear")
    with np.load(PARAMS) as data:
        state = params_from_numpy(
            linear_params({k: data[k] for k in data.files}, seed=0))

    # (a) the dropout-0 step, held as phase 3d holds it.
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in random_batch(lc, seed=0, rolled_targets=True))
    log("linear: phase 3d's dropout-0 step on the linear kind")
    parity_step(lc, state, batch, "linear_params(r4, seed=0)", hold_r4=True)

    # (b) Trainer.fit, the checkpoint, exact launches.
    styles = [[os.path.join(TRAIN_WORK, d) for d in g] for g in lc.styles]
    ds = load_all(styles, lc.seq_len, lc)
    fc = lc.replace(out_dir=os.path.join(TRAIN_WORK, "out_linear"))
    trainer = Trainer(build_model(fc, "cuda"),
                      TrainConfig(seed=0, tensorboard=False))
    t = time.perf_counter()
    reset_counts()
    hist = trainer.fit(ds, epochs=1)
    train_launches, plain = read_counts()
    fit_s = time.perf_counter() - t
    steps = hist["steps_per_epoch"][0]
    log(f"linear: Trainer.fit {steps} steps, loss {hist['loss']}, "
        f"{fit_s:.1f} s; kernel launches {train_launches}, plain version "
        f"calls {plain}")
    want = {k: LINEAR_STEP.get(k, 0) * steps for k in train_launches}
    if train_launches != want or plain != 0:
        fail(f"linear: launches {train_launches}, expected {want} and no "
             f"plain call")
    nadam_launches = check_nadam_fit("linear", steps, trainer.model)
    if not np.isfinite(hist["loss"]).all():
        fail("linear: non-finite training loss")
    model, loaded = build_or_load(fc, "cuda")
    same = all(torch.equal(v, trainer.model.state_dict()[k])
               for k, v in model.state_dict().items())
    if not loaded or not same:
        fail("linear: the checkpoint did not reload bit for bit")
    log("linear: checkpoint reloaded bit for bit")

    # (c) generation against the committed JAX-CPU samples.
    model = build_model(lc, "cuda", state=state)
    gen_dir = os.path.join(WORK, "linear")
    gen_launches, n_bytes = 0, 0
    for G in (3, 64):
        styles = [compute_genre(i % 3, lc) for i in range(G)]
        _reset_notegen_counts()
        t = time.perf_counter()
        res = Sampler(model).generate(styles, num_bars=2, seed=0)
        gen_s = time.perf_counter() - t
        counts = _notegen_counts()
        n_steps = 2 * lc.notes_per_bar
        log(f"linear: generate G={G}, {n_steps} timesteps in {gen_s:.2f} "
            f"s; notegen launches {counts[0]} ({counts[1]} streamed), "
            f"comparison launches {counts[2]}, plain calls {counts[3]}")
        if counts != (n_steps, 0, 0, 0) or not np.isfinite(res.notes).all():
            fail(f"linear: generate G={G}: counts {counts}, expected "
                 f"{(n_steps, 0, 0, 0)}")
        gen_launches += counts[0]
        res.notes, res.styles = res.notes[:3], res.styles[:3]
        out = write_file(f"linear_G{G}", res, lc.replace(out_dir=gen_dir))
        for i, p in enumerate(out):
            ref = os.path.join(LINEAR_SAMPLES, f"linear_{i}.mid")
            same_bytes = check_sample(p, ref)
            n_bytes += same_bytes
            if not same_bytes:
                log("divergence: " + json.dumps(_divergence(p, ref)))
    log(f"linear: {n_bytes}/6 files byte-identical to "
        f"artifacts/linear_time_r19, 6/6 event-identical")
    sample_margins(lc, state, 2 * lc.notes_per_bar)
    service = GenerationService(config=lc, params=state, warmup=False)
    solo = service._encode_midi(Sampler(service.model).generate(
        [compute_genre(2, lc)], num_bars=2, seed=7,
        stream_indices=[0]).notes[0])
    httpd = DeepJHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, _, body = _post(f"http://127.0.0.1:{httpd.server_port}",
                                {"genre": 2, "bars": 2, "seed": 7})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    log(f"linear: /generate answered {status}, {len(body)} bytes, equal "
        f"to its solo run {body == solo}")
    if status != 200 or body != solo:
        fail("linear: the served response differs from its solo run")

    # (d) the study tool's routes at B = 16.
    study = run_parallel_scan_study.study(batches=(16,), steps=30,
                                          device="cuda", base=cfg, log=log)
    for route, r in study["B16"].items():
        if not np.isfinite(r["loss"]):
            fail(f"linear study: {route} non-finite loss")
    log(f"linear study ({card}): " + json.dumps(
        {route: {k: v for k, v in r.items()
                 if k != "device_ms_top_kernels"}
         for route, r in study["B16"].items()}))
    log("linear study, device ms a step by kernel, linear route: "
        + "; ".join(f"{k[:60]} {v:.4f}" for k, v in
                    study["B16"]["linear"]["device_ms_top_kernels"].items()))
    log(f"phase 3n: {time.perf_counter() - started:.1f} s")
    return {"notegen": gen_launches,
            "lstm2_fwd": train_launches["lstm2_fwd"],
            "lstm2_bwd": train_launches["lstm2_bwd"],
            "glru_scan_fwd": train_launches["glru_scan_fwd"],
            "glru_scan_bwd": train_launches["glru_scan_bwd"],
            "nadam": nadam_launches}


def _flip_first_note(path: str, out: str) -> tuple:
    """Write to `out` the roll of `path` with its first played cell turned
    off; return (t, midi pitch)."""
    from music_generator_tpu_torch.midi import (midi_decode, midi_encode,
                                                read_midifile,
                                                write_midifile)
    roll = midi_decode(read_midifile(path))
    t, p = np.argwhere(roll[:, :, 0] > 0)[0]
    roll[t, p] = 0.0
    write_midifile(out, midi_encode(roll))
    return int(t), int(p)


def host_tools(card, short_paths) -> None:
    """Phase 3o.  (a) the native MIDI decoder built on this machine
    (midi/native.py) decoding every committed .mid under artifacts/ bit
    for bit like the Python codec, ms a file for both; (b) `python -m
    music_generator_tpu_torch.midi` round-tripping a phase-3 file, its
    bytes those of the codec called in this process; (c) analyze_divergence
    on the card, a phase-3 file against a copy with its first played cell
    off: the report names that cell and the draw (u < p, as the file
    played it)."""
    import glob

    from music_generator_tpu_torch.midi import (midi_decode, midi_encode,
                                                native, read_midifile,
                                                write_midifile)
    from music_generator_tpu_torch.tools import analyze_divergence
    started = time.perf_counter()
    if not native.available():
        fail(f"native decoder: {native.why_unavailable()}")
    log(f"native decoder: {native.library_path()} loaded (built on this "
        f"machine at its first use, the corpus loads of phase 3c)")
    files = sorted(glob.glob(os.path.join(ROOT, "artifacts", "**", "*.mid"),
                             recursive=True))
    nat_s = py_s = 0.0
    for f in files:
        t = time.perf_counter()
        nat = native.native_decode_file(f)
        nat_s += time.perf_counter() - t
        t = time.perf_counter()
        py = midi_decode(read_midifile(f), 128)
        py_s += time.perf_counter() - t
        if nat.shape != py.shape or not np.array_equal(nat, py):
            fail(f"native decoder: {f} decodes otherwise than the Python "
                 f"codec")
    log(f"native decoder: {len(files)} committed .mid files bit-identical "
        f"to the Python codec; {nat_s * 1e3 / len(files):.4f} ms a file "
        f"native, {py_s * 1e3 / len(files):.4f} ms in Python (warm page "
        f"cache; {card})")

    src = os.path.join(WORK, short_paths[0][0])
    out = os.path.join(WORK, "codec_cli.mid")
    proc = subprocess.run(
        [sys.executable, "-m", "music_generator_tpu_torch.midi", src, out],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    buf = io.BytesIO()
    write_midifile(buf, midi_encode(midi_decode(read_midifile(src))))
    log(f"codec CLI: exit {proc.returncode}: "
        f"{' | '.join(proc.stdout.splitlines())}")
    if (proc.returncode != 0 or not os.path.isfile(out)
            or open(out, "rb").read() != buf.getvalue()):
        fail(f"codec CLI: {proc.stderr}")

    flipped = os.path.join(WORK, "flipped.mid")
    t0, pitch = _flip_first_note(src, flipped)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        analyze_divergence.main([src, flipped, "--params", PARAMS,
                                 "--seed", "0", "--style", "genre:0",
                                 "--stream-offset", "0"])
    lines = text.getvalue().splitlines()
    log("analyze_divergence: " + " | ".join(lines))
    m = re.search(r"prob=([0-9.]+) uniform=([0-9.]+)", lines[-1])
    if (len(lines) != 3 or not lines[0].startswith(
            f"first divergence: t={t0}, midi pitch={pitch}, channel=play")
            or m is None or not float(m.group(2)) < float(m.group(1))):
        fail(f"analyze_divergence did not report the flipped cell (t={t0}, "
             f"pitch {pitch})")
    log(f"phase 3o: {time.perf_counter() - started:.1f} s")


def first_draw_gap(model, sampler, style, notes, g: int, t: int,
                   n: int, k: int, flavor: str) -> float:
    """|u - p| of draw (t, n, channel k) of stream g behind the roll
    `notes` [T, N, 3] (seed 0): the time axis teacher-forced through the
    roll's steps 0..t-1 as the Sampler runs a prime, then step t's
    tempered probabilities along the roll in the flavor's arithmetic
    (notegen.tempered_probs)."""
    from music_generator_tpu_torch.ops import notegen
    dev = model.device
    style_emb = model.style_embedding(torch.as_tensor(style[None],
                                                      device=dev))
    state = sampler._init_state(1, 0, sampler.default_temp, g)
    state = sampler._advance_through_prime(style_emb, state,
                                           notes[None, :t])
    feats, _ = model.time_axis_step(state.prev_note,
                                    sampler._beat_row(t, 1), style_emb,
                                    state.time_state)
    us = sampler._chunk_uniforms(state.stream_keys, t, 1)[0]
    probs = notegen.tempered_probs(
        feats, torch.as_tensor(notes[t][None], device=dev),
        state.temperature, model.note_axis, model.note_dense,
        model.volume_dense, style_emb, model.cfg.lstm_recurrent_activation,
        torch.bfloat16, flavor)
    return abs(float(us[0, n, k] - probs[0, n, k]))


def bf16_generation(cfg) -> dict:
    """Phase 3p: generate_main at gen_dtype="bfloat16" for each flavor
    (every count set to 0 just before and read just after): the r4
    weights, 3 genres, 8 bars, seed 0.  Every timestep must launch that
    flavor's bfloat16 instance once.  The notes are held to the same
    generate_main run on the CPU (the plain version): up to each stream's
    first differing draw the volumes agree within BF16_VOLUME_ATOL, and
    that draw's |u - p|, replayed on the CPU in the flavor's arithmetic
    (`first_draw_gap`), lies below BF16_EDGE.  The files' byte and event
    matches against phase 3's float32 samples (artifacts/short_samples_r4)
    are printed, the control, with no threshold.  Returns {flavor:
    launches}."""
    from music_generator_tpu_torch import cli
    from music_generator_tpu_torch.generation.sampler import Sampler
    from music_generator_tpu_torch.midi import midi_decode, read_midifile
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.ops import notegen
    from music_generator_tpu_torch.params import load_params_npz
    steps = 8 * cfg.notes_per_bar
    launches = {}
    real, real_write = cli.default_config, cli.write_file
    results = []

    def capture(name, result, c):
        results.append(result)
        return real_write(name, result, c)
    cli.write_file = capture
    cwd = os.getcwd()
    os.chdir(WORK)
    try:
        for flavor, over in (("scan", {}), ("fused", dict(
                fused_gen_kernel=True, lstm_kernel="pallas"))):
            bcfg = real().replace(gen_dtype="bfloat16", **over)
            cli.default_config = lambda: bcfg
            argv = ["--params", PARAMS, "--bars", "8", "--seed", "0"]
            results.clear()
            _reset_notegen_counts()
            paths = cli.generate_main(argv + ["--out", f"bf16_{flavor}"])
            counts = (notegen.note_sample.launches,
                      dict(notegen.note_sample.bf16_launches),
                      notegen.note_sample.streamed_launches,
                      notegen.note_sample_streamed.launches,
                      notegen.note_sample_reference.calls)
            log(f"bf16 generate ({flavor}): notegen launches {counts[0]} "
                f"for {steps} timesteps, bfloat16 instances {counts[1]}, "
                f"streamed {counts[2]} + {counts[3]}, plain version calls "
                f"{counts[4]}")
            if (counts[0] != steps or counts[1][flavor] != steps
                    or sum(counts[1].values()) != steps or counts[2]
                    or counts[3] or counts[4]):
                fail(f"bf16 generate ({flavor}): not every timestep ran "
                     f"the {flavor} bfloat16 cluster kernel")
            got = results[0]
            t0 = time.perf_counter()
            cli.generate_main(argv + ["--out", f"bf16_{flavor}_cpu",
                                      "--device", "cpu"])
            want = results[1]
            cpu_s = time.perf_counter() - t0
            model = build_model(bcfg, "cpu",
                                state=load_params_npz(PARAMS))
            sampler = Sampler(model)
            N, verdicts = bcfg.num_notes, []
            for g in range(got.notes.shape[0]):
                w = want.notes[g].reshape(-1, 3)
                o = got.notes[g].reshape(-1, 3)
                diff = np.nonzero((w[:, :2] != o[:, :2]).any(-1))[0]
                stop = int(diff[0]) if len(diff) else len(w)
                dv = float(np.abs(w[:stop, 2] - o[:stop, 2]).max(
                    initial=0.0))
                if dv > BF16_VOLUME_ATOL:
                    fail(f"bf16 generate ({flavor}) stream {g}: volumes "
                         f"{dv:.3g} from the CPU run before any draw "
                         f"differs")
                if stop == len(w):
                    verdicts.append(f"stream {g}: all {len(w)} draws equal, "
                                    f"max|dv| {dv:.3g}")
                    continue
                t, n = divmod(stop, N)
                k = 0 if w[stop, 0] != o[stop, 0] else 1
                with torch.no_grad():
                    gap = first_draw_gap(model, sampler, want.styles[g],
                                         want.notes[g], g, t, n, k, flavor)
                verdicts.append(f"stream {g}: first differing draw t={t} "
                                f"pitch {n} channel {k} |u-p| {gap:.3g}, "
                                f"max|dv| before it {dv:.3g}")
                if not gap < BF16_EDGE:
                    fail(f"bf16 generate ({flavor}) stream {g}: draw t={t} "
                         f"pitch {n} channel {k} differs from the CPU run "
                         f"with |u - p| = {gap:.3g}")
            log(f"bf16 generate ({flavor}) against the CPU run ({cpu_s:.1f} "
                f"s there): " + "; ".join(verdicts))
            same_bytes = same_events = 0
            for i, p in enumerate(paths):
                ref = os.path.join(SHORT, f"short_s0_{i}.mid")
                got = midi_decode(read_midifile(p))
                want = midi_decode(read_midifile(ref))
                same_bytes += open(p, "rb").read() == open(ref, "rb").read()
                same_events += (got.shape == want.shape and bool(
                    (got[..., :2] == want[..., :2]).all()))
                if not np.isfinite(got).all() or not got[..., 0].any():
                    fail(f"bf16 generate ({flavor}): {p} holds no notes")
            log(f"bf16 generate ({flavor}) against the float32 samples "
                f"(the control, no threshold): {same_bytes}/{len(paths)} "
                f"byte-identical, {same_events}/{len(paths)} "
                f"event-identical")
            launches[flavor] = counts[1][flavor]
    finally:
        cli.default_config = real
        cli.write_file = real_write
        os.chdir(cwd)
    return launches


def convergence(card) -> None:
    """Phase 3q: tools/run_convergence.py at default_config() on a small
    corpus: it must stop training within --epochs 3 (--patience 1), write
    and reload the best checkpoint, generate and write one sample a
    style, and write report.json with the card's line."""
    from music_generator_tpu_torch.tools import run_convergence
    run_dir = os.path.join(WORK, "convergence")
    shutil.rmtree(run_dir, ignore_errors=True)
    t = time.perf_counter()
    report = run_convergence.main([
        "--run-dir", run_dir, "--styles", "0", "1", "--files-per-style",
        "1", "--bars", "16", "--epochs", "3", "--patience", "1",
        "--sample-bars", "2"])
    secs = time.perf_counter() - t
    losses = report["loss_curve"]
    samples = [os.path.join(run_dir, r["sample"]) for r in report["fidelity"]]
    log(f"run_convergence: {report['windows']} windows, "
        f"{report['epochs_run']} epochs, loss {losses[0]:.4f} -> "
        f"{report['best_loss']:.4f}, {len(samples)} samples, own overlap "
        f"{[round(r['own_overlap'], 3) for r in report['fidelity']]}, "
        f"{secs:.1f} s ({card})")
    if not (1 <= report["epochs_run"] <= 3 and len(losses)
            == report["epochs_run"] and np.isfinite(losses).all()):
        fail(f"run_convergence: {report['epochs_run']} epochs, {losses}")
    if not os.path.isfile(os.path.join(run_dir, "out", "model.pt")):
        fail("run_convergence wrote no checkpoint")
    if (len(samples) != 2 or not all(map(os.path.isfile, samples))
            or report["card"] != card
            or not os.path.isfile(os.path.join(run_dir, "report.json"))):
        fail("run_convergence did not write its samples and report")


def augment_study(card) -> dict:
    """Phase 3r.  (a) tools/run_augment_study.py at default_config() on a
    small corpus (2 styles, 1 file of 16 bars each, --epochs 3 --patience
    1 --augment 1): three times the baseline's windows in the augmented
    run, 1-3 epochs a run with finite losses, a checkpoint in each run's
    out/, twelve finite entries in the eval matrix and the card's line in
    the report; every count set to 0 just before each fit and read just
    after it: each step one launch of each biaxial kernel (kernels 2-5),
    no other training kernel and no plain version, and no plain version in
    the evaluations either.  (b) tools/render_audio.py on the host:
    artifacts/short_samples_r2/short_s0_{0,1,2}.mid rendered into WORK,
    each the committed .wav's bytes, ms a file.  Returns the biaxial
    kernels' launches summed over the two fits."""
    from music_generator_tpu_torch.tools import render_audio, run_augment_study
    from music_generator_tpu_torch.training import trainer as trainer_mod
    started = time.perf_counter()
    run_dir = os.path.join(WORK, "augment")
    shutil.rmtree(run_dir, ignore_errors=True)
    real_fit = trainer_mod.Trainer.fit
    fits = []                       # (steps, launches, plain calls) a fit

    def counted_fit(self, ds, epochs=None):
        reset_counts()
        hist = real_fit(self, ds, epochs)
        launches, plain = read_counts()
        fits.append((sum(hist["steps_per_epoch"]), launches, plain))
        reset_counts()
        return hist
    trainer_mod.Trainer.fit = counted_fit
    try:
        report = run_augment_study.main([
            "--run-dir", run_dir, "--styles", "0", "1", "--files-per-style",
            "1", "--bars", "16", "--epochs", "3", "--patience", "1",
            "--augment", "1"])
    finally:
        trainer_mod.Trainer.fit = real_fit
    _, eval_plain = read_counts()   # the evaluations after the last fit
    secs = time.perf_counter() - started
    runs = report["runs"]
    matrix = [v for rows in report["eval_loss"].values()
              for row in rows.values() for v in row.values()]
    log(f"augment study: windows {runs['baseline']['windows']} / "
        f"{runs['augmented']['windows']}, epochs "
        f"{runs['baseline']['epochs_run']} / {runs['augmented']['epochs_run']}"
        f", best loss {runs['baseline']['best_loss']:.4f} / "
        f"{runs['augmented']['best_loss']:.4f}; eval matrix "
        f"{json.dumps(report['eval_loss'])}; {secs:.1f} s ({card})")
    log(f"augment study: fits (steps, kernel launches, plain calls) {fits}; "
        f"plain calls in the evaluations {eval_plain}")
    if runs["augmented"]["windows"] != 3 * runs["baseline"]["windows"]:
        fail("augment study: the augmented run does not hold three times "
             "the baseline's windows")
    for name, run in runs.items():
        if not (1 <= run["epochs_run"] <= 3
                and len(run["loss_curve"]) == run["epochs_run"]
                and np.isfinite(run["loss_curve"]).all()):
            fail(f"augment study: {name} ran {run['epochs_run']} epochs, "
                 f"losses {run['loss_curve']}")
        if not os.path.isfile(os.path.join(run_dir, name, "out",
                                           "model.pt")):
            fail(f"augment study: {name} wrote no checkpoint")
    if len(matrix) != 12 or not np.isfinite(matrix).all():
        fail(f"augment study: eval matrix {report['eval_loss']}")
    if report["card"] != card or not os.path.isfile(
            os.path.join(run_dir, "report.json")):
        fail("augment study: report.json not written with the card's line")
    if len(fits) != 2 or eval_plain != 0 or any(
            plain != 0 or any(v != (steps if k.startswith("biax") else 0)
                              for k, v in launches.items())
            for steps, launches, plain in fits):
        fail("augment study: the fits did not run every step through each "
             "biaxial kernel, and only through them, or a plain version "
             "ran on the card")
    study_launches = {k: sum(f[1][k] for f in fits) for k in fits[0][1]}

    out = os.path.join(WORK, "render")
    os.makedirs(out, exist_ok=True)
    for i in range(3):
        mid = os.path.join(ROOT, "artifacts", "short_samples_r2",
                           f"short_s0_{i}.mid")
        wav = os.path.join(out, f"short_s0_{i}.wav")
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            render_audio.render_file(mid, wav)
        ms = (time.perf_counter() - t) * 1e3
        same = (open(wav, "rb").read()
                == open(os.path.splitext(mid)[0] + ".wav", "rb").read())
        log(f"render_audio: short_s0_{i}: {ms:.1f} ms, "
            f"{'byte-identical to' if same else 'differs from'} the "
            f"committed .wav (host numpy {np.__version__}; {card})")
        if not same:
            fail(f"render_audio: short_s0_{i}.wav differs from the "
                 f"committed file")
    log(f"phase 3r: {time.perf_counter() - started:.1f} s")
    return study_launches


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
             "lstm2_masks", "nadam", "glru_scan"]
    libs = _build.build(names)
    log(f"build: {', '.join(names)} in {time.perf_counter() - t:.1f} s")
    for lib in libs:
        log(open(str(lib) + ".log").read().strip())

    # -- 2. kernel against its plain version --------------------------------
    full_f32()
    cfg = default_config()
    model = build_model(cfg, "cuda", state=load_params_npz(PARAMS))
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
                    args = (feats, us, temp, model.note_axis, *heads, emb,
                            act, grid)
                    got = notegen.note_sample(*args)
                    streamed = notegen.note_sample_streamed(*args)
                    torch.cuda.synchronize()
                    if not torch.equal(got, streamed):
                        fail(f"notegen G={G} T={T} {act} quantize="
                             f"{grid is not None}: the cluster kernel "
                             f"differs from the streamed kernel")
                    want = notegen.note_sample_reference(*args)
                    probs = notegen.tempered_probs(
                        feats, got, temp, model.note_axis, *heads, emb, act)
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
    bf16_checks = check_notegen_bf16(cfg, card)
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
    nadam_err = check_nadam(cfg)
    glru_err = check_glru(cfg)

    # -- 3. main path --------------------------------------------------------
    os.makedirs(WORK, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(WORK)
    _reset_notegen_counts()
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
    streamed_launches = (notegen.note_sample_streamed.launches
                         + notegen.note_sample.streamed_launches)
    steps = 2 * 8 * cfg.notes_per_bar
    log(f"main path: notegen launches {launches} for {steps} timesteps, "
        f"streamed kernel launches {streamed_launches}, plain version calls "
        f"{plain_calls}")
    if (launches != steps or plain_calls != 0 or streamed_launches != 0
            or sum(notegen.note_sample.bf16_launches.values())):
        fail("the main path did not run every timestep through the cluster "
             "kernel's float32 instance")
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
    # The validators and primed generation run the LSTM time axis; kernel
    # 12 is the linear kind's (phases 2 and 3n).
    idle = [k for k, v in slice_launches.items()
            if v == 0 and not k.startswith("glru_scan")]
    if idle:
        fail(f"kernels not launched on the validators' and primed "
             f"generation's path: {idle}")
    if notegen.note_sample_streamed.launches:
        fail("the streamed pitch-loop kernel ran on the validators' and "
             "primed generation's path")

    # -- 3i. the HTTP service on the card -------------------------------------
    serving(cfg, card)

    # -- 3j. this slice's path: Keras 2 weights, visualize, analyze ----------
    keras_slice(cfg, card, paths)

    # -- 3k. this slice's path: the trainer's staging modes, --profile -------
    trainer_modes(cfg, card)

    # -- 3l. this slice's path: generation at note depths 1-8 ----------------
    depth_times, depth_launches, depth_err = note_depths(cfg, card)

    # -- 3m. this slice's path: two ranks, gloo on one card ----------------
    mp_readings = multi_rank(cfg, card)

    # -- 3n. this slice's path: the linear time axis -------------------------
    linear_launches = linear_time(cfg, card)

    # -- 3o. this slice's path: the native decoder, codec CLI, divergence ----
    host_tools(card, paths)

    # -- 3p. this slice's path: generation at gen_dtype="bfloat16" -----------
    bf16_launches = bf16_generation(cfg)

    # -- 3q. this slice's path: tools/run_convergence.py ----------------------
    convergence(card)

    # -- 3r. this slice's path: the augmentation study, the .wav renderer ----
    study_launches = augment_study(card)

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
    gen_launches = {**depth_launches, 2: launches}
    kernels = [{
        "name": "notegen",
        "route": "cuda",
        "source": "music_generator_tpu_torch/csrc/notegen.cu",
        "replaces": "music_generator_tpu/ops/pallas_notegen.py:35",
        "launches": launches,
        "max_abs_err": max(max_err, depth_err),
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        # The note depths it ran (phase 3 at depth 2; phase 3l at 1-8):
        # the plan's kernel, ms a launch and bound at G = 3 and 64, and,
        # where a generate run was counted (phase 3 at depth 2, phase 3l
        # at depths 1, 3 and 6), its launches.
        "depths": {str(L): {
            "kernel": t[3][0], "ms": {G: t[G][1] for G in t},
            "bound_ms": {G: t[G][2] for G in t},
            **({"generate_launches": gen_launches[L]}
               if L in gen_launches else {})}
            for L, t in depth_times.items()},
        # Phase 3n's generate runs with the linear time axis.
        "linear_time": {"launches": linear_launches["notegen"]},
    }]
    # Kernel 1's bfloat16 instances: phase 3p's launches, phase 2b's
    # largest volume gap, ms at depth 2 and G = 3 (G = 64 beside it), each
    # with the float32 instance's ms on the same inputs in the same loop.
    for flavor in ("scan", "fused"):
        err, t = bf16_checks[flavor]
        ms, plain, bound, bound_by, ms32, _ = t[3]
        kernels.append({
            "name": f"notegen_bf16_{flavor}", "route": "cuda",
            "source": "music_generator_tpu_torch/csrc/notegen.cu",
            "replaces": "music_generator_tpu/ops/pallas_notegen.py:35",
            "launches": bf16_launches[flavor], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None, "float32_ms": ms32,
            "G64": {"ms": t[64][0], "plain_ms": t[64][1],
                    "bound_ms": t[64][2], "bound_by": t[64][3],
                    "float32_ms": t[64][4]},
        })
    for name, replaces, source in BIAX_KERNELS:
        ms, plain = biax_times[name]
        bound, bound_by = biax_bound_ms(name, cfg, cfg.seq_len, True)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": biax_errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            # Phase 3r's two fits of the augmentation study.
            "augment_study": {"launches": study_launches[name]},
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
        if name in linear_launches:
            # Phase 3n's Trainer.fit: the linear kind's note axis.
            kernels[-1]["linear_time"] = {"launches": linear_launches[name]}
    mask_times = time_masks(card)
    ms, plain, bound, bound_by = mask_times[("time", "float32")]
    name, replaces, source = MASK_KERNEL
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": slice_launches[name],
        "max_abs_err": mask_err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
    })
    # Kernel 11 on the deepj cell's leaves; phase 3n's launches and the
    # times on the linear kind's leaves under "linear_time".
    nadam_times = time_nadam(cfg, card)
    name, replaces, source = NADAM_KERNEL
    ms, plain, bound = nadam_times["lstm"]
    lin_ms, lin_plain, lin_bound = nadam_times["linear"]
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": train_launches[name],
        "max_abs_err": nadam_err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
        "linear_time": {"launches": linear_launches[name], "ms": lin_ms,
                        "plain_ms": lin_plain, "bound_ms": lin_bound},
    })
    # Kernel 12 at the linear cell's shapes; phase 3n's launches.
    glru_times = time_glru(cfg, card)
    name, replaces, source = GLRU_KERNEL
    for way in ("fwd", "bwd"):
        ms, plain, bound, tree = glru_times[way]
        kernels.append({
            "name": f"{name}_{way}", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": linear_launches[f"{name}_{way}"],
            "max_abs_err": glru_err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "tree_ms": tree,
        })
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    log(json.dumps({"multi_rank": mp_readings}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
