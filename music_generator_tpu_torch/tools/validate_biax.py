"""On-card validation of the biaxial training kernels (ops/biax.py, kernels
of csrc/biax_time.cu and csrc/biax_note.cu), the production training path,
against the plain stacks; after the JAX package's
tools/tpu_validate_biax.py.

    python -m music_generator_tpu_torch.tools.validate_biax \
        [--gates sigmoid|hard_sigmoid] [--device cpu]

At default_config() widths, batch 16, dropout 0, fresh weights from seed 0
and `random_batch(seed=0, rolled_targets=True)`, one training step (loss,
every gradient, one Nadam update, the loss after it) runs on each variant:
  fused-bf16  the kernels in bfloat16 (the main path);
  plain-bf16  the plain stacks in bfloat16 (the JAX tool's xla-bf16);
  plain-f32   the plain stacks in float32 (the ground truth);
  fused-f32   the kernels in float32.
It prints the JAX tool's lines (each loss, the relative differences, the
worst-leaf gradient cosine and relative error, the two step losses of each
bfloat16 path and the post-update gap) beside the TPU's readings in
artifacts/kernel_validation_r5/, and holds them to the JAX tool's bars and
to PARITY_BAR (`step_bars`); `step_readings` is chip_smoke.py's step of
phases 3d and 3f.  A miss raises CheckFailed.  With --device cpu every
wrapper runs its plain version, so the fused variants are the plain ones.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, List, Optional, Tuple

import torch

from music_generator_tpu_torch.cli import _device_flag
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.data.synth import random_batch
from music_generator_tpu_torch.device import full_f32, resolve_device
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops.nadam import Nadam
from music_generator_tpu_torch.tools.common import (F32_GRAD_REL, leaf_stats,
                                                    require, synchronize)

# One dropout-0 training step on random_batch(seed=0, rolled_targets=True).
# float32 kernels against the float32 plain path: loss within 1e-5
# relative, gradients within F32_GRAD_REL, parameters after one Nadam step
# within STEP_ATOL (the first Keras-2 Nadam step moves a weight by about
# the learning rate, 2e-3, whatever its gradient's size, so only a gradient
# element near zero whose sign differs could exceed it).  bfloat16 kernels
# against the float32 plain path: PARITY_BAR (loss relative difference,
# worst-leaf gradient cosine, post-update loss gap against a bfloat16 plain
# step), beside the TPU's readings (artifacts/kernel_validation_r5).
STEP_ATOL = 1e-4
PARITY_BAR = (5e-4, 0.999, 5e-4)
# The JAX tool's own bars (tools/tpu_validate_biax.py:81,85,116-117,
# 137-139): loss against float32, loss against the bfloat16 plain path,
# worst-leaf cosine and relative error against the bfloat16 plain path,
# post-update loss gap.
JAX_BARS = {"loss_vs_f32": 5e-2, "loss_vs_plain16": 2e-2, "cos": 0.98,
            "rel": 0.15, "gap": 5e-2}

R5_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "kernel_validation_r5")
R5_FILES = {"sigmoid": "biax_tpu_validation_sigmoid.txt",
            "hard_sigmoid": "biax_tpu_validation_hard_gates.txt"}


def tpu_r5(gates: str) -> List[str]:
    """The lines of the JAX tool's r5 log on the TPU for one gate flavor."""
    with open(os.path.join(R5_DIR, R5_FILES[gates])) as f:
        return [line.strip() for line in f]


def r5_value(lines: List[str], label: str) -> Optional[str]:
    """What the TPU's log printed after `label` (its first such line)."""
    for line in lines:
        if line.startswith(label):
            return line[len(label):]
    return None


def tpu_r5_parity(gates: str) -> Tuple[float, float, float]:
    """(loss rel diff to float32, worst-leaf cosine, post-update gap) of
    the TPU's fused bfloat16 kernels, the readings PARITY_BAR compares."""
    r = tpu_r5(gates)
    return (float(r5_value(r, "fused-bf16 vs xla-f32 loss rel-diff: ")),
            float(r5_value(r, "grad cosine similarity (worst leaf): ")
                  .split()[0]),
            float(r5_value(r, "post-update loss abs-diff: ")))


def _plain_lstm2(x0, s1m, w0, b0, b1, u0, w1, u1, **kw):
    """lstm2_stack's plain version from zero initial states, as DeepJ
    calls the stack."""
    from music_generator_tpu_torch.ops import lstm2
    z = torch.zeros(x0.shape[1], u0.shape[0], device=x0.device)
    return lstm2.lstm2_stack_reference(x0, s1m, w0, b0, b1, u0, w1, u1, z, z,
                                       z, z, **kw)


def _plain_glru(p, xs, compute_dtype=torch.float32):
    """glru_scan's plain version where it launches kernels (CUDA tensors);
    elsewhere glru_scan itself, which is plain there."""
    from music_generator_tpu_torch.ops import linear_scan
    if xs.is_cuda:
        return linear_scan.glru_scan_fused_reference(p, xs, compute_dtype)
    return linear_scan.glru_scan(p, xs, compute_dtype)


@contextlib.contextmanager
def plain_stacks():
    """Run DeepJ.forward through the plain versions of every training
    kernel, even on the card."""
    from music_generator_tpu_torch.models import deepj
    from music_generator_tpu_torch.ops import biax, recurrence
    saved = (deepj.biax_time_stack, deepj.biax_note_stack, deepj.lstm2_stack,
             recurrence.lstm_recurrence, deepj.glru_scan)
    deepj.biax_time_stack = biax.biax_time_stack_reference
    deepj.biax_note_stack = biax.biax_note_stack_reference
    deepj.lstm2_stack = _plain_lstm2
    recurrence.lstm_recurrence = recurrence.lstm_recurrence_reference
    deepj.glru_scan = _plain_glru
    try:
        yield
    finally:
        (deepj.biax_time_stack, deepj.biax_note_stack, deepj.lstm2_stack,
         recurrence.lstm_recurrence, deepj.glru_scan) = saved


def one_step(cfg, state, batch, plain: bool):
    """One dropout-0 train step from `state` on the batch's device: (loss,
    gradients by name, parameters after one Nadam step, the loss after
    it)."""
    dev = batch[0].device
    model = build_model(cfg, dev, state=state, trainable=True)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    with plain_stacks() if plain else contextlib.nullcontext():
        loss, _ = model.loss(batch, generator=None, train=True)
        grads = torch.autograd.grad(loss, params)
        opt = Nadam(params, cfg.learning_rate, cfg.beta1, cfg.beta2, cfg.eps,
                    cfg.schedule_decay)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        with torch.no_grad():
            after = model.loss(batch, generator=None, train=False)[0]
    synchronize(dev)
    return (float(loss.detach()), dict(zip(names, grads)),
            {n: p.detach().clone() for n, p in zip(names, params)},
            float(after))


def steps(cfg, state, batch, act) -> Dict[str, tuple]:
    """one_step of each variant, {variant: one_step's tuple}."""
    base = cfg.replace(dropout=0.0, input_dropout=0.0,
                       lstm_recurrent_activation=act)
    c32 = base.replace(compute_dtype="float32")
    c16 = base.replace(compute_dtype="bfloat16")
    return {"fused-f32": one_step(c32, state, batch, plain=False),
            "plain-f32": one_step(c32, state, batch, plain=True),
            "fused-bf16": one_step(c16, state, batch, plain=False),
            "plain-bf16": one_step(c16, state, batch, plain=True)}


def step_readings(cfg, state, batch, act, runs=None, log=print):
    """The float32 and bfloat16 steps of one gate flavor, kernels and plain
    stacks: (float32 loss rel diff, gradient worst rel, parameter max|d|,
    bfloat16 loss rel diff to the float32 plain path, worst-leaf cosine,
    post-update loss gap, and the bfloat16 plain path's own loss rel diff
    and worst-leaf cosine against the float32 plain path), logged.  `runs`
    reuses steps()' result."""
    runs = runs or steps(cfg, state, batch, act)
    k32, p32 = runs["fused-f32"], runs["plain-f32"]
    k16, p16 = runs["fused-bf16"], runs["plain-bf16"]
    names = list(p32[1])
    d_loss = abs(k32[0] - p32[0]) / abs(p32[0])
    _, g_rel, _ = leaf_stats([k32[1][n] for n in names],
                             [p32[1][n] for n in names])
    p_err, _, _ = leaf_stats([k32[2][n] for n in names],
                             [p32[2][n] for n in names])
    b_loss = abs(k16[0] - p32[0]) / abs(p32[0])
    _, _, b_cos = leaf_stats([k16[1][n] for n in names],
                             [p32[1][n] for n in names])
    gap = abs(k16[3] - p16[3])
    pb_loss = abs(p16[0] - p32[0]) / abs(p32[0])
    _, _, pb_cos = leaf_stats([p16[1][n] for n in names],
                              [p32[1][n] for n in names])
    tpu = tpu_r5_parity(act)
    log(f"  {act} float32, kernels vs plain: loss {k32[0]:.7f} vs "
        f"{p32[0]:.7f} (rel {d_loss:.3g}), gradients worst rel {g_rel:.3g}, "
        f"parameters after one Nadam step max|d| {p_err:.3g}")
    log(f"  {act} bfloat16 kernels vs float32 plain: loss rel diff "
        f"{b_loss:.4g} (TPU r5 {tpu[0]:.4g}), worst-leaf gradient cosine "
        f"{b_cos:.6f} (TPU r5 {tpu[1]:.5f}); post-update loss {k16[3]:.6f} "
        f"vs bfloat16 plain {p16[3]:.6f}, gap {gap:.3g} (TPU r5 "
        f"{tpu[2]:.3g})")
    log(f"  {act} bfloat16 plain vs float32 plain: loss rel diff "
        f"{pb_loss:.4g}, worst-leaf gradient cosine {pb_cos:.6f}")
    return d_loss, g_rel, p_err, b_loss, b_cos, gap, pb_loss, pb_cos


def step_bars(readings, what: str, log=print) -> None:
    """Hold step_readings' float32 readings to (1e-5, F32_GRAD_REL,
    STEP_ATOL) and its bfloat16 readings to PARITY_BAR, unless the
    bfloat16 plain path misses PARITY_BAR too (bfloat16 itself moves the
    loss that far): then both readings are printed and the kernels are
    held to the bfloat16 plain step (post-update loss gap <=
    PARITY_BAR[2])."""
    d_loss, g_rel, p_err, b_loss, b_cos, gap, pb_loss, pb_cos = readings
    require(d_loss <= 1e-5 and g_rel <= F32_GRAD_REL and p_err <= STEP_ATOL,
            f"{what}, float32 step: kernels and plain versions disagree")
    if (b_loss <= PARITY_BAR[0] and b_cos >= PARITY_BAR[1]
            and gap <= PARITY_BAR[2]):
        log(f"  {what}: bfloat16 step meets the bar {PARITY_BAR}")
        return
    plain_misses = pb_loss > PARITY_BAR[0] or pb_cos < PARITY_BAR[1]
    log(f"  {what}: the bfloat16 kernels miss the bar; the bfloat16 plain "
        f"path {'misses' if plain_misses else 'meets'} it")
    require(plain_misses and gap <= PARITY_BAR[2],
            f"{what}, bfloat16 step misses the bar")
    log(f"  {what}: held to the bfloat16 plain step instead: post-update "
        f"gap {gap:.3g} <= {PARITY_BAR[2]}")


def bf16_against_plain(cfg, batch, act, runs, log=print) -> tuple:
    """The bfloat16 kernels against the bfloat16 plain path of steps()'
    `runs`, which parts the kernels' own error from what bfloat16 does to
    the step where the bfloat16 plain path itself misses PARITY_BAR: (loss
    relative difference, worst-leaf gradient cosine, the share of gradient
    elements whose signs differ, the post-update gap's evaluation part
    |L_k(k') - L_p(k')| and its update part |L_p(k') - L_p(p')|), logged.
    k' and p' are the parameters after the kernels' and the plain path's
    Nadam step, L_k and L_p the kernels' and the plain path's bfloat16
    loss.  The first Nadam step moves each weight by about the learning
    rate in its gradient's sign, so a gradient element whose sign differs
    moves the update by twice that, and how far such moves shift the loss
    depends on the weights, not on the kernels."""
    k16, p16 = runs["fused-bf16"], runs["plain-bf16"]
    names = list(p16[1])
    loss = abs(k16[0] - p16[0]) / abs(p16[0])
    _, _, cos = leaf_stats([k16[1][n] for n in names],
                           [p16[1][n] for n in names])
    flips = sum(int((torch.sign(k16[1][n]) != torch.sign(p16[1][n])).sum())
                for n in names) / sum(p16[1][n].numel() for n in names)
    c16 = cfg.replace(dropout=0.0, input_dropout=0.0,
                      lstm_recurrent_activation=act,
                      compute_dtype="bfloat16")
    model = build_model(c16, batch[0].device, state=k16[2], trainable=True)
    with plain_stacks(), torch.no_grad():
        plain_at_k = float(model.loss(batch, generator=None,
                                      train=False)[0])
    evaluation, update = abs(k16[3] - plain_at_k), abs(plain_at_k - p16[3])
    log(f"  {act} bfloat16 kernels vs bfloat16 plain: loss rel diff "
        f"{loss:.4g}, worst-leaf gradient cosine {cos:.6f}, gradient signs "
        f"differing {flips:.4%}; post-update gap {abs(k16[3] - p16[3]):.3g}"
        f" = evaluation {evaluation:.3g} (both paths on the kernels' "
        f"update) and update {update:.3g} (the two updates on the plain "
        f"path)")
    return loss, cos, flips, evaluation, update


def worst_leaf(ga: Dict[str, torch.Tensor], gb: Dict[str, torch.Tensor]):
    """The JAX tool's worst leaves of ga against the reference gb: (lowest
    cosine, its leaf, highest ||a - b|| / ||b||, its leaf)."""
    stats = {n: leaf_stats([ga[n]], [gb[n]]) for n in gb}
    cos_at = min(stats, key=lambda n: stats[n][2])
    rel_at = max(stats, key=lambda n: stats[n][1])
    return stats[cos_at][2], cos_at, stats[rel_at][1], rel_at


def validate(cfg, gates: str, device="cuda", log=print) -> Dict[str, float]:
    """The checks at `cfg`'s widths and batch (dropout off, `gates` set
    by `steps`); returns the readings."""
    dev = resolve_device(device)
    full_f32()
    fresh = build_model(cfg, "cpu", seed=0).state_dict()
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in random_batch(cfg, seed=0, rolled_targets=True))
    tpu = tpu_r5(gates)

    def beside(label: str) -> str:
        value = r5_value(tpu, label)
        return "" if value is None else f"  (TPU r5: {value})"

    log(f"device: {dev}")
    log(f"gates: {gates}")
    runs = steps(cfg, fresh, batch, gates)
    # The JAX tool's name of each variant, as the TPU's log prints it.
    jax_name = {"fused-bf16": "fused-bf16", "plain-bf16": "xla-bf16",
                "plain-f32": "xla-f32"}
    for v, j in jax_name.items():
        log(f"{v}: loss={runs[v][0]:.6f}" + beside(f"{j}: loss="))
    ref = runs["plain-f32"][0]
    rels = {}
    for v in ("fused-bf16", "plain-bf16"):
        rels[v] = abs(runs[v][0] - ref) / ref
        log(f"{v} vs plain-f32 loss rel-diff: {rels[v]:.3e}"
            + beside(f"{jax_name[v]} vs xla-f32 loss rel-diff: "))
    d16 = abs(runs["fused-bf16"][0] - runs["plain-bf16"][0]) / \
        runs["plain-bf16"][0]
    log(f"fused-bf16 vs plain-bf16 loss rel-diff: {d16:.3e}"
        + beside("fused-bf16 vs xla-bf16 loss rel-diff: "))
    cos, cos_at, rel, rel_at = worst_leaf(runs["fused-bf16"][1],
                                          runs["plain-bf16"][1])
    log(f"grad cosine similarity (worst leaf): {cos:.5f} at {cos_at}"
        + beside("grad cosine similarity (worst leaf): "))
    log(f"grad relative error ||a-b||/||b|| (worst leaf): {rel:.3e} at "
        f"{rel_at}"
        + beside("grad relative error ||a-b||/||b|| (worst leaf): "))
    for v in ("fused-bf16", "plain-bf16"):
        log(f"{v}: step losses {runs[v][0]:.5f} -> {runs[v][3]:.5f}"
            + beside(f"{jax_name[v]}: step losses "))
    gap = abs(runs["fused-bf16"][3] - runs["plain-bf16"][3])
    log(f"post-update loss abs-diff: {gap:.2e}"
        + beside("post-update loss abs-diff: "))
    readings = step_readings(cfg, fresh, batch, gates, runs, log)
    for v in ("fused-bf16", "plain-bf16"):
        require(rels[v] < JAX_BARS["loss_vs_f32"],
                f"{v} loss is {rels[v]:.3e} from float32")
    require(d16 < JAX_BARS["loss_vs_plain16"],
            f"fused-bf16 loss is {d16:.3e} from plain-bf16")
    require(cos > JAX_BARS["cos"], f"worst-leaf cosine {cos} at {cos_at}")
    require(rel < JAX_BARS["rel"], f"worst-leaf rel error {rel} at {rel_at}")
    require(runs["fused-bf16"][3] < runs["fused-bf16"][0],
            "the fused step did not reduce the loss")
    require(gap < JAX_BARS["gap"], f"post-update gap {gap}")
    step_bars(readings, f"{gates} gates", log)
    return {"loss_rel_fused_bf16": rels["fused-bf16"],
            "loss_rel_plain_bf16": rels["plain-bf16"],
            "loss_rel_fused_vs_plain_bf16": d16, "worst_cos": cos,
            "worst_rel": rel, "gap": gap, "parity_loss_rel": readings[3],
            "parity_cos": readings[4], "parity_gap": readings[5]}


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        description="Validates the biaxial training kernels against the "
                    "plain stacks: loss, gradients and one update.")
    parser.add_argument("--gates", default="sigmoid",
                        choices=["sigmoid", "hard_sigmoid"],
                        help="LSTM recurrent (gate) activation to validate")
    _device_flag(parser, "validate")
    args = parser.parse_args(argv)
    out = validate(default_config().replace(batch_size=16), args.gates,
                   args.device)
    print("ALL CHECKS PASSED")
    return out


if __name__ == "__main__":
    main()
