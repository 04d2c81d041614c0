"""Bulk generation traffic: `Sampler.generate` calls back to back, each of
`streams` style mixtures for `bars` bars under its own seed.

Traffic parameters (`portbench/traffic/<mix>.json`): `streams`, `bars`,
`warmup_bars` (one call at the window's batch warms every shape: the
calls run in chunks of 8 bars), `weights` (a committed checkpoint and its
sha256), `check_streams` (streams compared with the reference after the
window), and `keep_per_call` (streams of each call kept for that sample).  A
`--trace 1` run profiles one call more, and names its idle gaps from
another.

A call's mixtures interpolate two styles drawn from the seed, as
`generate --sweep A B <streams>` makes them.  The window ends with the
first call that completes after `--seconds`.

The check: the sampled streams are teacher-forced through the plain
reference (their chosen notes, the temperatures those notes give, the
stream's threefry uniforms).  A draw where the program's choice differs
from the reference's `u <= p` counts by its margin |u - p|; `draw_gap` is
the widest such margin (0 when every draw agrees) and `volume_gap` the
largest difference of a played note's volume."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import trace
from portbench.drivers.common import load_checkpoint, program_config, sub_seed
from portbench.reference import deepj as ref


WARMUP_CALL = 1 << 30         # the warm-up call's index: no window call's


def mixtures(cm: dict, seed: int, k: int, n: int) -> np.ndarray:
    """Call k's n mixtures: two distinct styles from the seed, weighted
    (1 - w, w) for w evenly from 0 to 1."""
    rng = np.random.default_rng(sub_seed(seed, 10, k))
    a, b = rng.choice(cm["num_styles"], size=2, replace=False)
    eye = np.eye(cm["num_styles"], dtype=np.float32)
    w = np.linspace(0.0, 1.0, max(2, n), dtype=np.float64)[:n, None]
    return ((1 - w) * eye[a] + w * eye[b]).astype(np.float32)


def call_seed(seed: int, k: int) -> int:
    return sub_seed(seed, 11, k, bits=32)


def setup(r) -> SimpleNamespace:
    from music_generator_tpu_torch.generation.sampler import Sampler
    from music_generator_tpu_torch.models.deepj import DeepJ

    cfg = program_config(r)
    tr = r.traffic
    weights = load_checkpoint(r.root, tr["weights"])
    model = DeepJ(cfg, r.device)
    model.load_state_dict(weights)
    model.requires_grad_(False).eval()
    sampler = Sampler(model)
    ctx = SimpleNamespace(sampler=sampler, weights=weights, cm=r.model,
                          streams=tr["streams"], bars=tr["bars"])
    warm = mixtures(ctx.cm, r.seed, WARMUP_CALL, ctx.streams)
    with torch.profiler.record_function("portbench.generate"):
        sampler.generate(list(warm), num_bars=tr["warmup_bars"],
                         seed=call_seed(r.seed, WARMUP_CALL))
    return ctx


def one_call(r, ctx, k: int) -> np.ndarray:
    """Call k of the window: its notes [streams, T, N, 3]."""
    mix = mixtures(ctx.cm, r.seed, k, ctx.streams)
    with torch.profiler.record_function("portbench.generate"):
        return ctx.sampler.generate(list(mix), num_bars=ctx.bars,
                                    seed=call_seed(r.seed, k)).notes


def run(r) -> None:
    tr = r.traffic
    ctx = setup(r)
    r.mark_setup()
    rng = np.random.default_rng(sub_seed(r.seed, 12))
    kept = []                      # (call, stream, notes [T, N, 3])
    k = 0
    t0 = time.perf_counter()
    while True:
        notes = one_call(r, ctx, k)
        for g in rng.choice(ctx.streams, tr["keep_per_call"], replace=False):
            kept.append((k, int(g), notes[g].copy()))
        k += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    window = time.perf_counter() - t0
    steps = ctx.bars * r.model["notes_per_bar"]
    r.attempted = k * ctx.streams
    r.e2e["gen_timesteps_per_s"] = k * ctx.streams * steps / window
    r.facts.update(calls=k, streams=ctx.streams, steps=steps,
                   window_s=window)
    if r.trace:
        r.profile = trace.window(lambda: one_call(r, ctx, k),
                                 lambda: one_call(r, ctx, k + 1), r.device)
    r.window_closed()
    weights = ctx.weights
    del ctx
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    pick = rng.choice(len(kept), min(tr["check_streams"], len(kept)),
                      replace=False)
    sample = [kept[i] for i in sorted(pick)]
    readings = gaps(r, weights, sample, ref.Arith())
    for name, limit in r.limits.items():
        r.check(name, readings[name], limit)


def gaps(r, weights, sample, ar, decide=None) -> dict:
    """draw_gap and volume_gap of the sampled streams [(call, stream,
    notes)] against the reference in arithmetic `ar`.  `decide`, when
    given, replaces the program's choices by another arithmetic's
    (the control): it is an Arith whose own probabilities choose."""
    cm, dev = r.model, r.device
    p = {k: v.to(dev) for k, v in weights.items()}
    notes = torch.from_numpy(np.stack([s[2] for s in sample])).to(dev)
    mix = np.stack([mixtures(cm, r.seed, c, r.traffic["streams"])[g]
                    for c, g, _ in sample])
    seeds = [call_seed(r.seed, c) for c, _, _ in sample]
    G, T, N, _ = notes.shape
    temps = ref.temperatures(cm, notes.cpu().numpy(),
                             np.ones(G, np.float32))
    u = ref.stream_uniforms(seeds, [g for _, g, _ in sample], T, N, dev)
    styles = torch.from_numpy(mix).to(dev)
    temps = torch.from_numpy(temps).to(dev)
    probs, vol = ref.generation_probs(p, cm, styles, notes, temps, ar)
    if decide is None:
        play, replay, volume = notes[..., 0] > 0, notes[..., 1] > 0, \
            notes[..., 2]
    else:
        cp, cv = ref.generation_probs(p, cm, styles, notes, temps, decide)
        play = u[..., 0] <= cp[..., 0]
        replay = u[..., 1] <= cp[..., 1]
        volume = cv
    want_play = u[..., 0] <= probs[..., 0]
    want_replay = u[..., 1] <= probs[..., 1]
    margin = (u - probs).abs()
    bad_play = play != want_play
    bad_replay = play & want_play & (replay != want_replay)
    draw = torch.cat([margin[..., 0][bad_play], margin[..., 1][bad_replay],
                      margin.new_zeros(1)]).max()
    both = play & want_play
    vgap = torch.cat([(volume - vol).abs()[both], vol.new_zeros(1)]).max()
    r.log(f"{int(bad_play.sum())} play and {int(bad_replay.sum())} replay "
          f"draws of {G} streams x {T} steps x {N} pitches differ from the "
          f"reference's")
    return {"draw_gap": float(draw), "volume_gap": float(vgap)}
