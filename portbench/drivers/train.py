"""Training traffic: `train_step` back to back on batches gathered from a
synthetic corpus resident on the device, as the trainer's resident epoch
runs them (no synchronisation between steps but the program's own).

Traffic parameters (`portbench/traffic/<mix>.json`): `batch` rows a step,
`corpus_gib` of corpus made on the device from the seed, each row with
its own note density drawn from `density` [lo, hi] and its own style;
`trace_steps` steps in the profiled window of a `--trace 1` run, and
`trace_host_steps` in the one that names its idle gaps.

Set-up makes the corpus and the weights on the device from the seed
(`reference.deepj.make_weights`), builds the model and Nadam state once,
and drives that one state through its first three steps on three batches
of distinct rows.  Those steps are the warm-up, and their readings are
compared with the plain reference's three steps from the same weights,
batches and dropout: each step's loss, each leaf's gradient norm at step
1 (from Nadam's first moment after it, mu = (1 - beta1) g), and each
leaf's change after step 3.  The window then runs the same state on."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import trace
from portbench.drivers.common import (median_leaf_gap, program_config,
                                      sub_seed, worst_leaf_gap)
from portbench.reference import deepj as ref

CHECKED_STEPS = 3
MAX_STEPS = 4096              # feed rows precomputed for this many steps
ZERO_GRAD_SHARE = 1e-3        # leaves below this share of the median
                              # gradient norm are left out of the change


def make_corpus(cm: dict, M: int, T: int, density, gen: torch.Generator):
    """M rows of (notes, targets, beats, styles) on gen's device: a roll of
    T + 1 steps per row with its own play density, replays on a third of
    the played notes, volumes in [0.3, 0.9], one style a row; targets are
    the notes one step on."""
    dev = gen.device
    N, S, bar = cm["num_notes"], cm["num_styles"], cm["notes_per_bar"]
    lo, hi = density
    dens = lo + (hi - lo) * torch.rand(M, 1, 1, generator=gen, device=dev)
    u = torch.rand(3, M, T + 1, N, generator=gen, device=dev)
    play = (u[0] < dens).float()
    roll = torch.stack([play, play * (u[1] < 1 / 3).float(),
                        play * (0.3 + 0.6 * u[2])], dim=-1)
    beats = torch.zeros(M, T, bar, device=dev)
    beats[:, torch.arange(T), torch.arange(T) % bar] = 1.0
    style = torch.randint(0, S, (M,), generator=gen, device=dev)
    styles = torch.nn.functional.one_hot(style, S).float()[:, None].expand(
        M, T, S).contiguous()
    return (roll[:, :T].contiguous(), roll[:, 1:].contiguous(), beats,
            styles)


def feed_rows(M: int, B: int, steps: int, gen: torch.Generator):
    """[steps, B] row indices: epochs of a permutation of the M rows."""
    per = M // B
    out = []
    while sum(len(o) for o in out) < steps:
        out.append(torch.randperm(M, generator=gen, device=gen.device)[
            :per * B].view(per, B))
    return torch.cat(out)[:steps]


def setup(r) -> SimpleNamespace:
    """The corpus, the weights, the one training state, and its first
    CHECKED_STEPS steps with their readings (`ctx.readings`)."""
    from music_generator_tpu_torch.models.deepj import DeepJ
    from music_generator_tpu_torch.ops.nadam import Nadam
    from music_generator_tpu_torch.parallel import train_step as ts

    cfg = program_config(r)
    cm = r.model
    dev = r.device
    tr = r.traffic
    B, T = tr["batch"], cfg.seq_len
    row_bytes = 4 * (2 * T * cm["num_notes"] * cm["note_units"]
                     + T * cm["notes_per_bar"] + T * cm["num_styles"])
    M = max(CHECKED_STEPS * B, int(tr["corpus_gib"] * 2**30) // row_bytes)
    g_data = torch.Generator(device=dev).manual_seed(sub_seed(r.seed, 1))
    corpus = make_corpus(cm, M, T, tr["density"], g_data)
    rows = feed_rows(M, B, MAX_STEPS, g_data)
    weights = ref.make_weights(cm, torch.Generator(device=dev).manual_seed(
        sub_seed(r.seed, 2)))
    drop_seed = sub_seed(r.seed, 3)

    model = DeepJ(cfg, dev)
    model.load_state_dict(weights)
    model.requires_grad_(True).train()
    state = ts.TrainState(model, Nadam(model.parameters(), cfg.learning_rate,
                                       cfg.beta1, cfg.beta2, cfg.eps,
                                       cfg.schedule_decay), 0, drop_seed)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())

    def step(k: int):
        idx = rows[k % MAX_STEPS]
        with torch.profiler.record_function("portbench.train_step"):
            return ts.train_step(state, tuple(a[idx] for a in corpus))

    losses, grad = [], {}
    for k in range(CHECKED_STEPS):
        losses.append(step(k)["loss"])
        if k == 0:
            mu = [state.optimizer.state[p]["mu"] for p in params]
            norms = torch.stack([m.norm() for m in mu]) / (1.0 - cfg.beta1)
            grad = dict(zip(names, norms.tolist()))
    change = torch.stack([(p.detach() - weights[n]).norm()
                          for n, p in zip(names, params)])
    readings = {"loss": torch.stack(losses).tolist(), "grad": grad,
                "change": dict(zip(names, change.tolist()))}
    batches = [tuple(a[rows[i]] for a in corpus)
               for i in range(CHECKED_STEPS)]
    return SimpleNamespace(cfg=cfg, state=state, step=step, B=B, T=T,
                           readings=readings, weights=weights,
                           batches=batches, drop_seed=drop_seed)


def run(r) -> None:
    ctx = setup(r)
    r.mark_setup()
    k = CHECKED_STEPS
    t0 = time.perf_counter()
    while True:
        ctx.step(k)
        k += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    r.sync()
    window = time.perf_counter() - t0
    steps = k - CHECKED_STEPS
    r.attempted = steps
    r.e2e["train_timesteps_per_s"] = steps * ctx.B * ctx.T / window
    r.facts.update(steps=steps, window_s=window, batch=ctx.B,
                   seq_len=ctx.T, compute_dtype=ctx.cfg.compute_dtype)
    if r.trace:
        n, m = r.traffic["trace_steps"], r.traffic["trace_host_steps"]

        def steps(first, count):
            return lambda: [ctx.step(first + i) for i in range(count)]
        r.profile = trace.window(steps(k, n), steps(k + n, m), r.device)
        r.facts["trace_steps"] = n
    r.window_closed()
    got, weights, batches = ctx.readings, ctx.weights, ctx.batches
    del ctx
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    want = ref.train_readings(weights, r.model, batches,
                              sub_seed(r.seed, 3), ref.Arith())
    compare(r, got, want)


def train_gaps(got: dict, want: dict, log=None) -> dict:
    """The numbers a training cell may compare (its limits file names
    those it does): the largest relative gap of the three losses and that
    of the first; the worst leaf's gap of the gradient norms at step 1 and
    the median leaf's; the worst leaf's gap of the change norms after step
    3 and the median leaf's (leaves whose reference gradient is under
    ZERO_GRAD_SHARE of the median leaf's are left out of the change)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       want["loss"]))
    names = sorted(want["grad"])
    med = float(np.median([want["grad"][k] for k in names]))
    moving = [k for k in names if want["grad"][k] >= ZERO_GRAD_SHARE * med]
    grad_gap, grad_leaf = worst_leaf_gap(got["grad"], want["grad"], names)
    change_gap, change_leaf = worst_leaf_gap(got["change"], want["change"],
                                             moving)
    if log is not None:
        log(f"losses {got['loss']} against the reference's "
            f"{want['loss']}; worst gradient leaf {grad_leaf}, worst change "
            f"leaf {change_leaf}; {len(names) - len(moving)} leaves left out "
            f"of the change")
    return {"loss_gap": loss_gap,
            "loss1_gap": abs(got["loss"][0] - want["loss"][0])
            / abs(want["loss"][0]),
            "grad_gap": grad_gap,
            "grad_median_gap": median_leaf_gap(got["grad"], want["grad"],
                                               names),
            "change_gap": change_gap,
            "change_median_gap": median_leaf_gap(got["change"],
                                                 want["change"], moving)}


def compare(r, got: dict, want: dict) -> None:
    gaps = train_gaps(got, want, r.log)
    for name, limit in r.limits.items():
        r.check(name, gaps[name], limit)
