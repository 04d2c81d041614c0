"""music_generator_tpu_torch/tools/run_convergence.py on the CPU at
test_config() widths: 2 styles x 1 file x 2 bars, at most 3 epochs,
patience 1, 1-bar samples.

  * the report holds every field of the JAX tool's report (the keys of
    artifacts/convergence_r4/report.json and of its fidelity records),
    and the card's line (null off the card);
  * early stop and the best checkpoint follow the JAX Trainer's rule
    (training/trainer.py:379-390 of the JAX package: a checkpoint on every
    strict improvement of the epoch's train loss, a stop once `patience`
    epochs in a row have not improved), read off the run's loss curve and
    its checkpoint's step;
  * the fidelity numbers equal the JAX package's `pitch_class_histogram`
    overlaps and replay rates on the same rolls (the sampled ones,
    captured from the run, and the JAX `synth_piece` corpus pieces).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data.synth import pitch_class_histogram as jax_hist
from music_generator_tpu.data.synth import synth_piece as jax_synth_piece
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.generation import sampler as port_sampler
from music_generator_tpu_torch.tools import run_convergence

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STYLES = [0, 1]
ARGS = ["--styles", *map(str, STYLES), "--files-per-style", "1",
        "--bars", "2", "--epochs", "3", "--patience", "1",
        "--sample-bars", "1", "--device", "cpu"]


def _run(tmp_path_factory, **overrides):
    """One run of the tool; the sampled rolls captured on their way out."""
    run_dir = tmp_path_factory.mktemp("convergence")
    rolls = []
    real = port_sampler.Sampler.generate

    def generate(self, *a, **k):
        res = real(self, *a, **k)
        rolls.append(res.notes.copy())
        return res
    mp = pytest.MonkeyPatch()
    mp.setattr(port_sampler.Sampler, "generate", generate)
    try:
        report = run_convergence.main(["--run-dir", str(run_dir), *ARGS],
                                      cfg=port_test_config(**overrides))
    finally:
        mp.undo()
    return run_dir, report, rolls


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory)


@pytest.fixture(scope="module")
def flat_run(tmp_path_factory):
    """A run whose loss cannot fall (learning rate 0, no dropout): its
    epochs differ only in batch order, and it stops early."""
    return _run(tmp_path_factory, learning_rate=0.0, dropout=0.0,
                input_dropout=0.0)


def test_report_has_every_field_of_the_jax_report(run):
    run_dir, report, _ = run
    with open(os.path.join(ROOT, "artifacts", "convergence_r4",
                           "report.json")) as f:
        jax_report = json.load(f)
    assert set(jax_report) <= set(report)
    assert set(jax_report["fidelity"][0]) <= set(report["fidelity"][0])
    assert report["card"] is None and report["backend"] == "cpu"
    with open(os.path.join(run_dir, "report.json")) as f:
        assert json.load(f) == report
    assert [r["style"] for r in report["fidelity"]] == STYLES
    for rec in report["fidelity"]:
        assert os.path.isfile(os.path.join(run_dir, rec["sample"]))
    assert os.path.isfile(os.path.join(run_dir, "out", "logs",
                                       "metrics.jsonl"))
    assert report["loss_curve"][0] == report["first_loss"]
    assert report["best_loss"] == min(report["loss_curve"])
    assert report["steady_epoch_timesteps_per_sec"] > 0


def _jax_rule(losses, epochs: int, patience: int):
    """(epochs run, index of the checkpointed epoch) by the JAX Trainer's
    rule, for a run whose epoch losses begin with `losses`."""
    best, bad, saved = math.inf, 0, None
    for e, loss in enumerate(losses):
        if loss < best:
            best, bad, saved = loss, 0, e
        else:
            bad += 1
            if bad >= patience:
                return e + 1, saved
    return min(len(losses), epochs), saved


@pytest.mark.parametrize("which", ["run", "flat_run"])
def test_early_stop_and_best_checkpoint_follow_the_jax_rule(which, request):
    run_dir, report, _ = request.getfixturevalue(which)
    losses = report["loss_curve"]
    ran, saved = _jax_rule(losses, epochs=3, patience=1)
    assert report["epochs_run"] == len(losses) == ran
    if which == "flat_run":
        assert ran < 3
    cfg = port_test_config()
    steps = math.ceil(report["windows"] / min(cfg.batch_size,
                                              report["windows"]))
    ckpt = torch.load(os.path.join(run_dir, "out", "model.pt"),
                      map_location="cpu", weights_only=True)
    assert int(ckpt["step"]) == (saved + 1) * steps
    # The rule itself, on curves that stop and that do not.
    assert _jax_rule([0.5, 0.4, 0.45], 3, 1) == (3, 1)
    assert _jax_rule([0.5, 0.5, 0.1], 3, 1) == (2, 0)
    assert _jax_rule([0.5, 0.6, 0.7, 0.1], 9, 2) == (3, 0)


def test_fidelity_equals_the_jax_histograms(run):
    _, report, rolls = run
    assert len(rolls) == 1
    cfg = port_test_config()
    notes = rolls[0]
    assert notes.shape == (len(STYLES), cfg.notes_per_bar, cfg.num_notes, 3)

    def corpus(s):
        return jax_synth_piece(s, bars=2, seed=0, config=jax_test_config()
                               )[:, cfg.min_note:cfg.max_note]

    for i, rec in enumerate(report["fidelity"]):
        gen = notes[i]
        h = jax_hist(gen)
        own = corpus(rec["style"])
        assert rec["own_overlap"] == float(np.minimum(h, jax_hist(own)).sum())
        assert rec["max_other_overlap"] == max(
            float(np.minimum(h, jax_hist(corpus(s))).sum())
            for s in STYLES if s != rec["style"])
        assert rec["notes"] == int(gen[..., 0].sum())
        assert rec["replay_rate"] == float(
            gen[..., 1].sum() / max(1, (gen[..., 0] > 0).sum()))
        assert rec["corpus_replay_rate"] == float(
            own[..., 1].sum() / max(1, (own[..., 0] > 0).sum()))
