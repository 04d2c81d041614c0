"""music_generator_tpu_torch/tools/run_augment_study.py and the port's
Trainer.evaluate against the JAX package on the CPU, at test_config()
widths, float32:

  * the study (styles 0 and 1, 1 file of 2 bars, at most 3 epochs,
    patience 1): its report holds every key of the JAX tool's report
    (artifacts/augment_r4/report.json) at every level, and the card's line
    (null off the card); its window counts equal the JAX `load_all` on the
    same corpus at transpose_augment 0 and k; its seven corpora are
    byte-equal to the JAX `write_synth_corpus`; each run's checkpoint holds
    the step of its best epoch by the JAX Trainer's rule; every entry of
    its eval matrix equals the JAX Trainer.evaluate of the restored weights
    on the same corpus within rtol 1e-5; the caller's cwd is unchanged
    after `main`, also after a `main` that raises;
  * Trainer.evaluate: all four metrics against the JAX Trainer.evaluate on
    shared weights within rtol 1e-5, on a corpus whose window count the
    batch divides and on ones it does not (the last batch padded, its pad
    rows weighted out).
"""

from __future__ import annotations

import filecmp
import json
import math
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data.dataset import load_all as jax_load_all
from music_generator_tpu.data.synth import \
    write_synth_corpus as jax_write_synth_corpus
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.parallel.mesh import make_mesh
from music_generator_tpu.training.trainer import Trainer as JaxTrainer
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.dataset import load_all
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import params_to_numpy
from music_generator_tpu_torch.tools import run_augment_study
from music_generator_tpu_torch.training import trainer as port_trainer
from music_generator_tpu_torch.training.checkpoint import build_or_load

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STYLES = [0, 1]
AUGMENT = 1
ARGS = ["--styles", *map(str, STYLES), "--files-per-style", "1",
        "--bars", "2", "--epochs", "3", "--patience", "1",
        "--augment", str(AUGMENT), "--device", "cpu"]
METRICS = ("loss", "bce_play", "bce_replay", "mse_volume")


def _styles(cfg, root):
    return [[os.path.join(root, s) for s in g] for g in cfg.styles]


def _tree_from(flat: dict, like):
    """A JAX parameter tree shaped like `like` from keystr-keyed arrays."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        jax.numpy.asarray(flat[jax.tree_util.keystr(p)]) for p, _ in paths])


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("augment")
    here = os.getcwd()
    report = run_augment_study.main(["--run-dir", str(run_dir), *ARGS],
                                    cfg=port_test_config())
    assert os.getcwd() == here
    return run_dir, report


@pytest.fixture(scope="module")
def jax_trainer():
    """What the JAX Trainer.evaluate reads of its trainer (model, config,
    a one-device mesh, the state's params, the cached eval step), without
    the trainer's eager parameter initialization, which takes seconds on
    the CPU: each test sets the params, and the eval step is compiled once
    for the module."""
    cfg = jax_test_config()
    like = jax.eval_shape(lambda: init_params(jax.random.key(0), cfg))
    return SimpleNamespace(model=JaxDeepJ(cfg), cfg=cfg,
                           mesh=make_mesh(jax.devices()[:1]), like=like,
                           state=None, _eval_step=None)


def _jax_evaluate(trainer, state_dict, root, batch_size=None) -> dict:
    trainer.state = SimpleNamespace(params=_tree_from(
        params_to_numpy(state_dict), trainer.like))
    cfg = trainer.cfg
    return JaxTrainer.evaluate(
        trainer, jax_load_all(_styles(cfg, root), cfg.seq_len, cfg),
        batch_size)


def _key_paths(tree, prefix=()):
    """Every key path of the dicts in `tree`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield prefix + (k,)
            yield from _key_paths(v, prefix + (k,))


def test_report_has_every_key_of_the_jax_report(study):
    run_dir, report = study
    with open(os.path.join(ROOT, "artifacts", "augment_r4",
                           "report.json")) as f:
        jax_report = json.load(f)
    assert set(_key_paths(jax_report)) <= set(_key_paths(report))
    assert report["card"] is None and report["backend"] == "cpu"
    assert report["styles"] == STYLES
    with open(os.path.join(run_dir, "report.json")) as f:
        assert json.load(f) == report
    for name, k in (("baseline", 0), ("augmented", AUGMENT)):
        run = report["runs"][name]
        assert run["transpose_augment"] == k
        assert run["loss_curve"][0] == run["first_loss"]
        assert run["best_loss"] == min(run["loss_curve"])
        assert run["steady_epoch_timesteps_per_sec"] > 0
        for family in ("train", "heldout"):
            row = report["eval_loss"][name][family]
            assert sorted(row) == ["shift+0", "shift+1", "shift-1"]
            assert all(np.isfinite(v) for v in row.values())


def test_windows_equal_jax_load_all(study):
    run_dir, report = study
    root = os.path.join(run_dir, "corpus")
    for name, k in (("baseline", 0), ("augmented", AUGMENT)):
        cfg = jax_test_config(transpose_augment=k)
        want = len(jax_load_all(_styles(cfg, root), cfg.seq_len, cfg))
        assert report["runs"][name]["windows"] == want
    assert (report["runs"]["augmented"]["windows"]
            == (2 * AUGMENT + 1) * report["runs"]["baseline"]["windows"])


def test_corpora_are_byte_equal_to_jax(study, tmp_path):
    run_dir, _ = study
    dirs = {"corpus": dict()}
    for family, seed in (("train", 0),
                         ("heldout", run_augment_study.EVAL_SEED)):
        for shift in (-1, 0, 1):
            dirs[f"eval_{family}_shift{shift:+d}"] = dict(seed=seed,
                                                          shift=shift)
    assert sorted(os.listdir(run_dir)) == sorted(
        [*dirs, "baseline", "augmented", "report.json"])
    for d, kw in dirs.items():
        paths = jax_write_synth_corpus(
            str(tmp_path / d), styles=STYLES, files_per_style=1, bars=2,
            config=jax_test_config(), **kw)
        assert len(paths) == len(STYLES)
        for p in paths:
            rel = os.path.relpath(p, tmp_path / d)
            assert filecmp.cmp(p, os.path.join(run_dir, d, rel),
                               shallow=False), (d, rel)


def _jax_rule(losses, epochs: int, patience: int):
    """(epochs run, index of the checkpointed epoch) by the JAX Trainer's
    rule (training/trainer.py of the JAX package: a checkpoint on every
    strict improvement of the epoch's loss, a stop once `patience` epochs
    in a row have not improved)."""
    best, bad, saved = math.inf, 0, None
    for e, loss in enumerate(losses):
        if loss < best:
            best, bad, saved = loss, 0, e
        else:
            bad += 1
            if bad >= patience:
                return e + 1, saved
    return min(len(losses), epochs), saved


@pytest.mark.parametrize("name", ["baseline", "augmented"])
def test_checkpoint_holds_the_best_epoch(study, name):
    run_dir, report = study
    run = report["runs"][name]
    ran, saved = _jax_rule(run["loss_curve"], epochs=3, patience=1)
    assert run["epochs_run"] == len(run["loss_curve"]) == ran
    steps = math.ceil(run["windows"] / min(port_test_config().batch_size,
                                           run["windows"]))
    ckpt = torch.load(os.path.join(run_dir, name, "out", "model.pt"),
                      map_location="cpu", weights_only=True)
    assert int(ckpt["step"]) == (saved + 1) * steps


@pytest.mark.parametrize("name", ["baseline", "augmented"])
def test_eval_matrix_equals_jax_evaluate(study, jax_trainer, name):
    """Every entry of the model's two rows, against the JAX evaluate of its
    restored checkpoint's weights on the same eval corpus."""
    run_dir, report = study
    cfg = port_test_config(out_dir=os.path.join(run_dir, name, "out"))
    model, loaded = build_or_load(cfg, "cpu")
    assert loaded
    for family in ("train", "heldout"):
        for shift in (-1, 0, 1):
            root = os.path.join(run_dir, f"eval_{family}_shift{shift:+d}")
            want = _jax_evaluate(jax_trainer, model.state_dict(), root)
            np.testing.assert_allclose(
                report["eval_loss"][name][family][f"shift{shift:+d}"],
                want["loss"], rtol=1e-5, err_msg=f"{family} {shift:+d}")


def test_cwd_is_restored_when_main_raises(tmp_path, monkeypatch):
    here = os.getcwd()
    monkeypatch.setattr(port_trainer.Trainer, "maybe_restore",
                        lambda self: False)
    args = ["--run-dir", str(tmp_path), *ARGS, "--epochs", "1"]
    with pytest.raises(RuntimeError, match="did not restore"):
        run_augment_study.main(args, cfg=port_test_config())
    assert os.getcwd() == here


# -- Trainer.evaluate against the JAX package's ------------------------------

@pytest.fixture(scope="module")
def eval_corpora(tmp_path_factory):
    """(root, windows) of a corpus of 2 styles (6 windows, which the batch
    of 2 divides) and of 3 styles (9 windows, which it does not)."""
    out = {}
    for tag, styles in (("even", [0, 1]), ("odd", [0, 1, 3])):
        root = str(tmp_path_factory.mktemp(f"eval_{tag}"))
        jax_write_synth_corpus(root, styles=styles, files_per_style=1,
                               bars=2, seed=7, config=jax_test_config())
        out[tag] = root
    return out


@pytest.mark.parametrize("corpus, batch_size, windows", [
    ("even", None, 6), ("odd", None, 9), ("even", 4, 6)])
def test_evaluate_equals_jax(eval_corpora, jax_trainer, corpus, batch_size,
                             windows):
    root = eval_corpora[corpus]
    cfg = port_test_config()
    ds = load_all(_styles(cfg, root), cfg.seq_len, cfg)
    assert len(ds) == windows
    trainer = port_trainer.Trainer(
        build_model(cfg, "cpu", seed=5),
        port_trainer.TrainConfig(checkpoint=False, tensorboard=False))
    got = trainer.evaluate(ds, batch_size)
    want = _jax_evaluate(jax_trainer, trainer.model.state_dict(), root,
                         batch_size)
    assert set(got) == set(want) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
