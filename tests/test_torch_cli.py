"""The port's train CLI on the CPU at test_config dims: `train_main` on a
small synthetic corpus writes out/model.pt, resumes from it, and
`generate_main` picks it up; without a card and without `--device cpu`
training raises; `train --from-keras` warm-starts from a Keras 2 file and
`tools/export_keras.py` writes the checkpoint as one."""

import os

import numpy as np
import pytest
import torch

from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.synth import write_synth_corpus
from music_generator_tpu_torch.midi import midi_decode, read_midifile
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import biax
from music_generator_tpu_torch.params import params_from_numpy, save_params_npz
from music_generator_tpu_torch.tools import export_keras
from music_generator_tpu_torch.training import checkpoint, trainer
from music_generator_tpu_torch.training.keras_import import (
    load_keras_weights, save_keras_weights)

torch.set_num_threads(2)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    cfg = port_test_config()
    monkeypatch.setattr(cli, "default_config", lambda: cfg)
    monkeypatch.chdir(tmp_path)
    write_synth_corpus(".", styles=[0, 1], files_per_style=1, bars=4,
                       config=cfg)
    return tmp_path


def test_train_then_generate_from_the_checkpoint(workdir, capsys):
    launches = biax.biax_time_stack.fwd_launches
    hist = cli.train_main(["--device", "cpu", "--epochs", "2"])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert os.path.isfile(workdir / "out" / "model.pt")
    assert os.path.isfile(workdir / "out" / "logs" / "metrics.jsonl")
    # On the CPU the stacks run their plain versions: nothing launched.
    assert biax.biax_time_stack.fwd_launches == launches
    capsys.readouterr()

    cli.train_main(["--device", "cpu", "--epochs", "1"])
    assert "Loaded model from file." in capsys.readouterr().out
    paths = cli.generate_main(["--device", "cpu", "--bars", "1"])
    assert "Loaded model from file." in capsys.readouterr().out
    assert len(paths) == 3
    for p in paths:
        roll = midi_decode(read_midifile(os.path.join(workdir, p)))
        assert roll.ndim == 3 and roll.shape[1:] == (128, 3)


def test_no_resume_starts_fresh(workdir, capsys):
    cli.train_main(["--device", "cpu", "--epochs", "1"])
    capsys.readouterr()
    cli.train_main(["--device", "cpu", "--epochs", "1", "--no-resume"])
    assert "Loaded model from file." not in capsys.readouterr().out


def test_train_refuses_to_run_without_a_card(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train_main(["--epochs", "1"])
    assert not os.path.exists(workdir / "out" / "model.pt")


def _assert_state_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_train_from_keras_warm_starts(workdir, monkeypatch, capsys):
    """`train --from-keras`: the file's weights bit for bit before the
    first step, a Nadam with no state, step 0, and precedence over
    resuming from out/model.pt."""
    cfg = cli.default_config()
    cli.train_main(["--device", "cpu", "--epochs", "1"])   # out/model.pt
    state = build_model(cfg, "cpu", seed=6).state_dict()
    save_keras_weights(state, "w.h5")
    seen = {}

    def fit(self, ds, epochs=None):
        seen["params"] = {k: v.detach().clone()
                          for k, v in self.model.state_dict().items()}
        seen["optimizer"] = dict(self.state.optimizer.state)
        seen["step"] = self.state.step
        return {"loss": []}

    monkeypatch.setattr(trainer.Trainer, "fit", fit)
    capsys.readouterr()
    cli.train_main(["--device", "cpu", "--epochs", "1",
                    "--from-keras", "w.h5"])
    out = capsys.readouterr().out
    assert "Warm-started from Keras weights: w.h5" in out
    assert "Loaded model from file." not in out
    _assert_state_equal(seen["params"], state)
    assert seen["optimizer"] == {} and seen["step"] == 0


def test_export_keras_writes_the_checkpoint(workdir, monkeypatch):
    """tools/export_keras.py: no checkpoint exits non-zero; after a
    training run its file reads back as the checkpoint's weights, bit for
    bit, and `--params` exports a keystr .npz."""
    cfg = cli.default_config()
    monkeypatch.setattr(export_keras, "default_config", lambda: cfg)
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_keras.main(["--out", "none.h5"])
    assert not os.path.exists("none.h5")
    cli.train_main(["--device", "cpu", "--epochs", "1"])
    export_keras.main(["--out", "model.h5"])
    ckpt = checkpoint.CheckpointStore(checkpoint.model_path(cfg)).load()
    want = params_from_numpy({k: v.numpy()
                              for k, v in ckpt["params"].items()})
    _assert_state_equal(load_keras_weights("model.h5", cfg), want)

    save_params_npz(want, "w.npz")
    export_keras.main(["--params", "w.npz", "--out", "npz.h5"])
    assert open("npz.h5", "rb").read() == open("model.h5", "rb").read()
