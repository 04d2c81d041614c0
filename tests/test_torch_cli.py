"""The port's train CLI on the CPU at test_config dims: `train_main` on a
small synthetic corpus writes out/model.pt, resumes from it, and
`generate_main` picks it up; without a card and without `--device cpu`
training raises."""

import os

import numpy as np
import pytest
import torch

from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.synth import write_synth_corpus
from music_generator_tpu_torch.midi import midi_decode, read_midifile
from music_generator_tpu_torch.ops import biax

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
