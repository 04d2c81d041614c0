"""The port's host tools against the JAX package's, on committed files:

  * music_generator_tpu_torch/tools/analyze_divergence.py (--device cpu)
    prints the JAX tool's (tools/analyze_divergence.py) lines on a
    committed sample (artifacts/short_samples_r4/short_s0_0.mid, stream 0
    of the 3-genre batch, seed 0) against a copy with one play cell
    flipped, with artifacts/trained_model_r4/params.npz: the first
    divergence and the count equal as text, the flip's prob and uniform
    each within 1e-6 of JAX's (the replay runs in float32 through other
    libraries' operations); and it stops after the count without weights,
    and says so when the rolls are identical;
  * `draw_margins` replays each committed linear-kind sample
    (artifacts/linear_time_r19, on tools/common.py::linear_params(r4)) and
    every play draw falls as the file has it;
  * `python -m music_generator_tpu_torch.midi in.mid out.mid` prints the
    JAX tool's text and writes its bytes."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from music_generator_tpu.midi.__main__ import main as jax_codec_main
from music_generator_tpu_torch import midi
from music_generator_tpu_torch.midi.__main__ import main as codec_main
from music_generator_tpu_torch.tools.analyze_divergence import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.analyze_divergence import main as jax_main  # noqa: E402

SAMPLE = os.path.join(ROOT, "artifacts", "short_samples_r4",
                      "short_s0_0.mid")
R4 = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
FLIP = re.compile(r"prob=([0-9.]+) uniform=([0-9.]+)")


def _flipped(tmp_path) -> tuple:
    """(the sample's path, a copy with its first played cell turned off,
    the cell)."""
    roll = midi.midi_decode(midi.read_midifile(SAMPLE))
    t, p = np.argwhere(roll[:, :, 0] > 0)[0]
    roll[t, p] = 0.0
    path = str(tmp_path / "flipped.mid")
    midi.write_midifile(path, midi.midi_encode(roll))
    return SAMPLE, path, (int(t), int(p))


def _lines(fn, argv, capsys):
    fn(argv)
    return capsys.readouterr().out.splitlines()


def test_report_matches_the_jax_tool(tmp_path, capsys):
    a, b, (t, p) = _flipped(tmp_path)
    argv = [a, b, "--params", R4, "--seed", "0", "--style", "genre:0",
            "--stream-offset", "0"]
    want = _lines(jax_main, argv, capsys)
    got = _lines(main, argv + ["--device", "cpu"], capsys)
    assert len(got) == len(want) == 3, got
    assert got[0] == want[0]
    assert got[0].startswith(f"first divergence: t={t}, midi pitch={p}, "
                             f"channel=play: 1.000000 vs 0.000000")
    assert got[1] == want[1]
    (pg, ug), (pw, uw) = (map(float, FLIP.search(x).groups())
                          for x in (got[2], want[2]))
    assert abs(pg - pw) <= 1e-6 and abs(ug - uw) <= 1e-6, (got[2], want[2])
    assert got[2].startswith("at the flip: play prob=")
    assert ug < pg      # the committed piece played the note: u < p


def test_without_weights_and_identical(tmp_path, capsys):
    a, b, _ = _flipped(tmp_path)
    assert _lines(main, [a, b], capsys) == _lines(jax_main, [a, b], capsys)
    assert _lines(main, [a, a], capsys) == ["rolls identical"]


@pytest.mark.parametrize("i", range(3))
def test_draw_margins_replay_the_linear_samples(i):
    """Every play draw behind linear_{i}.mid (2 bars, genre i, stream i,
    seed 0) replays to the file's note, the replay draws one a played
    note; the closest play draw sits more than 1e-4 from flipping."""
    import torch

    from music_generator_tpu_torch.config import default_config
    from music_generator_tpu_torch.data.dataset import (clamp_midi,
                                                        compute_genre)
    from music_generator_tpu_torch.generation.sampler import Sampler
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.params import params_from_numpy
    from music_generator_tpu_torch.tools.analyze_divergence import (
        draw_margins)
    from music_generator_tpu_torch.tools.common import linear_params
    cfg = default_config().replace(time_axis_kind="linear")
    with np.load(R4) as data:
        state = params_from_numpy(linear_params(
            {k: data[k] for k in data.files}, seed=0))
    model = build_model(cfg.replace(compute_dtype=cfg.gen_dtype), "cpu",
                        state=state)
    roll = midi.midi_decode(midi.read_midifile(os.path.join(
        ROOT, "artifacts", "linear_time_r19", "samples", f"linear_{i}.mid")),
        cfg.midi_max_notes)
    notes = clamp_midi(roll, cfg)[:2 * cfg.notes_per_bar]
    style = torch.as_tensor(compute_genre(i, cfg)[None], dtype=torch.float32)
    play, replay = draw_margins(model, Sampler(model), style, notes, seed=0,
                                stream_offset=i)
    assert play.shape == notes.shape[:2]
    np.testing.assert_array_equal(play >= 0, notes[:, :, 0] > 0)
    assert len(replay) == int(notes[:, :, 0].sum())
    assert np.abs(play).min() > 1e-4


@pytest.mark.parametrize("name", ["short_s0_0.mid", "short_s1_2.mid"])
def test_codec_cli_writes_the_jax_tools_bytes(name, tmp_path, capsys):
    src = os.path.join(ROOT, "artifacts", "short_samples_r4", name)
    out_port, out_jax = str(tmp_path / "port.mid"), str(tmp_path / "jax.mid")
    assert jax_codec_main([src, out_jax]) == 0
    want = capsys.readouterr().out.replace(out_jax, "OUT")
    assert codec_main([src, out_port]) == 0
    assert capsys.readouterr().out.replace(out_port, "OUT") == want
    with open(out_port, "rb") as f, open(out_jax, "rb") as g:
        assert f.read() == g.read()


def test_codec_cli_as_a_module(tmp_path):
    """`python -m music_generator_tpu_torch.midi`, and its usage text
    with the wrong arguments (exit 2)."""
    out = str(tmp_path / "o.mid")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = [sys.executable, "-m", "music_generator_tpu_torch.midi"]
    proc = subprocess.run(run + [SAMPLE, out], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == f"wrote {out}"
    roll = midi.midi_decode(midi.read_midifile(out))
    assert roll.shape[1:] == (128, 3) and roll[..., 0].sum() > 0
    usage = subprocess.run(run, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
    assert usage.returncode == 2
    assert "python -m music_generator_tpu_torch.midi in.mid out.mid" in \
        usage.stdout
