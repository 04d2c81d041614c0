"""music_generator_tpu_torch/tools/render_audio.py against the JAX
package's tools/render_audio.py, on the host:

  * render_file on the committed artifacts/short_samples_r2/short_s0_*.mid
    writes the committed .wav bytes (the JAX tool's output);
  * render_roll on seeded random rolls (held notes, replays inside held
    notes, a zero-volume onset, a note that runs to the last step, bass and
    treble pitches) equals the JAX tool's render_roll bit for bit;
  * main([]) errors as the JAX tool's does.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from music_generator_tpu_torch.tools import render_audio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools import render_audio as jax_render_audio  # noqa: E402

SHORT = os.path.join(ROOT, "artifacts", "short_samples_r2")


@pytest.mark.parametrize("i", [0, 1, 2])
def test_render_file_writes_the_committed_wav(i, tmp_path):
    wav = str(tmp_path / f"short_s0_{i}.wav")
    assert render_audio.render_file(
        os.path.join(SHORT, f"short_s0_{i}.mid"), wav) == wav
    with open(wav, "rb") as got, \
            open(os.path.join(SHORT, f"short_s0_{i}.wav"), "rb") as want:
        assert got.read() == want.read()


def _roll(seed: int, T: int = 12) -> np.ndarray:
    """A [T, 128, 3] roll of a few random voices, with a replay inside a
    held note, a zero-volume onset and a note held to the last step."""
    rng = np.random.default_rng(seed)
    roll = np.zeros((T, 128, 3))
    for pitch in rng.choice(np.arange(21, 109), size=5, replace=False):
        play = rng.random(T) < 0.6
        roll[:, pitch, 0] = play
        roll[:, pitch, 1] = play & (rng.random(T) < 0.3)
        roll[:, pitch, 2] = play * rng.uniform(0.1, 1.0, T)
    # Pitch 40 held from step 2 to the end, re-struck at step 5; pitch 100
    # (treble: two strings, partials cut by the Nyquist guard) struck at
    # volume 0 at step 1, then sounding from step 3.
    roll[2:, 40, 0] = 1.0
    roll[2:, 40, 2] = 0.7
    roll[5, 40, 1] = 1.0
    roll[1:6, 100, 0] = 1.0
    roll[1:6, 100, 2] = [0.0, 0.0, 0.5, 0.5, 0.5]
    roll[3, 100, 1] = 1.0
    return roll


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_roll_equals_jax_bit_for_bit(seed):
    roll = _roll(seed)
    got = render_audio.render_roll(roll)
    want = jax_render_audio.render_roll(roll)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.abs(got).max() > 0


def test_main_without_paths_errors_as_jax(capsys):
    with pytest.raises(SystemExit) as want:
        jax_render_audio.main([])
    want_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        render_audio.main([])
    got_err = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split(": ", 1)[1] == want_err.split(": ", 1)[1] == (
        "error: give .mid paths or --all-artifacts")
