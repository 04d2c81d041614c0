"""The port's native MIDI decoder (music_generator_tpu_torch/midi/native.py)
and the codec's use of it, on the cases of tests/test_native_codec.py:

  * the port builds native/midi_codec.cc with the system C++ compiler into
    build/torch_native/ and decodes bit-identically (array_equal) to its
    Python codec and to the JAX package's native decoder: random single-
    and multi-track files, boundary and inner re-articulations, a file
    path, every committed .mid under artifacts/;
  * a truncated or over-long track chunk fails with RuntimeError;
  * `load_midi` takes the native path, and caches;
  * DEEPJ_MIDI_LIB names the library to load; with no compiler
    `available()` is False (said once), the decoders raise ImportError and
    `load_midi` decodes in Python to the same roll;
  * importing every module of the port builds and loads nothing."""

import glob
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from music_generator_tpu.midi import native as jax_native
from music_generator_tpu_torch import midi
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.midi import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), native.why_unavailable()
    path = str(native.library_path())
    assert path.startswith(os.path.join(ROOT, "build", "torch_native"))
    assert os.path.isfile(path)
    if not jax_native.available():
        subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                       check=True, capture_output=True)
        jax_native._LIB_TRIED = False
    assert jax_native.available()


def _bytes(pattern) -> bytes:
    buf = io.BytesIO()
    midi.write_midifile(buf, pattern)
    return buf.getvalue()


def _random_pattern(seed, tracks=1, events_per_track=60, resolution=96):
    rng = np.random.default_rng(seed)
    pattern = midi.Pattern(resolution=resolution)
    for _ in range(tracks):
        track = midi.Track()
        sounding = set()
        for _ in range(events_per_track):
            tick = int(rng.integers(0, 40))
            pitch = int(rng.integers(20, 100))
            kind = rng.random()
            if kind < 0.55 or not sounding:
                track.append(midi.NoteOnEvent(
                    tick=tick, pitch=pitch,
                    velocity=int(rng.integers(1, 128))))
                sounding.add(pitch)
            elif kind < 0.9:
                p = int(rng.choice(sorted(sounding)))
                track.append(midi.NoteOffEvent(tick=tick, pitch=p))
                sounding.discard(p)
            else:
                p = int(rng.choice(sorted(sounding)))
                track.append(midi.NoteOnEvent(tick=tick, pitch=p,
                                              velocity=0))
                sounding.discard(p)
        track.append(midi.EndOfTrackEvent(tick=int(rng.integers(0, 30))))
        pattern.append(track)
    return pattern


def _replay_pattern():
    """Re-articulations at a boundary tick and an inner tick."""
    pattern = midi.Pattern(resolution=8)   # step = 8/4 = 2
    pattern.append(midi.Track([
        midi.NoteOnEvent(tick=0, pitch=60, velocity=100),
        midi.NoteOnEvent(tick=3, pitch=60, velocity=90),   # inner: replay
        midi.NoteOnEvent(tick=1, pitch=60, velocity=80),   # boundary tick 4
        midi.NoteOffEvent(tick=5, pitch=60),
        midi.EndOfTrackEvent(tick=2),
    ]))
    return pattern


CASES = ([("single", s, lambda s=s: _random_pattern(s)) for s in range(8)]
         + [("multi", s, lambda s=s: _random_pattern(s, tracks=3,
                                                     events_per_track=40))
            for s in (100, 101, 102)]
         + [("replay", 0, _replay_pattern)])


def _check_three(data: bytes) -> np.ndarray:
    py = midi.midi_decode(midi.read_midifile(io.BytesIO(data)), 128)
    nat = native.native_decode_bytes(data)
    assert nat.shape == py.shape and nat.dtype == np.float64
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat, jax_native.native_decode_bytes(data))
    return py


@pytest.mark.parametrize("kind, seed, make", CASES,
                         ids=[f"{k}{s}" for k, s, _ in CASES])
def test_native_matches_python_and_jax(kind, seed, make):
    py = _check_three(_bytes(make()))
    if kind == "replay":
        assert py[:, 60, 1].sum() == 1    # the inner replay only


def test_native_file_path(tmp_path):
    path = str(tmp_path / "x.mid")
    midi.write_midifile(path, _random_pattern(7, tracks=2))
    py = midi.midi_decode(midi.read_midifile(path), 128)
    np.testing.assert_array_equal(native.native_decode_file(path), py)
    np.testing.assert_array_equal(jax_native.native_decode_file(path), py)


def test_every_committed_mid_decodes_alike():
    files = sorted(glob.glob(os.path.join(ROOT, "artifacts", "**", "*.mid"),
                             recursive=True))
    assert len(files) > 50
    for f in files:
        with open(f, "rb") as fh:
            _check_three(fh.read())


def test_truncated_track_chunk_rejected():
    data = bytearray(_bytes(_random_pattern(3)))
    i = data.find(b"MTrk")
    data[i + 4:i + 8] = (0x7FFFFFF0).to_bytes(4, "big")
    with pytest.raises(RuntimeError):
        native.native_decode_bytes(bytes(data))
    with pytest.raises(RuntimeError):
        native.native_decode_bytes(bytes(data[:i + 12]))


def _load_twice(tmp_path, monkeypatch):
    cfg = default_config().replace(out_dir=str(tmp_path / "out"))
    monkeypatch.chdir(tmp_path)
    midi.write_midifile("y.mid", _random_pattern(9))
    roll = midi.load_midi("y.mid", cfg)
    assert os.path.exists(os.path.join(cfg.cache_dir, "y.mid.npy"))
    np.testing.assert_array_equal(midi.load_midi("y.mid", cfg), roll)
    return roll


def test_load_midi_takes_the_native_path(tmp_path, monkeypatch):
    calls = []
    decode = native.native_decode_file
    monkeypatch.setattr(native, "native_decode_file",
                        lambda *a: calls.append(a) or decode(*a))
    roll = _load_twice(tmp_path, monkeypatch)
    assert calls == [("y.mid", 4)]         # the second load hit the cache
    np.testing.assert_array_equal(
        roll, midi.midi_decode(midi.read_midifile("y.mid"), 128))


def test_deepj_midi_lib_names_the_library(tmp_path, monkeypatch):
    copy = str(tmp_path / "libcopy.so")
    shutil.copy(native.library_path(), copy)
    monkeypatch.setenv("DEEPJ_MIDI_LIB", copy)
    for name, value in (("_TRIED", False), ("_LIB", None), ("_WHY", "")):
        monkeypatch.setattr(native, name, value)
    assert native.available() and native._LIB._name == copy
    _check_three(_bytes(_random_pattern(5)))


def test_without_a_compiler_load_midi_decodes_in_python(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.delenv("DEEPJ_MIDI_LIB", raising=False)
    monkeypatch.setattr(native, "compiler", lambda: None)
    for name, value in (("_TRIED", False), ("_LIB", None), ("_WHY", "")):
        monkeypatch.setattr(native, name, value)
    assert not native.available() and not native.available()
    err = capsys.readouterr().err
    assert err.count("native MIDI decoder unavailable") == 1, err
    assert "no C++ compiler" in native.why_unavailable()
    with pytest.raises(ImportError, match="no C\\+\\+ compiler"):
        native.native_decode_bytes(_bytes(_random_pattern(1)))
    roll = _load_twice(tmp_path, monkeypatch)
    np.testing.assert_array_equal(
        roll, jax_native.native_decode_file(str(tmp_path / "y.mid")))


PROBE = """
import importlib, pkgutil
import music_generator_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from music_generator_tpu_torch.midi import native
from music_generator_tpu_torch.ops import _build
assert not native._TRIED and native._LIB is None, "the decoder was loaded"
assert not _build._loaded, "a kernel was loaded"
print("ok")
"""


def test_importing_the_port_builds_nothing():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)
