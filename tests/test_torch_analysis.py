"""The port's corpus analysis (music_generator_tpu_torch/data/analysis.py),
each test the counterpart of one in tests/test_analysis.py, plus
`analyze_corpus` and `analyze_main` against the JAX package's on a small
synthetic corpus."""

import json
import os

import numpy as np
import pytest

from music_generator_tpu.data import analysis as jax_analysis
from music_generator_tpu_torch import cli, midi
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.analysis import (analyze_corpus,
                                                     autocorrelation,
                                                     event_replays,
                                                     length_distribution,
                                                     note_distribution,
                                                     piece_metrics)
from music_generator_tpu_torch.data.synth import write_synth_corpus


def test_note_and_length_distribution():
    r1 = np.zeros((10, 128, 3))
    r1[:, 60, 0] = 1
    r2 = np.zeros((4, 128, 3))
    r2[:2, 72, 0] = 1
    hist = note_distribution([r1, r2])
    assert hist[60] == 10 and hist[72] == 2 and hist.sum() == 12
    np.testing.assert_array_equal(length_distribution([r1, r2]), [10, 4])


def test_autocorrelation_periodic_signal():
    roll = np.zeros((64, 128, 3))
    roll[::4, 50, 0] = 1
    ac = autocorrelation(roll, max_lag=8)
    assert ac[3] > 0.9
    assert ac[0] < 0.5


def test_analyze_corpus_end_to_end(tmp_path, monkeypatch):
    cfg = default_config().replace(out_dir=str(tmp_path / "out"))
    styledir = tmp_path / "data" / "baroque" / "bach"
    styledir.mkdir(parents=True)
    monkeypatch.chdir(tmp_path)
    T = 64
    play = np.zeros((T, 128))
    play[::4, 60] = 1
    vol = play * 0.5
    pattern = midi.midi_encode(np.stack([play, np.zeros((T, 128)), vol], 2),
                               step=1)
    midi.write_midifile(str(styledir / "a.mid"), pattern)

    stats = analyze_corpus([[str(styledir)]], cfg)
    assert stats["num_files"] == 1
    assert stats["pitch_range_used"] == [60, 60]
    adir = tmp_path / "out" / "analysis"
    for name in ("corpus_stats.json", "note_distribution.tsv", "lengths.tsv",
                 "autocorrelation.tsv"):
        assert (adir / name).exists()
    assert json.load(open(adir / "corpus_stats.json"))["num_files"] == 1


def test_piece_metrics_replay_rate():
    roll = np.zeros((8, 128, 3))
    roll[:, 60, 0] = 1.0
    roll[4, 60, 1] = 1.0
    roll[:, 60, 2] = 0.5
    m = piece_metrics(roll)
    assert m["notes"] == 8
    assert m["replay_rate"] == 1.0 / 8
    assert piece_metrics(np.zeros((4, 128, 3)))["replay_rate"] == 0.0


def test_event_replays_recovers_encoder_written_re_strikes():
    roll = np.zeros((8, 2, 3))
    roll[:, 0, 0] = 1.0
    roll[:, 0, 2] = 0.5
    roll[4, 0, 1] = 1.0
    roll[4:, 1, 0] = 1.0
    roll[4:, 1, 2] = 0.5
    pattern = midi.midi_encode(roll, step=1)
    decoded = midi.midi_decode(pattern, classes=2, step=1)
    assert decoded[..., 1].sum() == 0
    assert event_replays(pattern, step=1) == [(4, 0)]


def test_event_replays_requires_a_sounding_note():
    from music_generator_tpu_torch.midi import (EndOfTrackEvent, NoteOffEvent,
                                                NoteOnEvent, Pattern, Track)
    defensive = Track([NoteOffEvent(tick=0, pitch=60, velocity=0),
                       NoteOnEvent(tick=0, pitch=60, velocity=80),
                       EndOfTrackEvent(tick=4)])
    assert event_replays(Pattern([defensive], resolution=4)) == []
    genuine = Track([NoteOnEvent(tick=0, pitch=60, velocity=80),
                     NoteOffEvent(tick=4, pitch=60, velocity=0),
                     NoteOnEvent(tick=0, pitch=60, velocity=80),
                     EndOfTrackEvent(tick=4)])
    assert event_replays(Pattern([genuine], resolution=4)) == [(4, 60)]
    with pytest.raises(ValueError, match="unsupported MIDI resolution"):
        event_replays(Pattern([genuine], resolution=2))


def test_analyze_corpus_equals_the_jax_package(tmp_path, monkeypatch):
    """On a synthetic corpus of three styles: the same stats dict, the same
    files under out/analysis, and piece_metrics equal on every piece;
    analyze_main prints the dict."""
    from music_generator_tpu.config import test_config as jax_test_config
    from music_generator_tpu.midi.codec import load_midi as jax_load_midi
    cfg = port_test_config()
    monkeypatch.chdir(tmp_path)
    write_synth_corpus(".", styles=[0, 1, 5], files_per_style=2, bars=4,
                       config=cfg)
    jcfg = jax_test_config()
    port = analyze_corpus(cfg.styles, cfg, out_dir="port")
    want = jax_analysis.analyze_corpus(jcfg.styles, jcfg, out_dir="jax")
    assert port == want and port["num_files"] == 6
    for name in sorted(os.listdir("jax/analysis")):
        assert open(f"port/analysis/{name}", "rb").read() == \
            open(f"jax/analysis/{name}", "rb").read(), name
    for f in sorted(os.path.join(d, n) for group in cfg.styles
                    for d in group if os.path.isdir(d)
                    for n in os.listdir(d)):
        roll = jax_load_midi(f, jcfg)
        assert piece_metrics(roll) == jax_analysis.piece_metrics(roll)

    monkeypatch.setattr(cli, "default_config", lambda: cfg)
    assert cli.analyze_main([]) == port
