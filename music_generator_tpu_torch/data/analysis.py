"""Corpus statistics: note distributions, sequence lengths, autocorrelation
(the port's own copy of the JAX package's `data/analysis.py`, numpy only).

The reference ships a broken analysis script (ref: distribution.py — imports
a nonexistent `music` module and a `dataset.load_melodies` that doesn't
exist; SURVEY.md §2 #17).  This module rebuilds its *intent* on the actual
pipeline: statistics over the decoded piano-roll corpus, written as TSV/JSON
(plots render anywhere) plus optional matplotlib PNGs when available.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from music_generator_tpu_torch.config import Config, default_config
from music_generator_tpu_torch.midi.codec import load_midi
from music_generator_tpu_torch.utils import get_all_files


def note_distribution(rolls: Sequence[np.ndarray]) -> np.ndarray:
    """Total play mass per MIDI pitch, over all sequences → [128]."""
    hist = np.zeros(128)
    for roll in rolls:
        hist += roll[:, :, 0].sum(axis=0)
    return hist


def length_distribution(rolls: Sequence[np.ndarray]) -> np.ndarray:
    """Sequence lengths in piano-roll timesteps."""
    return np.array([len(r) for r in rolls])


def autocorrelation(roll: np.ndarray, max_lag: int = 64) -> np.ndarray:
    """Autocorrelation of the total-activity signal (how periodic the piece
    is on the 16th-note grid) → [max_lag]."""
    sig = roll[:, :, 0].sum(axis=1)
    sig = sig - sig.mean()
    denom = float(np.dot(sig, sig))
    if denom == 0 or len(sig) < 2:
        return np.zeros(max_lag)
    out = np.zeros(max_lag)
    for lag in range(1, min(max_lag, len(sig) - 1) + 1):
        out[lag - 1] = float(np.dot(sig[:-lag], sig[lag:])) / denom
    return out


def polyphony(roll: np.ndarray) -> float:
    """Mean simultaneous sounding notes over the steps where anything
    sounds (silent steps excluded so piece length doesn't dilute it)."""
    per_step = (roll[:, :, 0] > 0).sum(axis=1)
    active = per_step[per_step > 0]
    return float(active.mean()) if len(active) else 0.0


def velocity_stats(roll: np.ndarray) -> Dict[str, float]:
    """Mean/std of the volume channel over sounding cells (the dynamics
    head's output range; published pieces carry real velocities)."""
    vols = roll[:, :, 2][roll[:, :, 0] > 0]
    if not len(vols):
        return {"mean": 0.0, "std": 0.0}
    return {"mean": float(vols.mean()), "std": float(vols.std())}


def event_replays(pattern, step: Optional[int] = None,
                  config: Optional[Config] = None):
    """(frame, pitch) of every same-instant NoteOff+NoteOn re-strike in a
    parsed MIDI pattern.

    Re-articulations written by `midi_encode` land as same-instant off+on
    pairs on the frame grid — exactly where `midi_decode`'s pinned
    reference quirk suppresses replay detection (codec.py module doc), so
    the decoded replay channel of any encoder-written file reads 0.  This
    recovers them at the event level; used by the audio renderer and the
    replay evidence in docs/TRAINING.md.  `step` = ticks per roll row
    (defaults to the decoder's resolution-derived value, with the same
    sub-beat-resolution rejection as `midi_decode`).

    A re-strike requires the pitch to have been SOUNDING when the
    same-instant NoteOff arrived — a defensive NoteOff on a silent pitch
    (a common sequencer export pattern) followed by its NoteOn is a plain
    onset, not a re-articulation (mirrors the decoder's
    `vol_prev > 0` condition)."""
    if step is None:
        cfg = config or default_config()
        step = pattern.resolution // cfg.notes_per_beat
        if step <= 0:
            # Same boundary contract as midi_decode: frame indices on a
            # grid no decodable roll uses would silently mislead callers
            # that pair the two (render_audio does).
            raise ValueError(
                f"unsupported MIDI resolution {pattern.resolution} "
                f"(needs >= {cfg.notes_per_beat} ticks/beat)")
    out = []
    for track in pattern:
        tick = 0
        offs = set()        # sounding pitches NoteOff'd at this instant
        sounding = set()    # pitches currently held
        for ev in track:
            if ev.tick > 0:
                offs.clear()
            tick += ev.tick
            name = type(ev).__name__
            is_off = name == "NoteOffEvent" or (
                name == "NoteOnEvent" and ev.velocity == 0)
            if is_off:
                if ev.pitch in sounding:
                    offs.add(ev.pitch)
                sounding.discard(ev.pitch)
            elif name == "NoteOnEvent":
                if ev.pitch in offs:
                    out.append((tick // step, ev.pitch))
                offs.discard(ev.pitch)
                sounding.add(ev.pitch)
    return out


def piece_metrics(roll: np.ndarray, max_lag: int = 64) -> Dict:
    """The per-piece quality fingerprint used by
    tools/compare_published.py: note density, polyphony, velocity
    distribution, 12-dim pitch-class profile, and the bar-period
    autocorrelation (lag 16 = one bar on the 16th-note grid)."""
    from music_generator_tpu_torch.data.synth import pitch_class_histogram
    ac = autocorrelation(roll, max_lag=max_lag)
    sounding = int((roll[:, :, 0] > 0).sum())
    return {
        "timesteps": int(len(roll)),
        "notes": sounding,
        "note_density": float(sounding / max(1, len(roll))),
        # Re-articulations per sounding cell — the replay head's footprint
        # in the music.  (The reference's own published pieces almost
        # never re-strike — 1 in 7,631 onsets, docs/TRAINING.md — so 0
        # here matches DeepJ v1; real corpora score 0.04-0.06.)
        "replay_rate": float(roll[:, :, 1].sum() / max(1, sounding)),
        "polyphony": polyphony(roll),
        "velocity": velocity_stats(roll),
        "pitch_class_profile": [round(float(x), 4)
                                for x in pitch_class_histogram(roll)],
        "autocorr_bar": float(ac[15]) if len(ac) > 15 else 0.0,
        "autocorrelation": [round(float(x), 4) for x in ac],
    }


def profile_intersection(a: Sequence[float], b: Sequence[float]) -> float:
    """Histogram intersection of two normalized profiles (1 = identical
    mass placement, ~1/3 = unrelated scales for pitch-class profiles)."""
    return float(np.minimum(np.asarray(a), np.asarray(b)).sum())


def analyze_corpus(styles: Optional[Sequence[Sequence[str]]] = None,
                   config: Optional[Config] = None,
                   out_dir: Optional[str] = None) -> Dict:
    """Walk the corpus, decode (cached), and write statistics.

    Outputs (under <out_dir or cfg.out_dir>/analysis/):
      corpus_stats.json, note_distribution.tsv, lengths.tsv,
      autocorrelation.tsv (mean across pieces)
    """
    cfg = config or default_config()
    styles = styles if styles is not None else cfg.styles
    target = os.path.join(out_dir or cfg.out_dir, "analysis")
    os.makedirs(target, exist_ok=True)

    per_style: Dict[str, int] = {}
    rolls: List[np.ndarray] = []
    for style in (y for x in styles for y in x):
        files = get_all_files([style])
        per_style[style] = len(files)
        for f in files:
            try:
                rolls.append(load_midi(f, cfg))
            except Exception as e:
                print(f"skipping {f}: {type(e).__name__}: {e}")

    notes_hist = note_distribution(rolls)
    lengths = length_distribution(rolls)
    acs = [autocorrelation(r) for r in rolls if len(r) > 2]
    mean_ac = np.mean(acs, axis=0) if acs else np.zeros(64)

    stats = {
        "num_files": len(rolls),
        "files_per_style": per_style,
        "total_timesteps": int(lengths.sum()) if len(lengths) else 0,
        "mean_length": float(lengths.mean()) if len(lengths) else 0.0,
        "median_length": float(np.median(lengths)) if len(lengths) else 0.0,
        "pitch_range_used": [
            int(np.nonzero(notes_hist)[0].min()),
            int(np.nonzero(notes_hist)[0].max()),
        ] if notes_hist.any() else None,
        "notes_per_timestep": float(
            notes_hist.sum() / max(1, lengths.sum())),
    }

    np.savetxt(os.path.join(target, "note_distribution.tsv"),
               np.stack([np.arange(128), notes_hist], 1),
               delimiter="\t", header="pitch\tcount", comments="")
    np.savetxt(os.path.join(target, "lengths.tsv"), lengths,
               delimiter="\t", header="timesteps", comments="")
    np.savetxt(os.path.join(target, "autocorrelation.tsv"),
               np.stack([np.arange(1, len(mean_ac) + 1), mean_ac], 1),
               delimiter="\t", header="lag\tautocorr", comments="")
    with open(os.path.join(target, "corpus_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)

    _maybe_plot(target, notes_hist, lengths, mean_ac)
    return stats


def _maybe_plot(target: str, notes_hist, lengths, mean_ac) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].bar(np.arange(128), notes_hist)
    axes[0].set_title("note distribution")
    axes[1].hist(lengths, bins=30)
    axes[1].set_title("sequence lengths")
    axes[2].plot(np.arange(1, len(mean_ac) + 1), mean_ac)
    axes[2].set_title("mean autocorrelation")
    fig.tight_layout()
    fig.savefig(os.path.join(target, "corpus_stats.png"), dpi=100)
    plt.close(fig)
