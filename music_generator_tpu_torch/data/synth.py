"""Deterministic synthetic-but-musical corpus generator: the port's own
copy of the JAX package's `data/synth.py` (`synth_piece`,
`_encode_replay_preserving`, `write_synth_corpus`, `random_batch`,
`pitch_class_histogram`), so the
port writes byte-identical corpora and batches from the same seeds.

Each style has its own mode and tonic; pieces are built from bar-long chord
units (root-position triads in a low register) under a scale-wise melody
with occasional leaps (high register), metric velocity accents, and
deliberate re-articulations (exercising the replay channel).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from music_generator_tpu_torch.config import Config, default_config

# Modes as semitone offsets from the tonic.
_MODES = (
    (0, 2, 4, 5, 7, 9, 11),    # ionian (major)
    (0, 2, 3, 5, 7, 8, 10),    # aeolian (natural minor)
    (0, 2, 3, 5, 7, 9, 10),    # dorian
    (0, 1, 3, 5, 7, 8, 10),    # phrygian
    (0, 2, 4, 6, 7, 9, 11),    # lydian
    (0, 2, 4, 5, 7, 9, 10),    # mixolydian
)

# Simple tonal progressions in scale degrees (0-based).
_PROGRESSIONS = (
    (0, 3, 4, 0),              # I  IV V  I
    (0, 5, 3, 4),              # I  vi IV V
    (0, 3, 0, 4),              # I  IV I  V
    (5, 3, 0, 4),              # vi IV I  V
)


def _style_scale(style_id: int, cfg: Config) -> tuple:
    """(tonic_midi, mode) for a style — distinct tonics/modes per style so
    styles are separable in pitch-class space."""
    tonic = cfg.min_note + 12 + (style_id * 5) % 12     # circle of fourths
    mode = _MODES[style_id % len(_MODES)]
    return tonic, mode


def synth_piece(style_id: int, bars: int = 16, seed: int = 0,
                config: Optional[Config] = None) -> np.ndarray:
    """One piece as a [T, 128, 3] piano roll (play, replay, volume).

    Deterministic in (style_id, bars, seed).  T = bars * notes_per_bar.
    """
    cfg = config or default_config()
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, style_id, bars]))
    npb = cfg.notes_per_bar
    T = bars * npb
    roll = np.zeros((T, cfg.midi_max_notes, 3), np.float64)

    tonic, mode = _style_scale(style_id, cfg)
    progression = _PROGRESSIONS[style_id % len(_PROGRESSIONS)]

    def degree_pitch(degree: int, octave: int = 0) -> int:
        return tonic + 12 * (octave + degree // 7) + mode[degree % 7]

    def put(t0: int, dur: int, pitch: int, vol: float) -> None:
        if not (cfg.min_note <= pitch < cfg.max_note):
            return
        dur = min(dur, T - t0)
        # Re-articulation if the same pitch is already sounding at t0.
        # A re-struck note KEEPS the sounding volume: the decoder's pinned
        # replay quirk (codec.py module doc) carries the previous volume
        # through a re-articulation, so this is the only volume a replay
        # cell can round-trip to — the corpus stays a codec fixed point.
        if t0 > 0 and roll[t0 - 1, pitch, 0] > 0:
            roll[t0, pitch, 1] = 1.0
            vol = roll[t0 - 1, pitch, 2]
        roll[t0:t0 + dur, pitch, 0] = 1.0
        roll[t0:t0 + dur, pitch, 2] = vol

    # Left hand: one root-position triad per bar, held a whole bar, with a
    # re-struck root on beat 3 (replay material).
    for bar in range(bars):
        deg = progression[bar % len(progression)]
        root = degree_pitch(deg, octave=-1)
        vol = 0.55 + 0.05 * ((bar % 4) == 0)
        for chord_deg in (0, 2, 4):
            put(bar * npb, npb, degree_pitch(deg + chord_deg, octave=-1), vol)
        put(bar * npb + npb // 2, npb // 2, root, vol)     # re-strike

    # Right hand: scale-wise melody in 8th notes (every 2 steps), mostly
    # steps with occasional leaps, accent on the downbeat.
    degree = 7          # start an octave above the tonic
    for t in range(0, T, 2):
        if rng.random() < 0.12:
            continue                         # breathe
        move = rng.choice([-4, -2, -1, 0, 1, 2, 4],
                          p=[.08, .08, .27, .14, .27, .08, .08])
        degree = int(np.clip(degree + move, 4, 17))
        beat_pos = t % npb
        accent = 0.9 if beat_pos == 0 else (0.75 if beat_pos % 4 == 0 else 0.6)
        dur = 4 if (rng.random() < 0.15) else 2
        put(t, dur, degree_pitch(degree), accent)

    # Quantize volumes to exact MIDI velocities so encode→decode round-trips
    # to the same grid values.
    vel = np.round(roll[..., 2] * cfg.max_velocity)
    roll[..., 2] = vel / cfg.max_velocity
    roll[..., 0] = (roll[..., 2] > 0).astype(np.float64)
    return roll


def _encode_replay_preserving(roll: np.ndarray, cfg: Config):
    """Encode a [T, 128, 3] roll as a Pattern whose re-articulations SURVIVE
    the decoder.

    `midi_encode` — bit-for-bit with the reference — emits a replay as a
    same-instant NoteOff+NoteOn pair on the frame grid, where the decoder's
    pinned quirk (codec.py module doc: the reference's downsample buffer is
    reset at frame boundaries, ref: midi_util.py:136-148) suppresses replay
    detection — so ANY roll self-round-tripped through the reference codec
    loses its replay channel (a corpus written that way would train the
    replay head on all-zero targets).  Real corpora
    don't, because their re-articulations land at arbitrary ticks INSIDE
    frames.  This writer reproduces that shape: 4 ticks per roll row
    (resolution = 4 × notes_per_beat), note boundaries on the row grid, and
    each re-articulation as a bare NoteOn over the sounding note one tick
    into its frame — which the decoder maps back to (replay=1, previous
    volume kept) in exactly the source row."""
    from music_generator_tpu_torch.midi.events import (
        EndOfTrackEvent, NoteOffEvent, NoteOnEvent, Pattern, Track)

    S = 4                                   # ticks per roll row
    play, replay, volume = roll[..., 0], roll[..., 1], roll[..., 2]
    T, classes = play.shape
    events = []                             # (abs_tick, NoteOn?, pitch, vel)
    current = np.zeros(classes)
    for t in range(T):
        row = play[t]
        for p in np.nonzero((current > 0) & (row == 0))[0]:
            events.append((S * t, False, int(p), 0))
        for p in np.nonzero((row > 0) & (current == 0))[0]:
            events.append((S * t, True, int(p),
                           int(round(volume[t, p] * cfg.max_velocity))))
        for p in np.nonzero((current > 0) & (row > 0) & (replay[t] > 0))[0]:
            events.append((S * t + 1, True, int(p),
                           int(round(volume[t, p] * cfg.max_velocity))))
        current = row
    for p in np.nonzero(current > 0)[0]:
        events.append((S * T, False, int(p), 0))
    events.sort(key=lambda e: e[0])         # stable: off<on<replay per tick

    track = Track()
    last = 0
    for tick, is_on, pitch, vel in events:
        if is_on:
            track.append(NoteOnEvent(tick=tick - last, velocity=vel,
                                     pitch=pitch))
        else:
            track.append(NoteOffEvent(tick=tick - last, pitch=pitch))
        last = tick
    # Pin the decoded length to T rows (+ the decoder's tail frame) even if
    # the piece ends in silence: EndOfTrack's tick advances the decoder's
    # clock (codec.py:82-87).
    track.append(EndOfTrackEvent(tick=S * T - last))
    return Pattern([track], resolution=cfg.notes_per_beat * S, fmt=1)


def write_synth_corpus(root: str, styles: Optional[Sequence[int]] = None,
                       files_per_style: int = 3, bars: int = 16,
                       seed: int = 0, shift: int = 0,
                       config: Optional[Config] = None) -> list:
    """Write a .mid corpus under `root` using the config's style-directory
    taxonomy (so load_all() consumes it unchanged).  Returns written paths.

    `shift` transposes every piece by that many semitones through the SAME
    transform training augmentation uses (dataset.transpose_augment), for
    pitch-invariance evaluation corpora."""
    from music_generator_tpu_torch.data.dataset import transpose_augment
    from music_generator_tpu_torch.midi.io import write_midifile

    cfg = config or default_config()
    if styles is None:
        styles = range(len(cfg.flat_styles))
    paths = []
    for style_id in styles:
        d = os.path.join(root, cfg.flat_styles[style_id])
        os.makedirs(d, exist_ok=True)
        for i in range(files_per_style):
            roll = synth_piece(style_id, bars=bars, seed=seed + i, config=cfg)
            # Shift the CLAMPED view (clamp -> shift -> unclamp), exactly
            # as training augmentation does on clamped windows: notes
            # shifted across the clamp boundary are zeroed.
            clamped = transpose_augment(
                roll[:, cfg.min_note:cfg.max_note], shift)
            roll = np.zeros_like(roll)
            roll[:, cfg.min_note:cfg.max_note] = clamped
            path = os.path.join(d, f"synth_{style_id}_{i}.mid")
            write_midifile(path, _encode_replay_preserving(roll, cfg))
            paths.append(path)
    return paths


def random_batch(cfg: Config, batch_size: Optional[int] = None, seed: int = 0,
                 rolled_targets: bool = False) -> tuple:
    """One seeded synthetic training batch (notes, targets, beats, styles)
    with the model's input geometry, bit-equal to the JAX package's
    `random_batch` for the same seed.

    `rolled_targets=True` makes the target the one-step-shifted notes (the
    training alignment); otherwise targets are an independent draw from the
    same stream (for gradient-parity checks)."""
    B = batch_size or cfg.batch_size
    T, N = cfg.seq_len, cfg.num_notes
    rng = np.random.default_rng(seed)
    notes = (rng.random((B, T, N, 3)) < 0.1).astype(np.float32)
    if rolled_targets:
        targets = np.roll(notes, -1, axis=1)
    else:
        targets = (rng.random((B, T, N, 3)) < 0.1).astype(np.float32)
    beats = np.zeros((B, T, cfg.notes_per_bar), np.float32)
    beats[:, np.arange(T), np.arange(T) % cfg.notes_per_bar] = 1
    styles = np.zeros((B, T, cfg.num_styles), np.float32)
    styles[..., 0] = 1
    return notes, targets, beats, styles


def pitch_class_histogram(roll: np.ndarray) -> np.ndarray:
    """Normalized played-mass per pitch class of a [T, P, 3] roll (P = 128
    or num_notes with an offset baked in by the caller)."""
    play = roll[..., 0]
    classes = np.arange(roll.shape[1]) % 12
    hist = np.zeros(12)
    for c in range(12):
        hist[c] = play[:, classes == c].sum()
    total = hist.sum()
    return hist / total if total > 0 else hist
