"""MIDI ⇄ piano-roll codec (the PyTorch port's own copy of the JAX
package's codec).  `load_midi` decodes with the native C++ decoder
(midi/native.py) where it builds, as the JAX package's does, else here in
Python; the two give the same rolls bit for bit.

The roll is a float array [T, classes, 3] with channels (play, replay, volume)
on a 16th-note grid — behavior-identical to the reference codec
(ref: midi_util.py:9-95 encode, 97-191 decode), including its quirks:

Decode (events → roll), ref: midi_util.py:97-191:
  * The event stream is conceptually expanded to a per-tick state timeline;
    frames of `step` ticks are aggregated with max-volume / any-replay
    (ref: midi_util.py:126-137).
  * Replay detection: a NoteOn over a sounding note sets replay=1 and KEEPS
    the previous volume (ref: midi_util.py:148-151) — but only when the
    reference's downsample buffer holds >1 entries, which is false exactly at
    frame-boundary ticks (tick % step == 0), where the buffer was just reset
    (ref: midi_util.py:136-137 vs :148).  We reproduce that.
  * The FINAL frame takes the volume at its first tick (not the window max)
    and any-replay over the leftover window (ref: midi_util.py:157-160).
  * Multi-track merge: pad to longest, then ADD rolls; play = ceil(volume);
    everything clamped to 1 (ref: midi_util.py:182-190).

Encode (roll → events), ref: midi_util.py:9-95:
  * Row diffs emit NoteOn / NoteOff / (NoteOff,NoteOn) pairs in ascending
    pitch order; `last_event_tick` advances at the first event of a row so
    later same-row events get delta 0 (ref: midi_util.py:38-70).
  * A replay flag with no play-row change emits nothing (the row-equality
    gate, ref: midi_util.py:35).
  * Held notes are flushed with NoteOffs after the last row; EndOfTrack's
    delta is the trailing no-op row count, NOT scaled by `step`
    (ref: midi_util.py:77-93).
  * A play=1 / volume=0 cell emits NoteOn with velocity 0 (ref:
    midi_util.py:41-45 — velocity = volume*127 unconditionally), which MIDI
    consumers — including this decoder (play = ceil(volume) = 0) — treat as
    note-off: such a note is silently absent from a re-decode.  The sampler
    can produce the combination (volume head clipped to 0 on a played
    step), so a piece primed from its own written .mid may differ there.
    Kept as-is: "fixing" it (a velocity floor) would change encoder bytes
    vs the reference (pinned: test_codec.py::test_encode_zero_volume...).

This implementation is vectorized: decode runs one Python pass over events
(state tracking) + numpy frame aggregation; encode loops only over changed
rows/transitions.  No per-tick Python loops.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from music_generator_tpu_torch.config import Config, default_config
from music_generator_tpu_torch.midi.events import (
    EndOfTrackEvent,
    NoteOffEvent,
    NoteOnEvent,
    Pattern,
    Track,
)
from music_generator_tpu_torch.midi.io import read_midifile


# ---------------------------------------------------------------------------
# Decode: events → piano roll
# ---------------------------------------------------------------------------

def _decode_track(track, classes: int, step: int):
    """Scan one track's events → (total_ticks, per-pitch volume/replay events).

    Returns (num_frames, volume [F, classes], replay [F, classes]).
    """
    # Per-pitch event records: post-event volume value at each absolute tick
    # (same-tick events collapse to the final value).
    vol_ticks = [[] for _ in range(classes)]
    vol_vals = [[] for _ in range(classes)]
    replay_ticks = []   # (tick, pitch); always tick % step != 0 (see module doc)
    replay_pitches = []

    cur = 0              # absolute tick of the current event position
    vol = np.zeros(classes)       # state at tick `cur` (post events so far)
    vol_prev = np.zeros(classes)  # state at tick `cur - 1`

    def record(pitch, value):
        lst_t, lst_v = vol_ticks[pitch], vol_vals[pitch]
        if lst_t and lst_t[-1] == cur:
            lst_v[-1] = value
        else:
            lst_t.append(cur)
            lst_v.append(value)

    for event in track:
        if event.tick:
            vol_prev = vol.copy()
            cur += event.tick
        if isinstance(event, EndOfTrackEvent):
            break
        if isinstance(event, NoteOnEvent):
            pitch, velocity = event.pitch, event.velocity
            if pitch >= classes:
                raise IndexError(f"pitch {pitch} >= classes {classes}")
            value = velocity / 127.0
            # Replay: NoteOn over a sounding note keeps the previous volume —
            # skipped at frame-boundary ticks (ref: midi_util.py:148-151 and
            # the buffer reset at :136-137).
            if cur % step != 0 and vol_prev[pitch] > 0 and value > 0:
                if not replay_ticks or replay_ticks[-1] != cur or replay_pitches[-1] != pitch:
                    replay_ticks.append(cur)
                    replay_pitches.append(pitch)
                value = vol_prev[pitch]
            vol[pitch] = value
            record(pitch, value)
        elif isinstance(event, NoteOffEvent):
            pitch = event.pitch
            if pitch >= classes:
                raise IndexError(f"pitch {pitch} >= classes {classes}")
            vol[pitch] = 0.0
            record(pitch, 0.0)

    total_ticks = cur
    m = total_ticks // step          # in-loop frames (ref: midi_util.py:126)
    num_frames = m + 1               # + the tail frame (ref: midi_util.py:157-160)
    if num_frames > 1 << 20:
        # ~18 hours of music at the reference grid — far beyond any real
        # piece.  Corrupted delta-ticks otherwise chain into a multi-GB
        # np.zeros whose lazily-committed pages blow up only when touched;
        # fail at the boundary instead (the native decoder enforces the
        # same kMaxFrames bound; dataset.py's safe_load skips the file).
        raise ValueError(
            f"MIDI duration {num_frames} frames exceeds the 2^20 bound "
            f"(corrupt delta-ticks?)")

    volume = np.zeros((num_frames, classes))
    replay = np.zeros((num_frames, classes))

    frame_starts = np.arange(num_frames) * step
    for p in range(classes):
        if not vol_ticks[p]:
            continue
        ticks = np.asarray(vol_ticks[p])
        vals = np.asarray(vol_vals[p])
        # Sampled state at each frame-start tick (post same-tick events).
        idx = np.searchsorted(ticks, frame_starts, side="right") - 1
        sampled = np.where(idx >= 0, vals[np.maximum(idx, 0)], 0.0)
        volume[:, p] = sampled
        # In-loop frames take the window max: events strictly inside a window
        # raise its max (ref: midi_util.py:132); the tail frame does NOT
        # (ref: midi_util.py:160 keeps buffer[0]).
        inner = ticks % step != 0
        if inner.any():
            f = ticks[inner] // step
            keep = f < m
            if keep.any():
                np.maximum.at(volume[:, p], f[keep], vals[inner][keep])

    if replay_ticks:
        f = np.asarray(replay_ticks) // step
        replay[f, np.asarray(replay_pitches)] = 1.0

    return volume, replay


def midi_decode(pattern: Pattern,
                classes: int = 128,
                step: Optional[int] = None,
                config: Optional[Config] = None) -> np.ndarray:
    """Decode a MIDI pattern into a [T, classes, 3] (play, replay, volume)
    piano roll (ref: midi_util.py:97-191)."""
    cfg = config or default_config()
    if step is None:
        step = pattern.resolution // cfg.notes_per_beat
    if step <= 0:
        # A (possibly corrupt) resolution below notes_per_beat would
        # otherwise surface as a bare ZeroDivisionError deep in the
        # frame math — raise the contract violation at the boundary.
        raise ValueError(
            f"unsupported MIDI resolution {pattern.resolution} "
            f"(needs >= {cfg.notes_per_beat} ticks/beat)")

    merged_volume = None
    merged_replay = None
    for track in pattern:
        volume, replay = _decode_track(track, classes, step)
        if merged_volume is None:
            merged_volume, merged_replay = volume, replay
        else:
            # Pad the shorter to the longer, then ADD (ref: midi_util.py:170-186).
            if len(volume) > len(merged_volume):
                volume, merged_volume = merged_volume, volume
                replay, merged_replay = merged_replay, replay
            diff = len(merged_volume) - len(volume)
            merged_volume = merged_volume + np.pad(volume, ((0, diff), (0, 0)))
            merged_replay = merged_replay + np.pad(replay, ((0, diff), (0, 0)))

    if merged_volume is None:
        return np.zeros((0, classes, 3))

    merged = np.stack([np.ceil(merged_volume), merged_replay, merged_volume],
                      axis=2)
    # Stacked duplicate notes must not exceed one (ref: midi_util.py:190).
    return np.minimum(merged, 1)


# ---------------------------------------------------------------------------
# Encode: piano roll → events
# ---------------------------------------------------------------------------

def midi_encode(note_seq: np.ndarray,
                resolution: Optional[int] = None,
                step: int = 1,
                config: Optional[Config] = None) -> Pattern:
    """Encode a [T, classes, 3] piano roll into a MIDI pattern
    (ref: midi_util.py:9-95)."""
    cfg = config or default_config()
    if resolution is None:
        resolution = cfg.notes_per_beat

    note_seq = np.asarray(note_seq)
    play = note_seq[:, :, 0]
    replay = note_seq[:, :, 1]
    volume = note_seq[:, :, 2]

    track = Track()
    pattern = Pattern([track], resolution=resolution, fmt=1)

    T, classes = play.shape
    current = np.zeros(classes)
    last_event_tick = 0
    noop_ticks = 0

    # Rows whose play vector changed vs. the previous row (row 0 compares to
    # silence).  Only those rows emit events (ref: midi_util.py:35).
    prev = np.vstack([np.zeros((1, classes)), play[:-1]])
    changed_rows = np.nonzero((play != prev).any(axis=1))[0]

    for tick in changed_rows:
        data = play[tick]
        noop_ticks = 0
        # Ascending pitch order, one transition per pitch
        # (ref: midi_util.py:38-70 via np.ndenumerate).
        onsets = np.nonzero((data > 0) & (current == 0))[0]
        offsets = np.nonzero((current > 0) & (data == 0))[0]
        replays = np.nonzero((current > 0) & (data > 0) & (replay[tick] > 0))[0]
        for index in np.sort(np.concatenate([onsets, offsets, replays])).tolist():
            delta = (tick - last_event_tick) * step
            if data[index] > 0 and current[index] == 0:
                track.append(NoteOnEvent(
                    tick=delta,
                    velocity=int(volume[tick][index] * cfg.max_velocity),
                    pitch=index))
            elif current[index] > 0 and data[index] == 0:
                track.append(NoteOffEvent(tick=delta, pitch=index))
            else:  # replay: off+on pair at the same instant
                track.append(NoteOffEvent(tick=delta, pitch=index))
                track.append(NoteOnEvent(
                    tick=0,
                    velocity=int(volume[tick][index] * cfg.max_velocity),
                    pitch=index))
            last_event_tick = tick
        current = data

    # Trailing unchanged rows accumulate no-op ticks (ref: midi_util.py:72-73).
    if T:
        last_changed = changed_rows[-1] if len(changed_rows) else -1
        noop_ticks = T - 1 - last_changed

    tick = T
    # Flush still-sounding notes (ref: midi_util.py:79-89).
    for index in np.nonzero(current > 0)[0].tolist():
        track.append(NoteOffEvent(tick=(tick - last_event_tick) * step,
                                  pitch=index))
        last_event_tick = tick
        noop_ticks = 0

    # EndOfTrack delta = trailing no-op rows, NOT scaled by step
    # (ref: midi_util.py:92).
    track.append(EndOfTrackEvent(tick=noop_ticks))
    return pattern


# ---------------------------------------------------------------------------
# Cached loading
# ---------------------------------------------------------------------------

def load_midi(fname: str, config: Optional[Config] = None) -> np.ndarray:
    """Load a MIDI file as a [T, 128, 3] roll, with a .npy cache keyed by the
    source path (ref: midi_util.py:193-210).  Unlike the reference — which
    parses the MIDI file even on cache hits (ref: midi_util.py:194) — the
    cache is checked first, and (a deliberate improvement; the reference
    never invalidates) a cache entry not strictly newer than its source
    file is re-decoded rather than silently served stale — `<=` so a
    source rewritten within the same filesystem-timestamp tick as the
    cache write still invalidates.  The conservative trade: while the two
    mtimes stay tied (possible on every load under coarse timestamp
    granularity, since each re-decode rewrites the cache) the file keeps
    re-decoding — correctness over the cache hit; a decode is cheap and
    ties vanish once the clock tick passes."""
    cfg = config or default_config()
    # Key the cache by the source path, but always UNDER cache_dir: the
    # reference's bare join (ref: midi_util.py:197) resolves an absolute
    # fname to the corpus directory itself, littering it with .npy files
    # (or crashing on read-only corpora) — review r4 finding.  Relative
    # paths (the standard data/<genre>/<composer> layout) are unchanged.
    # Escaped path segments ("/" roots and leading ".."s) become RESERVED
    # key components instead of being dropped: dropping them aliases
    # distinct sources onto one key ("../data/x.mid" vs "data/x.mid", or
    # "/data/x.mid" vs "data/x.mid") and the mtime guard can then serve
    # one file's roll for the other — review r4 finding.
    rel = os.path.normpath(os.path.splitdrive(fname)[1])
    parts = []
    if os.path.isabs(fname):
        parts.append("__abs__")
        rel = rel.lstrip(os.sep)
    while rel.startswith(".." + os.sep) or rel == "..":
        parts.append("__up__")
        rel = "" if rel == ".." else rel[3:]
    if rel:
        parts.append(rel)
    rel = os.path.join(*parts) if parts else "_root"
    cache_path = os.path.join(cfg.cache_dir, rel + ".npy")
    try:
        if os.path.getmtime(cache_path) <= os.path.getmtime(fname):
            raise OSError("stale cache")
        note_seq = np.load(cache_path)
    except Exception:
        # The native C++ decoder where it builds (midi/native.py; bit for
        # bit the Python codec's rolls), else the Python codec.
        from music_generator_tpu_torch.midi import native
        if native.available():
            note_seq = native.native_decode_file(fname, cfg.notes_per_beat)
        else:
            pattern = read_midifile(fname)
            note_seq = midi_decode(pattern, cfg.midi_max_notes, config=cfg)
        try:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.save(cache_path, note_seq)
        except OSError:
            # The cache is an optimization: a full disk / read-only
            # out_dir must not discard a successful decode (review r4:
            # the caller treats the exception as an unreadable MIDI and
            # silently drops the file from the corpus).
            pass

    assert len(note_seq.shape) == 3, note_seq.shape
    assert note_seq.shape[1] == cfg.midi_max_notes, note_seq.shape
    assert note_seq.shape[2] == 3, note_seq.shape
    assert (note_seq >= 0).all()
    assert (note_seq <= 1).all()
    return note_seq
