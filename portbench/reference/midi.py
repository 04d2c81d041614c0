"""A Standard MIDI File read back into what it can say of a generated
piece, in plain Python: the reference of the served cells decodes the
service's `.mid` bytes with it.

The service writes one track at 4 ticks a beat, one tick a timestep: a
note-on (with velocity int(volume * 127)) where a pitch starts, a
note-off where it stops, and an off and an on at the same tick where a
sounding pitch is replayed; pitches are MIDI numbers, the model's pitch
index plus `min_note`.  So the file gives every timestep's play bit, the
replay bit wherever the pitch sounded the step before, and the velocity
byte of every onset and replay.  Only a timestep at which the set of
sounding pitches changes writes events, so a replay at any other step is
not in the file."""

from __future__ import annotations

import numpy as np


def _varlen(data: bytes, i: int):
    value = 0
    while True:
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if b < 0x80:
            return value, i


def note_events(data: bytes):
    """[(tick, pitch, velocity)] of every note event in the file's tracks,
    in file order; a note-off, or a note-on of velocity 0, has velocity
    None."""
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    hlen = int.from_bytes(data[4:8], "big")
    i = 8 + hlen
    out = []
    while i < len(data):
        kind, n = data[i:i + 4], int.from_bytes(data[i + 4:i + 8], "big")
        i += 8
        end = i + n
        if kind != b"MTrk":
            i = end
            continue
        tick, status = 0, None
        while i < end:
            delta, i = _varlen(data, i)
            tick += delta
            if data[i] >= 0x80:
                status = data[i]
                i += 1
            if status == 0xFF:
                i += 1
                length, i = _varlen(data, i)
                i += length
                status = None
            elif status in (0xF0, 0xF7):
                length, i = _varlen(data, i)
                i += length
                status = None
            else:
                hi = status >> 4
                width = 1 if hi in (0xC, 0xD) else 2
                args = data[i:i + width]
                i += width
                if hi == 0x9 and args[1] > 0:
                    out.append((tick, args[0], int(args[1])))
                elif hi in (0x8, 0x9):
                    out.append((tick, args[0], None))
        i = end
    return out


def decode(data: bytes, steps: int, num_notes: int, min_note: int):
    """The piece of `steps` timesteps: play [T, N] (exact), replay [T, N]
    with -1 where the file cannot tell (an onset, or a step at which no
    pitch starts or stops), velocity [T, N] with -1 where the file holds
    none."""
    play = np.zeros((steps, num_notes), np.int8)
    replay = np.full((steps, num_notes), -1, np.int8)
    vel = np.full((steps, num_notes), -1, np.int16)
    start = {}
    off_at = {}
    for tick, pitch, v in note_events(data):
        p = pitch - min_note
        if v is None:
            if p in start:
                play[start.pop(p):tick, p] = 1
                off_at[p] = tick
        else:
            vel[tick, p] = v
            replay[tick, p] = 1 if off_at.get(p) == tick else -1
            start[p] = tick
    for p, t0 in start.items():
        play[t0:, p] = 1
    before = np.zeros_like(play)
    before[1:] = play[:-1]
    changed = (play != before).any(axis=1)[:, None]
    # A held pitch at a step that wrote events and did not replay it;
    # a silent pitch replays nothing.
    replay[(play == 1) & (before == 1) & (replay != 1) & changed] = 0
    replay[play == 0] = 0
    return play, replay, vel
