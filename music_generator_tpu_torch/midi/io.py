"""Standard MIDI File (SMF) binary reader/writer.

Self-written replacement for python-midi's `read_midifile`/`write_midifile`
(used by the reference at midi_util.py:194,217 and generate.py:134).  Handles
format 0/1 files, running status, variable-length deltas, meta and sysex
events; unknown events are preserved generically so real-world corpora
round-trip losslessly.
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Union

from music_generator_tpu_torch.midi.events import (
    CHANNEL_CLASSES,
    CHANNEL_DATA_BYTES,
    META_CLASSES,
    AfterTouchEvent,
    ChannelAfterTouchEvent,
    ChannelEvent,
    ControlChangeEvent,
    Event,
    MetaEvent,
    NoteOffEvent,
    NoteOnEvent,
    Pattern,
    PitchWheelEvent,
    ProgramChangeEvent,
    SysexEvent,
    Track,
)


def _read_varlen(buf: BinaryIO) -> int:
    value = 0
    # SMF bounds a variable-length quantity at 4 bytes (max 0x0FFFFFFF).
    # Reading on past that (as an unbounded loop would) lets one corrupted
    # continuation bit chain gigabyte-scale tick values into the decoder —
    # and diverges from the native parser, which rejects at the same bound
    # (tests/test_native_codec.py pins the parity).
    for _ in range(4):
        b = buf.read(1)
        if not b:
            raise EOFError("truncated variable-length quantity")
        byte = b[0]
        value = (value << 7) | (byte & 0x7F)
        if not byte & 0x80:
            return value
    raise ValueError("variable-length quantity exceeds the SMF 4-byte bound")


def _write_varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError(f"negative delta tick: {value}")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(chunks))


def _parse_track(data: bytes) -> Track:
    buf = io.BytesIO(data)
    track = Track()
    running_status = None
    while buf.tell() < len(data):
        tick = _read_varlen(buf)
        first = buf.read(1)
        if not first:
            break
        status = first[0]
        if status < 0x80:
            # Running status: first byte is data, reuse previous status.
            if running_status is None:
                raise ValueError("data byte with no running status")
            status = running_status
            buf.seek(-1, os.SEEK_CUR)

        if status == 0xFF:
            running_status = None
            mt = buf.read(1)
            if not mt:
                raise EOFError("truncated meta event")
            meta_type = mt[0]
            length = _read_varlen(buf)
            payload = buf.read(length)
            if len(payload) < length:
                # Same hardening as channel events below: a declared
                # length past EOF is a malformed file, not a short
                # payload (review r4: silent truncation here let a
                # crafted upload parse "successfully" with e.g. a
                # 0-byte SetTempo payload).
                raise EOFError("truncated meta event")
            cls = META_CLASSES.get(meta_type)
            if cls is not None:
                evt = cls.__new__(cls)
                Event.__init__(evt, tick)
                evt.meta_type = meta_type
                evt.payload = payload
            else:
                evt = MetaEvent(tick, meta_type, payload)
            track.append(evt)
            if meta_type == 0x2F:
                break
        elif status in (0xF0, 0xF7):
            running_status = None
            length = _read_varlen(buf)
            payload = buf.read(length)
            if len(payload) < length:
                raise EOFError("truncated sysex event")
            track.append(SysexEvent(tick, status, payload))
        else:
            nibble = status >> 4
            if nibble == 0xF:
                # System-common 0xF1-0xFE: not valid SMF track content and
                # not a channel event — fail loudly (and identically to the
                # native parser) instead of KeyError-ing below or, worse,
                # letting it become running status.
                raise ValueError(f"invalid status byte {status:#04x} "
                                 f"in track data")
            channel = status & 0x0F
            running_status = status
            n = CHANNEL_DATA_BYTES[nibble]
            d = buf.read(n)
            if len(d) < n:
                raise EOFError("truncated channel event")
            if nibble in (0x8, 0x9):
                track.append(CHANNEL_CLASSES[nibble](
                    tick=tick, pitch=d[0], velocity=d[1], channel=channel))
            elif nibble == 0xA:
                track.append(AfterTouchEvent(tick=tick, pitch=d[0], value=d[1],
                                             channel=channel))
            elif nibble == 0xB:
                track.append(ControlChangeEvent(tick=tick, control=d[0],
                                                value=d[1], channel=channel))
            elif nibble == 0xC:
                track.append(ProgramChangeEvent(tick=tick, value=d[0],
                                                channel=channel))
            elif nibble == 0xD:
                track.append(ChannelAfterTouchEvent(tick=tick, value=d[0],
                                                    channel=channel))
            elif nibble == 0xE:
                track.append(PitchWheelEvent(
                    tick=tick, pitch_bend=d[0] | (d[1] << 7), channel=channel))
    return track


def read_midifile(path_or_file: Union[str, os.PathLike, BinaryIO]) -> Pattern:
    """Parse a .mid file into a Pattern of Tracks of Events."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    buf = io.BytesIO(data)

    magic = buf.read(4)
    if magic != b"MThd":
        raise ValueError(f"not a MIDI file (bad header {magic!r})")
    (hdr_len,) = struct.unpack(">I", buf.read(4))
    fmt, ntracks, division = struct.unpack(">HHH", buf.read(6))
    if hdr_len > 6:
        buf.read(hdr_len - 6)
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")

    pattern = Pattern(resolution=division, fmt=fmt)
    for _ in range(ntracks):
        chunk = buf.read(4)
        if len(chunk) < 4:
            break
        (length,) = struct.unpack(">I", buf.read(4))
        body = buf.read(length)
        if chunk == b"MTrk":
            pattern.append(_parse_track(body))
        # Unknown chunk types are skipped per the SMF spec.
    return pattern


def _encode_event(evt: Event, out: bytearray) -> None:
    out += _write_varlen(evt.tick)
    if isinstance(evt, MetaEvent):
        out.append(0xFF)
        out.append(evt.meta_type)
        out += _write_varlen(len(evt.payload))
        out += evt.payload
    elif isinstance(evt, SysexEvent):
        out.append(evt.status)
        out += _write_varlen(len(evt.payload))
        out += evt.payload
    elif isinstance(evt, ChannelEvent):
        status = (type(evt).status_nibble << 4) | (evt.channel & 0x0F)
        out.append(status)
        if isinstance(evt, (NoteOnEvent, NoteOffEvent)):
            out += bytes([evt.pitch & 0x7F, evt.velocity & 0x7F])
        elif isinstance(evt, AfterTouchEvent):
            out += bytes([evt.pitch & 0x7F, evt.value & 0x7F])
        elif isinstance(evt, ControlChangeEvent):
            out += bytes([evt.control & 0x7F, evt.value & 0x7F])
        elif isinstance(evt, ProgramChangeEvent):
            out += bytes([evt.value & 0x7F])
        elif isinstance(evt, ChannelAfterTouchEvent):
            out += bytes([evt.value & 0x7F])
        elif isinstance(evt, PitchWheelEvent):
            out += bytes([evt.pitch_bend & 0x7F, (evt.pitch_bend >> 7) & 0x7F])
        else:  # pragma: no cover
            raise TypeError(f"unknown channel event {type(evt)}")
    else:  # pragma: no cover
        raise TypeError(f"unknown event {type(evt)}")


def write_midifile(path_or_file: Union[str, os.PathLike, BinaryIO],
                   pattern: Pattern) -> None:
    """Serialize a Pattern back to a .mid file (no running-status compression,
    matching python-midi's writer so byte-level goldens are stable).

    The header's format field is `pattern.fmt` as given (default 1, like
    python-midi's Pattern.format): the reference's published files are all
    format 1 with a single track, so forcing format 0 for single-track
    patterns (as this writer once did) broke both read→write losslessness
    and byte parity with reference-written files — review r4 finding; the
    committed sample artifacts were re-stamped under the fix."""
    fmt = getattr(pattern, "fmt", 1)
    body = bytearray()
    body += b"MThd" + struct.pack(">IHHH", 6, fmt, len(pattern),
                                  pattern.resolution)
    for track in pattern:
        tb = bytearray()
        has_eot = any(isinstance(e, MetaEvent) and e.meta_type == 0x2F
                      for e in track)
        for evt in track:
            _encode_event(evt, tb)
        if not has_eot:
            tb += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])
        body += b"MTrk" + struct.pack(">I", len(tb)) + tb

    if hasattr(path_or_file, "write"):
        path_or_file.write(bytes(body))
    else:
        with open(path_or_file, "wb") as f:
            f.write(bytes(body))
