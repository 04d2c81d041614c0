"""MIDI event model.

A minimal, self-written object model for Standard MIDI File events.  It covers
everything the framework needs (note on/off, end-of-track, tempo/time
signature metadata, generic channel/meta/sysex passthrough for lossless
re-serialization of real-world files).

The attribute surface mirrors what the reference code consumed from
python-midi (`event.tick`, `event.pitch`, `event.velocity`, `event.data`,
list-like `Pattern`/`Track` with a `resolution`) — ref: midi_util.py:38-93,
119-155 — but the implementation is original.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


class Event:
    """Base MIDI event: a delta `tick` plus payload."""

    __slots__ = ("tick",)

    def __init__(self, tick: int = 0):
        self.tick = int(tick)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        fields = ", ".join(
            f"{name}={getattr(self, name)!r}"
            for cls in type(self).__mro__
            for name in getattr(cls, "__slots__", ())
        )
        return f"{type(self).__name__}({fields})"

    def __eq__(self, other) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        names = [n for cls in type(self).__mro__ for n in getattr(cls, "__slots__", ())]
        return all(getattr(self, n) == getattr(other, n) for n in names)

    def __hash__(self):  # pragma: no cover
        return id(self)


class ChannelEvent(Event):
    """Voice-channel event (status nibble + channel)."""

    __slots__ = ("channel",)
    status_nibble: int = 0x0  # overridden by subclasses

    def __init__(self, tick: int = 0, channel: int = 0):
        super().__init__(tick)
        self.channel = int(channel)


class NoteEvent(ChannelEvent):
    __slots__ = ("pitch", "velocity")

    def __init__(self, tick: int = 0, pitch: int = 0, velocity: int = 0, channel: int = 0):
        super().__init__(tick, channel)
        self.pitch = int(pitch)
        self.velocity = int(velocity)

    @property
    def data(self) -> List[int]:
        """(pitch, velocity) pair, matching the tuple-unpack the reference's
        decoder uses (ref: midi_util.py:144,154)."""
        return [self.pitch, self.velocity]


class NoteOnEvent(NoteEvent):
    status_nibble = 0x9


class NoteOffEvent(NoteEvent):
    status_nibble = 0x8


class AfterTouchEvent(ChannelEvent):
    __slots__ = ("pitch", "value")
    status_nibble = 0xA

    def __init__(self, tick=0, pitch=0, value=0, channel=0):
        super().__init__(tick, channel)
        self.pitch = int(pitch)
        self.value = int(value)


class ControlChangeEvent(ChannelEvent):
    __slots__ = ("control", "value")
    status_nibble = 0xB

    def __init__(self, tick=0, control=0, value=0, channel=0):
        super().__init__(tick, channel)
        self.control = int(control)
        self.value = int(value)


class ProgramChangeEvent(ChannelEvent):
    __slots__ = ("value",)
    status_nibble = 0xC

    def __init__(self, tick=0, value=0, channel=0):
        super().__init__(tick, channel)
        self.value = int(value)


class ChannelAfterTouchEvent(ChannelEvent):
    __slots__ = ("value",)
    status_nibble = 0xD

    def __init__(self, tick=0, value=0, channel=0):
        super().__init__(tick, channel)
        self.value = int(value)


class PitchWheelEvent(ChannelEvent):
    __slots__ = ("pitch_bend",)
    status_nibble = 0xE

    def __init__(self, tick=0, pitch_bend=0x2000, channel=0):
        super().__init__(tick, channel)
        self.pitch_bend = int(pitch_bend)


class MetaEvent(Event):
    """Generic meta event (0xFF type len data)."""

    __slots__ = ("meta_type", "payload")

    def __init__(self, tick: int = 0, meta_type: int = 0, payload: bytes = b""):
        super().__init__(tick)
        self.meta_type = int(meta_type)
        self.payload = bytes(payload)


class EndOfTrackEvent(MetaEvent):
    def __init__(self, tick: int = 0):
        super().__init__(tick, meta_type=0x2F, payload=b"")


class SetTempoEvent(MetaEvent):
    """Tempo in microseconds per quarter note."""

    def __init__(self, tick: int = 0, mpqn: int = 500_000):
        super().__init__(tick, meta_type=0x51, payload=int(mpqn).to_bytes(3, "big"))

    @property
    def mpqn(self) -> int:
        return int.from_bytes(self.payload, "big")

    @property
    def bpm(self) -> float:
        return 60e6 / self.mpqn


class TimeSignatureEvent(MetaEvent):
    def __init__(self, tick: int = 0, numerator: int = 4, denominator: int = 4,
                 metronome: int = 24, thirty_seconds: int = 8):
        denom_pow = max(0, denominator.bit_length() - 1)
        super().__init__(tick, meta_type=0x58,
                         payload=bytes([numerator, denom_pow, metronome, thirty_seconds]))

    @property
    def numerator(self) -> int:
        return self.payload[0]

    @property
    def denominator(self) -> int:
        return 1 << self.payload[1]


class SysexEvent(Event):
    __slots__ = ("status", "payload")

    def __init__(self, tick: int = 0, status: int = 0xF0, payload: bytes = b""):
        super().__init__(tick)
        self.status = int(status)
        self.payload = bytes(payload)


class Track(list):
    """A list of Events."""

    def __init__(self, events: Optional[Iterable[Event]] = None):
        super().__init__(events or [])

    def __repr__(self) -> str:  # pragma: no cover
        inner = ",\n  ".join(repr(e) for e in self)
        return f"Track([\n  {inner}])"


class Pattern(list):
    """A list of Tracks plus the file-level `resolution` (ticks/quarter)."""

    def __init__(self, tracks: Optional[Iterable[Track]] = None,
                 resolution: int = 220, fmt: int = 1):
        super().__init__(tracks or [])
        self.resolution = int(resolution)
        self.fmt = int(fmt)

    def __repr__(self) -> str:  # pragma: no cover
        inner = ",\n ".join(repr(t) for t in self)
        return f"Pattern(resolution={self.resolution}, tracks=[\n {inner}])"


# Meta-type → convenience subclass used by the parser.
META_CLASSES = {
    0x2F: EndOfTrackEvent,
    0x51: SetTempoEvent,
    0x58: TimeSignatureEvent,
}

# Status nibble → channel-event subclass, and payload sizes.
CHANNEL_CLASSES = {
    0x8: NoteOffEvent,
    0x9: NoteOnEvent,
    0xA: AfterTouchEvent,
    0xB: ControlChangeEvent,
    0xC: ProgramChangeEvent,
    0xD: ChannelAfterTouchEvent,
    0xE: PitchWheelEvent,
}

CHANNEL_DATA_BYTES = {0x8: 2, 0x9: 2, 0xA: 2, 0xB: 2, 0xC: 1, 0xD: 1, 0xE: 2}
