"""MIDI subsystem of the port: event model, binary Standard-MIDI-File IO and
the piano-roll codec — own copies of the JAX package's jax-free modules, so
the port writes the same bytes."""

from music_generator_tpu_torch.midi.codec import (
    load_midi,
    midi_decode,
    midi_encode,
)
from music_generator_tpu_torch.midi.events import (
    EndOfTrackEvent,
    Event,
    MetaEvent,
    NoteOffEvent,
    NoteOnEvent,
    Pattern,
    Track,
)
from music_generator_tpu_torch.midi.io import read_midifile, write_midifile

__all__ = [
    "Event",
    "NoteOnEvent",
    "NoteOffEvent",
    "EndOfTrackEvent",
    "MetaEvent",
    "Pattern",
    "Track",
    "read_midifile",
    "write_midifile",
    "midi_decode",
    "midi_encode",
    "load_midi",
]
