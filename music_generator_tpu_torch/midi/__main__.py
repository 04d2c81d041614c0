"""Codec round-trip smoke tool (ref: midi_util.py:212-217's __main__):

    python -m music_generator_tpu_torch.midi in.mid out.mid

Decodes `in.mid` to a piano roll and re-encodes it to `out.mid` — the
byte-level inspection harness for codec debugging.  The text and bytes of
the JAX package's `python -m music_generator_tpu.midi`.
"""

import sys

from music_generator_tpu_torch.midi.codec import midi_decode, midi_encode
from music_generator_tpu_torch.midi.io import read_midifile, write_midifile


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    src, dst = argv
    pattern = read_midifile(src)
    roll = midi_decode(pattern)
    print(f"decoded {src}: {roll.shape[0]} frames, "
          f"{int(roll[..., 0].sum())} note-frames on")
    write_midifile(dst, midi_encode(roll))
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
