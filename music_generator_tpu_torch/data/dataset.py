"""Dataset pipeline (ref: dataset.py): own copies of the JAX package's
`data/dataset.py` helpers.  Walk style directories -> decode (cached,
parallel) -> clamp to the modeled pitch range -> window into (X, Y-shifted)
training sequences with beat and style conditioning.

As in the JAX package: windowing is vectorized, file decode fans out over a
thread pool, file order is deterministic, batches have fixed shapes, and
octave-transpose augmentation is optional (off by default).  Data
parallelism takes `Dataset.shard` (each rank's rows, padded to equal
lengths), `shard_validity` (which of them are real) and
`block_epoch_permutation` (the sharded epoch's batch stream), equal to
the JAX package's array for array."""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from music_generator_tpu_torch.config import Config, default_config
from music_generator_tpu_torch.midi.codec import load_midi
from music_generator_tpu_torch.utils import get_all_files, one_hot


def compute_beat(beat: int, notes_in_bar: int) -> np.ndarray:
    """One-hot position within the bar (ref: dataset.py:14-15)."""
    return one_hot(beat % notes_in_bar, notes_in_bar)


def compute_completion(beat: int, len_melody: int) -> np.ndarray:
    """Fractional position in the piece (ref: dataset.py:17-18; unused there
    too, kept for API parity)."""
    return np.array([beat / len_melody])


def compute_genre(genre_id: int, config: Optional[Config] = None) -> np.ndarray:
    """Uniform style mass over one genre's composers (ref: dataset.py:20-26)."""
    cfg = config or default_config()
    genre_hot = np.zeros((cfg.num_styles,))
    start_index = sum(len(s) for i, s in enumerate(cfg.styles) if i < genre_id)
    styles_in_genre = len(cfg.styles[genre_id])
    genre_hot[start_index:start_index + styles_in_genre] = 1 / styles_in_genre
    return genre_hot


def stagger(data: np.ndarray, time_steps: int,
            hop: int) -> Tuple[np.ndarray, np.ndarray]:
    """Window a [L, ...] sequence into X=[N, time_steps, ...] and the one-step
    shifted Y, after prepending `time_steps` zero-frames (ref:
    dataset.py:28-37, vectorized).  N = ceil(L / hop) windows at starts
    0, hop, 2*hop, ... < L."""
    data = np.asarray(data)
    L = len(data)
    padded = np.concatenate(
        [np.zeros((time_steps,) + data.shape[1:], dtype=data.dtype), data])
    starts = np.arange(0, L, hop)
    idx = starts[:, None] + np.arange(time_steps + 1)[None, :]
    windows = padded[idx]
    return windows[:, :-1], windows[:, 1:]


def clamp_midi(sequence: np.ndarray, config: Optional[Config] = None) -> np.ndarray:
    """Clamp a [T, 128, 3] roll to the modeled note range
    (ref: dataset.py:78-82)."""
    cfg = config or default_config()
    return sequence[:, cfg.min_note:cfg.max_note, :]


def unclamp_midi(sequence: np.ndarray, config: Optional[Config] = None) -> np.ndarray:
    """Left-pad the clamped pitch axis back to MIDI note numbers
    (ref: dataset.py:84-88)."""
    cfg = config or default_config()
    return np.pad(sequence, ((0, 0), (cfg.min_note, 0), (0, 0)), "constant")


def decode_prime(source, prime_bars: Optional[int] = None,
                 max_bars: int = 4096,
                 config: Optional[Config] = None) -> np.ndarray:
    """Decode a .mid (path or file-like) into a clamped [T, num_notes, 3]
    roll for primed continuation (`generate --prime`), bypassing
    load_midi's cache.  `prime_bars` keeps the first K bars.  Raises
    ValueError for unparseable input, for negative prime_bars and for
    primes longer than `max_bars` bars (the prime advance is O(length)
    device work)."""
    from music_generator_tpu_torch.midi.codec import midi_decode
    from music_generator_tpu_torch.midi.io import read_midifile

    cfg = config or default_config()
    try:
        roll = midi_decode(read_midifile(source), cfg.midi_max_notes,
                           config=cfg)
    except Exception as e:
        raise ValueError(f"not a valid MIDI file: {e}")
    roll = clamp_midi(roll, cfg)
    if prime_bars is not None:
        prime_bars = int(prime_bars)
        if prime_bars < 0:
            raise ValueError(f"prime_bars must be >= 0, got {prime_bars}")
        roll = roll[:prime_bars * cfg.notes_per_bar]
    if roll.shape[0] > max_bars * cfg.notes_per_bar:
        raise ValueError(
            f"prime too long (> {max_bars * cfg.notes_per_bar} steps)")
    return roll


def transpose_augment(seq: np.ndarray, shift: int) -> np.ndarray:
    """Transpose a clamped [T, num_notes, 3] roll by `shift` semitones,
    zero-filling the vacated edge."""
    if shift == 0:
        return seq
    out = np.zeros_like(seq)
    if shift > 0:
        out[:, shift:] = seq[:, :-shift]
    else:
        out[:, :shift] = seq[:, -shift:]
    return out


@dataclasses.dataclass
class Dataset:
    """Fully materialized training arrays (the corpus is small — the
    reference also materializes everything, ref: dataset.py:72-76)."""

    notes: np.ndarray        # [N, T, num_notes, 3] float32
    targets: np.ndarray      # [N, T, num_notes, 3] float32 (one-step shift)
    beats: np.ndarray        # [N, T, notes_per_bar] float32
    styles: np.ndarray       # [N, T, num_styles] float32
    # Set by shard(): (shard_index, shard_count, global_rows), so that a
    # consumer can tell wrap-padded duplicate rows from real ones, for any
    # shard (Trainer.evaluate weights every rank's duplicates out).
    shard_info: Optional[Tuple[int, int, int]] = None

    def __len__(self) -> int:
        return len(self.notes)

    def shard(self, index: int, count: int) -> "Dataset":
        """Rank `index`'s rows of `count`: rows index, index + count, ...
        wrap-padded to the same length ceil(n / count) on every rank, since
        every train step is a collective and a rank with one row fewer
        would run one step fewer and deadlock the group.  At most one
        duplicate row a rank; exact consumers use `shard_validity`."""
        n = len(self.notes)
        want = -(-n // count) if n else 0
        idx = (index + count * np.arange(want)) % max(n, 1)
        return Dataset(self.notes[idx], self.targets[idx],
                       self.beats[idx], self.styles[idx],
                       shard_info=(index, count, n))

    def shard_validity(self, index: Optional[int] = None) -> np.ndarray:
        """[len(self)] float mask, 1.0 for real rows and 0.0 for wrap-padded
        duplicates, of shard `index` (default: this one) of the same
        shard() call, so that every rank can build every other's."""
        if self.shard_info is None:
            return np.ones(len(self), np.float64)
        own, count, n_global = self.shard_info
        q = own if index is None else index
        return ((q + count * np.arange(len(self))) < n_global).astype(
            np.float64)


def _load_style_files(files: Sequence[str], cfg: Config) -> List[np.ndarray]:
    if not files:
        return []

    def safe_load(f):
        # Real-world corpora contain malformed files: skip with a warning
        # instead of aborting the whole run (the reference would crash).
        try:
            return load_midi(f, cfg)
        except Exception as e:
            print(f"skipping unreadable MIDI {f}: {type(e).__name__}: {e}")
            return None

    with ThreadPoolExecutor() as pool:
        return [r for r in pool.map(safe_load, files) if r is not None]


def load_all(styles: Optional[Sequence[Sequence[str]]] = None,
             time_steps: Optional[int] = None,
             config: Optional[Config] = None) -> Dataset:
    """Load every style directory into windowed training arrays
    (ref: dataset.py:39-76)."""
    cfg = config or default_config()
    if styles is None:
        styles = cfg.styles
    if time_steps is None:
        time_steps = cfg.seq_len
    hop = cfg.notes_per_bar

    note_data, note_target, beat_data, style_data = [], [], [], []

    flat_styles = [y for x in styles for y in x]
    for style_id, style in enumerate(flat_styles):
        style_hot = one_hot(style_id, cfg.num_styles).astype(np.float32)
        seqs = _load_style_files(get_all_files([style]), cfg)

        for seq in seqs:
            if len(seq) < time_steps:
                # Too short to fill one window (ref: dataset.py:59).
                continue
            clamped = clamp_midi(seq, cfg).astype(np.float32)
            shifts = [0]
            if cfg.transpose_augment > 0:
                k = cfg.transpose_augment
                shifts = list(range(-k, k + 1))
            # Beat and style windows depend only on the piece length: built
            # once per piece and reused for every shift.
            beats = np.eye(cfg.notes_per_bar, dtype=np.float32)[
                np.arange(len(clamped)) % cfg.notes_per_bar]
            beat_windows = stagger(beats, time_steps, hop)[0]
            style_rows = np.tile(style_hot, (len(clamped), 1))
            style_windows = stagger(style_rows, time_steps, hop)[0]
            for shift in shifts:
                s = transpose_augment(clamped, shift)
                x, y = stagger(s, time_steps, hop)
                note_data.append(x)
                note_target.append(y)
                beat_data.append(beat_windows)
                style_data.append(style_windows)

    if not note_data:
        T, N = time_steps, cfg.num_notes
        return Dataset(
            np.zeros((0, T, N, 3), np.float32),
            np.zeros((0, T, N, 3), np.float32),
            np.zeros((0, T, cfg.notes_per_bar), np.float32),
            np.zeros((0, T, cfg.num_styles), np.float32))

    return Dataset(
        np.concatenate(note_data).astype(np.float32),
        np.concatenate(note_target).astype(np.float32),
        np.concatenate(beat_data).astype(np.float32),
        np.concatenate(style_data).astype(np.float32))


def epoch_permutation(n: int, batch_size: int, rng: np.random.Generator,
                      drop_remainder: bool = True) -> np.ndarray:
    """The epoch's shuffled sample indices as an [S, batch_size] matrix.
    With drop_remainder=False the final short batch wraps around
    (np.resize cycles, so datasets smaller than a batch still fill one)."""
    perm = rng.permutation(n)
    if not drop_remainder and n % batch_size:
        pad = batch_size - n % batch_size
        perm = np.concatenate([perm, np.resize(perm, pad)])
    S = len(perm) // batch_size
    return perm[:S * batch_size].reshape(S, batch_size)


def block_epoch_permutation(block_len: int, n_blocks: int,
                            per_block_batch: int,
                            rng: np.random.Generator) -> np.ndarray:
    """One epoch's shuffled block-local indices for the sharded epoch: an
    [S, n_blocks * per_block_batch] int32 matrix whose column block d
    indexes rank d's resident [block_len] rows.  Each block shuffles on its
    own and every batch takes per_block_batch rows of every block (a
    stratified shuffle); a block that does not divide wraps its final rows
    (np.resize cycles).  Every rank computes the same matrix from the
    shared epoch rng, so the ranks stay in step without sending indices."""
    if block_len <= 0 or per_block_batch <= 0 or n_blocks <= 0:
        raise ValueError("block_len, n_blocks, per_block_batch must be >= 1")
    S = -(-block_len // per_block_batch)
    want = S * per_block_batch
    cols = []
    for _ in range(n_blocks):
        perm = rng.permutation(block_len)
        if want > block_len:
            perm = np.concatenate([perm, np.resize(perm, want - block_len)])
        cols.append(perm.reshape(S, per_block_batch))
    return np.concatenate(cols, axis=1).astype(np.int32)


def batches(ds: Dataset, batch_size: int, *, rng: np.random.Generator,
            drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, ...]]:
    """Shuffled fixed-shape batches for one epoch."""
    if len(ds) == 0:
        return
    for sel in epoch_permutation(len(ds), batch_size, rng, drop_remainder):
        yield (ds.notes[sel], ds.targets[sel], ds.beats[sel], ds.styles[sel])
