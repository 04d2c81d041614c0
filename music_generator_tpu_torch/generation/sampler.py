"""Streaming autoregressive generation on the card (the JAX package's
`generation/sampler.py`).

Per timestep: the time-axis step (octave conv, note features, the two
time-axis LSTM cells, or GLRU steps, over G*N rows; plain PyTorch ops),
then the whole 48-pitch loop at any note-axis depth as ONE launch of the
notegen kernel (ops/notegen.py), then the adaptive-temperature update
(ref: generate.py:60-71).  The recurrent state is O(1) per step and crosses
chunk boundaries exactly.

Generation runs in `cfg.gen_dtype`, as the JAX Sampler does on its model
rebuilt at that compute dtype (sampler.py:80-81): the model's generation
steps read gen_dtype (models/deepj.py).  In float32 every matmul is full
float32 (device.full_f32).  In bfloat16 the card's matmuls sum in float32
while the Sampler runs (device.bf16_f32_sums), and the pitch loop runs
the kernel's bfloat16 instance of the flavor that the JAX Sampler's
route gives (`gen_flavor`), on weights cast once per Sampler.

Sampling semantics and RNG discipline are the JAX package's: stream g's
step-t uniforms are `uniform(fold_in(fold_in(key(seed), offset + g), t),
(N, 2))` (deviation #10), reproduced bit for bit by generation/prng.py and
drawn for a whole chunk in one batched call.  The same seed therefore
gives the same notes as the JAX `Sampler`, up to float32 knife edges.
Per-stream (seed, index, temperature) triples, batch padding (`pad_to`),
primed continuation (`prime`: the state is teacher-forced through a given
roll, consuming no randomness) and the incremental surface
(`begin` / `ActiveGeneration.advance`) keep that contract.

Data parallelism (parallel/mesh.py, one process per card): in a process
group of `world` ranks every rank makes the same calls with the same
arguments; the batch is padded to a multiple of lcm(pad_to, world), rank r
runs the contiguous block r of the streams through the same time step and
pitch-loop launch, and each chunk's notes are all-gathered rank-major, so
that every rank returns the whole result (the JAX sampler's `_mp_fns`
returns it replicated).  Stream-indexed uniforms make the bytes those of
the one-process run.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from music_generator_tpu_torch.config import Config
from music_generator_tpu_torch.data.dataset import unclamp_midi
from music_generator_tpu_torch.device import bf16_f32_sums, full_f32
from music_generator_tpu_torch.generation import prng
from music_generator_tpu_torch.midi.codec import midi_encode
from music_generator_tpu_torch.midi.io import write_midifile
from music_generator_tpu_torch.models.deepj import DeepJ
from music_generator_tpu_torch.ops.notegen import note_sample, note_weights
from music_generator_tpu_torch.parallel import mesh
from music_generator_tpu_torch.utils import spans


@functools.lru_cache(maxsize=None)
def _velocity_grid(max_velocity: int) -> np.ndarray:
    """Exact f32(k/max_velocity) grid for gen_volume_quantize, by IEEE true
    division on the host: a device-side x/127 may become a multiply by the
    reciprocal, whose 1-ULP-low results truncate to the wrong velocity
    through the encoder's int(v*max_velocity)."""
    return (np.arange(max_velocity + 1, dtype=np.float32)
            / np.float32(max_velocity))


def gen_flavor(cfg: Config, G: int, L: int) -> str:
    """The pitch loop's bfloat16 flavor for G streams at note depth L:
    "fused" exactly where the JAX Sampler takes the Pallas kernel
    (sampler.py:119-122: fused_gen_kernel, the LSTM kernel "pallas" --
    "auto" is "xla" off a TPU, deepj.py:195-205 -- two note layers,
    G <= fused_gen_max_batch and no gen_volume_quantize), else "scan".
    In float32 the two are one arithmetic."""
    fused = (cfg.fused_gen_kernel and cfg.lstm_kernel == "pallas" and L == 2
             and G <= cfg.fused_gen_max_batch
             and not cfg.gen_volume_quantize)
    return "fused" if fused else "scan"


class StepState(NamedTuple):
    time_state: Tuple            # per-layer (h, c), or (h,) when linear
    prev_note: torch.Tensor      # [G, N, 3] the notes chosen last step
    temperature: torch.Tensor    # [G] current (adaptive) temperature
    base_temp: torch.Tensor      # [G] reset value
    silent_time: torch.Tensor    # [G] int32
    stream_keys: torch.Tensor    # [G, 2] fold_in(key(seed), stream index)


@dataclasses.dataclass
class GenerationResult:
    notes: np.ndarray            # [G, T, N, 3]
    styles: np.ndarray           # [G, num_styles]


class Sampler:
    """Generates from a DeepJ on its device in `cfg.gen_dtype` (float32
    with TF32 off by default).  In bfloat16 the note axis's weights are
    cast when the Sampler is made: it generates from the weights as they
    were then."""

    def __init__(self, model: DeepJ, default_temp: float = 1.0):
        full_f32()
        self.model = model
        self.cfg = model.cfg
        self.default_temp = default_temp
        self.device = model.device
        cfg = self.cfg
        self._dt = model._gen_dt()
        self._weights = None
        self._bf16_card = (self._dt == torch.bfloat16
                           and self.device.type == "cuda")
        if self._bf16_card:
            self._weights = note_weights(model.note_axis, model.note_dense,
                                         model.volume_dense,
                                         cfg.time_axis_units)
        # Row r of _beats is the one-hot of beat r; the last row, all
        # zeros, is the beat row of step 0 (see _beat_row).
        self._beats = torch.cat([
            torch.eye(cfg.notes_per_bar),
            torch.zeros(1, cfg.notes_per_bar)]).to(self.device)
        self._vgrid = (torch.from_numpy(_velocity_grid(cfg.max_velocity))
                       .to(self.device) if cfg.gen_volume_quantize else None)

    # -- one timestep ------------------------------------------------------

    def _note_scan(self, feats: torch.Tensor, style_emb: torch.Tensor,
                   temperature: torch.Tensor,
                   us: torch.Tensor) -> torch.Tensor:
        """Sample all pitches of one timestep: feats [G, N, time_units],
        us [G, N, 2] -> [G, N, 3].  One kernel launch on the card.  The
        flavor's G is the whole batch, every rank's streams, as the JAX
        Sampler's is under a mesh."""
        m = self.model
        flavor = gen_flavor(self.cfg, feats.shape[0] * mesh.world(),
                            len(m.note_axis))
        return note_sample(feats, us, temperature, m.note_axis,
                           m.note_dense, m.volume_dense, style_emb,
                           self.cfg.lstm_recurrent_activation, self._vgrid,
                           self._dt, flavor, self._weights)

    def _beat_row(self, t: int, G: int) -> torch.Tensor:
        """The beat of step t-1 (the note consumed at step t was chosen at
        t-1; ref: generate.py:73-79); all zeros at t = 0."""
        row = (t - 1) % self.cfg.notes_per_bar if t > 0 else -1
        return self._beats[row].expand(G, -1)

    def _temperature_update(self, state: StepState, note_t: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Adaptive temperature (ref: generate.py:60-71): +0.1 per silent
        step once a full bar has been silent; reset on any note."""
        silent = note_t.sum(dim=(1, 2)) == 0
        silent_time = torch.where(silent, state.silent_time + 1,
                                  torch.zeros_like(state.silent_time))
        bump = silent & (silent_time >= self.cfg.notes_per_bar)
        temperature = torch.where(
            bump, state.temperature + 0.1,
            torch.where(silent, state.temperature, state.base_temp))
        return temperature, silent_time

    def _step(self, style_emb: torch.Tensor, state: StepState, t: int,
              us: torch.Tensor) -> Tuple[StepState, torch.Tensor]:
        G = style_emb.shape[0]
        with spans.span("gen.time_step"):
            feats, time_state = self.model.time_axis_step(
                state.prev_note, self._beat_row(t, G), style_emb,
                state.time_state)
        with spans.span("gen.note_sample"):
            next_note = self._note_scan(feats, style_emb, state.temperature,
                                        us)
            temperature, silent_time = self._temperature_update(state,
                                                                next_note)
        return StepState(time_state, next_note, temperature, state.base_temp,
                         silent_time, state.stream_keys), next_note

    def _prime_step(self, style_emb: torch.Tensor, state: StepState, t: int,
                    note_t: torch.Tensor) -> StepState:
        """Teacher-force the given notes of step t: the time-axis step and
        the adaptive-temperature update of `_step`, on the same inputs and
        shapes, with `note_t` [G, N, 3] in place of the sampled notes.  No
        randomness is consumed, so the continuation's uniforms stay keyed
        by absolute step (deviation #10)."""
        G = style_emb.shape[0]
        _, time_state = self.model.time_axis_step(
            state.prev_note, self._beat_row(t, G), style_emb,
            state.time_state)
        temperature, silent_time = self._temperature_update(state, note_t)
        return StepState(time_state, note_t, temperature, state.base_temp,
                         silent_time, state.stream_keys)

    def _advance_through_prime(self, style_emb: torch.Tensor,
                               state: StepState,
                               prime: np.ndarray) -> StepState:
        """Run the [G, T_p, N, 3] prime through the state, one step at a
        time.  The JAX package pads its tail chunk to a bar because XLA
        compiles a short scan differently (sampler.py:474-483); these eager
        steps are the same code whatever the chunking, so they need no
        padding."""
        rows = torch.from_numpy(prime.transpose(1, 0, 2, 3).copy()).to(
            self.device)                                    # [T_p, G, N, 3]
        with bf16_f32_sums(self._bf16_card):
            for t in range(rows.shape[0]):
                state = self._prime_step(style_emb, state, t, rows[t])
        return state

    # -- whole piece -------------------------------------------------------

    def _init_state(self, G: int, seed: int, temperature,
                    stream_offset: int = 0,
                    seeds: Optional[np.ndarray] = None,
                    stream_indices: Optional[np.ndarray] = None
                    ) -> StepState:
        """Stream g's key is fold_in(key(seed), stream_offset + g), or
        fold_in(key(seeds[g]), stream_indices[g]) where those are given: a
        per-stream identity, so a stream's uniforms (and bytes) never
        depend on the batch it rides in."""
        cfg = self.cfg
        dev = self.device
        if stream_indices is None:
            idx = torch.arange(stream_offset, stream_offset + G,
                               dtype=torch.int64, device=dev)
        else:
            idx = torch.as_tensor(np.asarray(stream_indices, np.int64),
                                  device=dev)
        if seeds is None:
            root = prng.key(seed, dev)
        else:
            root = prng.key(torch.as_tensor(np.asarray(seeds, np.int64),
                                            device=dev))
        stream_keys = prng.fold_in(root, idx)
        temp = torch.as_tensor(np.broadcast_to(
            np.asarray(temperature, np.float32), (G,)).copy(), device=dev)
        return StepState(
            time_state=self.model.init_time_state(G),
            prev_note=torch.zeros(G, cfg.num_notes, cfg.note_units,
                                  device=dev),
            temperature=temp,
            base_temp=temp,
            # A fresh generation counts as already silent for a bar
            # (ref: generate.py:24 inits silent_time = NOTES_PER_BAR).
            silent_time=torch.full((G,), cfg.notes_per_bar,
                                   dtype=torch.int32, device=dev),
            stream_keys=stream_keys)

    def _chunk_uniforms(self, stream_keys: torch.Tensor, t0: int,
                        num_steps: int) -> torch.Tensor:
        """Deviation #10: stream g's step-t uniforms are
        uniform(fold_in(stream_keys[g], t), (N, 2)), a pure function of
        (seed, stream index, t), so a stream's bytes do not depend on the
        batch it rides in.  Returns [num_steps, G, N, 2] for t0, t0+1, ..."""
        ts = torch.arange(t0, t0 + num_steps, dtype=torch.int64,
                          device=stream_keys.device)
        step_keys = prng.fold_in(stream_keys[None], ts[:, None])
        return prng.uniform(step_keys, (self.cfg.num_notes, 2))

    def _chunk(self, style_emb: torch.Tensor, state: StepState,
               num_steps: int, t0: int
               ) -> Tuple[StepState, Tuple[torch.Tensor, torch.Tensor]]:
        """`num_steps` timesteps from t0.  All of the chunk's uniforms come
        from one batched threefry call [C, G, N, 2], the same bits as a
        per-step draw.  Returns the notes packed for the transfer: play +
        2*replay as uint8 [G, C, N] and the volume [G, C, N] (float32, or
        the velocity byte under gen_compact_transfer)."""
        cfg = self.cfg
        with spans.span("gen.chunk"):
            with spans.span("gen.uniforms"):
                us_all = self._chunk_uniforms(state.stream_keys, t0,
                                              num_steps)
            notes = []
            with bf16_f32_sums(self._bf16_card):
                for i in range(num_steps):
                    state, note = self._step(style_emb, state, t0 + i,
                                             us_all[i])
                    notes.append(note)
            notes = torch.stack(notes, dim=1)             # [G, C, N, 3]
            playreplay = (notes[..., 0] + 2.0 * notes[..., 1]).to(
                torch.uint8)
            vol = notes[..., 2]
            if cfg.gen_compact_transfer:
                vol = torch.floor(vol * float(cfg.max_velocity)).to(
                    torch.uint8)
            # Every rank's streams, rank-major: the whole batch on every
            # rank.
            return state, (mesh.all_gather_rows(playreplay),
                           mesh.all_gather_rows(vol))

    def _pull(self, out: Tuple[torch.Tensor, torch.Tensor]) -> np.ndarray:
        """A chunk's packed notes copied to the host (the wait for the
        chunk) and unpacked: [G, C, N, 3]."""
        with spans.span("gen.host_copy", wait=True):
            pulled = [x.cpu().numpy() for x in out]
        with spans.span("gen.assemble"):
            return self._assemble(*pulled)

    def _assemble(self, pulled_pr: np.ndarray,
                  pulled_vol: np.ndarray) -> np.ndarray:
        """Host-side inverse of the packed transfer, bit-exact for play and
        replay; volumes are raw float32, or the exact grid float of the
        velocity byte under gen_compact_transfer."""
        play = (pulled_pr & 1).astype(np.float32)
        replay = ((pulled_pr >> 1) & 1).astype(np.float32)
        if pulled_vol.dtype == np.uint8:
            pulled_vol = _velocity_grid(self.cfg.max_velocity)[pulled_vol]
        return np.stack([play, replay, np.asarray(pulled_vol, np.float32)],
                        axis=-1)

    def _begin_streams(self, styles, seed, temperature, stream_offset,
                       pad_to, seeds, stream_indices):
        """Validate and pad the stream batch, compute the style embedding
        and build the initial state: what `generate` and `begin` do before
        their chunk loop.  Pad rows repeat the last real stream and are
        sliced off.  In a process group the batch pads to a multiple of the
        world too, and the embedding and state returned are this rank's
        block of the streams: every float computation of a stream runs at
        the rank's batch, as one process runs it at its own.  Returns
        (style_emb, state, styles_np, G_real)."""
        if not styles:
            raise ValueError("at least one style mixture is required")
        if not 0 <= int(seed) < 2 ** 32:
            raise ValueError(f"seed must be in [0, 2**32), got {seed}")
        G_real = len(styles)
        styles = list(styles)
        pad = (-G_real) % math.lcm(pad_to or 1, mesh.world())
        styles = styles + [styles[-1]] * pad

        def _per_stream(vals, name, dtype, lo=None, hi=None):
            vals = [dtype(v) for v in vals]
            if len(vals) != G_real:
                raise ValueError(f"{name} must have one entry per style "
                                 f"mixture ({G_real}), got {len(vals)}")
            for v in vals:
                if lo is not None and not lo <= v < hi:
                    raise ValueError(
                        f"each {name} entry must be in [{lo}, {hi}), got {v}")
            return np.asarray(vals + [vals[-1]] * pad)

        if seeds is not None:
            seeds = _per_stream(seeds, "seeds", int, 0, 2 ** 32)
        if stream_indices is not None:
            stream_indices = _per_stream(stream_indices, "stream_indices",
                                         int, 0, 2 ** 32)
        styles_np = np.stack([np.asarray(s) for s in styles]).astype(
            np.float32)
        with bf16_f32_sums(self._bf16_card):
            style_emb = self.model.style_embedding(
                torch.from_numpy(self._local(styles_np)).to(self.device))
        if temperature is None:
            temp = self.default_temp
        elif np.ndim(temperature) == 0:
            temp = float(temperature)
        else:
            temp = _per_stream(temperature, "temperature", float).astype(
                np.float32)
        state = self._init_state(styles_np.shape[0], int(seed), temp,
                                 stream_offset, seeds=seeds,
                                 stream_indices=stream_indices)
        return style_emb, self._local(state), styles_np, G_real

    def _local(self, x):
        """This rank's contiguous block of the streams of a per-stream
        tensor, or of every tensor of a StepState (the time state's rows
        are stream-major, N rows a stream)."""
        world = mesh.world()
        if world == 1:
            return x
        if isinstance(x, StepState):
            return StepState(
                tuple(tuple(self._local(t) for t in layer)
                      for layer in x.time_state),
                *(self._local(t) for t in x[1:]))
        n = x.shape[0] // world
        return x[mesh.rank() * n:(mesh.rank() + 1) * n]

    @torch.no_grad()
    def begin(self, styles: Sequence[np.ndarray], *, chunk_bars: int = 8,
              seed: int = 0, temperature=None, stream_offset: int = 0,
              pad_to: Optional[int] = None,
              seeds: Optional[Sequence[int]] = None,
              stream_indices: Optional[Sequence[int]] = None,
              ) -> "ActiveGeneration":
        """Open an incremental generation: the stream semantics of
        `generate`, but the caller drives the chunk loop through the
        returned handle's `advance()`; between calls the state stays on the
        device.  `begin(...)` followed by `advance()` calls gives the exact
        notes of `generate(..., pad_partial_chunk=True,
        chunk_bars=chunk_bars)`, however the calls are grouped."""
        style_emb, state, styles_np, G_real = self._begin_streams(
            styles, seed, temperature, stream_offset, pad_to, seeds,
            stream_indices)
        return ActiveGeneration(self, style_emb, state, styles_np, G_real,
                                self.cfg.notes_per_bar * chunk_bars)

    @torch.no_grad()
    def generate(self, styles: Sequence[np.ndarray], num_bars: int = 32,
                 seed: int = 0, chunk_bars: int = 8, temperature=None,
                 stream_offset: int = 0, pad_to: Optional[int] = None,
                 prime: Optional[np.ndarray] = None,
                 pad_partial_chunk: bool = False,
                 seeds: Optional[Sequence[int]] = None,
                 stream_indices: Optional[Sequence[int]] = None,
                 ) -> GenerationResult:
        """Generate `num_bars` bars for each style mixture.

        The piece runs in chunks of `chunk_bars` bars; chunking does not
        change the output.  Stream g draws its uniforms from (seed,
        stream_offset + g, t), so stream g of a batch equals a solo run at
        stream_offset=g.  `temperature` is a scalar or one value per
        stream; None takes the sampler's default.

        `pad_to` pads the batch to a multiple of that size with copies of
        the last style mixture (the serving bucket); the padding is sliced
        off.  `seeds` / `stream_indices` / a per-stream `temperature` give
        stream g its own (seed, index, temperature) triple: its notes equal
        the solo run `generate([styles[g]], seed=seeds[g],
        stream_offset=stream_indices[g], temperature=temps[g])`.

        `prime`: an optional clamped piano roll ([T_p, N, 3] shared by every
        stream, or [G, T_p, N, 3] per stream) to continue from: the state is
        teacher-forced through it, then `num_bars` bars are generated from
        absolute step T_p.  The result holds the continuation only
        (`prepend_prime` gives the whole piece).

        `pad_partial_chunk` runs the final partial chunk at the full chunk
        length and slices the surplus off: the same notes (the scan is
        causal, the uniforms keyed by absolute step)."""
        cfg = self.cfg
        if num_bars < 0:
            raise ValueError(f"num_bars must be >= 0, got {num_bars}")
        style_emb, state, styles_np, G_real = self._begin_streams(
            styles, seed, temperature, stream_offset, pad_to, seeds,
            stream_indices)
        gen_steps = cfg.notes_per_bar * num_bars
        num_steps = gen_steps
        if pad_partial_chunk:
            chunk = cfg.notes_per_bar * chunk_bars
        else:
            chunk = min(num_steps, cfg.notes_per_bar * chunk_bars)
        prime_steps = 0
        if prime is not None and prime.shape[-3] > 0:
            prime = np.asarray(prime, np.float32)
            G_pad = styles_np.shape[0]
            if prime.ndim == 3:
                prime = np.broadcast_to(prime[None], (G_pad,) + prime.shape)
            elif prime.shape[0] != G_real:
                raise ValueError(
                    f"prime has {prime.shape[0]} streams but "
                    f"{G_real} style mixtures were given")
            elif prime.shape[0] != G_pad:        # pad like the styles
                prime = np.concatenate(
                    [prime] + [prime[-1:]] * (G_pad - prime.shape[0]))
            prime_steps = prime.shape[1]
            state = self._advance_through_prime(style_emb, state,
                                                self._local(prime))
        if num_steps == 0:
            return GenerationResult(
                np.zeros((G_real, 0, cfg.num_notes, cfg.note_units),
                         np.float32), styles_np[:G_real])
        # Enqueue chunk k+1 before copying chunk k to the host, so the copy
        # overlaps the next chunk's work.  The output is that of the
        # serial loop.
        pieces, pending = [], None
        t = prime_steps
        num_steps += prime_steps
        while t < num_steps:
            n = chunk if pad_partial_chunk else min(chunk, num_steps - t)
            state, out = self._chunk(style_emb, state, n, t)
            if pending is not None:
                pieces.append(self._pull(pending))
            pending = out
            t += n
        pieces.append(self._pull(pending))
        notes = np.concatenate(pieces, axis=1)[:G_real, :gen_steps]
        return GenerationResult(notes, styles_np[:G_real])


class ActiveGeneration:
    """An open incremental generation (`Sampler.begin`): the per-stream
    state stays on the device between `advance()` calls."""

    def __init__(self, sampler: Sampler, style_emb, state, styles_np,
                 G_real: int, chunk_steps: int):
        self._sampler = sampler
        self._style_emb = style_emb
        self._state = state
        self.styles_np = styles_np
        self.G_real = G_real
        self.chunk_steps = chunk_steps
        self.t = 0                     # absolute step of the next chunk

    @torch.no_grad()
    def advance(self, num_chunks: int = 1) -> np.ndarray:
        """Run `num_chunks` full chunks and return their notes, real
        streams only: [G_real, num_chunks * chunk_steps, N, 3]."""
        s = self._sampler
        pieces = []
        for _ in range(num_chunks):
            self._state, out = s._chunk(self._style_emb, self._state,
                                        self.chunk_steps, self.t)
            pieces.append(s._pull(out)[:self.G_real])
            self.t += self.chunk_steps
        return np.concatenate(pieces, axis=1)

    def close(self) -> None:
        """Release the state on the device (the handle is unusable
        after)."""
        self._state = None
        self._style_emb = None


def prepend_prime(notes: np.ndarray, prime: np.ndarray) -> np.ndarray:
    """The whole piece of a primed generation: the (clamped) prime followed
    by the continuation, per stream.  A 3-d prime (shared by every stream)
    broadcasts across the batch; a 4-d prime is per stream already."""
    prime = np.asarray(prime, np.float32)
    if prime.ndim == 3:
        prime = np.broadcast_to(prime[None],
                                (notes.shape[0],) + prime.shape)
    return np.concatenate([prime, notes], axis=1)


def write_file(name: str, result: GenerationResult,
               config: Optional[Config] = None) -> list:
    """Write one .mid per generation to cfg.samples_dir
    (ref: generate.py:123-134)."""
    cfg = config or Config()
    paths = []
    for i in range(result.notes.shape[0]):
        fpath = os.path.join(cfg.samples_dir, f"{name}_{i}.mid")
        os.makedirs(os.path.dirname(fpath), exist_ok=True)
        print("Writing file", fpath)
        mf = midi_encode(unclamp_midi(result.notes[i], cfg), config=cfg)
        write_midifile(fpath, mf)
        paths.append(fpath)
    return paths
