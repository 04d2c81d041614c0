"""The yardstick's arithmetic: the card's published peaks, the least time
of each hand-written kernel at its shapes, and the model FLOPs of a
training step and of a generated stream-timestep.

`notegen_bound_ms`, `biax_bound_ms` and `lstm_bound_ms` are frozen copies
of the functions of the same names in the repository's `chip_smoke.py`
(`notegen_bound_ms`, `biax_bound_ms`, `lstm_bound_ms`), changed only to take
the sizes from a `Dims` instead of the program's `Config`.  A later change
to the program's copies does not move the benchmark's readings.

Every size comes from a configuration file of `portbench/configs/`
(`Dims.from_config`), never from the program."""

from __future__ import annotations

import dataclasses

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 FLOP/s
# on the CUDA cores, bfloat16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes the arithmetic reads (the DeepJ configuration's)."""
    num_notes: int
    note_units: int
    octave_units: int
    notes_per_bar: int
    octave: int
    time_axis_units: int
    note_axis_units: int
    time_axis_kind: str

    @property
    def feature_dim(self) -> int:
        """pitch_pos(1) + pitch_class(octave) + chroma(1) + conv + beat."""
        return 1 + self.octave + 1 + self.octave_units + self.notes_per_bar

    @classmethod
    def from_config(cls, model: dict) -> "Dims":
        return cls(**{f.name: model[f.name]
                      for f in dataclasses.fields(cls)})


def _bound(t_bytes: float, t_ops: float):
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def notegen_bound_ms(G: int, N: int, F: int, H: int, L: int = 2,
                     esize: int = 4):
    """Least time for one pitch loop at note depth L, and what sets it:
    every input read once and the output written once at HBM rate, or its
    multiply-adds at the card's peak for their inputs' type (float32, or
    bfloat16 with float32 sums for the bfloat16 instances).  `esize`: the
    bytes of a weight and a feature (4 float32, 2 bfloat16; the bfloat16
    scan flavor's style table [G, L, H] is float32).  Returns (ms,
    "bytes" or "operations")."""
    H4 = 4 * H
    R = 2 * L - 1                                 # U_0, and W_l, U_l
    narrow = (G * N * F                           # feats
              + F * H4 + 3 * H4 + R * H * H4      # W0f, W0c, U, W
              + 3 * H)                            # heads' kernels
    floats = (G * N * 2 + G                       # uniforms, T
              + L * G * H4                        # a_l
              + 3                                 # heads' biases
              + (G * L * H if esize == 2 else 0)  # style table
              + G * N * 3)                        # output
    flops = 2 * G * N * (F * H4 + 3 * H4 + R * H * H4 + 3 * H)
    t_bytes = (esize * narrow + 4 * floats) / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOP_PER_S if esize == 2 else F32_FLOP_PER_S)
    return _bound(t_bytes, t_ops)


def biax_bound_ms(name: str, d: Dims, B: int, T: int, bf16: bool):
    """Least time of one launch of a biaxial kernel ("biax_time_fwd",
    "biax_time_bwd", "biax_note_fwd", "biax_note_bwd") at batch B and T
    timesteps: every input read once and every output written once at HBM
    rate, or its operations (the Pallas kernels' CostEstimate counts) at
    the peak of the compute dtype.  Returns (ms, "bytes" or
    "operations")."""
    it = 2 if bf16 else 4
    N, C = d.num_notes, d.note_units
    if name.startswith("biax_time"):
        Fin, H = d.feature_dim, d.time_axis_units
        ins = T * N * B * Fin * it + T * B * (Fin + H) * it
        ws = (Fin + 3 * H) * 4 * H * it + 2 * 4 * H * it
        ew = 20
    else:
        Ht, H = d.time_axis_units, d.note_axis_units
        Fin = Ht + C
        ins = (T * N * B * Fin * it + T * B * (Fin + H) * it)
        ws = (Fin + 3 * H) * 4 * H * it + 2 * 4 * H * it + H * 3 * it + 12
        ew = 0
    R, H4 = T * N * B, 4 * H
    tapes = 4 * R * H * it
    grads = ((Fin + 3 * H) * H4 + 2 * H4) * 4 + T * B * (Fin + H) * 4
    if name.endswith("fwd"):
        flops = 2 * R * (Fin + 3 * H) * H4 + ew * R * H4
        out = R * H * it if name.startswith("biax_time") else R * 3 * 4
        nbytes = ins + ws + out + tapes
    else:
        flops = 6 * R * (Fin + 3 * H) * H4 + 2 * ew * R * H4
        dout = R * H * it if name.startswith("biax_time") else R * 3 * 4
        nbytes = 2 * ins + ws + tapes + dout + grads
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    return _bound(t_bytes, t_ops)


def lstm_bound_ms(name: str, S: int, R: int, F: int, H: int):
    """Least time of one bfloat16 launch ("lstm2_fwd", "lstm2_bwd",
    "lstm_rec_fwd", "lstm_rec_bwd") at these shapes: every input read
    once and every output (and tape) written once at HBM rate, or the
    Pallas kernels' CostEstimate operations at the bfloat16 peak.  Returns
    (ms, "bytes" or "operations")."""
    it, H4 = 2, 4 * H
    seq = S * R * H * it                  # one [S, R, H] tape
    st = R * H * 4                        # one float32 state
    if name.startswith("lstm2"):
        ws = (F + 3 * H) * H4 * it + 2 * H4 * it
        ins = S * R * F * it + seq        # x0, s1m
        if name.endswith("fwd"):
            flops = 2 * S * R * (F + 3 * H) * H4 + 20 * S * R * H4
            nbytes = ins + ws + 4 * st + 4 * seq + 4 * st
        else:
            flops = 6 * S * R * (F + 3 * H) * H4 + 40 * S * R * H4
            grads = ((F + 3 * H) * H4 + 2 * H4) * 4
            nbytes = 2 * ins + ws + 5 * seq + 2 * st + grads + 4 * st
    else:
        xw = S * R * H4 * it
        if name.endswith("fwd"):
            flops = 2 * S * R * H * H4 + 10 * S * R * H4
            nbytes = xw + H * H4 * it + 2 * st + 2 * seq + 2 * st
        else:
            flops = 6 * S * R * H * H4 + 30 * S * R * H4
            nbytes = (xw + H * H4 * it + 2 * seq + 2 * seq + st + xw
                      + H * H4 * 4 + 2 * st)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return _bound(t_bytes, t_ops)


# -- model FLOPs --------------------------------------------------------

CONV_WIDTH_OCTAVES = 2        # the octave conv spans two octaves


def _conv_flops(d: Dims, rows: int) -> int:
    """The octave conv over `rows` (time, note) positions."""
    return 2 * rows * CONV_WIDTH_OCTAVES * d.octave * d.note_units \
        * d.octave_units


def _time_axis_flops(d: Dims, rows: int) -> int:
    """Both time-axis layers over `rows` (batch, time, note) rows: an
    LSTM layer's products 2 (in + H) 4H a row, a GLRU layer's gate GEMM
    2 in 2H (no recurrent product)."""
    F, H = d.feature_dim, d.time_axis_units
    if d.time_axis_kind == "linear":
        return 2 * rows * (F + H) * 2 * H
    return 2 * rows * (F + 3 * H) * 4 * H


def _note_axis_flops(d: Dims, rows: int) -> int:
    """Both note-axis LSTM layers and the three heads over `rows`."""
    F, H = d.time_axis_units + d.note_units, d.note_axis_units
    return 2 * rows * (F + 3 * H) * 4 * H + 2 * rows * H * 3


def train_step_flops(d: Dims, B: int, T: int) -> int:
    """Model FLOPs of one training step at batch B, T timesteps: the
    forward's products (octave conv, both axes, heads) over B T N rows,
    and twice that for the backward."""
    R = B * T * d.num_notes
    fwd = _conv_flops(d, R) + _time_axis_flops(d, R) + _note_axis_flops(d, R)
    return 3 * fwd


def gen_timestep_flops(d: Dims) -> int:
    """Model FLOPs of one generated stream-timestep: the time-axis step
    (conv and both layers over N rows) and the pitch loop (both note
    layers and the heads at each of N pitches)."""
    N = d.num_notes
    return _conv_flops(d, N) + _time_axis_flops(d, N) + _note_axis_flops(d, N)
