"""The DeepJ biaxial model (ref: model.py:51-169) as a PyTorch module — the
streaming generation paths of the JAX package's `models/deepj.py`.

Parameters keep the JAX layouts so the same `.npz` (keystr paths, see
params.py) loads into either package: Dense kernels `[in, out]`, LSTM
kernels `[in, 4H]` with gates (i, f, g, o), the octave conv kernel
`[width, in, out]`.  Only the conv converts, inside `Conv1D.forward`, to
PyTorch's `[out, in, width]`.

Deliberate fix kept from the JAX package (deviation #1): the chromagram is
the per-pitch-class played-note count over octaves, tiled per octave — the
documented intent of ref: model.py:43-49, whose raw reshape scrambles
batch, time and pitch.

Generation runs `style_embedding`, `octave_conv`, `note_features`,
`init_time_state`/`time_axis_step` and `init_note_state`/`note_axis_cell`
(with ops/notegen.py's heads) in the config's `gen_dtype` (float32 by
default).  The JAX Sampler runs them on a model rebuilt at
compute_dtype=gen_dtype; reading gen_dtype here gives the same
arithmetic without a second model, and keeps a model called directly
(the default config trains in bfloat16) streaming as its Sampler would.  Training runs
`forward` in the config's compute dtype, and `loss` / `primary_loss`.
`forward` routes as the JAX package's does with lstm_kernel="pallas":
both axes as the biaxial stacks of ops/biax.py (`_forward_biax_v3`), or
per axis the fused two-layer stack of ops/lstm2.py, or one ops/lstm.py
`lstm_scan` per layer (any depth).  With `time_axis_kind="linear"` the time axis is one
ops/linear_scan.py `glru_scan` per layer and the biaxial stacks are off,
as in the JAX package.  Dropout draws come from an explicit
`torch.Generator`; without one (or with train=False) there is no dropout,
like Keras `predict`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from music_generator_tpu_torch.config import Config
from music_generator_tpu_torch.device import DeviceLike, resolve_device
from music_generator_tpu_torch.ops import notegen
from music_generator_tpu_torch.ops.biax import (biax_note_stack,
                                                biax_time_stack)
from music_generator_tpu_torch.ops.linear_scan import (GLRUParams, glru_scan,
                                                       glru_step)
from music_generator_tpu_torch.ops.lstm import (check_recurrent_activation,
                                                lstm_scan, lstm_step)
from music_generator_tpu_torch.ops.lstm2 import lstm2_stack
from music_generator_tpu_torch.utils import spans


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def feature_dim(cfg: Config) -> int:
    """pitch_pos(1) + pitch_class(12) + chroma(1) + conv + beat."""
    return 1 + cfg.octave + 1 + cfg.octave_units + cfg.notes_per_bar


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


def dense_apply(p: Dense, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x @ kernel + bias with every operand cast to `dt` (deepj.py:56-57)."""
    return x.to(dt) @ p.kernel.to(dt) + p.bias.to(dt)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Inverted dropout (deepj.py:83-89): keep with probability 1 - rate
    and scale by 1/keep.  No-op unless training with a generator."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Conv1D(nn.Module):
    """'same' 1-D conv over the second-to-last axis of [B, L, C], with
    Keras's asymmetric padding for even widths: left (w-1)//2, right w//2
    (11 and 12 for the octave conv's width 24)."""

    def __init__(self, width: int, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(width, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor,
                dt: torch.dtype = torch.float32) -> torch.Tensor:
        w = self.kernel.shape[0]
        xt = F.pad(x.to(dt).transpose(1, 2), ((w - 1) // 2, w // 2))
        out = F.conv1d(xt, self.kernel.to(dt).permute(2, 1, 0))
        return out.transpose(1, 2) + self.bias.to(dt)


class LSTMParams(nn.Module):
    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(input_dim, 4 * hidden))
        self.recurrent = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))


class AxisLayer(nn.Module):
    """A style projection and a recurrent unit: an LSTM, or on the time
    axis of `time_axis_kind="linear"` a GLRUParams (ops/linear_scan.py),
    held under the same `lstm` name as the JAX package holds it."""

    def __init__(self, style_units: int, input_dim: int, hidden: int,
                 kind: str = "lstm"):
        super().__init__()
        self.style_proj = Dense(style_units, input_dim)
        self.lstm = (GLRUParams(input_dim, hidden) if kind == "linear"
                     else LSTMParams(input_dim, hidden))


class DeepJ(nn.Module):
    """The model, bound to a config and a device (CUDA unless asked)."""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        super().__init__()
        check_recurrent_activation(cfg.lstm_recurrent_activation)
        if cfg.time_axis_kind not in ("lstm", "linear"):
            raise ValueError(
                f"unknown time_axis_kind={cfg.time_axis_kind!r}; expected "
                f"'lstm' or 'linear'")
        self.cfg = cfg
        f = feature_dim(cfg)
        self.style_embed = Dense(cfg.num_styles, cfg.style_units)
        self.conv = Conv1D(2 * cfg.octave, cfg.note_units, cfg.octave_units)
        dims = [f] + [cfg.time_axis_units] * cfg.time_axis_layers
        self.time_axis = nn.ModuleList(
            AxisLayer(cfg.style_units, dims[i], cfg.time_axis_units,
                      cfg.time_axis_kind)
            for i in range(cfg.time_axis_layers))
        dims = ([cfg.time_axis_units + cfg.note_units]
                + [cfg.note_axis_units] * cfg.note_axis_layers)
        self.note_axis = nn.ModuleList(
            AxisLayer(cfg.style_units, dims[i], cfg.note_axis_units)
            for i in range(cfg.note_axis_layers))
        self.note_dense = Dense(cfg.note_axis_units, 2)
        self.volume_dense = Dense(cfg.note_axis_units, 1)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.style_embed.kernel.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh Keras-default weights drawn from a seeded CPU generator:
        glorot-uniform kernels, orthogonal recurrent matrices, zero biases
        with a unit forget-gate bias on the LSTMs (a GLRU layer: glorot
        kernel, zero bias).  The same distributions as the JAX
        package's `init_params`, NOT its bits (jax.random keys and
        torch.Generator streams differ)."""
        def glorot(p: torch.Tensor, fan_in: int, fan_out: int) -> None:
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            p.copy_(torch.empty(p.shape).uniform_(-lim, lim,
                                                  generator=generator))

        for name, p in self.named_parameters():
            if name.endswith("recurrent"):
                q = torch.empty(p.shape)
                nn.init.orthogonal_(q, generator=generator)
                p.copy_(q)
            elif name.endswith("kernel"):
                if p.dim() == 3:          # conv [width, in, out]
                    w, i, o = p.shape
                    glorot(p, w * i, w * o)
                else:
                    glorot(p, p.shape[0], p.shape[1])
            else:
                p.zero_()
        for layer in list(self.time_axis) + list(self.note_axis):
            if isinstance(layer.lstm, LSTMParams):
                h = layer.lstm.recurrent.shape[0]
                layer.lstm.bias[h:2 * h] = 1.0

    # -- features (ref: model.py:22-49) ------------------------------------

    def note_features(self, notes: torch.Tensor, beat: torch.Tensor,
                      conv_out: torch.Tensor) -> torch.Tensor:
        """Concat per-(time, note) features -> [B, T, N, F].

        notes: [B, T, N, 3], beat: [B, T, notes_per_bar],
        conv_out: [B, T, N, octave_units]."""
        cfg = self.cfg
        B, T, N, _ = notes.shape
        dt, dev = conv_out.dtype, conv_out.device
        pitch_pos = (torch.arange(N, dtype=dt, device=dev) / N)
        pitch_pos = pitch_pos[None, None, :, None].expand(B, T, N, 1)
        classes = F.one_hot(torch.arange(N, device=dev) % cfg.octave,
                            cfg.octave).to(dt)
        pitch_class = classes[None, None].expand(B, T, N, cfg.octave)
        # Chromagram (deviation #1): per pitch class, the play mass summed
        # over octaves, seen by every note of that class.
        play = notes[..., 0]
        bins = play.reshape(B, T, cfg.num_octaves, cfg.octave).sum(dim=2)
        chroma = bins.repeat(1, 1, cfg.num_octaves)[..., None].to(dt)
        beat_rep = beat[:, :, None, :].to(dt).expand(B, T, N, beat.shape[-1])
        return torch.cat([pitch_pos, pitch_class, chroma, conv_out,
                          beat_rep], dim=-1)

    def octave_conv(self, notes: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False,
                    dt: torch.dtype = torch.float32) -> torch.Tensor:
        """tanh(Conv1D over the note axis) + dropout (ref: model.py:56-58),
        in `dt`."""
        B, T, N, C = notes.shape
        out = torch.tanh(self.conv(notes.reshape(B * T, N, C), dt))
        return dropout(out.reshape(B, T, N, -1), self.cfg.dropout,
                       generator, train)

    # -- style ------------------------------------------------------------

    def style_embedding(self, style: torch.Tensor) -> torch.Tensor:
        """The shared 'style' Dense layer (ref: model.py:141-142), in the
        generation dtype (deepj.py:257-259 under the Sampler's model)."""
        return dense_apply(self.style_embed, style, self._gen_dt())

    # -- streaming single-step paths (generation) --------------------------

    def init_time_state(self, batch: int) -> Tuple:
        """Per-layer (h, c) of the time-axis LSTMs over G·N rows, or (h,)
        of the linear kind's GLRU layers."""
        cfg = self.cfg
        shape = (batch * cfg.num_notes, cfg.time_axis_units)
        n = 1 if cfg.time_axis_kind == "linear" else 2
        return tuple(
            tuple(torch.zeros(shape, device=self.device) for _ in range(n))
            for _ in range(cfg.time_axis_layers))

    def time_axis_step(self, note_row: torch.Tensor, beat_row: torch.Tensor,
                       style_emb: torch.Tensor,
                       state: Tuple) -> Tuple[torch.Tensor, Tuple]:
        """One streaming timestep of the time axis.

        note_row: [G, N, 3] (the notes chosen at the previous step),
        beat_row: [G, notes_per_bar], style_emb: [G, style_units].
        Returns ([G, N, time_units], new_state): O(1) recurrent state per
        step instead of the reference's 128-step window recompute
        (ref: generate.py:106-109).  Runs in the generation dtype as the
        JAX Sampler's step does (deepj.py:567-598): the octave conv, the
        note features, each layer's tanh style projection (float32 on the
        rounded dense, as XLA keeps it, `notegen.style_term`) and its
        cell; an LSTM cell's h and c come back float32, a GLRU's h in the
        generation dtype."""
        G, N, _ = note_row.shape
        dt = self._gen_dt()
        notes = note_row[:, None]
        beat = beat_row[:, None]
        x = self.note_features(notes, beat,
                               self.octave_conv(notes, dt=dt))[:, 0]
        new_state = []
        for layer, layer_state in zip(self.time_axis, state):
            proj = notegen.style_term(layer, style_emb, dt)
            x = x + proj[:, None, :]
            xin = x.reshape(G * N, x.shape[-1])
            if isinstance(layer.lstm, LSTMParams):
                h, c = lstm_step(layer.lstm, xin, *layer_state,
                                 self.cfg.lstm_recurrent_activation, dt)
                new_state.append((h, c))
            else:
                h = glru_step(layer.lstm, xin, layer_state[0], dt)
                new_state.append((h,))
            x = h.reshape(G, N, -1)
        return x, tuple(new_state)

    def init_note_state(self, batch: int) -> Tuple:
        cfg = self.cfg
        shape = (batch, cfg.note_axis_units)
        return tuple(
            (torch.zeros(shape, device=self.device),
             torch.zeros(shape, device=self.device))
            for _ in range(cfg.note_axis_layers))

    def note_axis_cell(self, feat_n: torch.Tensor, prev_chosen: torch.Tensor,
                       style_emb: torch.Tensor, state: Tuple,
                       ) -> Tuple[torch.Tensor, Tuple]:
        """One note of the pitch recurrence during generation.

        feat_n: [G, time_units], prev_chosen: [G, 3] (the sampled note
        n-1; zeros for n=0).  Returns ([G, 3] prediction, new state)."""
        x = torch.cat([feat_n, prev_chosen.to(feat_n.dtype)], dim=-1)
        return notegen.note_cell(x, self.note_axis, style_emb, state,
                                 self.note_dense, self.volume_dense,
                                 self.cfg.lstm_recurrent_activation,
                                 self._gen_dt())

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """sigmoid(play, replay) ++ linear volume in the compute dtype,
        returned as float32 (ref: model.py:94-95,125; deepj.py:436-442).
        Generation runs ops/notegen.py's `heads`."""
        dt = self._dt()
        notes_out = torch.sigmoid(dense_apply(self.note_dense, x, dt))
        volume_out = dense_apply(self.volume_dense, x, dt)
        return torch.cat([notes_out, volume_out], dim=-1).float()

    # -- training forward (ref: model.py:128-152) -------------------------

    def _dt(self) -> torch.dtype:
        return _DTYPES[self.cfg.compute_dtype]

    def _gen_dt(self) -> torch.dtype:
        return _DTYPES[self.cfg.gen_dtype]

    @staticmethod
    def _two_equal(layers) -> bool:
        """Two LSTM layers of one width (a GLRU axis never is: it has no
        recurrent matrix to fuse)."""
        return (len(layers) == 2
                and all(isinstance(l.lstm, LSTMParams) for l in layers)
                and layers[0].lstm.recurrent.shape
                == layers[1].lstm.recurrent.shape)

    def _use_biax_v3(self) -> bool:
        """The biaxial stacks run both axes when `fused_biax_v3` is set and
        each axis has two equal-width layers (deepj.py:446-457)."""
        return (self.cfg.fused_biax_v3 and self._two_equal(self.time_axis)
                and self._two_equal(self.note_axis))

    def _use_fused(self, layers) -> bool:
        """The fused two-layer stack runs an axis when `fused_axis_kernel`
        is set and the axis has two equal-width layers (deepj.py:284-293);
        otherwise each layer is one lstm_scan."""
        return self.cfg.fused_axis_kernel and self._two_equal(layers)

    def _check_biax_shape(self) -> None:
        """The fused biaxial stacks take two equal-width LSTM layers per
        axis (the DeepJ shape, deepj.py:446-457)."""
        for name, layers in (("time", self.time_axis),
                             ("note", self.note_axis)):
            if not self._two_equal(layers):
                raise NotImplementedError(
                    f"the biaxial stacks take two equal-width LSTM layers "
                    f"on the {name} axis; got {len(layers)}")

    def _stack_dropout(self, generator: Optional[torch.Generator],
                       train: bool) -> float:
        """The stacks' in-kernel dropout rate: train=True without a
        generator means no dropout, not a frozen seed-0 mask
        (deepj.py:307-314, 504-511)."""
        return self.cfg.dropout if (train and generator is not None) else 0.0

    def _stack_seeds(self, generator: Optional[torch.Generator],
                     train: bool, n: int) -> list:
        """`n` stack mask seeds drawn from `generator` in one call (one
        read on the host) when the stacks' dropout is on, else zeros."""
        if self._stack_dropout(generator, train) <= 0.0:
            return [0] * n
        with spans.span("deepj.stack_seeds", wait=True):
            return torch.randint(0, 2**31 - 1, (n,), generator=generator,
                                 device=generator.device).tolist()

    def _fused_stack(self, layers, x_flat: torch.Tensor,
                     proj1_flat: torch.Tensor,
                     generator: Optional[torch.Generator], train: bool,
                     seed: Optional[int]) -> torch.Tensor:
        """Two layers as one lstm2_stack (deepj.py:295-322): x_flat
        [S, R, F] the layer-0 input with its style term added, proj1_flat
        [S, R, H] the masked layer-1 style term; returns hs1 [S, R, H].
        The mask seed is drawn here when `seed` is None."""
        l0, l1 = layers
        if seed is None:
            (seed,) = self._stack_seeds(generator, train, 1)
        hs1, _ = lstm2_stack(
            x_flat, proj1_flat, l0.lstm.kernel, l0.lstm.bias, l1.lstm.bias,
            l0.lstm.recurrent, l1.lstm.kernel, l1.lstm.recurrent,
            dropout_p=self._stack_dropout(generator, train), seed=seed,
            compute_dtype=self._dt(),
            recurrent_activation=self.cfg.lstm_recurrent_activation)
        return hs1

    def _axis(self, layers, x: torch.Tensor, emb: torch.Tensor, dim: int,
              generator: Optional[torch.Generator], train: bool,
              seed: Optional[int]) -> torch.Tensor:
        """One axis in its scan-major layout (deepj.py:335-375, 402-432):
        x [S, a, b, F] -> [S, a, b, H], scanning S over the rows (a, b).
        Each layer adds its style term (ref: model.py:77-82, 110-117):
        tanh of the style projection of `emb`, broadcast along the new
        dimension `dim` to the layer's input, then dropout.  A fused axis
        runs one lstm2_stack (mask seed `seed`, drawn when None); otherwise
        each layer is one lstm_scan, or a GLRU layer's glru_scan.  Every
        layer's output goes through dropout (on a fused axis, the last)."""
        cfg = self.cfg
        S, A, B, _ = x.shape

        def style(layer, shape):
            proj = torch.tanh(dense_apply(layer.style_proj, emb, self._dt()))
            return dropout(proj.unsqueeze(dim).expand(shape), cfg.dropout,
                           generator, train)

        if self._use_fused(layers):
            H = layers[1].lstm.recurrent.shape[0]
            x = x + style(layers[0], x.shape)
            proj1 = style(layers[1], (S, A, B, H))
            hs = self._fused_stack(layers, x.reshape(S, A * B, -1),
                                   proj1.reshape(S, A * B, H), generator,
                                   train, seed)
            return dropout(hs.reshape(S, A, B, -1), cfg.dropout, generator,
                           train)
        for layer in layers:
            x = x + style(layer, x.shape)
            if isinstance(layer.lstm, LSTMParams):
                hs, _ = lstm_scan(layer.lstm, x.reshape(S, A * B, -1),
                                  compute_dtype=self._dt(),
                                  recurrent_activation=(
                                      cfg.lstm_recurrent_activation))
            else:
                hs = glru_scan(layer.lstm, x.reshape(S, A * B, -1),
                               compute_dtype=self._dt())
            x = dropout(hs.reshape(S, A, B, -1), cfg.dropout, generator,
                        train)
        return x

    def time_axis_tm(self, x: torch.Tensor, style_emb_tm: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False,
                     stack_seed: Optional[int] = None) -> torch.Tensor:
        """Time-major core (deepj.py:324-375): x [T, B, N, F],
        style_emb_tm [T, B, style_units] -> [T, B, N, time_units]; the
        scans' rows are (b, n)."""
        return self._axis(self.time_axis, x, style_emb_tm, 2, generator,
                          train, stack_seed)

    def note_axis_nm(self, time_out_nm: torch.Tensor, chosen: torch.Tensor,
                     style_emb: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False,
                     stack_seed: Optional[int] = None) -> torch.Tensor:
        """Note-major core (deepj.py:386-434): time_out_nm [N, B, T,
        time_units], chosen [B, T, N, 3] -> [N, B, T, 3] float32; the
        scans' rows are (b, t); ends in the heads."""
        # Shift the targets one note down: note n conditions on notes < n.
        chosen_nm = chosen.permute(2, 0, 1, 3)
        shift = torch.cat([torch.zeros_like(chosen_nm[:1]), chosen_nm[:-1]])
        x = torch.cat([time_out_nm, shift.to(time_out_nm.dtype)], dim=-1)
        return self.heads(self._axis(self.note_axis, x, style_emb, 0,
                                     generator, train, stack_seed))

    def forward(self, notes: torch.Tensor, chosen: torch.Tensor,
                beat: torch.Tensor, style: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        """[B, T, N, 3] notes, teacher-forced `chosen` targets, beat
        [B, T, notes_per_bar] and style [B, T, num_styles] -> predictions
        [B, T, N, 3] float32 (deepj.py:459-480).

        The route is chosen as the JAX package chooses it with
        lstm_kernel="pallas": the biaxial stacks (`_forward_biax_v3`) when
        `_use_biax_v3`; else, per axis, one lstm2_stack when `_use_fused`,
        else one lstm_scan per layer.  Input dropouts, the style
        embedding, the octave conv, the note features, the style terms and
        the between-layer dropouts run as PyTorch operations in the
        compute dtype.

        Dropout draws come from `generator` in this fixed order: the input
        dropouts of notes, beat and chosen; the conv output; the two stack
        seeds (time, note) in one draw, when the biaxial route runs or an
        axis is fused; then on the time axis the style term of each layer
        and each layer's output (a fused axis: the style terms of both
        layers, then the stack's output), then the same on the note axis.
        train=True without a generator means no dropout."""
        if self._use_biax_v3():
            return self._forward_biax_v3(notes, chosen, beat, style,
                                         generator, train)
        chosen, style_emb, feats = self._inputs(
            notes, chosen, beat, style, generator, train)
        # Both stack seeds in one draw before the axes are queued: a draw
        # between them would make the host wait for the time axis.
        fused = self._use_fused(self.time_axis) or self._use_fused(
            self.note_axis)
        seed_t, seed_n = (self._stack_seeds(generator, train, 2) if fused
                          else (0, 0))
        with spans.span("deepj.time_axis"):
            t_out_tm = self.time_axis_tm(feats.permute(1, 0, 2, 3),
                                         style_emb.transpose(0, 1),
                                         generator, train,
                                         seed_t)                # [T, B, N, H]
        with spans.span("deepj.note_axis"):
            out_nm = self.note_axis_nm(t_out_tm.permute(2, 1, 0, 3), chosen,
                                       style_emb, generator, train, seed_n)
        return out_nm.permute(1, 2, 0, 3)

    def _inputs(self, notes: torch.Tensor, chosen: torch.Tensor,
                beat: torch.Tensor, style: torch.Tensor,
                generator: Optional[torch.Generator], train: bool) -> Tuple:
        """What both routes run before the axes, in the compute dtype: the
        input dropouts of notes, beat and chosen, the style embedding, the
        octave conv and the note features; returns (chosen, style_emb
        [B, T, S], feats [B, T, N, F])."""
        cfg, dt = self.cfg, self._dt()
        with spans.span("deepj.inputs"):
            notes = dropout(notes, cfg.input_dropout, generator, train)
            beat = dropout(beat, cfg.input_dropout, generator, train)
            chosen = dropout(chosen, cfg.input_dropout, generator, train)
            style_emb = dense_apply(self.style_embed, style, dt)
            conv_out = self.octave_conv(notes, generator, train, dt)
            feats = self.note_features(notes, beat, conv_out)
        return chosen, style_emb, feats

    def _forward_biax_v3(self, notes: torch.Tensor, chosen: torch.Tensor,
                         beat: torch.Tensor, style: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         train: bool = False) -> torch.Tensor:
        """The JAX `_forward_biax_v3` (deepj.py:482-541): both axes as the
        biaxial stacks of ops/biax.py, each seeded once from `generator`."""
        self._check_biax_shape()
        cfg = self.cfg
        dt = self._dt()
        act = cfg.lstm_recurrent_activation
        chosen, style_emb, feats = self._inputs(
            notes, chosen, beat, style, generator, train)

        p = self._stack_dropout(generator, train)
        seed_t, seed_n = self._stack_seeds(generator, train, 2)

        emb_tb = style_emb.transpose(0, 1)                      # [T, B, S]
        with spans.span("deepj.time_axis"):
            tl0, tl1 = self.time_axis
            s0_t = torch.tanh(dense_apply(tl0.style_proj, emb_tb, dt))
            s1_t = torch.tanh(dense_apply(tl1.style_proj, emb_tb, dt))
            ht = biax_time_stack(
                feats.permute(1, 2, 0, 3), s0_t, s1_t,          # [T, N, B, F]
                tl0.lstm.kernel, tl0.lstm.bias, tl1.lstm.bias,
                tl0.lstm.recurrent, tl1.lstm.kernel, tl1.lstm.recurrent,
                dropout_p=p, seed=seed_t, compute_dtype=dt,
                recurrent_activation=act)

        with spans.span("deepj.note_axis"):
            nl0, nl1 = self.note_axis
            chosen_ntb = chosen.permute(2, 1, 0, 3)             # [N, T, B, 3]
            shift_chosen = torch.cat(
                [torch.zeros_like(chosen_ntb[:1]), chosen_ntb[:-1]], dim=0)
            s0_n = torch.tanh(dense_apply(nl0.style_proj, emb_tb, dt))
            s1_n = torch.tanh(dense_apply(nl1.style_proj, emb_tb, dt))
            whead = torch.cat([self.note_dense.kernel,
                               self.volume_dense.kernel], dim=-1)
            bhead = torch.cat([self.note_dense.bias, self.volume_dense.bias])
            out = biax_note_stack(
                ht, shift_chosen, s0_n, s1_n,
                nl0.lstm.kernel, nl0.lstm.bias, nl1.lstm.bias,
                nl0.lstm.recurrent, nl1.lstm.kernel, nl1.lstm.recurrent,
                whead, bhead, dropout_p=p, seed=seed_n, compute_dtype=dt,
                recurrent_activation=act)
        return out.permute(2, 1, 0, 3)                          # [B, T, N, 3]

    def loss(self, batch, generator: Optional[torch.Generator] = None,
             train: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """primary_loss of the forward on batch = (notes, targets, beats,
        styles) (deepj.py:545-549)."""
        notes, targets, beats, styles = batch
        preds = self.forward(notes, targets, beats, styles, generator, train)
        return primary_loss(targets, preds)



def primary_loss(y_true: torch.Tensor, y_pred: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BCE(play) + masked BCE(replay) + masked MSE(volume) (ref:
    model.py:14-20; deepj.py:634-652).  The mask replaces the prediction by
    the target where the play target is 0, zeroing the gradient there; BCE
    clips probabilities at 1e-7 like keras.backend.binary_crossentropy."""
    bce_note, bce_replay, mse = _loss_terms(y_true, y_pred)
    total = torch.mean(bce_note + bce_replay + mse)
    return total, {"loss": total, "bce_play": torch.mean(bce_note),
                   "bce_replay": torch.mean(bce_replay),
                   "mse_volume": torch.mean(mse)}


def _loss_terms(y_true: torch.Tensor, y_pred: torch.Tensor):
    """Elementwise [..., T, N] loss terms shared by the scalar training loss
    and the per-sample evaluation metrics."""
    played = y_true[..., 0]

    def bce(t, p):
        p = torch.clamp(p, 1e-7, 1 - 1e-7)
        return -(t * torch.log(p) + (1 - t) * torch.log1p(-p))

    bce_note = bce(y_true[..., 0], y_pred[..., 0])
    replay_masked = played * y_pred[..., 1] + (1 - played) * y_true[..., 1]
    bce_replay = bce(y_true[..., 1], replay_masked)
    vol_masked = played * y_pred[..., 2] + (1 - played) * y_true[..., 2]
    mse = torch.square(y_true[..., 2] - vol_masked)
    return bce_note, bce_replay, mse


def per_sample_loss(y_true: torch.Tensor,
                    y_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """primary_loss's metrics reduced per batch row ([B] vectors), so
    evaluation can weight out padded rows."""
    bce_note, bce_replay, mse = _loss_terms(y_true, y_pred)
    dims = tuple(range(1, bce_note.dim()))
    return {"loss": torch.mean(bce_note + bce_replay + mse, dim=dims),
            "bce_play": torch.mean(bce_note, dim=dims),
            "bce_replay": torch.mean(bce_replay, dim=dims),
            "mse_volume": torch.mean(mse, dim=dims)}


def build_model(cfg: Config, device: DeviceLike = None,
                state: Optional[dict] = None, seed: int = 0,
                trainable: bool = False) -> DeepJ:
    """A DeepJ on `device` holding `state` (a params.py state dict), or
    fresh weights from `seed` when no state is given.  Frozen for inference
    unless `trainable`."""
    model = DeepJ(cfg, device)
    if state is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state)
    if trainable:
        return model.requires_grad_(True).train()
    return model.requires_grad_(False).eval()
