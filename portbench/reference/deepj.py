"""DeepJ in plain float32 PyTorch: the forward of training with its
dropout, the masked three-term loss, autograd gradients and the Keras-2
Nadam update, and teacher-forced generation.  It imports nothing of the
program; weights are a dict of float32 tensors under the checkpoints'
names (`time_axis.0.lstm.kernel`, ...).

The model (Mao et al., "DeepJ", arXiv:1801.00887; the reference code's
model.py): per (time, note) features [pitch position, pitch class,
chromagram, tanh(octave conv), beat], two style-conditioned LSTM layers
along time, then two along the pitches fed with the chosen note below,
then sigmoid (play, replay) and a linear volume.  Departures from the
published description, each the program's documented behaviour:

  * the chromagram is the per-pitch-class count of played notes over the
    octaves (the reference code's reshape scrambles axes);
  * the recurrent gates are the logistic sigmoid, not Keras 2's
    hard_sigmoid;
  * dropout: the input, conv and style-term dropouts draw from a
    torch.Generator per step (`masks.step_generator`) in a fixed order;
    the LSTM stacks' dropouts are the hash masks of `masks.py`;
  * `time_axis_kind="linear"`: the time axis is a gated linear
    recurrence (Feng et al., arXiv:2410.01201), h = (1 - g) h + g z with
    g = sigmoid(x Wg + bg), z = tanh(x Wz + bz), run here one step at a
    time;
  * generation clips the volume to [0, 1] before it is copied through,
    re-tempers p by sigmoid(logit(p) / T) and raises T by 0.1 a silent
    step once a bar has been silent.

Precision: every product takes its operands and its result through
`Arith.q`.  Float32 (TF32 off) is the reference; `Arith("fp8")` rounds
each of them, and each of their gradients, to float8 e4m3 under a
per-tensor scale (the control of a bfloat16 configuration);
`Arith("tf32")` lets cuBLAS and cuDNN use TF32 (the control of a float32
configuration)."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import masks as rm

Params = Dict[str, torch.Tensor]


FP8_MAX = 448.0                  # float8 e4m3's largest finite value


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest (current scaling)."""
    amax = x.detach().abs().amax()
    s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Fp8Round(torch.autograd.Function):
    """Scaled float8 rounding of a value going forward and of its gradient
    coming back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Arith:
    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8", "tf32"):
            raise ValueError(f"unknown arithmetic {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """The operand or result of a product as this arithmetic holds it
        (float8: rounded, with its gradient, under a per-tensor scale)."""
        return _Fp8Round.apply(x) if self.kind == "fp8" else x

    @contextlib.contextmanager
    def on(self) -> Iterator[None]:
        """TF32 off, or on for "tf32", inside the block; the process's
        setting is restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        tf32 = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def _mm(ar: Arith, x, w):
    return ar.q(ar.q(x) @ ar.q(w))


def dense(p: Params, name: str, x, ar: Arith):
    return _mm(ar, x, p[name + ".kernel"]) + p[name + ".bias"]


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    """Inverted dropout: keep where a uniform from `gen` is below 1 -
    rate, scaled by 1/keep; the uniforms are drawn in x's full shape."""
    if gen is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=gen, device=gen.device) < keep
    return torch.where(m.to(x.device), x / keep, torch.zeros_like(x))


def octave_conv(p: Params, cm: dict, notes, ar: Arith):
    """tanh of the 'same' conv over the pitches, Keras's even-width
    padding: [B, T, N, C] -> [B, T, N, octave_units]."""
    B, T, N, C = notes.shape
    w = p["conv.kernel"]                           # [width, in, out]
    width = w.shape[0]
    x = notes.reshape(B * T, N, C).transpose(1, 2)
    x = F.pad(x, ((width - 1) // 2, width // 2))
    out = ar.q(F.conv1d(ar.q(x), ar.q(w.permute(2, 1, 0)))) \
        + p["conv.bias"][:, None]
    return torch.tanh(out.transpose(1, 2)).reshape(B, T, N, -1)


def features(cm: dict, notes, beat, conv):
    """[pitch position, pitch class, chromagram, conv, beat] per (b, t,
    n): [B, T, N, F]."""
    B, T, N, _ = notes.shape
    dev = notes.device
    octave = cm["octave"]
    pos = (torch.arange(N, device=dev, dtype=torch.float32) / N)
    pos = pos[None, None, :, None].expand(B, T, N, 1)
    cls = F.one_hot(torch.arange(N, device=dev) % octave, octave).float()
    cls = cls[None, None].expand(B, T, N, octave)
    counts = notes[..., 0].reshape(B, T, N // octave, octave).sum(dim=2)
    chroma = counts.repeat(1, 1, N // octave)[..., None]
    beat = beat[:, :, None, :].expand(B, T, N, beat.shape[-1])
    return torch.cat([pos, cls, chroma, conv, beat], dim=-1)


def lstm_cell(p: Params, name: str, xw, h, c, ar: Arith):
    """z = xw + h U (xw holding x W + b); gates i, f, g, o."""
    z = xw + _mm(ar, h, p[name + ".recurrent"])
    H = h.shape[-1]
    i = torch.sigmoid(z[..., :H])
    f = torch.sigmoid(z[..., H:2 * H])
    g = torch.tanh(z[..., 2 * H:3 * H])
    o = torch.sigmoid(z[..., 3 * H:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def lstm_layer(p: Params, name: str, xs, ar: Arith):
    """One LSTM layer over xs [S, R, in] from zero state -> hs [S, R, H].
    The input products of all steps are one product."""
    S, R, _ = xs.shape
    H = p[name + ".recurrent"].shape[0]
    xw = _mm(ar, xs, p[name + ".kernel"]) + p[name + ".bias"]
    h = xs.new_zeros(R, H)
    c = xs.new_zeros(R, H)
    hs = []
    for s in range(S):
        h, c = lstm_cell(p, name, xw[s], h, c, ar)
        hs.append(h)
    return torch.stack(hs)


def glru_layer(p: Params, name: str, xs, ar: Arith):
    """The gated linear recurrence over xs [S, R, in] from zero state."""
    W, b = p[name + ".kernel"], p[name + ".bias"]
    H = b.shape[0] // 2
    pre = _mm(ar, xs, W) + b
    g = torch.sigmoid(pre[..., :H])
    z = torch.tanh(pre[..., H:])
    a, bb = 1.0 - g, g * z
    h = xs.new_zeros(xs.shape[1], H)
    hs = []
    for s in range(xs.shape[0]):
        h = a[s] * h + bb[s]
        hs.append(h)
    return torch.stack(hs)


def heads(p: Params, x, ar: Arith):
    """sigmoid(play, replay) ++ linear volume."""
    return torch.cat([torch.sigmoid(dense(p, "note_dense", x, ar)),
                      dense(p, "volume_dense", x, ar)], dim=-1)


# -- weights ------------------------------------------------------------

def feature_dim(cm: dict) -> int:
    return 1 + cm["octave"] + 1 + cm["octave_units"] + cm["notes_per_bar"]


def param_shapes(cm: dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the configuration, by name, with its shape: Dense
    and LSTM kernels [in, out], LSTM gates (i, f, g, o), the conv kernel
    [width, in, out]; a GLRU layer holds kernel [in, 2H] and bias [2H]."""
    S, Ht, Hn = cm["style_units"], cm["time_axis_units"], cm["note_axis_units"]
    C = cm["note_units"]
    out = {"style_embed.kernel": (cm["num_styles"], S),
           "style_embed.bias": (S,),
           "conv.kernel": (2 * cm["octave"], C, cm["octave_units"]),
           "conv.bias": (cm["octave_units"],)}

    def axis(prefix, dims, H, linear):
        for l in range(len(dims) - 1):
            n = f"{prefix}.{l}"
            out[n + ".style_proj.kernel"] = (S, dims[l])
            out[n + ".style_proj.bias"] = (dims[l],)
            g = 2 if linear else 4
            out[n + ".lstm.kernel"] = (dims[l], g * H)
            if not linear:
                out[n + ".lstm.recurrent"] = (H, 4 * H)
            out[n + ".lstm.bias"] = (g * H,)

    axis("time_axis", [feature_dim(cm)] + [Ht] * cm["time_axis_layers"], Ht,
         cm["time_axis_kind"] == "linear")
    axis("note_axis", [Ht + C] + [Hn] * cm["note_axis_layers"], Hn, False)
    out.update({"note_dense.kernel": (Hn, 2), "note_dense.bias": (2,),
                "volume_dense.kernel": (Hn, 1), "volume_dense.bias": (1,)})
    return out


def make_weights(cm: dict, gen: torch.Generator) -> Params:
    """Weights from `gen` in one draw on its device: each kernel uniform
    in +-sqrt(6 / (fan_in + fan_out)) (glorot), each recurrent matrix
    uniform in +-sqrt(3 / H) (variance 1/H, an orthogonal matrix's),
    biases zero but an LSTM's forget gate, 1."""
    shapes = param_shapes(cm)
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[n])) for n in names]
    flat = torch.rand(sum(sizes), generator=gen, device=gen.device) * 2 - 1
    out, at = {}, 0
    for n, size in zip(names, sizes):
        shape = shapes[n]
        w = flat[at:at + size].reshape(shape)
        at += size
        if n.endswith("recurrent"):
            w = w * math.sqrt(3.0 / shape[0])
        elif n.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            fan_out = shape[-1] * (shape[0] if len(shape) == 3 else 1)
            w = w * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            w = torch.zeros_like(w)
            if n.endswith("lstm.bias") and (n.replace("bias", "recurrent")
                                             in shapes):
                H = shape[0] // 4
                w[H:2 * H] = 1.0
        out[n] = w.contiguous()
    return out


# -- training -----------------------------------------------------------

def _forward_lstm_stacks(p, cm, feats, chosen, emb, seeds, ar):
    """Both axes as two-layer LSTM stacks with the biaxial hash masks:
    time over (n, b) rows, then the pitches over (t, b) rows."""
    B, T, N, Fd = feats.shape
    keep = 1.0 - cm["dropout"]
    dev = feats.device
    seed_t, seed_n = seeds
    emb_tb = emb.transpose(0, 1)                              # [T, B, S]
    tn = lambda l: f"time_axis.{l}"
    nn_ = lambda l: f"note_axis.{l}"
    Ht = p["time_axis.0.lstm.recurrent"].shape[0]
    s0 = torch.tanh(dense(p, tn(0) + ".style_proj", emb_tb, ar))
    s1 = torch.tanh(dense(p, tn(1) + ".style_proj", emb_tb, ar))
    m = lambda site, W: rm.stack_mask(seed_t, site, T, N, B, W, keep, dev)
    m0, m1, mmid = m(rm.S_STYLE0, Fd), m(rm.S_STYLE1, Ht), m(rm.S_MID, Ht)
    x = feats.permute(1, 2, 0, 3)                             # [T, N, B, F]
    x0 = x + s0[:, None] * m0
    hs0 = lstm_layer(p, tn(0) + ".lstm", x0.reshape(T, N * B, Fd), ar)
    x1 = hs0.reshape(T, N, B, Ht) * mmid + s1[:, None] * m1
    ht = lstm_layer(p, tn(1) + ".lstm", x1.reshape(T, N * B, Ht), ar)
    ht = ht.reshape(T, N, B, Ht)

    C = chosen.shape[-1]
    Hn = p["note_axis.0.lstm.recurrent"].shape[0]
    ch = chosen.permute(2, 1, 0, 3)                           # [N, T, B, C]
    ch = torch.cat([torch.zeros_like(ch[:1]), ch[:-1]])
    s0n = torch.tanh(dense(p, nn_(0) + ".style_proj", emb_tb, ar))
    s1n = torch.tanh(dense(p, nn_(1) + ".style_proj", emb_tb, ar))
    m = lambda site, W: rm.stack_mask(seed_n, site, N, T, B, W, keep, dev)
    m_in, m0t, m0c = m(rm.S_IN, Ht), m(rm.S_STYLE0, Ht), m(rm.S_STYLE0C, C)
    m1, mmid, m_out = m(rm.S_STYLE1, Hn), m(rm.S_MID, Hn), m(rm.S_OUT, Hn)
    xt = ht.permute(1, 0, 2, 3) * m_in + s0n[None, ..., :Ht] * m0t
    xc = ch + s0n[None, ..., Ht:] * m0c
    x0 = torch.cat([xt, xc], dim=-1).reshape(N, T * B, Ht + C)
    hs0 = lstm_layer(p, nn_(0) + ".lstm", x0, ar).reshape(N, T, B, Hn)
    x1 = hs0 * mmid + s1n[None] * m1
    hs1 = lstm_layer(p, nn_(1) + ".lstm", x1.reshape(N, T * B, Hn), ar)
    out = heads(p, hs1.reshape(N, T, B, Hn) * m_out, ar)      # [N, T, B, 3]
    return out.permute(2, 1, 0, 3)


def _forward_linear(p, cm, feats, chosen, emb, seeds, gen, ar):
    """The GLRU time axis (style terms and outputs through the step's
    dropout generator), then the pitches as the fused two-layer stack
    with its hash mask between the layers."""
    B, T, N, Fd = feats.shape
    rate = cm["dropout"]
    _, seed_n = seeds
    x = feats.permute(1, 0, 2, 3)                             # [T, B, N, F]
    emb_tb = emb.transpose(0, 1)
    for l in range(2):
        name = f"time_axis.{l}"
        proj = torch.tanh(dense(p, name + ".style_proj", emb_tb, ar))
        x = x + dropout(proj.unsqueeze(2).expand(x.shape), rate, gen)
        hs = glru_layer(p, name + ".lstm", x.reshape(T, B * N, -1), ar)
        x = dropout(hs.reshape(T, B, N, -1), rate, gen)
    time_nm = x.permute(2, 1, 0, 3)                           # [N, B, T, H]
    ch = chosen.permute(2, 0, 1, 3)                           # [N, B, T, C]
    ch = torch.cat([torch.zeros_like(ch[:1]), ch[:-1]])
    x = torch.cat([time_nm, ch], dim=-1)
    Hn = p["note_axis.0.lstm.recurrent"].shape[0]
    proj0 = torch.tanh(dense(p, "note_axis.0.style_proj", emb, ar))
    x = x + dropout(proj0.unsqueeze(0).expand(x.shape), rate, gen)
    proj1 = torch.tanh(dense(p, "note_axis.1.style_proj", emb, ar))
    s1m = dropout(proj1.unsqueeze(0).expand(N, B, T, Hn), rate, gen)
    mid = rm.fused_stack_mask(seed_n, N, B * T, Hn, 1.0 - rate, x.device)
    hs0 = lstm_layer(p, "note_axis.0.lstm", x.reshape(N, B * T, -1), ar)
    x1 = hs0 * mid + s1m.reshape(N, B * T, Hn)
    hs1 = lstm_layer(p, "note_axis.1.lstm", x1, ar)
    out = heads(p, dropout(hs1.reshape(N, B, T, Hn), rate, gen), ar)
    return out.permute(1, 2, 0, 3)                            # [B, T, N, 3]


def train_forward(p: Params, cm: dict, batch, gen: torch.Generator,
                  ar: Arith):
    """Predictions [B, T, N, 3] of the training forward with dropout from
    `gen`, drawn in the step's order: the input dropouts of notes, beat
    and targets, the conv output, the two stack seeds in one draw, then
    (linear time axis) the style terms and outputs of each layer."""
    notes, targets, beats, styles = batch
    rate_in, rate = cm["input_dropout"], cm["dropout"]
    notes = dropout(notes, rate_in, gen)
    beats = dropout(beats, rate_in, gen)
    chosen = dropout(targets, rate_in, gen)
    emb = dense(p, "style_embed", styles, ar)                 # [B, T, S]
    conv = dropout(octave_conv(p, cm, notes, ar), rate, gen)
    feats = features(cm, notes, beats, conv)
    seeds = torch.randint(0, 2**31 - 1, (2,), generator=gen,
                          device=gen.device).tolist()
    if cm["time_axis_kind"] == "linear":
        return _forward_linear(p, cm, feats, chosen, emb, seeds, gen, ar)
    return _forward_lstm_stacks(p, cm, feats, chosen, emb, seeds, ar)


def loss_fn(y_true, y_pred):
    """BCE(play) + BCE(replay) and squared volume error where the play
    target is 1 (elsewhere the prediction is replaced by the target);
    probabilities clipped to [1e-7, 1 - 1e-7]."""
    played = y_true[..., 0]

    def bce(t, q):
        q = torch.clamp(q, 1e-7, 1 - 1e-7)
        return -(t * torch.log(q) + (1 - t) * torch.log1p(-q))

    rep = played * y_pred[..., 1] + (1 - played) * y_true[..., 1]
    vol = played * y_pred[..., 2] + (1 - played) * y_true[..., 2]
    return torch.mean(bce(y_true[..., 0], y_pred[..., 0])
                      + bce(y_true[..., 1], rep)
                      + torch.square(y_true[..., 2] - vol))


class Nadam:
    """Keras 2 Nadam (lr, beta1, beta2, eps, schedule decay) with the
    Dozat momentum schedule mu_t = beta1 (1 - 0.5 0.96^(0.004 t))."""

    def __init__(self, cm: dict, params: Params):
        self.lr, self.b1, self.b2 = (cm["learning_rate"], cm["beta1"],
                                     cm["beta2"])
        self.eps, self.decay = cm["eps"], cm["schedule_decay"]
        self.t = 0
        self.m_sched = 1.0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        t, b1, b2 = float(self.t), self.b1, self.b2
        mom_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self.decay))
        mom_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1.0) * self.decay))
        m_sched = self.m_sched * mom_t
        m_next = m_sched * mom_t1
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu = self.mu[k].mul_(b1).add_((1.0 - b1) * g)
                nu = self.nu[k].mul_(b2).add_((1.0 - b2) * g * g)
                m_bar = ((1.0 - mom_t) * g / (1.0 - m_sched)
                         + mom_t1 * mu / (1.0 - m_next))
                v = nu / (1.0 - b2 ** t)
                p.add_(-self.lr * m_bar / (torch.sqrt(v) + self.eps))
        self.m_sched = m_sched


def train_readings(p0: Params, cm: dict, batches: Sequence, seed: int,
                   ar: Arith, loss_rows: Optional[int] = None) -> dict:
    """Three training steps from the weights p0 on `batches` with the
    dropout of steps 0, 1, 2 under `seed`: each step's loss, every leaf's
    gradient norm at step 1, and every leaf's change norm after step 3.
    `loss_rows` takes the loss over the first rows of each batch only
    (with the whole batch's forward and dropout): a planted fault."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in p0.items()}
    opt = Nadam(cm, params)
    losses, grad_norms = [], {}
    with ar.on():
        for step, batch in enumerate(batches):
            dev = batch[0].device
            gen = rm.step_generator(seed, step, dev)
            pred = train_forward(params, cm, batch, gen, ar)
            loss = loss_fn(batch[1][:loss_rows], pred[:loss_rows])
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            losses.append(float(loss.detach()))
            if step == 0:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            opt.step(params, grads)
    change = {k: float((params[k].detach() - p0[k]).norm()) for k in p0}
    return {"loss": losses, "grad": grad_norms, "change": change}


# -- generation ---------------------------------------------------------

def apply_temperature(prob, temperature):
    q = torch.clamp(prob, 1e-7, 1 - 1e-7)
    return torch.sigmoid(-torch.log(1.0 / q - 1.0) / temperature)


def temperatures(cm: dict, notes: np.ndarray,
                 base: np.ndarray) -> np.ndarray:
    """The temperature in force at each step [G, T] of streams that chose
    `notes` [G, T, N, 3]: a generation starts silent for a bar; a step
    with no note resets T to its base, a silent step adds 0.1 once a
    full bar has been silent."""
    G, T = notes.shape[:2]
    bar = cm["notes_per_bar"]
    out = np.empty((G, T), np.float32)
    temp = base.astype(np.float32).copy()
    silent_time = np.full(G, bar, np.int64)
    for t in range(T):
        out[:, t] = temp
        silent = notes[:, t].sum(axis=(1, 2)) == 0
        silent_time = np.where(silent, silent_time + 1, 0)
        bump = silent & (silent_time >= bar)
        temp = np.where(bump, temp + np.float32(0.1),
                        np.where(silent, temp, base)).astype(np.float32)
    return out


@torch.no_grad()
def generation_probs(p: Params, cm: dict, styles, notes, temps,
                     ar: Arith):
    """Teacher-forced generation: for streams with style mixtures
    `styles` [G, num_styles] that chose `notes` [G, T, N, 3] under the
    temperatures `temps` [G, T], the tempered (play, replay) probabilities
    [G, T, N, 2] and the clipped volume [G, T, N] the model gives at every
    draw.  The time axis sees the notes chosen at t - 1 (zeros at t = 0)
    and the beat of t - 1; pitch n sees the note chosen at n - 1."""
    G, T, N, C = notes.shape
    bar = cm["notes_per_bar"]
    dev = notes.device
    with ar.on():
        emb = dense(p, "style_embed", styles, ar)                # [G, S]
        prev = torch.cat([torch.zeros_like(notes[:, :1]), notes[:, :-1]],
                         dim=1)
        beat = torch.zeros(G, T, bar, device=dev)
        t_idx = torch.arange(1, T, device=dev)
        beat[:, t_idx, (t_idx - 1) % bar] = 1.0
        conv = octave_conv(p, cm, prev, ar)
        x = features(cm, prev, beat, conv)                       # [G, T, N, F]
        for l in range(cm["time_axis_layers"]):
            name = f"time_axis.{l}"
            x = x + torch.tanh(dense(p, name + ".style_proj", emb, ar))[
                :, None, None]
            xs = x.permute(1, 0, 2, 3).reshape(T, G * N, -1)
            if cm["time_axis_kind"] == "linear":
                hs = glru_layer(p, name + ".lstm", xs, ar)
            else:
                hs = lstm_layer(p, name + ".lstm", xs, ar)
            x = hs.reshape(T, G, N, -1).permute(1, 0, 2, 3)      # [G, T, N, H]
        below = torch.cat([torch.zeros_like(notes[:, :, :1]),
                           notes[:, :, :-1]], dim=2)
        x = torch.cat([x, below], dim=-1)
        xs = x.permute(2, 0, 1, 3).reshape(N, G * T, -1)        # [N, GT, F]
        for l in range(cm["note_axis_layers"]):
            name = f"note_axis.{l}"
            term = torch.tanh(dense(p, name + ".style_proj", emb, ar))
            xs = xs + term[None, :, None].expand(
                N, G, T, term.shape[-1]).reshape(N, G * T, -1)
            xs = lstm_layer(p, name + ".lstm", xs, ar)
        pred = heads(p, xs, ar).reshape(N, G, T, 3).permute(1, 2, 0, 3)
        probs = apply_temperature(pred[..., :2], temps[:, :, None, None])
        volume = torch.clamp(pred[..., 2], 0.0, 1.0)
    return probs, volume


def stream_uniforms(seeds: Sequence[int], streams: Sequence[int], T: int,
                    N: int, device) -> torch.Tensor:
    """The uniforms [G, T, N, 2] of stream index streams[g] under seed
    seeds[g]."""
    root = rm.key(torch.as_tensor(np.asarray(seeds, np.int64),
                                  device=device))
    sk = rm.fold_in(root, torch.as_tensor(np.asarray(streams, np.int64),
                                          device=device))
    ts = torch.arange(T, dtype=torch.int64, device=device)
    return rm.uniform(rm.fold_in(sk[:, None], ts[None, :]), (N, 2))



class _Stepper:
    """The reference's generation one timestep, then one pitch, at a
    time, in one arithmetic, for G streams."""

    def __init__(self, p: Params, cm: dict, styles, ar: Arith):
        self.p, self.cm, self.ar = p, cm, ar
        G = styles.shape[0]
        self.G, self.N = G, cm["num_notes"]
        with ar.on():
            self.emb = dense(p, "style_embed", styles, ar)
        linear = cm["time_axis_kind"] == "linear"
        Ht = p["time_axis.0.lstm.bias"].shape[0] // (2 if linear else 4)
        z = styles.new_zeros(G * self.N, Ht)
        self.time = [(z, z)] * cm["time_axis_layers"]

    def time_step(self, prev, t: int) -> None:
        """Advance the time axis on the notes `prev` [G, N, 3] chosen at
        t - 1 and the beat of t - 1; start the pitch loop of step t."""
        p, cm, ar, G, N = self.p, self.cm, self.ar, self.G, self.N
        bar = cm["notes_per_bar"]
        with ar.on():
            beat = prev.new_zeros(G, 1, bar)
            if t > 0:
                beat[:, 0, (t - 1) % bar] = 1.0
            x = features(cm, prev[:, None], beat,
                         octave_conv(p, cm, prev[:, None], ar))[:, 0]
            for l, (h, c) in enumerate(self.time):
                name = f"time_axis.{l}"
                x = x + torch.tanh(dense(p, name + ".style_proj", self.emb,
                                         ar))[:, None]
                xin = x.reshape(G * N, -1)
                pre = _mm(ar, xin, p[name + ".lstm.kernel"]) + \
                    p[name + ".lstm.bias"]
                if cm["time_axis_kind"] == "linear":
                    H = pre.shape[-1] // 2
                    g = torch.sigmoid(pre[:, :H])
                    h = (1.0 - g) * h + g * torch.tanh(pre[:, H:])
                else:
                    h, c = lstm_cell(p, name + ".lstm", pre, h, c, ar)
                self.time[l] = (h, c)
                x = h.reshape(G, N, -1)
        self.feat = x
        self.note = [(x.new_zeros(G, p[f"note_axis.{l}.lstm.recurrent"]
                                  .shape[0]),) * 2
                     for l in range(cm["note_axis_layers"])]

    def pitch(self, n: int, chosen, temp):
        """Pitch n after the chosen note n - 1 [G, 3]: the tempered (play,
        replay) probabilities [G, 2] and the clipped volume [G]."""
        p, ar = self.p, self.ar
        with ar.on():
            x = torch.cat([self.feat[:, n], chosen], dim=-1)
            for l, (h, c) in enumerate(self.note):
                name = f"note_axis.{l}"
                x = x + torch.tanh(dense(p, name + ".style_proj", self.emb,
                                         ar))
                xw = _mm(ar, x, p[name + ".lstm.kernel"]) + \
                    p[name + ".lstm.bias"]
                h, c = lstm_cell(p, name + ".lstm", xw, h, c, ar)
                self.note[l] = (h, c)
                x = h
            pred = heads(p, x, ar)
        return (apply_temperature(pred[:, :2], temp[:, None]),
                torch.clamp(pred[:, 2], 0.0, 1.0))


@torch.no_grad()
def served_gaps(p: Params, cm: dict, styles, play, replay, vel, steps,
                seeds: Sequence[int], ar: Arith, decide=None) -> dict:
    """The pieces a service returned as `.mid` (`midi.decode`: play [G, T,
    N] exact, replay [G, T, N] and velocity bytes [G, T, N] with -1 where
    the file does not tell), each `steps[g]` timesteps of stream 0 under
    seed seeds[g] at temperature 1, generated again by the reference step
    by step and pitch by pitch, led by the file: every draw takes the
    file's play bit and, where the file has it, its replay bit; the rest
    (replays the file cannot show, every volume) are the reference's own.

    `draw_gap`: the widest |u - p| of a draw the file decided otherwise
    than the reference's u <= p; `volume_gap`: the largest distance of the
    reference's volume from [byte, byte + 1) / 127 of a velocity the file
    holds.  `decide`, when given, is an arithmetic that runs beside the
    reference on the same inputs and whose own draws and volume bytes
    stand in the file's place (the control)."""
    G, T, N = play.shape
    dev = play.device
    u = stream_uniforms(seeds, [0] * G, T, N, dev)              # [G,T,N,2]
    live = (torch.arange(T, device=dev)[None, :]
            < torch.as_tensor(list(steps), device=dev)[:, None])
    temps = torch.from_numpy(temperatures(
        cm, play.cpu().numpy()[..., None].astype(np.float32),
        np.ones(G, np.float32))).to(dev)
    ref = _Stepper(p, cm, styles, ar)
    ctl = None if decide is None else _Stepper(p, cm, styles, decide)
    draw = torch.zeros((), device=dev)
    vgap = torch.zeros((), device=dev)
    prev = torch.zeros(G, N, 3, device=dev)
    for t in range(T):
        ref.time_step(prev, t)
        if ctl is not None:
            ctl.time_step(prev, t)
        chosen = prev.new_zeros(G, 3)
        row = []
        for n in range(N):
            prob, vol = ref.pitch(n, chosen, temps[:, t])
            un, ok = u[:, t, n], live[:, t]
            mine_play = un[:, 0] <= prob[:, 0]
            mine_rep = un[:, 1] <= prob[:, 1]
            if ctl is None:
                f_play, f_rep, f_vel = (play[:, t, n] > 0, replay[:, t, n],
                                        vel[:, t, n])
            else:
                cprob, cvol = ctl.pitch(n, chosen, temps[:, t])
                f_play = un[:, 0] <= cprob[:, 0]
                f_rep = (un[:, 1] <= cprob[:, 1]).to(torch.int8)
                f_vel = torch.floor(cvol * 127.0).to(torch.int16)
            margin = (un - prob).abs()
            bad_p = ok & (f_play != mine_play)
            bad_r = ok & f_play & mine_play & (f_rep >= 0) & (
                (f_rep > 0) != mine_rep)
            draw = torch.maximum(draw, torch.where(bad_p, margin[:, 0],
                                                   0.0).max())
            draw = torch.maximum(draw, torch.where(bad_r, margin[:, 1],
                                                   0.0).max())
            lo = f_vel.float() / 127.0
            out = (torch.clamp(lo - vol, min=0.0)
                   + torch.clamp(vol - (lo + 1.0 / 127.0), min=0.0))
            vgap = torch.maximum(vgap, torch.where(
                ok & f_play & mine_play & (f_vel >= 0), out, 0.0).max())
            rep = torch.where(f_rep >= 0, f_rep > 0, mine_rep) & f_play
            chosen = torch.stack([f_play.float(), rep.float(),
                                  vol * f_play.float()], dim=-1)
            row.append(chosen)
        prev = torch.stack(row, dim=1)
    return {"draw_gap": float(draw), "volume_gap": float(vgap)}
