"""The pitch-loop kernel's plain version (music_generator_tpu_torch/ops/
notegen.py::note_sample_reference, the CPU branch of `note_sample`)
against the two JAX functions it stands for: `Sampler._note_scan` on its
XLA branch, and `pallas_note_sample` in Pallas interpret mode.

Tolerances, with their reasons:
  * play and replay are equal, except that a draw whose uniform lies
    within 1e-5 of its probability may fall either way (XLA:CPU's logistic
    and log differ from ATen's by ULPs); the rest of such a stream follows
    another path and is not compared (`draws_agree`);
  * volumes agree within atol 1e-5 (float32 sums in another order).
The CUDA kernel itself runs only on the card: chip_smoke.py holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.ops.pallas_notegen import pallas_note_sample
from music_generator_tpu.ops.sampling import (
    apply_temperature as jax_apply_temperature)
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.generation.sampler import _velocity_grid
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import notegen
from music_generator_tpu_torch.ops.lstm import lstm_step
from music_generator_tpu_torch.ops.sampling import apply_temperature
from music_generator_tpu_torch.params import params_from_numpy

torch.set_num_threads(2)

EDGE = 1e-5
VOLUME_ATOL = 1e-5
G = 3


def _flat(params) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _setup(act: str, quantize: bool = False, seed: int = 0):
    overrides = dict(lstm_recurrent_activation=act,
                     gen_volume_quantize=quantize)
    cfg = jax_test_config(**overrides)
    params = init_params(jax.random.key(17), cfg)
    port = build_model(torch_test_config(**overrides), "cpu",
                       state=params_from_numpy(_flat(params)))
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1, 1, (G, cfg.num_notes, cfg.time_axis_units)
                        ).astype(np.float32)
    us = rng.random((G, cfg.num_notes, 2), dtype=np.float32)
    emb = rng.standard_normal((G, cfg.style_units), dtype=np.float32)
    return cfg, params, port, feats, us, emb


def _port_args(port, feats, us, temp, emb, act, quantize):
    vg = (torch.from_numpy(_velocity_grid(port.cfg.max_velocity))
          if quantize else None)
    return (torch.from_numpy(feats), torch.from_numpy(us),
            torch.from_numpy(temp), port.note_axis, port.note_dense,
            port.volume_dense, torch.from_numpy(emb), act, vg)


def _check(want, got, port, feats, us, temp, emb, act):
    want = torch.tensor(np.asarray(want))
    probs = notegen.tempered_probs(
        torch.from_numpy(feats), want, torch.from_numpy(temp),
        port.note_axis, port.note_dense, port.volume_dense,
        torch.from_numpy(emb), act)
    ok, err, report = notegen.draws_agree(want, got, torch.from_numpy(us),
                                          probs, EDGE, VOLUME_ATOL)
    assert ok, report
    assert err <= VOLUME_ATOL
    assert got.shape == want.shape and got.dtype == torch.float32


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("T", [1.0, 0.9])
def test_plain_version_matches_jax_note_scan(T, act, quantize):
    cfg, params, port, feats, us, emb = _setup(act, quantize)
    temp = np.full((G,), T, np.float32)
    js = JaxSampler(JaxDeepJ(cfg), params)
    want = js._note_scan(params, jnp.asarray(feats), jnp.asarray(emb),
                         jnp.asarray(temp), jnp.asarray(us))
    calls = notegen.note_sample_reference.calls
    launches = notegen.note_sample.launches
    got = notegen.note_sample(*_port_args(port, feats, us, temp, emb, act,
                                          quantize))
    # A CPU tensor takes the plain version; no kernel launch is counted.
    assert notegen.note_sample_reference.calls == calls + 1
    assert notegen.note_sample.launches == launches
    _check(want, got, port, feats, us, temp, emb, act)
    if quantize:
        grid = _velocity_grid(cfg.max_velocity)
        assert np.isin(got[..., 2].numpy(), grid).all()


@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
@pytest.mark.parametrize("T", [1.0, 0.9])
def test_plain_version_matches_pallas_kernel_interpret(T, act):
    """The Pallas kernel the CUDA kernel replaces, run in interpret mode
    as the JAX package's own tests run it (it has no quantization)."""
    from jax.experimental.pallas import tpu as pltpu
    cfg, params, port, feats, us, emb = _setup(act, seed=1)
    temp = np.full((G,), T, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_note_sample(
            jnp.asarray(feats), jnp.asarray(us), jnp.asarray(temp),
            params.note_axis[0], params.note_axis[1], params.note_dense,
            params.volume_dense, jnp.asarray(emb),
            compute_dtype=jnp.float32, recurrent_activation=act)
    got = notegen.note_sample_reference(
        *_port_args(port, feats, us, temp, emb, act, False))
    _check(want, got, port, feats, us, temp, emb, act)


@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_kernel_split_weights_equal_the_plain_cell(act):
    """What the kernel computes per pitch from the wrapper's operands
    (fold_style): z0 = feat W0f + chosen W0c + a0 + h0 U0 and z1 = h0 W1 +
    a1 + h1 U1, equal to the plain cell's concat-and-add form."""
    _, _, port, feats, _, emb = _setup(act, seed=2)
    l0, l1 = port.note_axis
    feat = torch.from_numpy(feats[:, 5])
    emb = torch.from_numpy(emb)
    chosen = torch.tensor([[1.0, 0.0, 0.7], [0.0, 0.0, 0.0],
                           [1.0, 1.0, 0.2]])
    gen = torch.Generator().manual_seed(3)
    H = l0.lstm.recurrent.shape[0]
    h0, c0, h1, c1 = (torch.rand(G, H, generator=gen) * 2 - 1
                      for _ in range(4))
    w0f, w0c, (a0, a1) = notegen.fold_style(port.note_axis, emb,
                                            feat.shape[-1])
    z0 = feat @ w0f + chosen @ w0c + a0 + h0 @ l0.lstm.recurrent
    x = torch.cat([feat, chosen], -1) + torch.tanh(
        emb @ l0.style_proj.kernel + l0.style_proj.bias)
    z0_plain = x @ l0.lstm.kernel + h0 @ l0.lstm.recurrent + l0.lstm.bias
    torch.testing.assert_close(z0, z0_plain, rtol=0, atol=1e-5)
    h0n, _ = lstm_step(l0.lstm, x, h0, c0, act)
    z1 = h0n @ l1.lstm.kernel + a1 + h1 @ l1.lstm.recurrent
    x1 = h0n + torch.tanh(emb @ l1.style_proj.kernel + l1.style_proj.bias)
    z1_plain = x1 @ l1.lstm.kernel + h1 @ l1.lstm.recurrent + l1.lstm.bias
    torch.testing.assert_close(z1, z1_plain, rtol=0, atol=1e-5)


def test_apply_temperature_matches_jax():
    """Division form: sigmoid(logit(clip(p)) / T), clipped to
    [1e-7, 1-1e-7]; a few ULPs between XLA:CPU and ATen."""
    rng = np.random.default_rng(6)
    p = np.concatenate([rng.random(1000, dtype=np.float32),
                        np.float32([0.0, 1.0, 1e-9, 1 - 1e-9])])
    for T in (1.0, 0.9, 1.7):
        want = jax_apply_temperature(jnp.asarray(p), jnp.float32(T))
        got = apply_temperature(torch.from_numpy(p), torch.tensor(T))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                                   atol=1e-6)
    # The division, not a multiply by 1/T, which rounds twice: the two
    # forms differ in some of these float32 values, and the port gives the
    # division's bits.
    x = -torch.log(1.0 / torch.clamp(torch.from_numpy(p), 1e-7, 1 - 1e-7)
                   - 1.0)
    T = torch.tensor(0.9)
    got = apply_temperature(torch.from_numpy(p), T)
    assert torch.equal(got, torch.sigmoid(x / T))
    assert not torch.equal(got, torch.sigmoid(x * (1.0 / T)))


def test_draw_fires_when_the_uniform_equals_the_probability():
    """`u <= p` is inclusive (ref: generate.py:52-53): a uniform equal to
    the tempered probability plays the note, and replays it."""
    _, _, port, feats, us, emb = _setup("sigmoid", seed=4)
    temp = np.full((G,), 0.9, np.float32)
    args = _port_args(port, feats, us, temp, emb, "sigmoid", False)
    first = notegen.note_sample_reference(*args)
    probs = notegen.tempered_probs(args[0], first, args[2], *args[3:7])
    edge = us.copy()
    edge[:, 0] = probs[:, 0].numpy()
    got = notegen.note_sample_reference(args[0], torch.from_numpy(edge),
                                        *args[2:])
    assert (got[:, 0, :2] == 1).all()


def test_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused rather
    than silently run on another path."""
    _, _, port, feats, us, emb = _setup("sigmoid", seed=3)
    meta = lambda a: torch.from_numpy(a).to("meta")
    temp = torch.ones(G, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        notegen.note_sample(meta(feats), meta(us), temp, port.note_axis,
                            port.note_dense, port.volume_dense, meta(emb))


def test_draws_agree_rejects_a_real_difference():
    """The comparison used on the card accepts a flip only at a knife
    edge and reports a volume drift."""
    a = torch.zeros(1, 4, 3)
    b = a.clone()
    u = torch.full((1, 4, 2), 0.5)
    p = torch.full((1, 4, 2), 0.5)
    b[0, 2, 0] = 1.0                         # |u - p| = 0: a knife edge
    assert notegen.draws_agree(a, b, u, p)[0]
    p[0, 2, 0] = 0.3                         # far from the edge: a fault
    assert not notegen.draws_agree(a, b, u, p)[0]
    c = a.clone()
    c[0, 1, 2] = 1e-3
    assert not notegen.draws_agree(a, c, u, p)[0]
