"""The port's single-layer recurrence (music_generator_tpu_torch/ops/
recurrence.py) and `lstm_scan` (ops/lstm.py) against the JAX package's
Pallas recurrence (ops/pallas_lstm.py, run in interpret mode as
tests/test_pallas_lstm.py runs it), on the same numpy inputs, float32.

On the CPU the wrapper runs its plain version, so these tests hold the
plain loop (forward and autograd backward) to the Pallas forward and its
custom VJP, with nonzero initial states and nonzero cotangents of h_T and
c_T.  The CUDA kernels are held to this plain version on the card
(chip_smoke.py).  Tolerances: rtol 1e-5 and atol 1e-5 (float32 on both
sides; sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops.lstm import LSTMParams as JaxLSTMParams
from music_generator_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from music_generator_tpu.ops.pallas_lstm import pallas_lstm_recurrence
from music_generator_tpu_torch.ops import recurrence
from music_generator_tpu_torch.ops.lstm import lstm_scan

torch.set_num_threads(2)

S, R, D, H = 6, 10, 7, 8
GATES = ["sigmoid", "hard_sigmoid"]


def _normal(rng, *shape, sc=1.0):
    return (rng.standard_normal(shape) * sc).astype(np.float32)


def _check(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5, err_msg=what)


@pytest.mark.parametrize("gate", GATES)
def test_reference_matches_pallas(gate):
    """hs, h_T, c_T and the gradients in xw, u, h0, c0 with nonzero
    terminal cotangents."""
    rng = np.random.default_rng(0)
    inputs = [_normal(rng, S, R, 4 * H), _normal(rng, H, 4 * H, sc=0.4),
              _normal(rng, R, H, sc=0.5), _normal(rng, R, H, sc=0.5)]
    cots = [_normal(rng, S, R, H), _normal(rng, R, H), _normal(rng, R, H)]

    def jax_fn(*a):
        hs, (hT, cT) = pallas_lstm_recurrence(*a, compute_dtype=jnp.float32,
                                              recurrent_activation=gate)
        return hs, hT, cT

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
        want_grads = vjp(tuple(jnp.asarray(c) for c in cots))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    hs, (hT, cT) = recurrence.lstm_recurrence(*ts, torch.float32, gate)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip((hs, hT, cT), cots))
    loss.backward()
    for name, g, w in zip(("hs", "h_T", "c_T"), (hs, hT, cT), want):
        _check(g.detach(), w, name)
    for name, t, w in zip(("xw", "u", "h0", "c0"), ts, want_grads):
        _check(t.grad, w, f"d{name}")


@pytest.mark.parametrize("gate", GATES)
def test_lstm_scan_matches_jax_pallas_route(gate):
    """lstm_scan (projection + recurrence) against the JAX
    lstm_scan(kernel="pallas"): outputs and the gradients of the input,
    kernel, recurrent matrix and bias."""
    rng = np.random.default_rng(1)
    xs = _normal(rng, S, R, D)
    p = [_normal(rng, D, 4 * H, sc=0.5), _normal(rng, H, 4 * H, sc=0.4),
         _normal(rng, 4 * H, sc=0.1)]
    cot = _normal(rng, S, R, H)

    def jax_fn(xs, k, u, b):
        hs, _ = jax_lstm_scan(JaxLSTMParams(k, u, b), xs, kernel="pallas",
                              compute_dtype=jnp.float32,
                              recurrent_activation=gate)
        return hs

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fn, jnp.asarray(xs),
                            *[jnp.asarray(a) for a in p])
        want_grads = vjp(jnp.asarray(cot))
    tx = torch.tensor(xs, requires_grad=True)
    params = torch.nn.Module()
    for name, a in zip(("kernel", "recurrent", "bias"), p):
        setattr(params, name, torch.nn.Parameter(torch.tensor(a)))
    hs, (hT, cT) = lstm_scan(params, tx, recurrent_activation=gate)
    (hs * torch.from_numpy(cot)).sum().backward()
    _check(hs.detach(), want, "hs")
    _check(hT.detach(), want[-1], "h_T")
    for name, t, w in zip(("xs", "kernel", "recurrent", "bias"),
                          (tx, params.kernel, params.recurrent, params.bias),
                          want_grads):
        _check(t.grad, w, f"d{name}")


def test_bfloat16_plain_version_keeps_the_kernel_dtypes():
    """hs leaves in the compute dtype, the terminal states in float32."""
    rng = np.random.default_rng(2)
    xw, u = _normal(rng, S, R, 4 * H), _normal(rng, H, 4 * H, sc=0.4)
    zeros = torch.zeros(R, H)
    hs, (hT, cT) = recurrence.lstm_recurrence(
        torch.from_numpy(xw), torch.from_numpy(u), zeros, zeros,
        torch.bfloat16)
    assert hs.dtype == torch.bfloat16 and hs.shape == (S, R, H)
    assert hT.dtype == cT.dtype == torch.float32
    # h_T is the unrounded float32 h of the last step.
    assert torch.equal(hT.to(torch.bfloat16), hs[-1])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain loop and launches nothing; a tensor on
    another device is refused; an unknown gate name raises."""
    rng = np.random.default_rng(3)
    xw = torch.from_numpy(_normal(rng, S, R, 4 * H))
    u = torch.from_numpy(_normal(rng, H, 4 * H))
    h0 = torch.zeros(R, H)
    calls = recurrence.lstm_recurrence_reference.calls
    launches = (recurrence.lstm_recurrence.fwd_launches,
                recurrence.lstm_recurrence.bwd_launches)
    recurrence.lstm_recurrence(xw, u, h0, h0)
    assert recurrence.lstm_recurrence_reference.calls == calls + 1
    assert (recurrence.lstm_recurrence.fwd_launches,
            recurrence.lstm_recurrence.bwd_launches) == launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        recurrence.lstm_recurrence(xw.to("meta"), u, h0, h0)
    with pytest.raises(ValueError, match="unknown lstm_recurrent"):
        recurrence.lstm_recurrence(xw, u, h0, h0,
                                   recurrent_activation="hard-sigmoid")
