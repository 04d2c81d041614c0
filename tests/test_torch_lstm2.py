"""The port's fused two-layer stack (music_generator_tpu_torch/ops/lstm2.py)
against the JAX package's Pallas stack (ops/pallas_lstm2.py, run in
interpret mode as tests/test_pallas_lstm2.py runs it), on the same numpy
inputs, float32.

At dropout 0 the plain version (forward and autograd backward) is held to
the Pallas forward and its custom VJP: every output and every gradient,
with nonzero initial states and nonzero cotangents of all four terminal
states, the cotangent of h0T ignored on both sides.  The Pallas kernel
draws its dropout mask from the TPU's hardware PRNG, which the interpreter
only stubs, and no other device gives those bits; the port's own mask is
held by statistics, by its independence of the row split, and by the JAX
unfused layers with the port's mask injected between them.  The CUDA
kernels are held to the plain version on the card (chip_smoke.py).
Tolerances: forward atol 1e-5, gradients atol 1e-4 (float32 on both sides;
sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops.lstm import LSTMParams as JaxLSTMParams
from music_generator_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from music_generator_tpu.ops.pallas_lstm2 import pallas_lstm2
from music_generator_tpu_torch.ops import lstm2

torch.set_num_threads(2)

S, R, F, H = 5, 12, 11, 8
GATES = ["sigmoid", "hard_sigmoid"]


def _inputs(seed):
    """x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10."""
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return [n(S, R, F), n(S, R, H, sc=0.3), n(F, 4 * H, sc=0.4),
            n(4 * H, sc=0.1), n(4 * H, sc=0.1), n(H, 4 * H, sc=0.4),
            n(H, 4 * H, sc=0.4), n(H, 4 * H, sc=0.4), n(R, H, sc=0.5),
            n(R, H, sc=0.5), n(R, H, sc=0.5), n(R, H, sc=0.5)]


@pytest.mark.parametrize("gate", GATES)
def test_reference_matches_pallas(gate):
    inputs = _inputs(0)
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in [(S, R, H)] + [(R, H)] * 4]

    def jax_fn(*a):
        hs1, fin = pallas_lstm2(*a[:8], *a[8:], dropout_p=0.0, seed=0,
                                compute_dtype=jnp.float32,
                                recurrent_activation=gate)
        return (hs1, *fin)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
        want_grads = vjp(tuple(jnp.asarray(c) for c in cots))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    hs1, fin = lstm2.lstm2_stack(*ts, recurrent_activation=gate)
    outs = (hs1, *fin)
    assert not fin[0].requires_grad          # h0T's cotangent is ignored
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(outs, cots)).backward()
    for i, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5, err_msg=f"output {i}")
    names = ("x0", "s1m", "w0", "b0", "b1", "u0", "w1", "u1", "h00", "c00",
             "h10", "c10")
    for name, t, w in zip(names, ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("p", [0.5, 0.2])
def test_mask_keeps_one_minus_p(p):
    """Over 131072 elements the kept share is within 4 sigma of 1 - p, and
    every value is 0 or 1/keep."""
    m = lstm2.stack_masks(123, 4, 256, 128, 1.0 - p, torch.float32)
    n = m.numel()
    kept = float((m != 0).sum()) / n
    assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    assert set(torch.unique(m).tolist()) == {0.0, 1.0 / (1.0 - p)}


def test_mask_is_a_function_of_seed_step_row_unit():
    """The mask of a row does not depend on how the rows are split, and it
    changes with the seed and the step."""
    full = lstm2.stack_masks(7, 3, 96, 16, 0.5, torch.float32)
    for split in (1, 40, 95):
        rows = torch.arange(96)
        for s in range(3):
            parts = [lstm2.keep_mask(7, s, r, 16, 0.5, torch.float32)
                     for r in (rows[:split], rows[split:])]
            assert torch.equal(torch.cat(parts), full[s])
    assert not torch.equal(
        lstm2.stack_masks(8, 3, 96, 16, 0.5, torch.float32), full)
    assert not torch.equal(full[0], full[1])
    assert lstm2.stack_masks(7, 3, 96, 16, 1.0, torch.float32) is None


def test_dropout_matches_unfused_layers_with_the_mask_injected():
    """At p = 0.5 the plain stack equals two JAX layers (XLA scans) with the
    port's mask applied between them: forward and input gradients."""
    x0, s1m, w0, b0, b1, u0, w1, u1 = _inputs(2)[:8]
    masks = lstm2.stack_masks(99, S, R, H, 0.5, torch.float32).numpy()
    cot = np.random.default_rng(3).standard_normal((S, R, H)).astype(
        np.float32)

    def jax_fn(x0, s1m, w0, u0, w1, u1):
        hs0, _ = jax_lstm_scan(JaxLSTMParams(w0, u0, jnp.asarray(b0)), x0)
        hs1, _ = jax_lstm_scan(JaxLSTMParams(w1, u1, jnp.asarray(b1)),
                               hs0 * masks + s1m)
        return hs1

    args = (x0, s1m, w0, u0, w1, u1)
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in args])
    want_grads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    hs1, _ = lstm2.lstm2_stack(ts[0], ts[1], ts[2], torch.from_numpy(b0),
                               torch.from_numpy(b1), *ts[3:], dropout_p=0.5,
                               seed=99)
    (hs1 * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(hs1.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain loop and launches nothing; the initial
    states default to zeros; a tensor on another device is refused."""
    ts = [torch.from_numpy(a) for a in _inputs(4)]
    calls = lstm2.lstm2_stack_reference.calls
    launches = (lstm2.lstm2_stack.fwd_launches,
                lstm2.lstm2_stack.bwd_launches)
    hs1, fin = lstm2.lstm2_stack(*ts[:8])
    zero = torch.zeros(R, H)
    hs1_z, _ = lstm2.lstm2_stack(*ts[:8], zero, zero, zero, zero)
    assert torch.equal(hs1, hs1_z) and len(fin) == 4
    assert lstm2.lstm2_stack_reference.calls == calls + 2
    assert (lstm2.lstm2_stack.fwd_launches,
            lstm2.lstm2_stack.bwd_launches) == launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lstm2.lstm2_stack(ts[0].to("meta"), *ts[1:8])
