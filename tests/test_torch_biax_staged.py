"""The time stack's staged backward (music_generator_tpu_torch/ops/biax.py
`biax_time_bwd_staged`: the six passes of csrc/biax_time.cu in plain
PyTorch) against autograd through the plain forward
(`biax_time_stack_reference`) and against the JAX package's
`_time_bwd_impl` (ops/pallas_biax.py, in interpret mode as
tests/test_torch_biax.py runs it), on the same numpy inputs and on the
forward tapes of JAX's `_time_fwd_impl`.

Tolerances.  float32: every gradient within atol 1e-4 of both (sums in
another order).  bfloat16: against JAX, whose kernel has the same cast
points, every gradient within 2e-2 of the reference's norm (||a - b|| /
||b||): a float32 sum in another order can move one rounding to bfloat16 by
an ulp, which the recurrence carries on.  Against autograd, which rounds
each intermediate gradient to bfloat16 where the kernels keep float32,
within 0.1 relative and a cosine of at least 0.995 (chip_smoke.py's
bfloat16 bars)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops import pallas_biax as jb
from music_generator_tpu_torch.ops import biax

torch.set_num_threads(2)

# (T, N, B, F, H): tests/test_torch_biax.py's small time-stack shape, and
# one with three row tiles (k = 2).
SHAPES = {"small": (6, 5, 8, 10, 12), "multi": (5, 6, 96, 10, 12)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
CASES = ([("small", p, g, dt) for p in (0.0, 0.5)
          for g in ("sigmoid", "hard_sigmoid") for dt in DTYPES]
         + [("multi", 0.5, "sigmoid", "bf16")])
NAMES = ("dx", "ds0", "ds1", "dw0", "db0", "db1", "du0", "dw1", "du1")


def _inputs(shape, seed):
    T, N, B, F, H = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    return [n(T, N, B, F), n(T, B, F, sc=0.3), n(T, B, H, sc=0.3),
            n(F, 4 * H, sc=0.3), n(4 * H, sc=0.1), n(4 * H, sc=0.1),
            n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3)]


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_tapes_and_grads(inputs, cot, p, gate, jdt):
    """JAX's forward tapes (hs0, cs0, hs1, cs1) and `_time_bwd_impl`'s
    gradients, as float32 torch tensors."""
    keep, hard = 1.0 - p, gate == "hard_sigmoid"
    a = [jnp.asarray(v) for v in inputs]
    seed = jnp.asarray(7, jnp.int32).reshape(1, 1)
    with pltpu.force_tpu_interpret_mode():
        tapes = jb._time_fwd_impl(*a, seed, keep, jdt, hard=hard)
        grads = jb._time_bwd_impl((*a, seed, *tapes), jnp.asarray(cot),
                                  keep, jdt, hard)
    return [_f32(t) for t in tapes], [_f32(g) for g in grads]


def _staged(inputs, tapes, cot, p, gate, cdt):
    ts = [torch.from_numpy(v) for v in inputs]
    got = biax.biax_time_bwd_staged(
        *ts, *(t.to(cdt) for t in tapes), torch.from_numpy(cot).to(cdt),
        dropout_p=p, seed=7, compute_dtype=cdt, recurrent_activation=gate)
    return [g.float() for g in got]


def _check(got, want, cdt, rel_tol, cos_tol=None):
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        if cdt == torch.float32:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4, err_msg=name)
            continue
        a, b = a.double().flatten(), b.double().flatten()
        rel = float((a - b).norm() / b.norm())
        assert rel <= rel_tol, (name, rel)
        if cos_tol is not None:
            cos = float(a @ b / (a.norm() * b.norm()))
            assert cos >= cos_tol, (name, cos)


@pytest.mark.parametrize("shape,p,gate,dt", CASES)
def test_staged_matches_jax_time_bwd(shape, p, gate, dt):
    cdt, jdt = DTYPES[dt]
    s = SHAPES[shape]
    inputs = _inputs(s, 3)
    T, N, B, _, H = s
    cot = np.random.default_rng(4).standard_normal(
        (T, N, B, H)).astype(np.float32)
    tapes, want = _jax_tapes_and_grads(inputs, cot, p, gate, jdt)
    _check(_staged(inputs, tapes, cot, p, gate, cdt), want, cdt, 2e-2)


@pytest.mark.parametrize("shape,p,gate,dt", CASES)
def test_staged_matches_autograd_of_the_plain_stack(shape, p, gate, dt):
    cdt, jdt = DTYPES[dt]
    s = SHAPES[shape]
    inputs = _inputs(s, 5)
    T, N, B, _, H = s
    cot = np.random.default_rng(6).standard_normal(
        (T, N, B, H)).astype(np.float32)
    ts = [torch.tensor(v, requires_grad=True) for v in inputs]
    out = biax.biax_time_stack_reference(
        *ts, dropout_p=p, seed=7, compute_dtype=cdt,
        recurrent_activation=gate)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    tapes, _ = _jax_tapes_and_grads(inputs, cot, p, gate, jdt)
    got = _staged(inputs, tapes, cot, p, gate, cdt)
    # The gradients come in the order of the inputs.
    _check(got, [t.grad for t in ts], cdt, 0.1, 0.995)
