"""The time stack's staged forward (music_generator_tpu_torch/ops/biax.py
`biax_time_fwd_staged`: the six passes of csrc/biax_time.cu in plain
PyTorch) against the JAX package's `_time_fwd_impl` (ops/pallas_biax.py, in
interpret mode as tests/test_torch_biax.py runs it), all four tapes, and
against the plain loop `biax_time_stack_reference` (hs1), on the same numpy
inputs; and the staged backward run on the staged forward's tapes against
JAX's `_time_bwd_impl` on JAX's own tapes.

Tolerances.  float32: atol 1e-5, since the bulk products sum in another
order than a product per step.  bfloat16: within 2e-2 of the reference's
norm (||a - b|| / ||b||): a float32 sum in another order can move one
rounding to bfloat16 by an ulp, which the recurrence carries on.  The
backward case keeps tests/test_torch_biax_staged.py's tolerances (float32
atol 1e-4, bfloat16 2e-2 relative)."""

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
TAPES = ("hs0", "cs0", "hs1", "cs1")
GRADS = ("dx", "ds0", "ds1", "dw0", "db0", "db1", "du0", "dw1", "du1")


def _inputs(shape, seed):
    T, N, B, F, H = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    return [n(T, N, B, F), n(T, B, F, sc=0.3), n(T, B, H, sc=0.3),
            n(F, 4 * H, sc=0.3), n(4 * H, sc=0.1), n(4 * H, sc=0.1),
            n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3)]


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_tapes(inputs, p, gate, jdt):
    """JAX's forward tapes (hs0, cs0, hs1, cs1) as float32 torch tensors."""
    seed = jnp.asarray(7, jnp.int32).reshape(1, 1)
    with pltpu.force_tpu_interpret_mode():
        tapes = jb._time_fwd_impl(*(jnp.asarray(v) for v in inputs), seed,
                                  1.0 - p, jdt,
                                  hard=gate == "hard_sigmoid")
    return [_f32(t) for t in tapes]


def _staged_fwd(inputs, p, gate, cdt):
    return biax.biax_time_fwd_staged(
        *(torch.from_numpy(v) for v in inputs), dropout_p=p, seed=7,
        compute_dtype=cdt, recurrent_activation=gate)


def _check(names, got, want, cdt, f32_atol):
    for name, a, b in zip(names, got, want):
        a = a.float()
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        if cdt == torch.float32:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=f32_atol, err_msg=name)
            continue
        a, b = a.double().flatten(), b.double().flatten()
        rel = float((a - b).norm() / b.norm())
        assert rel <= 2e-2, (name, rel)


@pytest.mark.parametrize("shape,p,gate,dt", CASES)
def test_staged_fwd_matches_jax_time_fwd(shape, p, gate, dt):
    cdt, jdt = DTYPES[dt]
    inputs = _inputs(SHAPES[shape], 3)
    got = _staged_fwd(inputs, p, gate, cdt)
    assert all(t.dtype == cdt for t in got)
    _check(TAPES, got, _jax_tapes(inputs, p, gate, jdt), cdt, 1e-5)


@pytest.mark.parametrize("shape,p,gate,dt", CASES)
def test_staged_fwd_matches_the_plain_stack(shape, p, gate, dt):
    cdt, _ = DTYPES[dt]
    inputs = _inputs(SHAPES[shape], 5)
    want = biax.biax_time_stack_reference(
        *(torch.from_numpy(v) for v in inputs), dropout_p=p, seed=7,
        compute_dtype=cdt, recurrent_activation=gate)
    hs1 = _staged_fwd(inputs, p, gate, cdt)[2]
    _check(("hs1",), [hs1], [want.float()], cdt, 1e-5)


@pytest.mark.parametrize("dt", DTYPES)
def test_staged_bwd_on_staged_fwd_tapes_matches_jax(dt):
    """The prologue both staged versions share: the backward on the staged
    forward's tapes against `_time_bwd_impl` on JAX's tapes."""
    cdt, jdt = DTYPES[dt]
    p, gate = 0.5, "sigmoid"
    inputs = _inputs(SHAPES["small"], 3)
    T, N, B, _, H = SHAPES["small"]
    cot = np.random.default_rng(4).standard_normal(
        (T, N, B, H)).astype(np.float32)
    tapes = _staged_fwd(inputs, p, gate, cdt)
    got = biax.biax_time_bwd_staged(
        *(torch.from_numpy(v) for v in inputs), *tapes,
        torch.from_numpy(cot).to(cdt), dropout_p=p, seed=7,
        compute_dtype=cdt, recurrent_activation=gate)
    a = [jnp.asarray(v) for v in inputs]
    seed = jnp.asarray(7, jnp.int32).reshape(1, 1)
    with pltpu.force_tpu_interpret_mode():
        jt = jb._time_fwd_impl(*a, seed, 1.0 - p, jdt, hard=False)
        want = jb._time_bwd_impl((*a, seed, *jt), jnp.asarray(cot),
                                 1.0 - p, jdt, False)
    _check(GRADS, got, [_f32(g) for g in want], cdt, 1e-4)
