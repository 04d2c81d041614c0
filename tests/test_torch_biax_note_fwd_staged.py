"""The note stack's staged forward (music_generator_tpu_torch/ops/biax.py
`biax_note_fwd_staged`: the seven passes of csrc/biax_note.cu in plain
PyTorch) against the JAX package's `_note_fwd_impl` (ops/pallas_biax.py, in
interpret mode as tests/test_torch_biax.py runs it), out and all four
tapes, and against the plain loop `biax_note_stack_reference` (out), on the
same numpy inputs; and the staged backward run on the staged forward's
tapes against JAX's `_note_bwd_impl` on JAX's own tapes.  The shapes,
cases and inputs are tests/test_torch_biax_note_staged.py's; JAX's kernels
take s0 and w0 split into their Ht and C parts.

Tolerances.  float32: atol 1e-5, since the bulk products sum in another
order than a product per pitch (and the Pallas kernel splits the layer-0
product into its Ht and C parts).  bfloat16: within 2e-2 of the
reference's norm (||a - b|| / ||b||): a float32 sum in another order can
move one rounding to bfloat16 by an ulp, which the recurrence carries on.
The backward case keeps tests/test_torch_biax_note_staged.py's tolerances
(float32 atol 1e-4, bfloat16 2e-2 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops import pallas_biax as jb
from music_generator_tpu_torch.ops import biax
from tests.test_torch_biax_note_staged import (CASES, DTYPES, NAMES, SHAPES,
                                               _cot, _f32, _inputs)

torch.set_num_threads(2)

OUTS = ("out", "hs0", "cs0", "hs1", "cs1")


def _jax_args(inputs):
    """`_note_fwd_impl`'s inputs, s0 and w0 split into their Ht and C
    parts, and its seed."""
    ht, ch, s0, s1, w0, b0, b1, u0, w1, u1, wh, bh = (
        jnp.asarray(v) for v in inputs)
    Ht = ht.shape[-1]
    seed = jnp.asarray(7, jnp.int32).reshape(1, 1)
    return (ht, ch, s0[..., :Ht], s0[..., Ht:], s1, w0[:Ht], w0[Ht:], b0,
            b1, u0, w1, u1, wh, bh, seed)


def _staged_fwd(inputs, p, gate, cdt):
    return biax.biax_note_fwd_staged(
        *(torch.from_numpy(v) for v in inputs), dropout_p=p, seed=7,
        compute_dtype=cdt, recurrent_activation=gate)


def _check(names, got, want, cdt, f32_atol):
    for name, a, b in zip(names, got, want, strict=True):
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
def test_staged_fwd_matches_jax_note_fwd(shape, p, gate, dt):
    cdt, jdt = DTYPES[dt]
    inputs = _inputs(SHAPES[shape], 3)
    got = _staged_fwd(inputs, p, gate, cdt)
    assert got[0].dtype == torch.float32
    assert all(t.dtype == cdt for t in got[1:])
    with pltpu.force_tpu_interpret_mode():
        want = jb._note_fwd_impl(*_jax_args(inputs), 1.0 - p, jdt,
                                 hard=gate == "hard_sigmoid")
    _check(OUTS, got, [_f32(t) for t in want], cdt, 1e-5)


@pytest.mark.parametrize("shape,p,gate,dt", CASES)
def test_staged_fwd_matches_the_plain_stack(shape, p, gate, dt):
    cdt, _ = DTYPES[dt]
    inputs = _inputs(SHAPES[shape], 5)
    want = biax.biax_note_stack_reference(
        *(torch.from_numpy(v) for v in inputs), dropout_p=p, seed=7,
        compute_dtype=cdt, recurrent_activation=gate)
    out = _staged_fwd(inputs, p, gate, cdt)[0]
    _check(("out",), [out], [want], cdt, 1e-5)


@pytest.mark.parametrize("dt", DTYPES)
def test_staged_bwd_on_staged_fwd_tapes_matches_jax(dt):
    """The prologue and heads both staged versions share: the backward on
    the staged forward's tapes against `_note_bwd_impl` on JAX's tapes."""
    cdt, jdt = DTYPES[dt]
    p, gate = 0.5, "sigmoid"
    s = SHAPES["small"]
    inputs, cot = _inputs(s, 3), _cot(s, 4)
    _, *tapes = _staged_fwd(inputs, p, gate, cdt)
    got = biax.biax_note_bwd_staged(
        *(torch.from_numpy(v) for v in inputs), *tapes,
        torch.from_numpy(cot), dropout_p=p, seed=7, compute_dtype=cdt,
        recurrent_activation=gate)
    args = _jax_args(inputs)
    with pltpu.force_tpu_interpret_mode():
        _, *jt = jb._note_fwd_impl(*args, 1.0 - p, jdt, hard=False)
        (dht, dch, ds0t, ds0c, ds1, dw0t, dw0c, db0, db1, du0, dw1, du1,
         dwh, dbh) = jb._note_bwd_impl((*args, *jt), jnp.asarray(cot),
                                       1.0 - p, jdt, False)
    want = (dht, dch, jnp.concatenate([ds0t, ds0c], -1), ds1,
            jnp.concatenate([dw0t, dw0c], 0), db0, db1, du0, dw1, du1, dwh,
            dbh)
    _check(NAMES, [g.float() for g in got], [_f32(g) for g in want], cdt,
           1e-4)
