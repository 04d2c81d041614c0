"""The note stack's staged backward (music_generator_tpu_torch/ops/biax.py
`biax_note_bwd_staged`: the seven passes of csrc/biax_note.cu in plain
PyTorch) against autograd through the plain forward
(`biax_note_stack_reference`) and against the JAX package's
`_note_bwd_impl` (ops/pallas_biax.py, in interpret mode as
tests/test_torch_biax.py runs it), on the same numpy inputs and on the
forward tapes of JAX's `_note_fwd_impl`.  JAX's kernels take s0 and w0
split into their Ht and C parts, as its `biax_note_stack` splits them; its
gradients of the two parts are joined here.

Tolerances, as tests/test_torch_biax_staged.py states them for the time
stack.  float32: every gradient within atol 1e-4 of both (sums in another
order).  bfloat16: against JAX, whose kernel has the same cast points,
every gradient within 2e-2 of the reference's norm (||a - b|| / ||b||);
against autograd, which rounds each intermediate gradient to bfloat16
where the kernels keep float32, within 0.1 relative and a cosine of at
least 0.995."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops import pallas_biax as jb
from music_generator_tpu_torch.ops import biax

torch.set_num_threads(2)

# (T, N, B, Ht, C, H): tests/test_torch_biax.py's small note-stack shape,
# and one with three row tiles (B = 96, k = 2).
SHAPES = {"small": (6, 5, 8, 16, 3, 12), "multi": (6, 6, 96, 16, 3, 12)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
CASES = ([("small", p, g, dt) for p in (0.0, 0.5)
          for g in ("sigmoid", "hard_sigmoid") for dt in DTYPES]
         + [("multi", 0.5, "sigmoid", "bf16")])
NAMES = ("dht", "dch", "ds0", "ds1", "dw0", "db0", "db1", "du0", "dw1",
         "du1", "dwh", "dbh")


def _inputs(shape, seed):
    T, N, B, Ht, C, H = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    D = Ht + C
    return [n(T, N, B, Ht, sc=0.5), n(N, T, B, C, sc=0.5),
            n(T, B, D, sc=0.3), n(T, B, H, sc=0.3), n(D, 4 * H, sc=0.3),
            n(4 * H, sc=0.1), n(4 * H, sc=0.1), n(H, 4 * H, sc=0.3),
            n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3), n(H, 3, sc=0.4),
            n(3, sc=0.1)]


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_tapes_and_grads(inputs, cot, p, gate, jdt):
    """JAX's forward tapes (hs0, cs0, hs1, cs1) and `_note_bwd_impl`'s
    gradients in the port's order, as float32 torch tensors."""
    keep, hard = 1.0 - p, gate == "hard_sigmoid"
    ht, ch, s0, s1, w0, b0, b1, u0, w1, u1, wh, bh = (
        jnp.asarray(v) for v in inputs)
    Ht = ht.shape[-1]
    seed = jnp.asarray(7, jnp.int32).reshape(1, 1)
    args = (ht, ch, s0[..., :Ht], s0[..., Ht:], s1, w0[:Ht], w0[Ht:], b0,
            b1, u0, w1, u1, wh, bh, seed)
    with pltpu.force_tpu_interpret_mode():
        _, *tapes = jb._note_fwd_impl(*args, keep, jdt, hard=hard)
        (dht, dch, ds0t, ds0c, ds1, dw0t, dw0c, db0, db1, du0, dw1, du1,
         dwh, dbh) = jb._note_bwd_impl((*args, *tapes), jnp.asarray(cot),
                                       keep, jdt, hard)
    grads = (dht, dch, jnp.concatenate([ds0t, ds0c], -1), ds1,
             jnp.concatenate([dw0t, dw0c], 0), db0, db1, du0, dw1, du1, dwh,
             dbh)
    return [_f32(t) for t in tapes], [_f32(g) for g in grads]


def _staged(inputs, tapes, cot, p, gate, cdt):
    ts = [torch.from_numpy(v) for v in inputs]
    got = biax.biax_note_bwd_staged(
        *ts, *(t.to(cdt) for t in tapes), torch.from_numpy(cot),
        dropout_p=p, seed=7, compute_dtype=cdt, recurrent_activation=gate)
    return [g.float() for g in got]


def _check(got, want, cdt, rel_tol, cos_tol=None):
    for name, a, b in zip(NAMES, got, want, strict=True):
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


def _cot(shape, seed):
    T, N, B = shape[:3]
    return np.random.default_rng(seed).standard_normal(
        (N, T, B, 3)).astype(np.float32)


@pytest.mark.parametrize("shape,p,gate,dt", CASES)
def test_staged_matches_jax_note_bwd(shape, p, gate, dt):
    cdt, jdt = DTYPES[dt]
    s = SHAPES[shape]
    inputs, cot = _inputs(s, 3), _cot(s, 4)
    tapes, want = _jax_tapes_and_grads(inputs, cot, p, gate, jdt)
    _check(_staged(inputs, tapes, cot, p, gate, cdt), want, cdt, 2e-2)


@pytest.mark.parametrize("shape,p,gate,dt", CASES)
def test_staged_matches_autograd_of_the_plain_stack(shape, p, gate, dt):
    cdt, jdt = DTYPES[dt]
    s = SHAPES[shape]
    inputs, cot = _inputs(s, 5), _cot(s, 6)
    ts = [torch.tensor(v, requires_grad=True) for v in inputs]
    out = biax.biax_note_stack_reference(
        *ts, dropout_p=p, seed=7, compute_dtype=cdt,
        recurrent_activation=gate)
    (out * torch.from_numpy(cot)).sum().backward()
    tapes, _ = _jax_tapes_and_grads(inputs, cot, p, gate, jdt)
    got = _staged(inputs, tapes, cot, p, gate, cdt)
    # The gradients come in the order of the inputs.
    _check(got, [t.grad for t in ts], cdt, 0.1, 0.995)
