"""The single-layer recurrence's staged backward (music_generator_tpu_torch/
ops/recurrence.py `lstm_recurrence_bwd_staged`: the passes of
csrc/lstm_recurrence.cu in plain PyTorch) against the backward rule of the
JAX package's `pallas_lstm_recurrence` custom VJP (ops/pallas_lstm.py
`_bwd_rule`, in interpret mode as tests/test_torch_recurrence.py runs it)
and against autograd through the plain forward
(`lstm_recurrence_reference`), on the same numpy inputs and on the forward
tapes of the plain version, with nonzero h0, c0 and cotangents of hs, h_T
and c_T.

Tolerances (those of tests/test_torch_biax_staged.py).  float32: every
gradient within atol 1e-4 of both (sums in another order).  bfloat16:
against JAX, whose kernel has the same cast points, within 2e-2 of the
reference's norm (||a - b|| / ||b||); against autograd, which rounds each
intermediate gradient to bfloat16 where the passes keep float32, within
0.1 relative and a cosine of at least 0.995."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops.pallas_lstm import _bwd_rule
from music_generator_tpu_torch.ops import biax, recurrence

torch.set_num_threads(2)

# (S, R, H): tests/test_torch_recurrence.py's shape, and an odd one (R not
# a multiple of 8, H = 12).
SHAPES = {"small": (6, 10, 8), "odd": (5, 37, 12)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
CASES = [(s, g, dt) for s in SHAPES for g in ("sigmoid", "hard_sigmoid")
         for dt in DTYPES]
NAMES = ("dxw", "du", "dh0", "dc0")


def _inputs(shape, seed):
    """xw, u, h0, c0 and the cotangents dhs, dhT, dcT, float32 numpy."""
    S, R, H = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    return ([n(S, R, 4 * H), n(H, 4 * H, sc=0.4), n(R, H, sc=0.5),
             n(R, H, sc=0.5)],
            [n(S, R, H), n(R, H), n(R, H)])


def _plain_tapes(xw, u, h0, c0, cdt, gate):
    """The plain forward's tapes: hs (h after step t) and cs (c before it),
    both in the compute dtype, by the loop of lstm_recurrence_reference."""
    hard = gate == "hard_sigmoid"
    xw, U = xw.to(cdt), u.to(cdt)
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(xw.shape[0]):
        cs.append(c.to(cdt))
        h, c = biax._cell(xw[t], h, c, U, hard)
        hs.append(h.to(cdt))
    return torch.stack(hs), torch.stack(cs)


def _staged(inputs, cots, gate, cdt):
    """(tapes, the staged gradients as float32)."""
    xw, u, h0, c0 = (torch.from_numpy(a) for a in inputs)
    hs, cs = _plain_tapes(xw, u, h0, c0, cdt, gate)
    got = recurrence.lstm_recurrence_bwd_staged(
        xw, u, h0, hs, cs, *(torch.from_numpy(c) for c in cots),
        compute_dtype=cdt, recurrent_activation=gate)
    assert got[0].dtype == cdt
    return (hs, cs), [g.float() for g in got]


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


@pytest.mark.parametrize("shape,gate,dt", CASES)
def test_staged_matches_jax_backward_rule(shape, gate, dt):
    cdt, jdt = DTYPES[dt]
    inputs, cots = _inputs(SHAPES[shape], 1)
    (hs, cs), got = _staged(inputs, cots, gate, cdt)
    xw, u, h0, _ = (jnp.asarray(a) for a in inputs)
    tape = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    residuals = (u, xw.astype(jdt), tape(cs), tape(hs), h0)
    dhs, dhT, dcT = (jnp.asarray(c) for c in cots)
    with pltpu.force_tpu_interpret_mode():
        want = _bwd_rule(jdt, gate == "hard_sigmoid", residuals,
                         (dhs, (dhT, dcT)))
    want = [torch.from_numpy(np.array(w, dtype=np.float32)) for w in want]
    _check(got, want, cdt, 2e-2)


@pytest.mark.parametrize("shape,gate,dt", CASES)
def test_staged_matches_autograd_of_the_plain_recurrence(shape, gate, dt):
    cdt, _ = DTYPES[dt]
    inputs, cots = _inputs(SHAPES[shape], 2)
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    hs, (hT, cT) = recurrence.lstm_recurrence_reference(*ts, cdt, gate)
    sum((o.float() * torch.from_numpy(c)).sum()
        for o, c in zip((hs, hT, cT), cots)).backward()
    _, got = _staged(inputs, cots, gate, cdt)
    # The gradients come in the order of the inputs xw, u, h0, c0.
    _check(got, [t.grad for t in ts], cdt, 0.1, 0.995)
