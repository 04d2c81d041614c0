"""The single-layer recurrence's staged forward (music_generator_tpu_torch/
ops/recurrence.py `lstm_recurrence_fwd_staged`: the biaxial forwards' scan
`biax._forward_scan` with initial and terminal states, as
csrc/lstm_recurrence.cu computes it, in plain PyTorch) against the JAX
package's Pallas forward (ops/pallas_lstm.py `_forward_impl`, in interpret
mode as tests/test_torch_recurrence.py runs it) and against the plain loop
`lstm_recurrence_reference`, on the same numpy inputs with nonzero h0 and
c0: hs, the c tape (with and without tapes), h_T and c_T.  Also holds
`biax._forward_scan` without ends, which the biaxial stacks' staged
forwards rest on, bit for bit to its form before it took ends.

Tolerances (those of tests/test_torch_biax_time_fwd_staged.py).  float32:
atol 1e-5, sums in another order.  bfloat16: within 2e-2 of the
reference's norm (||a - b|| / ||b||): a float32 sum in another order can
move one rounding to bfloat16 by an ulp, which the recurrence carries on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops.pallas_lstm import _forward_impl
from music_generator_tpu_torch.ops import biax, recurrence

torch.set_num_threads(2)

# (S, R, H): tests/test_torch_recurrence.py's shape, and an odd one (R not
# a multiple of 8, H = 12).
SHAPES = {"small": (6, 10, 8), "odd": (5, 37, 12)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
GATES = ("sigmoid", "hard_sigmoid")
CASES = [(s, g, dt, tapes) for s in SHAPES for g in GATES for dt in DTYPES
         for tapes in (True, False)]
NAMES = ("hs", "cs", "h_T", "c_T")


def _inputs(shape, seed):
    """xw, u, h0, c0 as float32 numpy; h0 and c0 nonzero."""
    S, R, H = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    return [n(S, R, 4 * H), n(H, 4 * H, sc=0.4), n(R, H, sc=0.5),
            n(R, H, sc=0.5)]


def _staged(inputs, gate, cdt, tapes):
    got = recurrence.lstm_recurrence_fwd_staged(
        *(torch.from_numpy(a) for a in inputs), compute_dtype=cdt,
        recurrent_activation=gate, tapes=tapes)
    hs, cs, hT, cT = got
    assert hs.dtype == cdt and hT.dtype == cT.dtype == torch.float32
    assert (cs is not None) == tapes
    if tapes:
        assert cs.dtype == cdt
    return got


def _check(names, got, want, cdt):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a = a.float()
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        if cdt == torch.float32:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
            continue
        a, b = a.double().flatten(), b.double().flatten()
        rel = float((a - b).norm() / b.norm())
        assert rel <= 2e-2, (name, rel)


@pytest.mark.parametrize("shape,gate,dt,tapes", CASES)
def test_staged_fwd_matches_jax_forward(shape, gate, dt, tapes):
    cdt, jdt = DTYPES[dt]
    inputs = _inputs(SHAPES[shape], 1)
    got = _staged(inputs, gate, cdt, tapes)
    xw, u, h0, c0 = (jnp.asarray(a) for a in inputs)
    with pltpu.force_tpu_interpret_mode():
        want = _forward_impl(xw.astype(jdt), u, h0, c0, jdt, tape=tapes,
                             hard=gate == "hard_sigmoid")
    want = [None if w is None else
            torch.from_numpy(np.array(w, dtype=np.float32)) for w in want]
    _check(NAMES, got, want, cdt)


@pytest.mark.parametrize("shape,gate,dt,tapes", CASES)
def test_staged_fwd_matches_the_plain_recurrence(shape, gate, dt, tapes):
    cdt, _ = DTYPES[dt]
    inputs = _inputs(SHAPES[shape], 2)
    hs, cs, hT, cT = _staged(inputs, gate, cdt, tapes)
    want_hs, (want_hT, want_cT) = recurrence.lstm_recurrence_reference(
        *(torch.from_numpy(a) for a in inputs), cdt, gate)
    _check(("hs", "h_T", "c_T"), (hs, hT, cT),
           (want_hs.float(), want_hT, want_cT), cdt)
    if tapes:
        # The c tape is c before each step: c0, then c_t up to c_{S-2}.
        np.testing.assert_array_equal(cs[0].float().numpy(),
                                      torch.from_numpy(inputs[3]).to(cdt)
                                      .float().numpy())


def _forward_scan_before_ends(pre, u, hard):
    """`biax._forward_scan` as it was before it took initial and terminal
    states: h[-1] = 0, c from zero, (hs, cs)."""
    cdt = pre.dtype
    S, R, H4 = pre.shape
    h = c = torch.zeros(R, H4 // 4, device=pre.device)
    hs, cs = [], []
    for s in range(S):
        cs.append(c.to(cdt))
        h, c = biax._cell(pre[s], h, c, u, hard)
        hs.append(h.to(cdt))
    return torch.stack(hs), torch.stack(cs)


@pytest.mark.parametrize("shape,gate,dt",
                         [(s, g, dt) for s in SHAPES for g in GATES
                          for dt in DTYPES])
def test_forward_scan_without_ends_is_unchanged(shape, gate, dt):
    """The stacks' staged forwards call `_forward_scan` without ends: its
    result is the same, bit for bit."""
    cdt, _ = DTYPES[dt]
    xw, u, _, _ = (torch.from_numpy(a).to(cdt)
                   for a in _inputs(SHAPES[shape], 3))
    got = biax._forward_scan(xw, u, gate == "hard_sigmoid")
    want = _forward_scan_before_ends(xw, u, gate == "hard_sigmoid")
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == cdt
        assert torch.equal(a, b)
