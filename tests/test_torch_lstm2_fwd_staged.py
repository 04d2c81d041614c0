"""The fused two-layer stack's staged forward (music_generator_tpu_torch/
ops/lstm2.py `lstm2_fwd_staged`: the six passes of csrc/lstm2.cu in plain
PyTorch, on the biaxial forwards' scan `biax._forward_scan` with initial
and terminal states) against the JAX package's Pallas forward
(ops/pallas_lstm2.py `_forward_impl`, in interpret mode as
tests/test_torch_lstm2.py runs it) and against the plain loop
`lstm2_stack_reference`, on the same numpy inputs with nonzero h00, c00,
h10, c10: hs1, the tapes hs0, cs0, cs1 (with and without tapes) and the
four terminal states.

The Pallas kernel draws its inter-layer mask from the TPU's hardware PRNG,
which no other device gives (tests/test_torch_lstm2.py), so JAX is held at
dropout 0 and the plain loop, with the port's mask, at dropout 0 and 0.5.

Tolerances (those of tests/test_torch_recurrence_fwd_staged.py).  float32:
atol 1e-5, sums in another order.  bfloat16: within 2e-2 of the
reference's norm (||a - b|| / ||b||): a float32 sum in another order can
move one rounding to bfloat16 by an ulp, which the recurrence carries on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops.pallas_lstm2 import _forward_impl
from music_generator_tpu_torch.ops import biax, lstm2

torch.set_num_threads(2)

# (S, R, F, H): tests/test_torch_lstm2.py's shape, and an odd one (F odd,
# R not a multiple of 8, H = 12).
SHAPES = {"small": (5, 12, 11, 8), "odd": (5, 37, 13, 12)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
GATES = ("sigmoid", "hard_sigmoid")
CASES = [(s, g, dt, tapes) for s in SHAPES for g in GATES for dt in DTYPES
         for tapes in (True, False)]
NAMES = ("hs0", "cs0", "hs1", "cs1", "h0T", "c0T", "h1T", "c1T")
SEED = 4321


def _inputs(shape, seed):
    """x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10 as float32
    numpy; the initial states nonzero."""
    S, R, F, H = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    return [n(S, R, F), n(S, R, H, sc=0.3), n(F, 4 * H, sc=0.4),
            n(4 * H, sc=0.1), n(4 * H, sc=0.1), n(H, 4 * H, sc=0.4),
            n(H, 4 * H, sc=0.4), n(H, 4 * H, sc=0.4), n(R, H, sc=0.5),
            n(R, H, sc=0.5), n(R, H, sc=0.5), n(R, H, sc=0.5)]


def _staged(inputs, p, gate, cdt, tapes):
    got = lstm2.lstm2_fwd_staged(
        *(torch.from_numpy(a) for a in inputs), dropout_p=p, seed=SEED,
        compute_dtype=cdt, recurrent_activation=gate, tapes=tapes)
    assert len(got) == len(NAMES)
    for name, t in zip(NAMES, got):
        if name in ("hs0", "cs0", "cs1") and not tapes:
            assert t is None, name
        else:
            assert t.dtype == (cdt if name[:2] in ("hs", "cs")
                               else torch.float32), name
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
    got = _staged(inputs, 0.0, gate, cdt, tapes)
    x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10 = (
        jnp.asarray(a) for a in inputs)
    with pltpu.force_tpu_interpret_mode():
        outs = _forward_impl(x0.astype(jdt), s1m.astype(jdt), w0, b0, b1, u0,
                             w1, u1, h00, c00, h10, c10,
                             jnp.zeros((1, 1), jnp.int32), 1.0, jdt,
                             tapes=tapes, hard=gate == "hard_sigmoid")
    outs = [torch.from_numpy(np.array(w, dtype=np.float32)) for w in outs]
    # Pallas returns (hs0, cs0, hs1, cs1, ...) with tapes, (hs1, ...) without.
    want = outs if tapes else [None, None, outs[0], None, *outs[1:]]
    _check(NAMES, got, want, cdt)


@pytest.mark.parametrize("p", [0.0, 0.5])
@pytest.mark.parametrize("shape,gate,dt,tapes", CASES)
def test_staged_fwd_matches_the_plain_stack(shape, gate, dt, tapes, p):
    cdt, _ = DTYPES[dt]
    inputs = _inputs(SHAPES[shape], 2)
    hs0, cs0, hs1, cs1, h0T, c0T, h1T, c1T = _staged(inputs, p, gate, cdt,
                                                     tapes)
    want_hs1, want_fin = lstm2.lstm2_stack_reference(
        *(torch.from_numpy(a) for a in inputs), dropout_p=p, seed=SEED,
        compute_dtype=cdt, recurrent_activation=gate)
    _check(("hs1", "h0T", "c0T", "h1T", "c1T"), (hs1, h0T, c0T, h1T, c1T),
           (want_hs1.float(), *want_fin), cdt)
    if tapes:
        # The c tapes are c before each step: the initial c, then c_t; the
        # h tape of layer 0 ends in h0T rounded to the compute dtype.
        for tape, c0 in ((cs0, inputs[9]), (cs1, inputs[11])):
            assert torch.equal(tape[0], torch.from_numpy(c0).to(cdt))
        _check(("hs0[-1]",), (hs0[-1],), (want_fin[0].to(cdt).float(),),
               cdt)


def _loop_tapes(ts, p, cdt, gate):
    """hs0, cs0, hs1, cs1 carried by a plain loop over the steps, the loop
    of `lstm2_stack_reference` with its tapes kept (h after step t, c
    before it, in the compute dtype)."""
    x0, s1m, w0, b0, b1, u0, w1, u1, h00, c00, h10, c10 = ts
    hard = gate == "hard_sigmoid"
    S, R, _ = x0.shape
    H = u0.shape[0]
    x0, s1m = x0.to(cdt), s1m.to(cdt)
    W0, U0, W1, U1 = (w.to(cdt) for w in (w0, u0, w1, u1))
    B0, B1 = b0.to(cdt), b1.to(cdt)
    masks = lstm2.stack_masks(SEED, S, R, H, 1.0 - p, cdt)
    h0, c0, h1, c1 = h00, c00, h10, c10
    tapes = [], [], [], []
    for t in range(S):
        tapes[1].append(c0.to(cdt))
        h0, c0 = biax._cell(biax._dot(x0[t], W0).to(cdt) + B0, h0, c0, U0,
                            hard)
        tapes[0].append(h0.to(cdt))
        x1 = biax._apply(h0.to(cdt), None if masks is None else masks[t])
        tapes[3].append(c1.to(cdt))
        h1, c1 = biax._cell(biax._dot(x1 + s1m[t], W1).to(cdt) + B1, h1, c1,
                            U1, hard)
        tapes[2].append(h1.to(cdt))
    return [torch.stack(t).float() for t in tapes]


@pytest.mark.parametrize("dt", DTYPES)
def test_staged_fwd_tapes_match_the_plain_loop(dt):
    """The tapes the staged passes write are the h and c the plain loop
    carries, at dropout 0.5 (the staged backward's inputs); without tapes
    hs1 and the terminal states are the same bit for bit."""
    cdt, _ = DTYPES[dt]
    ts = [torch.from_numpy(a) for a in _inputs(SHAPES["odd"], 3)]
    got = lstm2.lstm2_fwd_staged(*ts, dropout_p=0.5, seed=SEED,
                                 compute_dtype=cdt)
    _check(NAMES[:4], got[:4], _loop_tapes(ts, 0.5, cdt, "sigmoid"), cdt)
    without = lstm2.lstm2_fwd_staged(*ts, dropout_p=0.5, seed=SEED,
                                     compute_dtype=cdt, tapes=False)
    assert without[0] is None and without[1] is None and without[3] is None
    for a, b in zip(without[2:], got[2:]):
        if a is not None:
            assert torch.equal(a, b)


def test_lstm2_fwd_never_falls_back_off_the_card():
    """Kernel 6's wrapper launches its passes or raises: given tensors that
    are not on a card it raises instead of running the plain version, and
    without a card no CUDA tensor reaches it.  No launch, scan or plain
    call is counted."""
    stack = lstm2.lstm2_stack
    counts = lambda: (stack.fwd_launches, stack.fwd_cluster_scans,
                      stack.fwd_streamed_scans,
                      lstm2.lstm2_stack_reference.calls)
    before = counts()
    ts = [torch.from_numpy(a) for a in _inputs(SHAPES["small"], 4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        lstm2.lstm2_fwd(*ts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lstm2.lstm2_fwd(*(t.to("meta") for t in ts))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        lstm2.lstm2_stack(*(t.to("meta") for t in ts))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            lstm2.lstm2_fwd(*(t.to("cuda") for t in ts))
    assert counts() == before
