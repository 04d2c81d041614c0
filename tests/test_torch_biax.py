"""The port's biaxial training stacks (music_generator_tpu_torch/ops/biax.py)
against the JAX package's Pallas kernels (ops/pallas_biax.py, run in
interpret mode as tests/test_pallas_biax.py runs them), on the same numpy
inputs, float32.

On the CPU the port's wrappers run their plain versions, so these tests
hold the plain loops (forward and autograd backward) to the Pallas
kernels' forward and custom VJP, and the port's Murmur3 masks to the
masks the kernels dump, bit for bit, including a case with several row
tiles.  The CUDA kernels are held to these plain versions on the card
(chip_smoke.py).

Tolerances: forward atol 1e-5, gradients atol 1e-4 (float32 on both sides;
sums in another order)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.ops import pallas_biax as jb
from music_generator_tpu_torch.ops import biax

torch.set_num_threads(2)

GATES = ["sigmoid", "hard_sigmoid"]
# (T, N, B, Ht, H, C, F_time): the shapes of tests/test_pallas_biax.py, and
# one with B = 96 over a scanned-across axis of 6 (k = 2, three tiles).
SMALL = (6, 5, 8, 16, 12, 3, 10)
MULTI = (6, 6, 96, 16, 12, 3, 10)
CASES = ([("small", p, g) for p in (0.0, 0.5) for g in GATES]
         + [("multi", 0.5, g) for g in GATES])
SHAPES = {"small": SMALL, "multi": MULTI}


def _time_inputs(shape, seed):
    T, N, B, _, H, _, F = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    return [n(T, N, B, F), n(T, B, F, sc=0.3), n(T, B, H, sc=0.3),
            n(F, 4 * H, sc=0.3), n(4 * H, sc=0.1), n(4 * H, sc=0.1),
            n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3)]


def _note_inputs(shape, seed):
    T, N, B, Ht, H, C, _ = shape
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (r.standard_normal(s) * sc).astype(np.float32)
    D = Ht + C
    return [n(T, N, B, Ht, sc=0.5), n(N, T, B, C, sc=0.5),
            n(T, B, D, sc=0.3), n(T, B, H, sc=0.3), n(D, 4 * H, sc=0.3),
            n(4 * H, sc=0.1), n(4 * H, sc=0.1), n(H, 4 * H, sc=0.3),
            n(H, 4 * H, sc=0.3), n(H, 4 * H, sc=0.3), n(H, 3, sc=0.4),
            n(3, sc=0.1)]


def _compare(jax_fn, port_fn, inputs, out_shape, seed):
    cot = np.random.default_rng(seed + 1).standard_normal(
        out_shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
        want_grads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = port_fn(*ts)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for i, (t, g) in enumerate(zip(ts, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4, err_msg=f"gradient {i}")


@pytest.mark.parametrize("shape,p,gate", CASES)
def test_time_stack_matches_pallas(shape, p, gate):
    s = SHAPES[shape]
    T, N, B, _, H, _, _ = s
    kw = dict(dropout_p=p, seed=7, recurrent_activation=gate)
    _compare(lambda *a: jb.biax_time_stack(*a, compute_dtype=jnp.float32,
                                           **kw),
             lambda *a: biax.biax_time_stack(*a, compute_dtype=torch.float32,
                                             **kw),
             _time_inputs(s, 3), (T, N, B, H), 3)


@pytest.mark.parametrize("shape,p,gate", CASES)
def test_note_stack_matches_pallas(shape, p, gate):
    s = SHAPES[shape]
    T, N, B = s[:3]
    kw = dict(dropout_p=p, seed=9, recurrent_activation=gate)
    _compare(lambda *a: jb.biax_note_stack(*a, compute_dtype=jnp.float32,
                                           **kw),
             lambda *a: biax.biax_note_stack(*a, compute_dtype=torch.float32,
                                             **kw),
             _note_inputs(s, 4), (N, T, B, 3), 4)


@pytest.mark.parametrize("shape", ["small", "multi"])
def test_masks_equal_the_kernels_dumped_masks(shape):
    """stack_mask reproduces every in-kernel mask bit for bit."""
    T, N, B, Ht, H, C, F = SHAPES[shape]
    ta = [jnp.asarray(a) for a in _time_inputs(SHAPES[shape], 5)]
    na = [jnp.asarray(a) for a in _note_inputs(SHAPES[shape], 6)]
    with pltpu.force_tpu_interpret_mode():
        _, tm = jb.time_stack_dump_masks(*ta, dropout_p=0.5, seed=11,
                                         compute_dtype=jnp.float32)
        _, nm = jb.note_stack_dump_masks(*na, dropout_p=0.5, seed=12,
                                         compute_dtype=jnp.float32)
    for site, W, m in zip((biax.S_STYLE0, biax.S_STYLE1, biax.S_MID),
                          (F, H, H), tm):
        got = biax.stack_mask(11, site, T, N, B, W, 0.5, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(m))
    for site, W, m in zip((biax.S_IN, biax.S_STYLE0, biax.S_STYLE0C,
                           biax.S_STYLE1, biax.S_MID, biax.S_OUT),
                          (Ht, Ht, C, H, H, H), nm):
        got = biax.stack_mask(12, site, N, T, B, W, 0.5, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(m))


def test_mask_tile_matches_the_kernel_helper():
    """`_mask` of one (site, tile, step) against the Pallas helper itself,
    over several seeds, keep rates and tile/step indices."""
    for seed, keep, site, j, s in itertools.product(
            (0, 7, 2**31 - 2), (0.5, 0.8), (0, 5), (0, 3), (0, 127)):
        with pltpu.force_tpu_interpret_mode():
            want = jb._mask(jnp.asarray([[seed]], jnp.int32), site,
                            jnp.int32(j), jnp.int32(s), (24, 20), keep,
                            jnp.float32)
        got = biax._mask(seed, site, j, s, (24, 20), keep, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_tiling_matches_jax():
    for A in range(1, 50):
        for B in (1, 2, 3, 8, 16, 31, 96, 128, 255, 256, 300):
            assert biax._row_tiling(A, B) == jb._row_tiling(A, B), (A, B)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain loop and launches nothing."""
    inputs = [torch.tensor(a) for a in _time_inputs(SMALL, 1)]
    calls = biax.biax_time_stack_reference.calls
    launches = biax.biax_time_stack.fwd_launches
    biax.biax_time_stack(*inputs)
    assert biax.biax_time_stack_reference.calls == calls + 1
    assert biax.biax_time_stack.fwd_launches == launches
    with pytest.raises(ValueError, match="unknown lstm_recurrent"):
        biax.biax_time_stack(*inputs, recurrent_activation="hard-sigmoid")
