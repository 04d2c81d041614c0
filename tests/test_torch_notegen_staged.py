"""The cluster pitch-loop kernel's math (music_generator_tpu_torch/ops/
notegen.py::note_sample_staged: feat W0f for every pitch in one product,
then the pitch chain carrying only the recurrent terms) against the JAX
functions it stands for, `Sampler._note_scan` and `pallas_note_sample` in
Pallas interpret mode, and against the port's plain loop; and the kernel's
plan (`notegen_plan`) at the flagship widths.

Tolerances, with their reasons:
  * play and replay are equal, except that a draw whose uniform lies
    within 1e-5 of its probability may fall either way (float32 sums in
    another order, XLA:CPU's logistic and log against ATen's); the rest of
    such a stream follows another path and is not compared (`draws_agree`);
  * volumes agree within atol 1e-5 (float32 sums in another order).
The CUDA kernels run only on the card: chip_smoke.py holds the cluster
kernel to the streamed one bit for bit, and both to the plain version.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.ops.pallas_notegen import pallas_note_sample
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.generation.sampler import _velocity_grid
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import notegen
from music_generator_tpu_torch.params import params_from_numpy

torch.set_num_threads(2)

EDGE = 1e-5
VOLUME_ATOL = 1e-5
# The flagship widths: time_axis_units, note_axis_units, num_notes.
FLAGSHIP = dict(F=256, H=128, N=48)
H100_SMS = 132


def _flat(params) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _setup(act: str, quantize: bool, G: int, seed: int):
    overrides = dict(lstm_recurrent_activation=act,
                     gen_volume_quantize=quantize)
    cfg = jax_test_config(**overrides)
    params = init_params(jax.random.key(23), cfg)
    port = build_model(torch_test_config(**overrides), "cpu",
                       state=params_from_numpy(_flat(params)))
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1, 1, (G, cfg.num_notes, cfg.time_axis_units)
                        ).astype(np.float32)
    us = rng.random((G, cfg.num_notes, 2), dtype=np.float32)
    emb = rng.standard_normal((G, cfg.style_units), dtype=np.float32)
    return cfg, params, port, feats, us, emb


def _port_args(port, feats, us, temp, emb, act, quantize):
    vg = (torch.from_numpy(_velocity_grid(port.cfg.max_velocity))
          if quantize else None)
    return (torch.from_numpy(feats), torch.from_numpy(us),
            torch.from_numpy(temp), port.note_axis, port.note_dense,
            port.volume_dense, torch.from_numpy(emb), act, vg)


def _check(want, got, args):
    want = torch.as_tensor(np.array(want))
    probs = notegen.tempered_probs(args[0], want, *args[2:8])
    ok, err, report = notegen.draws_agree(want, got, args[1], probs, EDGE,
                                          VOLUME_ATOL)
    assert ok, report
    assert err <= VOLUME_ATOL
    assert got.shape == want.shape and got.dtype == torch.float32


CASES = pytest.mark.parametrize("G", [1, 3, 5])
GATES = pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
TEMPS = pytest.mark.parametrize("T", [1.0, 0.9])
QUANTIZE = pytest.mark.parametrize("quantize", [False, True])


@QUANTIZE
@GATES
@TEMPS
@CASES
def test_staged_matches_jax_note_scan(G, T, act, quantize):
    cfg, params, port, feats, us, emb = _setup(act, quantize, G, seed=G)
    temp = np.full((G,), T, np.float32)
    js = JaxSampler(JaxDeepJ(cfg), params)
    want = js._note_scan(params, jnp.asarray(feats), jnp.asarray(emb),
                         jnp.asarray(temp), jnp.asarray(us))
    args = _port_args(port, feats, us, temp, emb, act, quantize)
    got = notegen.note_sample_staged(*args)
    _check(want, got, args)
    if quantize:
        grid = _velocity_grid(cfg.max_velocity)
        assert np.isin(got[..., 2].numpy(), grid).all()


@GATES
@TEMPS
@CASES
def test_staged_matches_pallas_kernel_interpret(G, T, act):
    """The Pallas kernel the CUDA kernels replace, in interpret mode as
    the JAX package's own tests run it; it has no quantization, so this
    holds the unquantized loop (the quantized one is held to
    `Sampler._note_scan` above)."""
    from jax.experimental.pallas import tpu as pltpu
    _, params, port, feats, us, emb = _setup(act, False, G, seed=10 + G)
    temp = np.full((G,), T, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_note_sample(
            jnp.asarray(feats), jnp.asarray(us), jnp.asarray(temp),
            params.note_axis[0], params.note_axis[1], params.note_dense,
            params.volume_dense, jnp.asarray(emb),
            compute_dtype=jnp.float32, recurrent_activation=act)
    args = _port_args(port, feats, us, temp, emb, act, False)
    _check(want, notegen.note_sample_staged(*args), args)


@QUANTIZE
@GATES
@TEMPS
@CASES
def test_staged_matches_plain_version(G, T, act, quantize):
    _, _, port, feats, us, emb = _setup(act, quantize, G, seed=20 + G)
    temp = np.full((G,), T, np.float32)
    args = _port_args(port, feats, us, temp, emb, act, quantize)
    want = notegen.note_sample_reference(*args)
    _check(want, notegen.note_sample_staged(*args), args)


@pytest.mark.parametrize("G", [1, 3, 8, 64, 256])
def test_plan_at_flagship_widths(G):
    """The cluster kernel's plan: within one block's shared memory, C
    dividing H, every stream in exactly one cluster, and one wave of the
    H100's 132 SMs for G <= 64 (whether the clusters are resident at once
    is the card's answer, chip_smoke.py phase 2)."""
    F, H, N = FLAGSHIP["F"], FLAGSHIP["H"], FLAGSHIP["N"]
    p = notegen.notegen_plan(G, 2, F, H, N)
    assert p.smem <= 232448
    assert p.smem == notegen._smem_bytes(p.C, p.Gc, 2, N, F, H)
    assert H % p.C == 0 and p.C in (4, 8, 16)
    assert 1 <= p.Gc <= notegen.GC_MAX
    assert p.clusters == math.ceil(G / p.Gc)
    assert (p.clusters - 1) * p.Gc < G <= p.clusters * p.Gc
    if G <= 64:
        assert p.clusters * p.C <= H100_SMS
    # The flagship plan: 8 blocks of 16 units; 8 streams a cluster once
    # G reaches 8 (226.5 KB a block), so G = 64 takes 8 clusters.
    assert p.C == 8
    if G >= 8:
        assert p.Gc == 8 and p.smem == 231936


@pytest.mark.parametrize("widths", [
    dict(F=256, H=1024, N=48),      # U0, W1, U1 exceed 16 blocks' memory
    dict(F=256, H=14, N=48),        # none of C = 8, 4, 16 divides H
    dict(F=258, H=128, N=48),       # F not a multiple of 4 (float4 reads)
    dict(F=256, H=128, N=2000),     # acc_F of one stream exceeds a block
])
def test_plan_raises_for_widths_that_do_not_fit(widths):
    with pytest.raises(ValueError, match="notegen_plan"):
        notegen.notegen_plan(3, 2, widths["F"], widths["H"], widths["N"])


def test_streamed_wrapper_takes_the_plain_version_on_the_cpu():
    """Both kernels' wrappers run the plain version on CPU tensors and
    count no launch there."""
    _, _, port, feats, us, emb = _setup("sigmoid", False, 3, seed=30)
    temp = np.full((3,), 1.0, np.float32)
    args = _port_args(port, feats, us, temp, emb, "sigmoid", False)
    calls = notegen.note_sample_reference.calls
    launches = (notegen.note_sample.launches,
                notegen.note_sample_streamed.launches)
    a = notegen.note_sample_streamed(*args)
    b = notegen.note_sample(*args)
    assert torch.equal(a, b)
    assert notegen.note_sample_reference.calls == calls + 2
    assert (notegen.note_sample.launches,
            notegen.note_sample_streamed.launches) == launches
