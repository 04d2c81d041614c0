"""The port's threefry2x32 (music_generator_tpu_torch/generation/prng.py)
against `jax.random`: keys, fold_in and uniform draws are BIT-equal (the
uint32 views compare with array_equal), which is what lets the port
sample the same notes as the JAX package from the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.generation import prng
from music_generator_tpu_torch.generation.sampler import Sampler
from music_generator_tpu_torch.models.deepj import build_model

torch.set_num_threads(2)

SEEDS = [0, 1, 2 ** 31, 2 ** 32 - 1]


def _bits(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_bit_equal(seed):
    k = jax.random.key(np.uint32(seed))
    np.testing.assert_array_equal(_bits(jax.random.key_data(k)),
                                  _bits(prng.key(seed)))
    idx = np.arange(64, dtype=np.uint32)
    want = jax.random.key_data(
        jax.vmap(jax.random.fold_in, (None, 0))(k, idx))
    got = prng.fold_in(prng.key(seed), torch.arange(64))
    np.testing.assert_array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal_over_streams_and_steps(seed):
    """uniform(fold_in(fold_in(key(seed), g), t), (48, 2)) for streams
    0..63 and steps 0..600 (the float32 bits, not just the values)."""
    idx = np.arange(64, dtype=np.uint32)
    ts = np.arange(601, dtype=np.uint32)

    @jax.jit
    def draws(seed):
        keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(seed),
                                                       idx)
        step = jax.vmap(jax.vmap(jax.random.fold_in, (0, None)),
                        (None, 0))(keys, ts)                 # [601, 64]
        return jax.vmap(jax.vmap(
            lambda k: jax.random.uniform(k, (48, 2))))(step)

    want = np.asarray(draws(np.uint32(seed)))
    keys = prng.fold_in(prng.key(seed), torch.arange(64))
    got = prng.uniform(prng.fold_in(keys[None], torch.arange(601)[:, None]),
                       (48, 2))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(want.view(np.uint32),
                                  got.numpy().view(np.uint32))


@pytest.mark.parametrize("seed,offset", [(0, 0), (7, 5), (2 ** 32 - 1, 60)])
def test_chunk_uniforms_match_jax_chunk_body(seed, offset):
    """The [C, G, 48, 2] block one chunk draws in one call equals the JAX
    `_chunk_body`'s vmapped `_step_uniforms` from the same stream keys."""
    jcfg = jax_test_config()
    js = JaxSampler(JaxDeepJ(jcfg), init_params(jax.random.key(0), jcfg))
    jstate = js._init_state(4, jnp.uint32(seed), 1.0, offset)
    ts = 48 + jnp.arange(32, dtype=jnp.int32)
    want = np.asarray(jax.vmap(js._step_uniforms, (None, 0))(
        jstate.stream_keys, ts))
    ts_ = Sampler(build_model(torch_test_config(), "cpu"))
    state = ts_._init_state(4, seed, 1.0, offset)
    np.testing.assert_array_equal(
        _bits(jax.random.key_data(jstate.stream_keys)),
        _bits(state.stream_keys))
    got = ts_._chunk_uniforms(state.stream_keys, 48, 32).numpy()
    assert got.shape == (32, 4, 48, 2)
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
