"""The PyTorch port's weight bridge (music_generator_tpu_torch/params.py):
keystr-layout .npz checkpoints and JAX `init_params` pytrees load into the
port's DeepJ with the JAX package's shapes and layouts, exactly."""

import os

import jax
import numpy as np
import pytest
import torch

from music_generator_tpu.config import default_config as jax_default_config
from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.models.deepj import DeepJ, build_model
from music_generator_tpu_torch.params import (load_params_npz,
                                              params_from_numpy,
                                              params_to_numpy)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = [
    "artifacts/trained_model_r3/params_short23.npz",
    "artifacts/trained_model_r4/params.npz",
    "artifacts/real_corpus_r3/params.npz",
]


def _flat(params) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_committed_checkpoint_maps_onto_the_port(path):
    """Every leaf of the checkpoint is a port tensor of `init_params`'
    shape, and the loaded weights are the file's, bit for bit."""
    shapes = jax.eval_shape(lambda k: init_params(k, jax_default_config()),
                            jax.random.key(0))
    template = {jax.tree_util.keystr(p): leaf for p, leaf in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with np.load(os.path.join(ROOT, path)) as data:
        flat = {k: data[k] for k in data.files}
    assert set(flat) == set(template)
    for k, v in flat.items():
        assert v.shape == template[k].shape, k
    model = build_model(default_config(), "cpu",
                        state=load_params_npz(os.path.join(ROOT, path)))
    state = model.state_dict()
    assert len(state) == len(flat)
    for k, v in params_to_numpy(state).items():
        np.testing.assert_array_equal(v, flat[k].astype(np.float32))


def test_jax_init_params_round_trip_exactly():
    """A JAX pytree flattened with keystr -> port state dict -> keystr
    arrays is the identity, leaf for leaf (layouts kept: LSTM [in, 4H],
    conv [width, in, out])."""
    flat = _flat(init_params(jax.random.key(5), jax_test_config()))
    model = DeepJ(torch_test_config(), "cpu")
    model.load_state_dict(params_from_numpy(flat))
    back = params_to_numpy(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)
    cfg = torch_test_config()
    assert model.note_axis[0].lstm.kernel.shape == (
        cfg.time_axis_units + 3, 4 * cfg.note_axis_units)
    assert model.conv.kernel.shape == (24, 3, cfg.octave_units)


@pytest.mark.parametrize("layers", [(3, 2), (1, 3)])
def test_deeper_stacks_round_trip_exactly(layers):
    """A JAX pytree with other depths per axis (time_axis_layers=3, ...)
    carries into the port's DeepJ and back, leaf for leaf."""
    kw = dict(time_axis_layers=layers[0], note_axis_layers=layers[1])
    flat = _flat(init_params(jax.random.key(6), jax_test_config(**kw)))
    model = DeepJ(torch_test_config(**kw), "cpu")
    model.load_state_dict(params_from_numpy(flat))
    back = params_to_numpy(model.state_dict())
    assert set(back) == set(flat) and len(model.time_axis) == layers[0]
    assert f".time_axis[{layers[0] - 1}].lstm.recurrent" in flat
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_fresh_weights_follow_keras_defaults():
    """Without a checkpoint the port draws Keras-default weights, the
    distributions of the JAX `init_params` (not its bits): glorot-uniform
    kernels, orthogonal recurrent matrices, zero biases but a unit forget
    gate, and the same draw for the same seed."""
    cfg = torch_test_config()
    model = build_model(cfg, "cpu", seed=3)
    for name, p in model.named_parameters():
        if name.endswith("recurrent"):
            torch.testing.assert_close(p @ p.T, torch.eye(p.shape[0]),
                                       rtol=0, atol=1e-5)
        elif name.endswith("kernel"):
            fan_in, fan_out = ((p.shape[0] * p.shape[1],
                                p.shape[0] * p.shape[2]) if p.dim() == 3
                               else p.shape)
            assert p.abs().max() <= np.sqrt(6.0 / (fan_in + fan_out))
            assert p.std() > 0
        elif name.endswith("lstm.bias"):
            H = p.shape[0] // 4
            assert (p[H:2 * H] == 1).all() and (p[:H] == 0).all()
            assert (p[2 * H:] == 0).all()
        else:
            assert (p == 0).all(), name
    again = build_model(cfg, "cpu", seed=3).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, again[k])
