"""The port's DeepJ streaming paths (music_generator_tpu_torch/models/
deepj.py) against the JAX `DeepJ` (float32, lstm_kernel="xla") on the
same weights and the same numpy inputs, for both LSTM gate flavors.

Tolerance: atol 1e-5.  Both sides compute in float32; XLA:CPU's tanh and
logistic and ATen's differ by a few ULPs, and matmul sums run in another
order, so values agree to ~1e-7 relative, far inside 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.config import default_config as jax_default_config
from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import (load_params_npz,
                                              params_from_numpy)

torch.set_num_threads(2)

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = ["sigmoid", "hard_sigmoid"]


def _flat(params) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module", params=GATES)
def pair(request):
    """(JAX model, JAX params, port model, cfg) at test_config dims."""
    cfg = jax_test_config(lstm_recurrent_activation=request.param)
    params = init_params(jax.random.key(11), cfg)
    port = build_model(
        torch_test_config(lstm_recurrent_activation=request.param), "cpu",
        state=params_from_numpy(_flat(params)))
    return JaxDeepJ(cfg), params, port, cfg


def _close(want, got):
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                               atol=ATOL)


def _notes(rng, shape):
    """A random sampled roll: {0,1} play, replay <= play, volume in [0,1)
    where played."""
    play = (rng.random(shape) < 0.4).astype(np.float32)
    replay = (rng.random(shape) < 0.5).astype(np.float32) * play
    vol = rng.random(shape).astype(np.float32) * play
    return np.stack([play, replay, vol], axis=-1)


def test_style_embedding(pair):
    jm, params, port, cfg = pair
    style = np.random.default_rng(0).random((5, cfg.num_styles),
                                            dtype=np.float32)
    _close(jm.style_embedding(params, jnp.asarray(style)),
           port.style_embedding(torch.from_numpy(style)))


def test_octave_conv(pair):
    """Keras 'same' padding for width 24: 11 left, 12 right."""
    jm, params, port, cfg = pair
    notes = _notes(np.random.default_rng(1), (3, 2, cfg.num_notes))
    _close(jm.octave_conv(params, jnp.asarray(notes), None, False),
           port.octave_conv(torch.from_numpy(notes)))


def test_note_features(pair):
    """pitch_pos(1), pitch_class(12), chroma(1), conv, beat: the chroma is
    the per-class play sum over octaves, tiled (deviation #1)."""
    jm, _, port, cfg = pair
    rng = np.random.default_rng(2)
    notes = _notes(rng, (2, 3, cfg.num_notes))
    beat = np.eye(cfg.notes_per_bar, dtype=np.float32)[[[1, 5, 9]] * 2]
    conv = rng.standard_normal((2, 3, cfg.num_notes, cfg.octave_units),
                               dtype=np.float32)
    want = jm.note_features(jnp.asarray(notes), jnp.asarray(beat),
                            jnp.asarray(conv))
    got = port.note_features(torch.from_numpy(notes), torch.from_numpy(beat),
                             torch.from_numpy(conv))
    assert got.shape[-1] == 1 + 12 + 1 + cfg.octave_units + cfg.notes_per_bar
    _close(want, got)


def test_time_axis_step_carries_state(pair):
    """Three streaming steps with the recurrent state carried through."""
    jm, params, port, cfg = pair
    rng = np.random.default_rng(3)
    G = 3
    style = rng.random((G, cfg.num_styles), dtype=np.float32)
    jemb = jm.style_embedding(params, jnp.asarray(style))
    temb = port.style_embedding(torch.from_numpy(style))
    jstate, tstate = jm.init_time_state(G), port.init_time_state(G)
    for t in range(3):
        note = _notes(rng, (G, cfg.num_notes))
        beat = np.zeros((G, cfg.notes_per_bar), np.float32)
        if t:
            beat[:, t - 1] = 1
        jx, jstate = jm.time_axis_step(params, jnp.asarray(note),
                                       jnp.asarray(beat), jemb, jstate)
        tx, tstate = port.time_axis_step(torch.from_numpy(note),
                                         torch.from_numpy(beat), temb,
                                         tstate)
        _close(jx, tx)
        for (jh, jc), (th, tc) in zip(jstate, tstate):
            _close(jh, th)
            _close(jc, tc)


def test_note_axis_cell(pair):
    jm, params, port, cfg = pair
    rng = np.random.default_rng(4)
    G = 4
    feat = rng.uniform(-1, 1, (G, cfg.time_axis_units)).astype(np.float32)
    prev = _notes(rng, (G,))
    emb = rng.standard_normal((G, cfg.style_units), dtype=np.float32)
    state = [tuple(rng.uniform(-1, 1, (G, cfg.note_axis_units))
                   .astype(np.float32) for _ in range(2))
             for _ in range(cfg.note_axis_layers)]
    jpred, jstate = jm.note_axis_cell(
        params, jnp.asarray(feat), jnp.asarray(prev), jnp.asarray(emb),
        tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in state))
    tpred, tstate = port.note_axis_cell(
        torch.from_numpy(feat), torch.from_numpy(prev),
        torch.from_numpy(emb),
        tuple((torch.from_numpy(h), torch.from_numpy(c)) for h, c in state))
    _close(jpred, tpred)
    for (jh, jc), (th, tc) in zip(jstate, tstate):
        _close(jh, th)
        _close(jc, tc)


def test_flagship_time_axis_step_with_trained_weights():
    """Flagship dims (time 256, note 128, style 64, conv 24x3x64) with the
    trained r4 weights: one streaming time-axis step."""
    path = os.path.join(ROOT, "artifacts/trained_model_r4/params.npz")
    cfg = jax_default_config().replace(compute_dtype="float32",
                                       lstm_kernel="xla")
    template = jax.eval_shape(lambda k: init_params(k, cfg),
                              jax.random.key(0))
    with np.load(path) as data:
        leaves, tree = jax.tree_util.tree_flatten_with_path(template)
        params = jax.tree_util.tree_unflatten(
            tree, [jnp.asarray(data[jax.tree_util.keystr(k)])
                   for k, _ in leaves])
    port = build_model(default_config(), "cpu", state=load_params_npz(path))
    jm = JaxDeepJ(cfg)
    rng = np.random.default_rng(5)
    G = 3
    style = rng.random((G, cfg.num_styles), dtype=np.float32)
    note = _notes(rng, (G, cfg.num_notes))
    beat = np.eye(cfg.notes_per_bar, dtype=np.float32)[[0, 7, 15]]
    jx, _ = jm.time_axis_step(params, jnp.asarray(note), jnp.asarray(beat),
                              jm.style_embedding(params, jnp.asarray(style)),
                              jm.init_time_state(G))
    tx, _ = port.time_axis_step(torch.from_numpy(note),
                                torch.from_numpy(beat),
                                port.style_embedding(torch.from_numpy(style)),
                                port.init_time_state(G))
    assert tx.shape == (G, cfg.num_notes, cfg.time_axis_units)
    _close(jx, tx)
