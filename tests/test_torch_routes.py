"""The port's training routes (music_generator_tpu_torch/models/deepj.py
`forward`) against the JAX package, at test_config dims, float32:

  * DeepJ.loss and the gradient of every parameter against JAX
    value_and_grad(DeepJ.loss) with lstm_kernel="pallas" (Pallas kernels in
    interpret mode), dropout 0, on the axis-fused route
    (fused_biax_v3=False: one two-layer stack per axis), the per-layer
    route (fused_axis_kernel=False as well: one recurrence per layer) and a
    3 + 1 layer stack: loss rtol 1e-5, grads atol 1e-4;
  * which route runs, read from the plain versions' call counters;
  * "train with no generator means no dropout" on each new route;
  * depths of 1 to 8 layers per axis train and evaluate, and a 3 + 3
    stack checkpoints through Trainer.fit;
  * one epoch of Trainer.fit on the per-layer route against the JAX
    Trainer.fit (XLA path), as tests/test_torch_train.py runs two on the
    biaxial route: loss rtol 1e-4, final params atol 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data import synth as jsynth
from music_generator_tpu.data.dataset import load_all as jax_load_all
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.parallel.mesh import make_mesh
from music_generator_tpu.training.trainer import TrainConfig as JaxTrainConfig
from music_generator_tpu.training.trainer import Trainer as JaxTrainer
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.dataset import load_all
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import biax, lstm2, recurrence
from music_generator_tpu_torch.params import (name_to_keystr,
                                              params_from_numpy)
from music_generator_tpu_torch.parallel.train_step import (create_train_state,
                                                           eval_step,
                                                           train_step)
from music_generator_tpu_torch.training.checkpoint import build_or_load
from music_generator_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)
ROUTES = {
    "axis_fused": dict(fused_biax_v3=False),
    "per_layer": dict(fused_biax_v3=False, fused_axis_kernel=False),
    "depth_3_1": dict(time_axis_layers=3, note_axis_layers=1),
}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(seed=0):
    return jsynth.random_batch(jax_test_config(), 2, seed=seed)


def _torch_batch(seed=0):
    return tuple(torch.from_numpy(a) for a in _batch(seed))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_loss_and_grads_match_jax_pallas_routes(route):
    jcfg = jax_test_config(lstm_kernel="pallas", **ROUTES[route])
    params = init_params(jax.random.key(3), jcfg)
    batch = _batch()
    jmodel = JaxDeepJ(jcfg)

    def f(p):
        return jmodel.loss(p, batch, rng=None, train=True)[0]

    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grads = jax.value_and_grad(f)(params)
    model = build_model(port_test_config(**ROUTES[route]), "cpu",
                        state=params_from_numpy(_flat(params)),
                        trainable=True)
    loss, _ = model.loss(_torch_batch())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = _flat(want_grads)
    assert len(want) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name_to_keystr(name)],
                                   rtol=0, atol=1e-4, err_msg=name)


def _calls():
    return (biax.biax_time_stack_reference.calls,
            biax.biax_note_stack_reference.calls,
            lstm2.lstm2_stack_reference.calls,
            recurrence.lstm_recurrence_reference.calls)


@pytest.mark.parametrize("overrides,expected", [
    ({}, (1, 1, 0, 0)),
    (ROUTES["axis_fused"], (0, 0, 2, 0)),
    (ROUTES["per_layer"], (0, 0, 0, 4)),
    (ROUTES["depth_3_1"], (0, 0, 0, 4)),
    (dict(time_axis_layers=3), (0, 0, 1, 3)),
    (dict(fused_biax_v3=False, note_axis_layers=1), (0, 0, 1, 1)),
    (dict(lstm_kernel="pallas", time_axis_layers=1, note_axis_layers=8),
     (0, 0, 0, 9)),
])
def test_route_selection(overrides, expected):
    """Per axis, as the JAX package with lstm_kernel="pallas": the biaxial
    stacks for two equal layers on both axes with fused_biax_v3, else one
    lstm2 stack for an axis of two equal layers with fused_axis_kernel,
    else one recurrence per layer.  lstm_kernel is not read."""
    model = build_model(port_test_config(**overrides), "cpu", seed=1)
    before = _calls()
    with torch.no_grad():
        out = model(*_torch_batch())
    assert out.shape == (2, 16, 48, 3) and out.dtype == torch.float32
    assert tuple(a - b for a, b in zip(_calls(), before)) == expected


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_without_generator_means_no_dropout(route):
    model = build_model(port_test_config(**ROUTES[route]), "cpu", seed=4)
    batch = _torch_batch(1)
    plain = model.loss(batch, generator=None, train=False)[0]
    assert torch.equal(model.loss(batch, generator=None, train=True)[0],
                       plain)
    g = lambda: torch.Generator().manual_seed(9)
    dropped = model.loss(batch, generator=g(), train=True)[0]
    assert not torch.equal(dropped, plain)
    assert torch.equal(model.loss(batch, generator=g(), train=True)[0],
                       dropped)


@pytest.mark.parametrize("layers", [(1, 1), (3, 2), (8, 5)])
def test_any_depth_trains_and_evaluates(layers):
    cfg = port_test_config(time_axis_layers=layers[0],
                           note_axis_layers=layers[1])
    state = create_train_state(build_model(cfg, "cpu"), seed=0)
    batch = _torch_batch(2)
    for _ in range(2):
        metrics = train_step(state, batch)
        assert np.isfinite(metrics["loss"].item())
    per_sample = eval_step(state.model, batch)
    assert per_sample["loss"].shape == (2,)
    assert torch.isfinite(per_sample["loss"]).all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    jsynth.write_synth_corpus(root, styles=[0, 1], files_per_style=2,
                              bars=4, config=jax_test_config())
    return root


def _styles(cfg, root):
    return [[os.path.join(root, s) for s in g] for g in cfg.styles]


def test_fit_on_the_per_layer_route_tracks_jax(corpus, tmp_path):
    """One dropout-0 epoch from the same weights: the JAX trainer on its
    XLA path (lax.scan per layer) and the port's per-layer route."""
    jcfg = jax_test_config(out_dir=str(tmp_path / "jax"), **NO_DROPOUT)
    jds = jax_load_all(_styles(jcfg, corpus), jcfg.seq_len, jcfg)
    jtrainer = JaxTrainer(
        JaxDeepJ(jcfg),
        JaxTrainConfig(seed=0, checkpoint=False, tensorboard=False,
                       epoch_scan_mode="replicated"),
        mesh=make_mesh(jax.devices()[:1]))
    init = _flat(jtrainer.state.params)
    want_hist = jtrainer.fit(jds, epochs=1)
    want_params = _flat(jtrainer.state.params)

    cfg = port_test_config(out_dir=str(tmp_path / "port"), **NO_DROPOUT,
                           **ROUTES["per_layer"])
    ds = load_all(_styles(cfg, corpus), cfg.seq_len, cfg)
    model = build_model(cfg, "cpu")
    trainer = Trainer(model, TrainConfig(seed=0, checkpoint=False,
                                         tensorboard=False))
    model.load_state_dict(params_from_numpy(init))
    before = recurrence.lstm_recurrence_reference.calls
    hist = trainer.fit(ds, epochs=1)
    steps = hist["steps_per_epoch"][0]
    assert hist["steps_per_epoch"] == want_hist["steps_per_epoch"]
    assert recurrence.lstm_recurrence_reference.calls - before >= 4 * steps
    np.testing.assert_allclose(hist["loss"], want_hist["loss"], rtol=1e-4)
    for name, p in model.state_dict().items():
        want = want_params[name_to_keystr(name)]
        np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_checkpoint_round_trip_at_depth_3(corpus, tmp_path):
    """A 3 + 3 layer model trains one epoch through Trainer.fit, writes
    out/model.pt and loads back leaf for leaf."""
    cfg = port_test_config(out_dir=str(tmp_path), time_axis_layers=3,
                           note_axis_layers=3)
    ds = load_all(_styles(cfg, corpus), cfg.seq_len, cfg)
    trainer = Trainer(build_model(cfg, "cpu"), TrainConfig(seed=1))
    hist = trainer.fit(ds, epochs=1)
    assert np.isfinite(hist["loss"]).all()
    assert os.path.isfile(tmp_path / "model.pt")
    model, loaded = build_or_load(cfg, "cpu")
    assert loaded
    saved = trainer.model.state_dict()
    assert len(saved) == 4 + 2 * 5 * 3 + 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
