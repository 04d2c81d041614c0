"""The port's training slice against the JAX package at test_config dims,
float32, dropout 0, on the same weights and numpy inputs:

  * DeepJ.loss and the gradient of every parameter against JAX
    value_and_grad(DeepJ.loss) on the v3 fused path (Pallas kernels in
    interpret mode) and on the XLA path: loss rtol 1e-5, grads atol 1e-4;
  * Keras-2 Nadam over 5 steps against ops/nadam.py: params atol 1e-6;
  * two epochs of Trainer.fit against the JAX Trainer.fit (XLA path,
    resident "replicated" epochs on a one-device mesh) from the same
    initial weights: per-epoch losses rtol 1e-4, final params atol 1e-4;
  * the checkpoint round trip, and "train with no generator means no
    dropout"."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data import synth as jsynth
from music_generator_tpu.data.dataset import load_all as jax_load_all
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.ops.nadam import nadam as jax_nadam
from music_generator_tpu.parallel.mesh import make_mesh
from music_generator_tpu.training.trainer import TrainConfig as JaxTrainConfig
from music_generator_tpu.training.trainer import Trainer as JaxTrainer
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.dataset import load_all
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops.nadam import Nadam
from music_generator_tpu_torch.params import (name_to_keystr,
                                              params_from_numpy)
from music_generator_tpu_torch.parallel.train_step import (create_train_state,
                                                           train_step)
from music_generator_tpu_torch.training.checkpoint import (CheckpointStore,
                                                           build_or_load)
from music_generator_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed=0):
    return jsynth.random_batch(cfg, 2, seed=seed)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_loss_and_grads_match_jax(kernel):
    jcfg = jax_test_config(lstm_kernel=kernel)
    params = init_params(jax.random.key(3), jcfg)
    batch = _batch(jcfg)
    jmodel = JaxDeepJ(jcfg)

    def f(p):
        return jmodel.loss(p, batch, rng=None, train=True)[0]

    with pltpu.force_tpu_interpret_mode():
        want_loss, want_grads = jax.value_and_grad(f)(params)
    model = build_model(port_test_config(lstm_kernel=kernel), "cpu",
                        state=params_from_numpy(_flat(params)),
                        trainable=True)
    loss, metrics = model.loss(tuple(torch.from_numpy(a) for a in batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(metrics) == {"loss", "bce_play", "bce_replay", "mse_volume"}
    want = _flat(want_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name_to_keystr(name)],
                                   rtol=0, atol=1e-4, err_msg=name)


def test_nadam_matches_jax_over_five_steps():
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    opt = jax_nadam()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = Nadam(list(tp.values()))
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = opt.update({k: jnp.asarray(g) for k, g in
                                  grads.items()}, jstate)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, t in tp.items():
            t.grad = torch.from_numpy(grads[k])
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
    st = topt.state[tp["a"]]
    assert st["count"].dtype == torch.float32 and float(st["count"]) == 5.0
    np.testing.assert_allclose(float(st["m_schedule"]),
                               float(jstate.m_schedule), rtol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    jsynth.write_synth_corpus(root, styles=[0, 1], files_per_style=2,
                              bars=4, config=jax_test_config())
    return root


def _styles(cfg, root):
    return [[os.path.join(root, s) for s in g] for g in cfg.styles]


@pytest.fixture(scope="module")
def jax_fit(corpus, tmp_path_factory):
    """Two dropout-0 epochs of the JAX trainer (XLA path, resident epochs,
    one device) on the corpus, computed once: (initial params, history,
    final params)."""
    out = str(tmp_path_factory.mktemp("jax_out"))
    cfg = jax_test_config(out_dir=out, **NO_DROPOUT)
    ds = jax_load_all(_styles(cfg, corpus), cfg.seq_len, cfg)
    trainer = JaxTrainer(
        JaxDeepJ(cfg),
        JaxTrainConfig(seed=0, checkpoint=False, tensorboard=False,
                       epoch_scan_mode="replicated"),
        mesh=make_mesh(jax.devices()[:1]))
    init = _flat(trainer.state.params)
    history = trainer.fit(ds, epochs=2)
    return init, history, _flat(trainer.state.params)


def test_fit_tracks_jax_for_two_epochs(corpus, jax_fit, tmp_path):
    init, want_hist, want_params = jax_fit
    cfg = port_test_config(out_dir=str(tmp_path), **NO_DROPOUT)
    ds = load_all(_styles(cfg, corpus), cfg.seq_len, cfg)
    model = build_model(cfg, "cpu")
    trainer = Trainer(model, TrainConfig(seed=0, checkpoint=False,
                                         tensorboard=False))
    model.load_state_dict(params_from_numpy(init))
    hist = trainer.fit(ds, epochs=2)
    assert hist["steps_per_epoch"] == want_hist["steps_per_epoch"]
    assert hist["batch_size"] == want_hist["batch_size"]
    np.testing.assert_allclose(hist["loss"], want_hist["loss"], rtol=1e-4)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_params[name_to_keystr(name)],
                                   rtol=0, atol=1e-4, err_msg=name)
    metrics = trainer.evaluate(ds)
    assert set(metrics) == {"loss", "bce_play", "bce_replay", "mse_volume"}
    assert np.isfinite(metrics["loss"])


def test_checkpoint_round_trip(corpus, tmp_path, capsys):
    cfg = port_test_config(out_dir=str(tmp_path))
    ds = load_all(_styles(cfg, corpus), cfg.seq_len, cfg)
    trainer = Trainer(build_model(cfg, "cpu"), TrainConfig(seed=1))
    trainer.fit(ds, epochs=1)
    assert os.path.isfile(tmp_path / "model.pt")
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    fresh = Trainer(build_model(cfg, "cpu"), TrainConfig(seed=2))
    assert fresh.maybe_restore()
    assert fresh.state.step == trainer.state.step > 0
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    a = trainer.state.optimizer.state_dict()["state"]
    b = fresh.state.optimizer.state_dict()["state"]
    for i in a:
        for k in ("mu", "nu", "count", "m_schedule"):
            assert torch.equal(a[i][k], b[i][k]), (i, k)
    model, loaded = build_or_load(cfg, "cpu")
    assert loaded and "Loaded model from file." in capsys.readouterr().out
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    CheckpointStore(str(tmp_path / "model.pt")).save(fresh.state)


def test_train_without_generator_means_no_dropout():
    cfg = port_test_config()                    # dropout 0.5, input 0.2
    model = build_model(cfg, "cpu", seed=4)
    batch = tuple(torch.from_numpy(a) for a in _batch(jax_test_config(), 1))
    plain = model.loss(batch, generator=None, train=False)[0]
    assert torch.equal(model.loss(batch, generator=None, train=True)[0],
                       plain)
    g = lambda: torch.Generator().manual_seed(9)
    dropped = model.loss(batch, generator=g(), train=True)[0]
    assert not torch.equal(dropped, plain)
    assert torch.equal(model.loss(batch, generator=g(), train=True)[0],
                       dropped)


def test_train_step_counts_and_reduces_loss():
    cfg = port_test_config(**NO_DROPOUT)
    state = create_train_state(build_model(cfg, "cpu"), seed=0)
    batch = tuple(torch.from_numpy(a) for a in _batch(jax_test_config(), 2))
    first = train_step(state, batch)["loss"].item()
    for _ in range(4):
        last = train_step(state, batch)["loss"].item()
    assert state.step == 5 and last < first
