"""The linear time axis (music_generator_tpu_torch/ops/linear_scan.py,
`time_axis_kind="linear"`) against the JAX package, at test_config dims,
float32 unless named, from numpy seeds:

  * `associative_scan` bit-equal to `jax.lax.associative_scan` on the same
    (a, b), float32 and bfloat16, at T = 128 and odd T (the h results;
    the tree's a-products are not returned by glru_scan);
  * `glru_scan` against `glru_scan_sequential` and a `glru_step` chain
    (atol 1e-6), and against JAX's `glru_scan` (atol 1e-6);
  * `DeepJ.loss` and the gradient of every parameter against JAX
    value_and_grad(DeepJ.loss) on its XLA path (the note axis's LSTMs as
    lax.scan; tests/test_torch_routes.py holds the port's note-axis routes
    to the Pallas kernels in interpret mode), dropout 0: loss rtol 1e-5,
    every gradient within 1e-5 of JAX's (atol);
  * the route: one glru_scan per time layer, one lstm2 stack on the note
    axis, the biaxial stacks off; with fused_axis_kernel=False one
    recurrence per note layer;
  * streaming (`time_axis_step`) equal to batched within 1e-5;
  * 8 training steps lower the loss, and Trainer.fit checkpoints and
    resumes;
  * a checkpoint of one kind refused by the other by name, before any
    parameter is copied; the Keras importer and exporter refuse the kind;
  * `linear_params` keeps r4's other leaves and matches JAX's leaf shapes;
  * the `Sampler` of both packages writing the same .mid bytes at test
    widths, and the port writing artifacts/linear_time_r19's JAX-CPU
    samples at the flagship widths;
  * a linear-kind service's batched stream equal to its solo response,
    and the sampler's rank block slicing (h,) time states;
  * tools/run_parallel_scan_study.py running its three routes."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data import synth as jsynth
from music_generator_tpu.data.dataset import compute_genre as jax_genre
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.generation.sampler import write_file as jax_write
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.ops import linear_scan as jls
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data import synth
from music_generator_tpu_torch.data.dataset import compute_genre
from music_generator_tpu_torch.generation.sampler import Sampler, write_file
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import lstm2, recurrence
from music_generator_tpu_torch.ops.linear_scan import (GLRUParams,
                                                       associative_scan,
                                                       glru_scan,
                                                       glru_scan_sequential,
                                                       glru_step)
from music_generator_tpu_torch.params import (name_to_keystr,
                                              params_from_numpy)
from music_generator_tpu_torch.parallel.train_step import (create_train_state,
                                                           train_step)
from music_generator_tpu_torch.tools.common import linear_params
from music_generator_tpu_torch.training.checkpoint import (CheckpointStore,
                                                           build_or_load,
                                                           time_axis_kind)
from music_generator_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

LINEAR = dict(time_axis_kind="linear")
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
SAMPLES = os.path.join(ROOT, "artifacts", "linear_time_r19", "samples")


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(flat: dict, cfg):
    tmpl = jax.tree_util.tree_flatten_with_path(
        init_params(jax.random.key(0), cfg))
    assert len(tmpl[0]) == len(flat)
    return jax.tree_util.tree_unflatten(
        tmpl[1], [jnp.asarray(flat[jax.tree_util.keystr(k)])
                  for k, _ in tmpl[0]])


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("T", [128, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_bit_equal_to_jax(T, dtype):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.0, 1.0, (T, 64, 32)).astype(np.float32)
    b = rng.uniform(-1.0, 1.0, (T, 64, 32)).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    _, want = jax.lax.associative_scan(
        _combine, (jnp.asarray(a, jd), jnp.asarray(b, jd)))
    _, got = associative_scan(torch.from_numpy(a).to(td),
                              torch.from_numpy(b).to(td))
    assert got.dtype == td
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _glru(seed, d_in, hidden):
    rng = np.random.default_rng(seed)
    p = GLRUParams(d_in, hidden)
    with torch.no_grad():
        p.kernel.copy_(torch.from_numpy(
            rng.uniform(-0.6, 0.6, (d_in, 2 * hidden)).astype(np.float32)))
        p.bias.copy_(torch.from_numpy(
            rng.uniform(-0.1, 0.1, 2 * hidden).astype(np.float32)))
    return p


def test_scan_matches_sequential_step_and_jax():
    p = _glru(0, 7, 5)
    xs = np.random.default_rng(1).standard_normal((33, 4, 7)).astype(
        np.float32)
    with torch.no_grad():
        par = glru_scan(p, torch.from_numpy(xs))
        seq = glru_scan_sequential(p, torch.from_numpy(xs))
        np.testing.assert_allclose(par.numpy(), seq.numpy(), atol=1e-6)
        h = torch.zeros(4, 5)
        for t in range(xs.shape[0]):
            h = glru_step(p, torch.from_numpy(xs[t]), h)
            np.testing.assert_allclose(h.numpy(), seq[t].numpy(), atol=1e-6)
    jp = jls.GLRUParams(jnp.asarray(p.kernel.detach().numpy()),
                        jnp.asarray(p.bias.detach().numpy()))
    want = jls.glru_scan(jp, jnp.asarray(xs))
    np.testing.assert_allclose(par.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("overrides", [{}, dict(fused_axis_kernel=False)])
def test_loss_and_grads_match_jax(overrides):
    jcfg = jax_test_config(**LINEAR, **NO_DROPOUT, **overrides)
    params = init_params(jax.random.key(5), jcfg)
    assert isinstance(params.time_axis[0].lstm, jls.GLRUParams)
    batch = jsynth.random_batch(jcfg, 2, seed=0)
    jmodel = JaxDeepJ(jcfg)

    def f(p):
        return jmodel.loss(p, batch, rng=None, train=True)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(f))(params)
    model = build_model(port_test_config(**LINEAR, **NO_DROPOUT,
                                         **overrides), "cpu",
                        state=params_from_numpy(_flat(params)),
                        trainable=True)
    calls = (lstm2.lstm2_stack_reference.calls,
             recurrence.lstm_recurrence_reference.calls)
    loss, _ = model.loss(tuple(torch.from_numpy(a) for a in batch))
    ran = (lstm2.lstm2_stack_reference.calls - calls[0],
           recurrence.lstm_recurrence_reference.calls - calls[1])
    assert ran == ((1, 0) if not overrides else (0, 2))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = _flat(want_grads)
    assert len(want) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name_to_keystr(name)],
                                   rtol=0, atol=1e-5, err_msg=name)


def test_streaming_equals_batched():
    cfg = port_test_config(**LINEAR)
    model = build_model(cfg, "cpu", seed=2)
    G, T, N = 2, 6, cfg.num_notes
    rng = np.random.default_rng(3)
    notes = torch.from_numpy(
        (rng.random((G, T, N, 3)) < 0.2).astype(np.float32))
    beat = torch.eye(cfg.notes_per_bar)[torch.arange(T) % cfg.notes_per_bar]
    beat = beat[None].expand(G, T, -1)
    style = torch.zeros(G, cfg.num_styles)
    style[:, 0] = 1.0
    with torch.no_grad():
        emb = model.style_embedding(style)
        feats = model.note_features(notes, beat, model.octave_conv(notes))
        emb_t = emb[:, None].expand(G, T, -1)
        batched = model.time_axis_tm(feats.permute(1, 0, 2, 3),
                                     emb_t.transpose(0, 1))
        state = model.init_time_state(G)
        assert all(len(layer) == 1 for layer in state)     # (h,) a layer
        for t in range(T):
            out, state = model.time_axis_step(notes[:, t], beat[:, t], emb,
                                              state)
            np.testing.assert_allclose(out.numpy(), batched[t].numpy(),
                                       atol=1e-5)


def test_eight_steps_lower_the_loss():
    cfg = port_test_config(**LINEAR)
    model = build_model(cfg, "cpu", seed=0, trainable=True)
    state = create_train_state(model, seed=0)
    batch = tuple(torch.from_numpy(a)
                  for a in synth.random_batch(cfg, seed=0,
                                              rolled_targets=True))
    losses = [float(train_step(state, batch)["loss"]) for _ in range(8)]
    assert losses[-1] < losses[0], losses


def test_fit_checkpoints_and_resumes(tmp_path):
    cfg = port_test_config(**LINEAR, out_dir=str(tmp_path / "out"))
    synth.write_synth_corpus(str(tmp_path), styles=[0, 1],
                             files_per_style=1, bars=4, config=cfg)
    from music_generator_tpu_torch.data.dataset import load_all
    styles = [[str(tmp_path / d) for d in g] for g in cfg.styles]
    ds = load_all(styles, cfg.seq_len, cfg)
    trainer = Trainer(build_model(cfg, "cpu", seed=0, trainable=True),
                      TrainConfig(seed=0, tensorboard=False))
    hist = trainer.fit(ds, epochs=2)
    assert np.isfinite(hist["loss"]).all()
    model, loaded = build_or_load(cfg, "cpu")
    assert loaded
    for k, v in model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k
    again = Trainer(build_model(cfg, "cpu", seed=1, trainable=True),
                    TrainConfig(seed=0, tensorboard=False))
    assert again.maybe_restore()
    assert again.state.step == trainer.state.step


@pytest.mark.parametrize("saved, loading", [("linear", "lstm"),
                                            ("lstm", "linear")])
def test_checkpoint_of_the_other_kind_is_refused(saved, loading, tmp_path,
                                                 capsys):
    path = str(tmp_path / "model.pt")
    src = build_model(port_test_config(time_axis_kind=saved), "cpu", seed=0,
                      trainable=True)
    CheckpointStore(path).save(create_train_state(src, seed=0))
    assert time_axis_kind(CheckpointStore(path).load()["params"]) == saved
    cfg = port_test_config(time_axis_kind=loading)
    model, loaded = build_or_load(cfg, "cpu", seed=3, path=path)
    assert not loaded
    assert f"time_axis_kind={saved!r}" in capsys.readouterr().out
    fresh = build_model(cfg, "cpu", seed=3)
    target = create_train_state(fresh, seed=0)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    with pytest.raises(ValueError, match=f"this model's is {loading!r}"):
        CheckpointStore(path).restore(target)
    for k, v in fresh.state_dict().items():     # nothing was copied
        assert torch.equal(v, before[k]), k


def test_keras_interchange_refuses_the_linear_kind(tmp_path):
    from music_generator_tpu_torch.training.keras_import import (
        load_keras_weights, save_keras_weights)
    with pytest.raises(ValueError, match="no Keras mapping"):
        load_keras_weights(os.path.join(ROOT, "artifacts",
                                        "trained_model_r4", "model.h5"),
                           default_config().replace(**LINEAR))
    state = build_model(port_test_config(**LINEAR), "cpu").state_dict()
    with pytest.raises(ValueError, match="no Keras mapping"):
        save_keras_weights(state, str(tmp_path / "m.h5"))
    assert not (tmp_path / "m.h5").exists()


def test_linear_params_keeps_r4_and_matches_jax_shapes():
    with np.load(R4) as data:
        r4 = {k: data[k] for k in data.files}
    got = linear_params(r4, seed=0)
    cfg = default_config().replace(**LINEAR)
    want = {jax.tree_util.keystr(path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda: init_params(jax.random.key(0),
                                                   cfg)))[0]}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.shape == want[k] and v.dtype == np.float32, k
        if ".time_axis[" in k and ".lstm." in k:
            assert not k.endswith("bias") or not v.any(), k
        else:
            assert np.array_equal(v, r4[k]), k
    again = linear_params(r4, seed=0)
    assert all(np.array_equal(again[k], v) for k, v in got.items())
    # params.py's names load into the port's linear model unchanged.
    build_model(cfg, "cpu", state=params_from_numpy(got))


def test_generate_matches_jax_bytes(tmp_path):
    """Test widths: the JAX and the port Sampler from the same arrays, 3
    genres, 2 bars, seed 0, each written by its package's write_file."""
    jcfg = jax_test_config(**LINEAR)
    flat = _flat(init_params(jax.random.key(43), jcfg))
    res = JaxSampler(JaxDeepJ(jcfg), _jax_params(flat, jcfg)).generate(
        [jax_genre(i, jcfg) for i in range(3)], num_bars=2, seed=0)
    want = jax_write("jax", res, jcfg.replace(out_dir=str(tmp_path)))
    cfg = port_test_config(**LINEAR)
    model = build_model(cfg, "cpu", state=params_from_numpy(flat))
    res = Sampler(model).generate(
        [compute_genre(i, cfg) for i in range(3)], num_bars=2, seed=0)
    got = write_file("port", res, cfg.replace(out_dir=str(tmp_path)))
    assert len(got) == 3
    for a, b in zip(want, got):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_generate_writes_the_committed_jax_samples(tmp_path):
    """Flagship widths, linear_params(r4, seed=0): the port's CPU
    generation writes artifacts/linear_time_r19's bytes."""
    with np.load(R4) as data:
        flat = linear_params({k: data[k] for k in data.files}, seed=0)
    cfg = default_config().replace(**LINEAR, out_dir=str(tmp_path))
    model = build_model(cfg, "cpu", state=params_from_numpy(flat))
    res = Sampler(model).generate([compute_genre(i, cfg) for i in range(3)],
                                  num_bars=2, seed=0)
    for i, p in enumerate(write_file("linear", res, cfg)):
        assert filecmp.cmp(p, os.path.join(SAMPLES, f"linear_{i}.mid"),
                           shallow=False), p


def test_service_serves_the_linear_kind():
    """A linear-kind GenerationService: a stream's bytes in a batch of two
    equal its solo response (the bucket padding and the batch slicing work
    on (h,) time states)."""
    from music_generator_tpu_torch.serving import GenerationService
    cfg = port_test_config(**LINEAR)
    service = GenerationService(
        config=cfg, params=build_model(cfg, "cpu", seed=0).state_dict(),
        warmup=False, device="cpu")
    mixtures = [compute_genre(i, cfg) for i in range(2)]
    pair = service.generate_batch(mixtures, bars=1, seed=3)
    assert pair[0] == service.generate_batch(mixtures[:1], bars=1, seed=3)[0]


def test_rank_block_slices_every_time_state_tensor(monkeypatch):
    """Sampler._local on two ranks takes rank 1's streams of each layer's
    (h,) tuple (and of an LSTM model's (h, c))."""
    from music_generator_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "world", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    for kind, n in (("linear", 1), ("lstm", 2)):
        cfg = port_test_config(time_axis_kind=kind)
        sampler = Sampler(build_model(cfg, "cpu", seed=0))
        state = sampler._init_state(4, 0, 1.0)
        local = sampler._local(state)
        N = cfg.num_notes
        for full, mine in zip(state.time_state, local.time_state):
            assert len(mine) == n
            for a, b in zip(full, mine):
                assert torch.equal(b, a[2 * N:])
        assert torch.equal(local.stream_keys, state.stream_keys[2:])


def test_parallel_scan_study_runs_every_route(tmp_path, monkeypatch):
    """tools/run_parallel_scan_study.py on the CPU at test widths: every
    route at the batch size asked for, its readings in the JSON report
    (no device time off the card)."""
    import json
    from music_generator_tpu_torch.tools import run_parallel_scan_study as s
    monkeypatch.setattr(s, "default_config", port_test_config)
    monkeypatch.setattr(s, "WARMUP", 1)
    out = str(tmp_path / "study.json")
    s.main(["--device", "cpu", "--batches", "2", "--steps", "1",
            "--out", out])
    with open(out) as f:
        report = json.load(f)
    assert report["card"] is None and list(report["throughput"]) == ["B2"]
    for rows in report["throughput"].values():
        assert sorted(rows) == sorted(s.ROUTES)
        for r in rows.values():
            assert r["timesteps_per_sec"] > 0 and len(r["host_ms_runs"]) == 3
            assert r["device_ms"] is None and r["busy_share"] is None
            assert np.isfinite(r["loss"])
