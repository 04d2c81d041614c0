"""The port trainer's staging modes (training/trainer.py) at test_config
dims on the CPU:

  * `epoch_scan_mode` picked as the JAX trainer picks it on one process:
    `auto` gives `replicated`, or `segments` past epoch_scan_max_bytes;
    epoch_scan off or `profile` gives `stream`; `sharded` runs on one
    process too (one block); an unknown mode raises ValueError (the
    choice on more than one rank: tests/test_torch_multiprocess.py);
  * the three modes run the same batch stream and give bit-equal per-step
    losses and final parameters, dropout on, with one-step segments and
    with segments that leave a tail (the CPU runs the same code, one
    thread, no overlap);
  * port `segments`, `stream` and `sharded` against the JAX trainer's
    same mode on a one-device mesh, dropout 0, two epochs from the same
    weights: losses rtol 1e-4, parameters atol 1e-4 (float32 sums in
    another order, as tests/test_torch_train.py holds `replicated`);
  * `train --profile` writes a Chrome trace, and tools/run_big_corpus.py
    runs its resident and segment epochs at --gb 0.01.
"""

import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data import synth as jsynth
from music_generator_tpu.data.dataset import load_all as jax_load_all
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.parallel.mesh import make_mesh
from music_generator_tpu.training.trainer import TrainConfig as JaxTrainConfig
from music_generator_tpu.training.trainer import Trainer as JaxTrainer
from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.dataset import Dataset, load_all
from music_generator_tpu_torch.data.synth import write_synth_corpus
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import (name_to_keystr,
                                              params_from_numpy)
from music_generator_tpu_torch.tools import run_big_corpus
from music_generator_tpu_torch.training import trainer as trainer_mod
from music_generator_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """20 windows: 10 steps an epoch at batch 2."""
    root = str(tmp_path_factory.mktemp("corpus"))
    jsynth.write_synth_corpus(root, styles=[0, 1], files_per_style=2,
                              bars=4, config=jax_test_config())
    return root


def _styles(cfg, root):
    return [[os.path.join(root, s) for s in g] for g in cfg.styles]


def _dataset(corpus, cfg) -> Dataset:
    return load_all(_styles(cfg, corpus), cfg.seq_len, cfg)


def _batch_bytes(ds: Dataset, batch: int) -> int:
    """One batch's bytes as Trainer.fit counts them for the segments."""
    return sum(int(a.nbytes) // len(ds) for a in (
        ds.notes, ds.targets, ds.beats, ds.styles)) * batch


def _fit(cfg, ds, epochs, weights=None, calls=None, monkeypatch=None,
         **tc):
    """Trainer.fit from `weights` (or seed-0 weights); with `calls`, each
    step's batch hash and loss are appended to it."""
    model = build_model(cfg, "cpu")
    trainer = Trainer(model, TrainConfig(seed=0, checkpoint=False,
                                         tensorboard=False, **tc))
    if weights is not None:
        model.load_state_dict(weights)
    if calls is not None:
        real = trainer_mod.train_step

        def recording(state, batch):
            metrics = real(state, batch)
            digest = hashlib.sha256()
            for t in batch:
                digest.update(t.cpu().numpy().tobytes())
            calls.append((digest.hexdigest(), metrics["loss"].item()))
            return metrics
        monkeypatch.setattr(trainer_mod, "train_step", recording)
    hist = trainer.fit(ds, epochs=epochs)
    if calls is not None:
        monkeypatch.setattr(trainer_mod, "train_step", real)
    return hist, model


@pytest.mark.parametrize("kw, mode", [
    (dict(), "replicated"),
    (dict(epoch_scan_mode="auto", epoch_scan_max_bytes=1), "segments"),
    (dict(epoch_scan_mode="replicated", epoch_scan=False), "stream"),
    (dict(epoch_scan_mode="segments", profile=True), "stream"),
    (dict(epoch_scan_mode="segments"), "segments"),
    (dict(epoch_scan_mode="stream"), "stream"),
    (dict(epoch_scan_mode="sharded"), "sharded"),
], ids=["auto", "auto-past-budget", "epoch-scan-off", "profile",
        "segments", "stream", "sharded"])
def test_mode_selection(corpus, tmp_path, kw, mode):
    cfg = port_test_config(out_dir=str(tmp_path))
    ds = _dataset(corpus, cfg)
    small = Dataset(*(a[:2] for a in (ds.notes, ds.targets, ds.beats,
                                      ds.styles)))
    hist, _ = _fit(cfg, small, 1, **kw)
    assert hist["epoch_scan_mode"] == mode
    assert hist["steps_per_epoch"] == [1] and np.isfinite(hist["loss"]).all()


@pytest.mark.parametrize("mode, error", [("nope", ValueError)])
def test_unknown_and_sharded_modes_raise(corpus, tmp_path, mode, error):
    cfg = port_test_config(out_dir=str(tmp_path))
    with pytest.raises(error, match="epoch_scan_mode"):
        _fit(cfg, _dataset(corpus, cfg), 1, epoch_scan_mode=mode)


@pytest.mark.parametrize("budget_steps", [0, 3],
                         ids=["one-step-segments", "segments-with-tail"])
def test_modes_agree_bit_for_bit(corpus, tmp_path, monkeypatch,
                                 budget_steps):
    """Dropout on (test_config's 0.5 and 0.2): each step's dropout comes
    from (seed, step), so equal batches give equal steps.  budget 1 makes
    one-step segments; 3 steps' buffers (twice 3 batches) make segments of
    3 steps and a 1-step tail over 10 steps."""
    cfg = port_test_config(out_dir=str(tmp_path))
    ds = _dataset(corpus, cfg)
    budget = (2 * budget_steps * _batch_bytes(ds, cfg.batch_size)
              if budget_steps else 1)
    weights = build_model(cfg, "cpu", seed=5).state_dict()
    runs = {}
    for mode, kw in (("replicated", {}),
                     ("segments", dict(epoch_scan_max_bytes=budget)),
                     ("stream", dict(epoch_scan=False))):
        calls = []
        hist, model = _fit(cfg, ds, 2, weights, calls, monkeypatch, **kw)
        assert hist["epoch_scan_mode"] == mode
        runs[mode] = (calls, hist, model.state_dict())
    want_calls, want_hist, want_state = runs["replicated"]
    assert len(want_calls) == 20
    for mode in ("segments", "stream"):
        calls, hist, state = runs[mode]
        assert [c[0] for c in calls] == [c[0] for c in want_calls], mode
        assert [c[1] for c in calls] == [c[1] for c in want_calls], mode
        assert hist["loss"] == want_hist["loss"], mode
        assert hist["steps_per_epoch"] == want_hist["steps_per_epoch"]
        for k, v in want_state.items():
            assert torch.equal(state[k], v), (mode, k)


@pytest.mark.parametrize("mode", ["segments", "stream", "sharded"])
def test_port_mode_tracks_jax(corpus, tmp_path, mode):
    """Two dropout-0 epochs of the JAX trainer (XLA path, one-device mesh)
    and of the port in the same mode, from the same weights; segments of
    5 steps (no tail: the JAX trainer would compile its per-step
    executable for it, and the port's tail is held bit for bit to its
    replicated epochs above); `sharded` on one device is one block, whose
    block permutation is the replicated stream."""
    jcfg = jax_test_config(out_dir=str(tmp_path / "jax"), **NO_DROPOUT)
    jds = jax_load_all(_styles(jcfg, corpus), jcfg.seq_len, jcfg)
    budget = 2 * 5 * _batch_bytes(jds, jcfg.batch_size)
    kw = {"segments": dict(epoch_scan_mode="segments",
                           epoch_scan_max_bytes=budget),
          "stream": dict(epoch_scan=False),
          "sharded": dict(epoch_scan_mode="sharded")}[mode]
    jtrainer = JaxTrainer(
        JaxDeepJ(jcfg),
        JaxTrainConfig(seed=0, checkpoint=False, tensorboard=False, **kw),
        mesh=make_mesh(jax.devices()[:1]))
    init = _flat(jtrainer.state.params)
    want = jtrainer.fit(jds, epochs=2)
    assert want["epoch_scan_mode"] == mode
    want_params = _flat(jtrainer.state.params)

    cfg = port_test_config(out_dir=str(tmp_path / "port"), **NO_DROPOUT)
    hist, model = _fit(cfg, _dataset(corpus, cfg), 2,
                       params_from_numpy(init), **kw)
    assert hist["epoch_scan_mode"] == mode
    assert hist["steps_per_epoch"] == want["steps_per_epoch"]
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=1e-4)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(),
                                   want_params[name_to_keystr(name)],
                                   rtol=0, atol=1e-4, err_msg=name)


def _profiled_train_main(tmp_path, monkeypatch) -> dict:
    """train --profile for one epoch of 10 steps on a synthetic corpus."""
    cfg = port_test_config()
    monkeypatch.setattr(cli, "default_config", lambda: cfg)
    monkeypatch.chdir(tmp_path)
    write_synth_corpus(".", styles=[0, 1], files_per_style=2, bars=4,
                       config=cfg)
    return cli.train_main(["--device", "cpu", "--profile", "--epochs", "1"])


_PROFILE_TRACE = os.path.join("out", "logs", "profile",
                              "train_steps_5_10.pt.trace.json")


def test_train_main_profile_writes_a_trace(tmp_path, monkeypatch, capsys):
    hist = _profiled_train_main(tmp_path, monkeypatch)
    assert hist["epoch_scan_mode"] == "stream"
    assert hist["steps_per_epoch"] == [10]
    trace = _PROFILE_TRACE
    assert f"profiler trace written to {trace}" in capsys.readouterr().out
    with open(tmp_path / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_train_main_profile_trace_holds_the_spans(tmp_path, monkeypatch):
    """The profiled steps 5-9 carry the program's spans: one `train.step`
    a step, each with its phases, and nothing left recording after."""
    from music_generator_tpu_torch.utils import spans
    kept = len(spans.profiled().spans)
    _profiled_train_main(tmp_path, monkeypatch)
    with open(tmp_path / _PROFILE_TRACE) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for name in ("train.step", "train.forward", "train.backward",
                 "train.optimizer", "deepj.stack_seeds"):
        assert names.count(name) == 5, name
    assert not spans.is_on() and len(spans.profiled().spans) == kept


def test_run_big_corpus_on_the_cpu(tmp_path, monkeypatch):
    """--gb 0.01 at test widths (batch 16: 33 steps an epoch); a budget of
    0.002 GiB gives segments of 3 steps."""
    monkeypatch.setattr(run_big_corpus, "default_config",
                        lambda: port_test_config(batch_size=16,
                                                 out_dir=str(tmp_path)))
    out = tmp_path / "big.json"
    res = run_big_corpus.main([
        "--gb", "0.01", "--epochs", "1", "--seg-epochs", "1",
        "--seg-budget-gb", "0.002", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["windows"] == res["windows"] > 16
    assert res["device"] == "cpu"
    assert res["resident"]["epoch_scan_mode"] == "replicated"
    assert res["segments"]["epoch_scan_mode"] == "segments"
    assert res["segments"]["losses"] == res["resident"]["losses"]
    assert set(res["h2d_MBps"]) == {"pageable", "pinned"}
