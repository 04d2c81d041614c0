"""The port's Keras 2 weight interchange (music_generator_tpu_torch/
training/keras_import.py on its own HDF5 reader and writer), each test the
counterpart of one in tests/test_keras_import.py, whose h5py fixture
writers (genuine Keras 2 layouts, the legacy bare layout) it imports; plus
the committed model files against their params.npz, files crossing
between the JAX and the port's writer and reader, and `generate
--from-keras` against `--params` (`train --from-keras` and the export
tool: tests/test_torch_cli.py).  Weights are compared bit for bit."""

import os

import jax
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.models import deepj as jdeepj
from music_generator_tpu.ops.lstm import LSTMParams
from music_generator_tpu.training import keras_import as jax_keras
from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.models.deepj import DeepJ, build_model
from music_generator_tpu_torch.params import load_params_npz, save_params_npz
from music_generator_tpu_torch.training.keras_import import (
    REFERENCE_LAYER_TABLE, load_keras_weights, save_keras_weights)

h5py = pytest.importorskip("h5py")

from tests.test_keras_import import (GENUINE_LAYER_NAMES,  # noqa: E402
                                     _PARTS, _params_rows,
                                     _write_genuine_keras_h5,
                                     _write_legacy_bare_h5)

torch.set_num_threads(2)

CFG = port_test_config()
JCFG = jax_test_config()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source(seed: int):
    """(JAX Params, the port's state dict) holding the same weights: every
    leaf drawn from a numpy generator at the port model's shapes."""
    rng = np.random.default_rng(seed)
    shapes = DeepJ(CFG, "cpu").state_dict()
    state = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                 .astype(np.float32))
             for k, v in shapes.items()}
    a = {k: v.numpy() for k, v in state.items()}

    def dense(p):
        return jdeepj.Dense(a[f"{p}.kernel"], a[f"{p}.bias"])

    def axis(name):
        return tuple(jdeepj.AxisLayer(
            dense(f"{name}.{l}.style_proj"),
            LSTMParams(a[f"{name}.{l}.lstm.kernel"],
                       a[f"{name}.{l}.lstm.recurrent"],
                       a[f"{name}.{l}.lstm.bias"])) for l in range(2))

    params = jdeepj.Params(
        style_embed=dense("style_embed"),
        conv=jdeepj.Conv1D(a["conv.kernel"], a["conv.bias"]),
        time_axis=axis("time_axis"), note_axis=axis("note_axis"),
        note_dense=dense("note_dense"), volume_dense=dense("volume_dense"))
    return params, state


def _assert_state_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("naming", ["inner", "wrapper", "nested"])
def test_import_genuine_keras_layout(tmp_path, naming):
    src, state = _source(7)
    path = str(tmp_path / "model.h5")
    _write_genuine_keras_h5(path, src, naming=naming)
    _assert_state_equal(load_keras_weights(path, CFG), state)


def test_imported_params_drive_forward_identically(tmp_path):
    src, state = _source(3)
    path = str(tmp_path / "model.h5")
    _write_genuine_keras_h5(path, src)
    imported = load_keras_weights(path, CFG)
    _assert_state_equal(imported, state)
    ref = build_model(CFG, "cpu", state=state)
    got = build_model(CFG, "cpu", state=imported)
    B, T, N = 2, CFG.seq_len, CFG.num_notes
    notes = torch.zeros((B, T, N, 3))
    notes[:, ::2, 10, 0] = 1.0
    beat = torch.eye(CFG.notes_per_bar)[torch.arange(T)
                                        % CFG.notes_per_bar].expand(B, T, -1)
    style = torch.zeros((B, T, CFG.num_styles))
    style[..., 0] = 1
    with torch.no_grad():
        want = ref.forward(notes, notes, beat, style)
        out = got.forward(notes, notes, beat, style)
    # The weights are bit-equal (above); the JAX test's bound for the
    # forward, since two CPU runs of a float32 forward may round apart.
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_import_legacy_bare_layout(tmp_path):
    src, state = _source(5)
    path = str(tmp_path / "legacy.h5")
    _write_legacy_bare_h5(path, src)
    _assert_state_equal(load_keras_weights(path, CFG), state)


def test_import_dedupes_shared_layers(tmp_path):
    src, state = _source(9)
    path = str(tmp_path / "model.h5")
    _write_genuine_keras_h5(path, src)
    with h5py.File(path, "a") as f:
        dup = f.create_group("time_distributed_11")
        lsrc = f["time_distributed_8"]
        names = [n for n in lsrc.attrs["weight_names"]]
        dup.attrs["weight_names"] = np.array(names)
        for n in names:
            dup.create_dataset(n.decode(), data=np.asarray(lsrc[n.decode()]))
        f.attrs["layer_names"] = np.array(
            list(f.attrs["layer_names"]) + [b"time_distributed_11"])
    _assert_state_equal(load_keras_weights(path, CFG), state)


def test_import_is_order_robust_when_shapes_disambiguate(tmp_path):
    src, state = _source(21)
    path = str(tmp_path / "model.h5")
    _write_genuine_keras_h5(path, src)
    with h5py.File(path, "a") as f:
        names = list(f.attrs["layer_names"])
        weighted = [n for n in names
                    if len(f[n.decode()].attrs["weight_names"])]
        rest = [n for n in names if n not in weighted]
        f.attrs["layer_names"] = np.array(rest + weighted[::-1])
    _assert_state_equal(load_keras_weights(path, CFG), state)


def test_import_rejects_wrong_architecture(tmp_path):
    src, state = _source(1)
    path = str(tmp_path / "model.h5")
    _write_genuine_keras_h5(path, src)
    with pytest.raises(ValueError, match="kernel"):
        load_keras_weights(path, port_test_config(time_axis_units=32))
    with h5py.File(path, "a") as f:
        names = [n for n in f.attrs["layer_names"] if n != b"style"]
        f.attrs["layer_names"] = np.array(names)
    with pytest.raises(ValueError, match="style"):
        load_keras_weights(path, CFG)


def test_import_supports_model_weights_subgroup(tmp_path):
    src, state = _source(2)
    inner = str(tmp_path / "flat.h5")
    _write_genuine_keras_h5(inner, src)
    outer = str(tmp_path / "full.h5")
    with h5py.File(inner, "r") as fin, h5py.File(outer, "w") as fout:
        g = fout.create_group("model_weights")
        for k in fin:
            fin.copy(k, g)
        for a, v in fin.attrs.items():
            g.attrs[a] = v
    _assert_state_equal(load_keras_weights(outer, CFG), state)


def test_export_matches_genuine_keras_layout(tmp_path):
    """save_keras_weights writes the layout of the JAX test's independently
    derived table: depth-ordered layer_names, empty weight_names for the
    weightless layers, wrapper-named groups, inner-layer weight names."""
    src, state = _source(11)
    path = str(tmp_path / "exported.h5")
    save_keras_weights(state, path)
    expected_rows = _params_rows(src)
    with h5py.File(path, "r") as f:
        layer_names = [n.decode() for n in f.attrs["layer_names"]]
        assert layer_names == GENUINE_LAYER_NAMES
        assert f.attrs["backend"] == b"tensorflow"
        assert f.attrs["keras_version"] == b"2.1.6"
        weighted = []
        for name in layer_names:
            g = f[name]
            wnames = [n.decode() for n in g.attrs["weight_names"]]
            if not wnames:
                continue
            weighted.append(name)
            group, inner, arrays = expected_rows[len(weighted) - 1]
            assert name == group
            assert wnames == [f"{inner}/{p}:0"
                              for p in _PARTS[len(arrays)]]
            for wn, a in zip(wnames, arrays):
                np.testing.assert_array_equal(
                    np.asarray(g[wn]), np.asarray(a, np.float32))
        assert len(weighted) == 12


def test_export_import_roundtrip(tmp_path):
    _, state = _source(11)
    path = str(tmp_path / "exported.h5")
    save_keras_weights(state, path)
    _assert_state_equal(load_keras_weights(path, CFG), state)


def test_layer_table_matches_graph_derivation():
    """The port's table is the JAX package's, which tests/
    keras_graph_oracle.py derives from the reference graph."""
    from tests.keras_graph_oracle import derive_layer_table
    assert REFERENCE_LAYER_TABLE == jax_keras.REFERENCE_LAYER_TABLE
    assert derive_layer_table() == REFERENCE_LAYER_TABLE
    assert [n for n, _ in REFERENCE_LAYER_TABLE] == GENUINE_LAYER_NAMES


def test_duplicate_named_group_conflict_rejected(tmp_path):
    src, state = _source(3)
    path = str(tmp_path / "dup.h5")
    _write_genuine_keras_h5(path, src)
    with h5py.File(path, "a") as f:
        g = f.create_group("style_b")
        names = ["style/kernel:0", "style/bias:0"]
        g.attrs["weight_names"] = np.array([n.encode() for n in names])
        g.create_dataset(names[0], data=np.zeros_like(
            np.asarray(src.style_embed.kernel, np.float32)))
        g.create_dataset(names[1], data=np.asarray(
            src.style_embed.bias, np.float32))
        f.attrs["layer_names"] = np.array(
            list(f.attrs["layer_names"]) + [b"style_b"])
    with pytest.raises(ValueError, match="duplicate 'style'"):
        load_keras_weights(path, CFG)
    with h5py.File(path, "a") as f:
        del f["style_b"]["style/kernel:0"]
        f["style_b"].create_dataset(
            "style/kernel:0",
            data=np.asarray(src.style_embed.kernel, np.float32))
    _assert_state_equal(load_keras_weights(path, CFG), state)


@pytest.mark.parametrize("run", ["r3", "r4"])
def test_committed_model_h5_equals_params_npz(run):
    """The committed flagship files, read (not trained) at default_config():
    the port's reader gives their params.npz leaf for leaf, bit for bit."""
    base = os.path.join(ROOT, "artifacts", f"trained_model_{run}")
    got = load_keras_weights(os.path.join(base, "model.h5"),
                             default_config())
    want = load_params_npz(os.path.join(base, "params.npz"))
    assert len(want) == 28
    _assert_state_equal(got, want)


def test_jax_loader_reads_the_port_writer(tmp_path):
    src, state = _source(13)
    path = str(tmp_path / "port.h5")
    save_keras_weights(state, path)
    imported = jax_keras.load_keras_weights(path, JCFG)
    for a, b in zip(jax.tree.leaves(src), jax.tree.leaves(imported)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_reads_the_jax_writer(tmp_path):
    src, state = _source(17)
    path = str(tmp_path / "jax.h5")
    jax_keras.save_keras_weights(src, path)
    _assert_state_equal(load_keras_weights(path, CFG), state)


def test_generate_from_keras_writes_the_params_bytes(tmp_path, monkeypatch):
    """`generate --from-keras` on the CPU writes the same .mid bytes as
    `--params` on the same weights; the two flags exclude each other."""
    monkeypatch.setattr(cli, "default_config", lambda: CFG)
    monkeypatch.chdir(tmp_path)
    state = build_model(CFG, "cpu", seed=4).state_dict()
    save_params_npz(state, "w.npz")
    save_keras_weights(state, "w.h5")
    common = ["--device", "cpu", "--bars", "1", "--seed", "2"]
    a = cli.generate_main(common + ["--params", "w.npz", "--out", "npz"])
    b = cli.generate_main(common + ["--from-keras", "w.h5", "--out", "h5"])
    assert len(a) == len(b) == 3
    for p, q in zip(a, b):
        assert open(p, "rb").read() == open(q, "rb").read()
    with pytest.raises(SystemExit):
        cli.generate_main(common + ["--params", "w.npz",
                                    "--from-keras", "w.h5"])
