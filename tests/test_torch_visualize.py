"""The port's style-embedding export (cli.visualize_main, ref:
visualize.py), each test the counterpart of one in tests/test_visualize.py:
the two TSVs hold the 'style' layer's embeddings and the genre/artist
labels, text-identical to those the JAX package's visualize_main writes on
the same weights."""

import os

import numpy as np
import pytest
import torch

from music_generator_tpu import cli as jax_cli
from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.models.deepj import build_model, dense_apply
from music_generator_tpu_torch.training.keras_import import (
    load_keras_weights, save_keras_weights)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSVS = ("style_embedding_vec.tsv", "style_embedding_labels.tsv")


def _texts(directory) -> list:
    return [open(os.path.join(directory, "out", name)).read()
            for name in TSVS]


def _jax_visualize(directory, monkeypatch, h5):
    """The JAX package's visualize_main --from-keras, run in `directory`."""
    os.makedirs(directory)
    monkeypatch.chdir(directory)
    jax_cli.visualize_main(["--from-keras", h5])
    return _texts(directory)


def test_visualize_writes_correct_tsvs(tmp_path, monkeypatch):
    """No checkpoint: fresh seed-0 weights (build_or_load); the vectors are
    the 'style' Dense layer on the identity, the labels the taxonomy, and
    the JAX package writes the same text from the same weights."""
    cfg = port_test_config()
    monkeypatch.setattr(cli, "default_config", lambda: cfg)
    monkeypatch.chdir(tmp_path)
    vec_path, label_path = cli.visualize_main(["--device", "cpu"])

    vec = np.loadtxt(vec_path, delimiter="\t")
    assert vec.shape == (cfg.num_styles, cfg.style_units)
    model = build_model(cfg, "cpu", seed=0)
    expected = dense_apply(model.style_embed, torch.eye(cfg.num_styles),
                           torch.float32).numpy()
    np.testing.assert_array_equal(vec, expected.astype(np.float64))

    lines = open(label_path).read().splitlines()
    assert lines[0] == "Genre\tArtist"
    rows = [line.split("\t") for line in lines[1:]]
    assert len(rows) == cfg.num_styles
    i = 0
    for genre, styles in zip(cfg.genres, cfg.styles):
        for style_dir in styles:
            assert rows[i] == [genre, os.path.basename(style_dir)]
            i += 1

    h5 = str(tmp_path / "fresh.h5")
    save_keras_weights(model.state_dict(), h5)
    monkeypatch.setattr(jax_cli, "default_config", jax_test_config)
    assert _jax_visualize(tmp_path / "jax", monkeypatch, h5) == \
        _texts(tmp_path)


def test_visualize_from_keras(tmp_path, monkeypatch):
    """--from-keras on the committed flagship model.h5 at default_config():
    the weights rounded to the config's bfloat16 and summed in float32, as
    the JAX package computes them on a Keras file's numpy weights, and the
    same TSV text as its visualize_main."""
    h5 = os.path.join(ROOT, "artifacts", "trained_model_r3", "model.h5")
    monkeypatch.chdir(tmp_path)
    cli.visualize_main(["--device", "cpu", "--from-keras", h5])
    cfg = default_config()
    assert cfg.compute_dtype == "bfloat16"
    vec = np.loadtxt(tmp_path / "out" / TSVS[0], delimiter="\t")
    model = build_model(cfg, "cpu", state=load_keras_weights(h5, cfg))
    layer = model.style_embed
    expected = (layer.kernel.to(torch.bfloat16).float()
                + layer.bias.to(torch.bfloat16).float()).numpy()
    np.testing.assert_array_equal(vec, expected.astype(np.float64))
    assert np.abs(vec - (layer.kernel + layer.bias).numpy()).max() > 0
    pytest.importorskip("h5py")
    assert _jax_visualize(tmp_path / "jax", monkeypatch, h5) == \
        _texts(tmp_path)
