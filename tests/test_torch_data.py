"""The port's data pipeline and helpers (music_generator_tpu_torch/data,
utils) against the JAX package's: the same synthetic corpus bytes, the same
windowed arrays, the same batch streams, exactly."""

import os

import jax
import numpy as np
import pytest

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data import dataset as jds
from music_generator_tpu.data import synth as jsynth
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.utils import get_all_files as jax_get_all_files
from music_generator_tpu.utils import param_summary as jax_param_summary
from music_generator_tpu.utils import tboard as jtb
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data import dataset as tds
from music_generator_tpu_torch.data import synth as tsynth
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.utils import get_all_files, param_summary
from music_generator_tpu_torch.utils import tboard as ttb


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same synth corpus written by each package into its own root."""
    roots = {}
    for name, mod in (("jax", jsynth), ("port", tsynth)):
        root = str(tmp_path_factory.mktemp(name))
        mod.write_synth_corpus(root, styles=[0, 4, 22], files_per_style=2,
                               bars=9, seed=3)
        roots[name] = root
    return roots


def _rel_files(root):
    return [os.path.relpath(p, root) for p in get_all_files([root])]


def test_synth_corpus_is_byte_identical(corpora):
    files = _rel_files(corpora["jax"])
    assert files == _rel_files(corpora["port"]) and len(files) == 6
    for f in files:
        a = open(os.path.join(corpora["jax"], f), "rb").read()
        b = open(os.path.join(corpora["port"], f), "rb").read()
        assert a == b, f


def test_get_all_files_matches(corpora):
    root = corpora["port"]
    assert get_all_files([root]) == jax_get_all_files([root])


@pytest.mark.parametrize("which", ["test", "default"])
def test_load_all_equals_jax(corpora, tmp_path, which):
    """Both loaders on the same corpus give the same arrays, exactly."""
    root = corpora["port"]
    cfg = (port_test_config() if which == "test" else default_config()).replace(
        out_dir=str(tmp_path / "out"))
    jcfg = jax_test_config() if which == "test" else None
    if jcfg is None:
        from music_generator_tpu.config import default_config as jdc
        jcfg = jdc()
    jcfg = jcfg.replace(out_dir=str(tmp_path / "jout"))
    styles = [[os.path.join(root, s) for s in g] for g in cfg.styles]
    got = tds.load_all(styles, cfg.seq_len, cfg)
    want = jds.load_all(styles, jcfg.seq_len, jcfg)
    assert len(got) == len(want) > 0
    for a in ("notes", "targets", "beats", "styles"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))


@pytest.mark.parametrize("n,bs,drop", [(17, 4, False), (17, 4, True),
                                       (3, 8, False), (64, 16, False)])
def test_epoch_permutation_equals_jax(n, bs, drop):
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        np.testing.assert_array_equal(
            tds.epoch_permutation(n, bs, a, drop),
            jds.epoch_permutation(n, bs, b, drop))


@pytest.mark.parametrize("rolled", [False, True])
def test_random_batch_equals_jax(rolled):
    cfg, jcfg = port_test_config(), jax_test_config()
    for seed in (0, 1):
        for x, y in zip(tsynth.random_batch(cfg, 3, seed, rolled),
                        jsynth.random_batch(jcfg, 3, seed, rolled)):
            np.testing.assert_array_equal(x, y)


def test_helpers_equal_jax():
    seq = np.random.default_rng(0).random((20, 48, 3)).astype(np.float32)
    for shift in (-3, 0, 2):
        np.testing.assert_array_equal(tds.transpose_augment(seq, shift),
                                      jds.transpose_augment(seq, shift))
    for x, y in zip(tds.stagger(seq, 8, 4), jds.stagger(seq, 8, 4)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tds.compute_beat(21, 16),
                                  jds.compute_beat(21, 16))
    ds = tds.Dataset(seq[None], seq[None], seq[None, :, :16], seq[None])
    got = list(tds.batches(ds, 2, rng=np.random.default_rng(1),
                           drop_remainder=False))
    assert len(got) == 1 and got[0][0].shape == (2, 20, 48, 3)


def test_param_summary_equals_jax():
    cfg = jax_test_config()
    params = init_params(jax.random.key(0), cfg)
    model = build_model(port_test_config(), "cpu")
    assert param_summary(model.state_dict()) == jax_param_summary(params)


def test_tboard_encoding_equals_jax():
    data = bytes(range(256)) * 3
    assert ttb.crc32c(data) == jtb.crc32c(data)
    vals = np.random.default_rng(2).standard_normal(1000)
    assert ttb._histogram_proto(vals) == jtb._histogram_proto(vals)
    assert (ttb._scalar_event(7, "a/b", 0.5, 12.0)
            == jtb._scalar_event(7, "a/b", 0.5, 12.0))
