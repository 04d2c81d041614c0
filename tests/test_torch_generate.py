"""The port's generation slice as a whole (music_generator_tpu_torch:
Sampler, write_file, cli.generate_main) on the CPU.

  * At test_config dims the port's `Sampler.generate` equals the JAX
    `Sampler.generate` from the same weights and seed: play and replay
    exactly, volumes within atol 1e-5 (float32 sums in another order), and
    the written .mid bytes.
  * At flagship dims the port regenerates committed TPU-generated
    samples byte for byte from their trained weights:
    short_samples_r4/short_s0_*.mid, short_samples_r2/short_s0_*.mid and
    real_corpus_r3/real_trained_*.mid.
  * The CLI writes parseable .mid files, and entry points refuse to run
    without a card unless asked for the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.generation.sampler import (
    write_file as jax_write_file)
from music_generator_tpu.midi import read_midifile as jax_read_midifile
from music_generator_tpu.midi import midi_decode as jax_midi_decode
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.data.dataset import compute_genre
from music_generator_tpu_torch.generation.sampler import (Sampler,
                                                          StepState,
                                                          write_file)
from music_generator_tpu_torch.midi import midi_decode, read_midifile
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import notegen
from music_generator_tpu_torch.params import (load_params_npz,
                                              params_from_numpy)
from music_generator_tpu_torch.utils import one_hot

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
VOLUME_ATOL = 1e-5


@pytest.fixture(scope="module")
def samplers():
    """(JAX Sampler, port Sampler, cfg) on the same test_config weights."""
    cfg = jax_test_config()
    params = init_params(jax.random.key(2), cfg)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    port = build_model(torch_test_config(), "cpu",
                       state=params_from_numpy(flat))
    return JaxSampler(JaxDeepJ(cfg), params), Sampler(port), cfg


def _assert_same_notes(want, got):
    assert want.shape == got.shape
    np.testing.assert_array_equal(want[..., :2], got[..., :2])
    np.testing.assert_allclose(want[..., 2], got[..., 2], rtol=0,
                               atol=VOLUME_ATOL)


@pytest.mark.parametrize("seed,T", [(0, 1.0), (0, 0.9), (7, 1.0), (7, 0.9)])
def test_generate_matches_jax_sampler(samplers, seed, T, tmp_path):
    """2 bars, the 3 genre mixtures: same notes, same .mid bytes."""
    js, ps, cfg = samplers
    styles = [compute_genre(i, cfg) for i in range(3)]
    want = js.generate(styles, num_bars=2, seed=seed, temperature=T)
    got = ps.generate(styles, num_bars=2, seed=seed, temperature=T)
    assert got.notes.shape == (3, 2 * cfg.notes_per_bar, cfg.num_notes, 3)
    assert 0 < got.notes[..., 0].mean() < 1
    _assert_same_notes(want.notes, got.notes)
    jpaths = jax_write_file("out", want, cfg.replace(out_dir=str(
        tmp_path / "jax")))
    ppaths = write_file("out", got, torch_test_config(out_dir=str(
        tmp_path / "torch")))
    for a, b in zip(jpaths, ppaths):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_sweep_streams_match_jax_and_solo_runs(samplers):
    """--sweep-style batch: 4 interpolated mixtures.  Equal to the JAX
    batch, and stream g equals a solo run at stream_offset=g (the
    stream-indexed uniforms of deviation #10)."""
    js, ps, cfg = samplers
    sa, sb = one_hot(1, cfg.num_styles), one_hot(5, cfg.num_styles)
    styles = [(1 - w) * sa + w * sb for w in np.linspace(0.0, 1.0, 4)]
    want = js.generate(styles, num_bars=1, seed=3)
    got = ps.generate(styles, num_bars=1, seed=3)
    _assert_same_notes(want.notes, got.notes)
    for g in (0, 2):
        solo = ps.generate([styles[g]], num_bars=1, seed=3, stream_offset=g)
        _assert_same_notes(got.notes[g:g + 1], solo.notes)


def test_chunking_does_not_change_the_output(samplers):
    """The state crosses chunk boundaries exactly: 2 bars in 1-bar chunks
    equal 2 bars in one chunk."""
    _, ps, cfg = samplers
    styles = [compute_genre(1, cfg)]
    a = ps.generate(styles, num_bars=2, seed=4, chunk_bars=1)
    b = ps.generate(styles, num_bars=2, seed=4, chunk_bars=8)
    np.testing.assert_array_equal(a.notes, b.notes)


def test_temperature_update_and_beat_rows_match_jax(samplers):
    """The adaptive-temperature machine (+0.1 per silent step after a
    silent bar, reset on any note) and the beat of t-1 (zeros at t=0)."""
    js, ps, cfg = samplers
    G = 5
    npb = cfg.notes_per_bar
    silent_time = np.array([0, npb - 2, npb - 1, npb + 3, 2], np.int32)
    temperature = np.array([1.0, 1.3, 0.9, 1.5, 0.8], np.float32)
    base = np.array([1.0, 1.0, 0.9, 1.2, 0.8], np.float32)
    note = np.zeros((G, cfg.num_notes, 3), np.float32)
    note[4, 7] = (1.0, 0.0, 0.5)
    jstate = js._init_state(G, jnp.uint32(0), 1.0)._replace(
        temperature=jnp.asarray(temperature), base_temp=jnp.asarray(base),
        silent_time=jnp.asarray(silent_time))
    want = js._temperature_update(jstate, jnp.asarray(note))
    pstate = ps._init_state(G, 0, 1.0)._replace(
        temperature=torch.from_numpy(temperature),
        base_temp=torch.from_numpy(base),
        silent_time=torch.from_numpy(silent_time))
    assert isinstance(pstate, StepState)
    got = ps._temperature_update(pstate, torch.from_numpy(note))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for t in range(2 * npb + 1):
        np.testing.assert_array_equal(np.asarray(js._beat_row(t, 2)),
                                      ps._beat_row(t, 2).numpy())


def test_midi_copy_writes_and_reads_like_the_jax_codec(samplers, tmp_path):
    """The port's own MIDI copies: the files the JAX package writes decode
    the same through either codec."""
    js, _, cfg = samplers
    res = js.generate([compute_genre(2, cfg)], num_bars=1, seed=5)
    (path,) = jax_write_file("x", res, cfg.replace(out_dir=str(tmp_path)))
    want = jax_midi_decode(jax_read_midifile(path))
    got = midi_decode(read_midifile(path))
    np.testing.assert_array_equal(want, got)


# name -> (weights, styles, bars, seed, temperature, committed file pattern);
# each recipe is the one its PROVENANCE/report records for the TPU run.
RECIPES = {
    "short_samples_r4": ("trained_model_r4/params.npz", "genres", 8, 0,
                         None, "short_samples_r4/short_s0_{}.mid"),
    "short_samples_r2": ("trained_model_r3/params_short23.npz", "genres",
                         8, 0, None, "short_samples_r2/short_s0_{}.mid"),
    "real_corpus_r3": ("real_corpus_r3/params.npz", (0, 3, 9), 16, 0, 0.75,
                       "real_corpus_r3/real_trained_{}.mid"),
}


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    """The port on the CPU at flagship dims, per recipe (run once each):
    the paths of the three .mid files it writes."""
    done = {}

    def run(name):
        if name not in done:
            npz, styles, bars, seed, temp, _ = RECIPES[name]
            cfg = default_config().replace(
                out_dir=str(tmp_path_factory.mktemp(name)))
            if styles == "genres":
                styles = [compute_genre(i, cfg) for i in range(3)]
            else:
                styles = [one_hot(s, cfg.num_styles) for s in styles]
            model = build_model(cfg, "cpu", state=load_params_npz(
                os.path.join(ROOT, "artifacts", npz)))
            result = Sampler(model).generate(styles, num_bars=bars,
                                             seed=seed, temperature=temp)
            done[name] = write_file(name, result, cfg)
        return done[name]
    return run


@pytest.mark.parametrize("i", [0, 1, 2])
@pytest.mark.parametrize("name", list(RECIPES))
def test_flagship_regenerates_committed_samples_byte_identically(
        regenerated, name, i):
    """Trained flagship weights -> the port on the CPU -> the committed
    TPU-generated .mid, byte for byte."""
    got = open(regenerated(name)[i], "rb").read()
    want = open(os.path.join(ROOT, "artifacts",
                             RECIPES[name][-1].format(i)), "rb").read()
    assert got == want, f"{RECIPES[name][-1].format(i)} does not regenerate"


@pytest.mark.parametrize("flags", [
    ["--params", R4],
    ["--seed", "3"],
    ["--params", R4, "--quantize-volume", "--keras2-gates", "--sweep", "0",
     "5", "4"],
], ids=["trained", "fresh", "quantize-hard-sweep"])
def test_cli_writes_parseable_midi(tmp_path, monkeypatch, flags):
    monkeypatch.chdir(tmp_path)
    launches = notegen.note_sample.launches
    paths = cli.generate_main(["--device", "cpu", "--bars", "1"] + flags)
    assert len(paths) == (4 if "--sweep" in flags else 3)
    for p in paths:
        roll = midi_decode(read_midifile(os.path.join(tmp_path, p)))
        assert roll.ndim == 3 and roll.shape[1:] == (128, 3)
    # On the CPU the pitch loop is the plain version: nothing launched.
    assert notegen.note_sample.launches == launches


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    """No card and no explicit CPU request: raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.generate_main(["--bars", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(torch_test_config())
    assert not os.path.exists(tmp_path / "out")
