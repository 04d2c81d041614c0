"""Primed continuation and the stream surface of the port's Sampler
(music_generator_tpu_torch: `generate(prime=, pad_to=, pad_partial_chunk=,
seeds=, stream_indices=)`, `begin` / `ActiveGeneration`, `prepend_prime`,
`data.dataset.decode_prime`, `generate --prime`) on the CPU.

Each contract of the JAX package's tests/test_generation.py is a case
here, held at test_config dims against the JAX `Sampler` on the same
weights: play and replay exactly, volumes within atol 1e-5, and the .mid
bytes equal.  At flagship dims the committed TPU demos
artifacts/primed_demos_r4/primed_*.mid regenerate from their own first 8
bars, byte for byte.
"""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data.dataset import (
    decode_prime as jax_decode_prime)
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.generation.sampler import (
    prepend_prime as jax_prepend_prime)
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu_torch import cli
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.data.dataset import (compute_genre,
                                                    decode_prime,
                                                    unclamp_midi)
from music_generator_tpu_torch.generation.sampler import (Sampler,
                                                          prepend_prime)
from music_generator_tpu_torch.midi import midi_encode, write_midifile
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.params import (load_params_npz,
                                              params_from_numpy)
from music_generator_tpu_torch.utils import one_hot

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = os.path.join(ROOT, "artifacts", "primed_demos_r4")
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


def _mid_bytes(roll, cfg):
    buf = io.BytesIO()
    write_midifile(buf, midi_encode(unclamp_midi(np.asarray(roll), cfg),
                                    config=cfg))
    return buf.getvalue()


def _same(want, got, cfg=None):
    """Notes as the JAX package's: play and replay exactly, volumes within
    VOLUME_ATOL, and (given cfg) each stream's .mid bytes."""
    assert want.shape == got.shape
    np.testing.assert_array_equal(want[..., :2], got[..., :2])
    np.testing.assert_allclose(want[..., 2], got[..., 2], rtol=0,
                               atol=VOLUME_ATOL)
    if cfg is not None:
        for w, g in zip(want, got):
            assert _mid_bytes(w, cfg) == _mid_bytes(g, cfg)


# name -> (genres, bars of the full run, seed, prime length in steps as a
# function of notes_per_bar, per-stream prime, continuation bars).
PRIMES = {
    # test_generation.py:252, the model's own first 2 bars.
    "self_consistency": ((0,), 4, 11, lambda b: 2 * b, False, 2),
    # :265, a prime that ends mid-bar, one per stream.
    "non_bar_aligned_per_stream": ((0, 1), 4, 13, lambda b: b + 3, True, 2),
    # :278, 8 bars + 1 bar + 3 steps (the JAX package's three chunkings).
    "big_bar_tail": ((1,), 11, 23, lambda b: 9 * b + 3, False, 1),
}


@pytest.mark.parametrize("name", list(PRIMES))
def test_prime_continues_the_run_and_matches_jax(samplers, name):
    """Priming with a run's own first K steps reproduces the rest of it
    exactly, and the port's primed continuation equals the JAX one."""
    js, ps, cfg = samplers
    genres, bars, seed, k, per_stream, cont_bars = PRIMES[name]
    styles = [compute_genre(g, cfg) for g in genres]
    full = ps.generate(styles, num_bars=bars, seed=seed)
    _same(js.generate(styles, num_bars=bars, seed=seed).notes, full.notes)
    K = k(cfg.notes_per_bar)
    T = cont_bars * cfg.notes_per_bar
    prime = full.notes[:, :K] if per_stream else full.notes[0, :K]
    cont = ps.generate(styles, num_bars=cont_bars, seed=seed, prime=prime)
    np.testing.assert_array_equal(cont.notes, full.notes[:, K:K + T])
    want = js.generate(styles, num_bars=cont_bars, seed=seed, prime=prime)
    _same(want.notes, cont.notes, cfg)


def test_prime_padding_invariance(samplers):
    """test_generation.py:293: bucket padding does not change primed
    notes.  Between batch sizes the port's float32 sums may take another
    order (as for any batch: tests/test_torch_generate.py), so volumes are
    held within VOLUME_ATOL and the .mid bytes must be equal."""
    js, ps, cfg = samplers
    styles = [compute_genre(0, cfg)]
    full = ps.generate(styles, num_bars=3, seed=17)
    K = cfg.notes_per_bar
    a = ps.generate(styles, num_bars=2, seed=17, prime=full.notes[0, :K])
    b = ps.generate(styles, num_bars=2, seed=17, prime=full.notes[0, :K],
                    pad_to=4)
    _same(a.notes, b.notes, cfg)
    np.testing.assert_array_equal(a.notes[0], full.notes[0, K:])
    want = js.generate(styles, num_bars=2, seed=17, prime=full.notes[0, :K],
                       pad_to=4)
    _same(want.notes, b.notes, cfg)


@pytest.mark.parametrize("n_styles,n_primes,pad_to", [
    (1, 4, None),     # test_generation.py:327
    (3, 6, 8),        # :334, padding would make room
    (3, 2, None),     # :334, too few
])
def test_prime_stream_count_rejected(samplers, n_styles, n_primes, pad_to):
    js, ps, cfg = samplers
    styles = [compute_genre(i % 3, cfg) for i in range(n_styles)]
    bad = np.zeros((n_primes, cfg.notes_per_bar, cfg.num_notes, 3),
                   np.float32)
    for s in (js, ps):
        with pytest.raises(ValueError, match="streams but"):
            s.generate(styles, num_bars=1, seed=0, prime=bad, pad_to=pad_to)


def test_per_stream_triples_match_solo_runs(samplers):
    """test_generation.py:213: per-stream (seed, index, temperature)
    triples give each stream its solo run's notes, also cut to a shorter
    length; the batch equals the JAX one."""
    js, ps, cfg = samplers
    styles = [compute_genre(i % 3, cfg) for i in range(3)]
    seeds, temps = [5, 9, 5], [1.0, 0.8, 1.3]
    kw = dict(num_bars=2, seeds=seeds, stream_indices=[0, 0, 0],
              temperature=temps, pad_to=4, pad_partial_chunk=True)
    co = ps.generate(styles, **kw)
    _same(js.generate(styles, **kw).notes, co.notes, cfg)
    spb = cfg.notes_per_bar
    for i in range(3):
        solo = ps.generate([styles[i]], num_bars=2, seed=seeds[i],
                           temperature=temps[i])
        _same(solo.notes, co.notes[i:i + 1], cfg)
        short = ps.generate([styles[i]], num_bars=1, seed=seeds[i],
                            temperature=temps[i])
        _same(short.notes, co.notes[i:i + 1, :spb], cfg)
    assert not np.array_equal(co.notes[0], co.notes[2])


@pytest.mark.parametrize("kw,match", [
    (dict(seeds=[1]), "seeds"),
    (dict(seeds=[1, 2 ** 32]), "seeds"),
    (dict(stream_indices=[0, -1]), "stream_indices"),
    (dict(temperature=[1.0]), "temperature"),
    (dict(seed=-1), "seed"),
    (dict(num_bars=-1), "num_bars"),
])
def test_per_stream_validation(samplers, kw, match):
    """test_generation.py:240,356,542: both samplers reject the same
    calls with the same message."""
    js, ps, cfg = samplers
    styles = [compute_genre(0, cfg), compute_genre(1, cfg)]
    kw = dict(dict(num_bars=1), **kw)
    for s in (js, ps):
        with pytest.raises(ValueError, match=match):
            s.generate(styles, **kw)


def test_pad_partial_chunk_is_identical(samplers):
    """test_generation.py:500: running the last chunk at full length and
    slicing gives the same notes, with and without a prime that leaves a
    mid-chunk tail; equal to the JAX runs."""
    js, ps, cfg = samplers
    styles = [compute_genre(0, cfg), compute_genre(1, cfg)]
    exact = ps.generate(styles, num_bars=3, seed=5, chunk_bars=2)
    padded = ps.generate(styles, num_bars=3, seed=5, chunk_bars=2,
                         pad_partial_chunk=True)
    np.testing.assert_array_equal(exact.notes, padded.notes)
    prime = exact.notes[:, :cfg.notes_per_bar // 2]
    e2 = ps.generate(styles, num_bars=1, seed=5, chunk_bars=2, prime=prime)
    p2 = ps.generate(styles, num_bars=1, seed=5, chunk_bars=2, prime=prime,
                     pad_partial_chunk=True)
    np.testing.assert_array_equal(e2.notes, p2.notes)
    _same(js.generate(styles, num_bars=1, seed=5, chunk_bars=2, prime=prime,
                      pad_partial_chunk=True).notes, p2.notes, cfg)


def test_begin_advance_matches_generate(samplers):
    """test_generation.py:520: chunks driven through begin/advance, grouped
    1 + 2, equal one generate() call and the JAX incremental run."""
    js, ps, cfg = samplers
    styles = [compute_genre(0, cfg), compute_genre(2, cfg)]
    spb = cfg.notes_per_bar
    kw = dict(temperature=[1.0, 0.8], seeds=[11, 12], stream_indices=[3, 7])
    whole = ps.generate(styles, num_bars=6, seed=11, chunk_bars=2,
                        pad_partial_chunk=True, **kw)
    gen = ps.begin(styles, chunk_bars=2, **kw)
    part1, part2 = gen.advance(1), gen.advance(2)
    assert part1.shape[1] == 2 * spb and part2.shape[1] == 4 * spb
    got = np.concatenate([part1, part2], axis=1)
    np.testing.assert_array_equal(got, whole.notes)
    jgen = js.begin(styles, chunk_bars=2, **kw)
    _same(jgen.advance(3), got, cfg)
    gen.close()
    assert gen._state is None


def test_prepend_prime_shared_and_per_stream():
    """test_generation.py:557, against the JAX function."""
    cfg = torch_test_config()
    notes = np.random.default_rng(0).random((3, 4, cfg.num_notes, 3),
                                            dtype=np.float32)
    shared = np.ones((2, cfg.num_notes, 3), np.float32)
    per_stream = np.stack([shared * (i + 1) for i in range(3)])
    for prime in (shared, per_stream):
        full = prepend_prime(notes, prime)
        assert full.shape == (3, 6, cfg.num_notes, 3)
        np.testing.assert_array_equal(full, jax_prepend_prime(notes, prime))
    np.testing.assert_array_equal(prepend_prime(notes, per_stream)[2, :2],
                                  3.0)


def test_decode_prime_matches_jax_and_rejects_bad_input(tmp_path):
    """decode_prime equals the JAX package's on a real file (whole, and cut
    to K bars), and raises its ValueErrors: not a MIDI file, negative
    prime_bars, a prime over max_bars."""
    cfg = default_config()
    from music_generator_tpu.config import default_config as jax_default
    path = os.path.join(DEMOS, "primed_Classical.mid")
    for bars in (None, 3):
        np.testing.assert_array_equal(
            decode_prime(path, bars, config=cfg),
            jax_decode_prime(path, bars, config=jax_default()))
    assert decode_prime(path, 3, config=cfg).shape == (
        3 * cfg.notes_per_bar, cfg.num_notes, 3)
    junk = tmp_path / "junk.mid"
    junk.write_bytes(b"not a midi file")
    with pytest.raises(ValueError, match="not a valid MIDI file"):
        decode_prime(str(junk), config=cfg)
    with pytest.raises(ValueError, match="prime_bars must be >= 0"):
        decode_prime(path, -1, config=cfg)
    with pytest.raises(ValueError, match="prime too long"):
        decode_prime(path, max_bars=2, config=cfg)


R4 = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")


@pytest.fixture(scope="module")
def jax_flagship():
    """The JAX Sampler at flagship dims on the trained r4 weights."""
    from music_generator_tpu.config import default_config as jax_default
    cfg = jax_default()
    model = JaxDeepJ(cfg)
    template = init_params(jax.random.key(0), cfg)
    leaves, tree = jax.tree_util.tree_flatten_with_path(template)
    with np.load(R4) as data:
        params = jax.tree_util.tree_unflatten(
            tree, [data[jax.tree_util.keystr(k)] for k, _ in leaves])
    return JaxSampler(model, params), cfg


@pytest.mark.parametrize("continuation_only", [False, True],
                         ids=["whole-piece", "continuation-only"])
def test_cli_prime_writes_the_jax_files(tmp_path, monkeypatch, jax_flagship,
                                        continuation_only):
    """generate --prime FILE --prime-bars 2 --bars 1 on the trained r4
    weights: the three genre streams continue the prime, and each written
    .mid equals the JAX Sampler's piece byte for byte (prime + continuation,
    or the continuation alone)."""
    js, jcfg = jax_flagship
    monkeypatch.chdir(tmp_path)
    prime_file = os.path.join(DEMOS, "primed_Romantic.mid")
    flags = ["--device", "cpu", "--params", R4, "--bars", "1", "--prime",
             prime_file, "--prime-bars", "2"]
    paths = cli.generate_main(
        flags + (["--continuation-only"] if continuation_only else []))
    assert len(paths) == 3
    prime = jax_decode_prime(prime_file, 2, config=jcfg).astype(np.float32)
    want = js.generate([compute_genre(i, jcfg) for i in range(3)],
                       num_bars=1, seed=0, prime=prime).notes
    if not continuation_only:
        want = jax_prepend_prime(want, prime)
    cfg = default_config()
    for i, p in enumerate(paths):
        got = open(os.path.join(tmp_path, p), "rb").read()
        assert got == _mid_bytes(want[i], cfg), p
        head = decode_prime(io.BytesIO(got), 2, config=cfg)
        assert np.array_equal(head[..., :2], prime[..., :2]) != (
            continuation_only), p


@pytest.mark.parametrize("genre", ["Baroque", "Classical", "Romantic"])
def test_committed_primed_demos_regenerate(genre):
    """artifacts/primed_demos_r4/primed_<genre>.mid, as its provenance.json
    records it (real_corpus_r3 weights, style slot, seed 0, T 0.75, 8 + 8
    bars): its own first 8 bars as the prime regenerate the whole file,
    byte for byte, on the port's CPU path."""
    rec = json.load(open(os.path.join(DEMOS, "provenance.json")))[
        "files"][genre]
    cfg = default_config()
    path = os.path.join(DEMOS, f"primed_{genre}.mid")
    prime = decode_prime(path, rec["prime_bars"], config=cfg).astype(
        np.float32)
    model = build_model(cfg, "cpu", state=load_params_npz(
        os.path.join(ROOT, rec["params"])))
    res = Sampler(model).generate(
        [one_hot(rec["style_slot"], cfg.num_styles)],
        num_bars=rec["continuation_bars"], seed=rec["seed"],
        temperature=rec["temperature"], prime=prime)
    got = _mid_bytes(prepend_prime(res.notes, prime)[0], cfg)
    assert got == open(path, "rb").read()
