"""Generation at gen_dtype="bfloat16" (music_generator_tpu_torch/
generation/sampler.py, models/deepj.py, ops/lstm.py, ops/notegen.py)
against the JAX package on the CPU, with weights and inputs drawn from
seeds with numpy (every bias nudged off its initial value, so that the
biases' rounding is exercised):

  (a) `DeepJ.time_axis_step` against the JAX step at compute_dtype
      bfloat16, for the LSTM and the linear time axis, over a few steps;
  (b) the scan flavor of the plain pitch loop against the JAX
      `Sampler._note_scan` (its lax.scan branch) at depths 1-3, both gate
      flavors, quantize on and off;
  (c) the fused flavor against `pallas_note_sample(compute_dtype=
      bfloat16)` in interpret mode, run as tests/test_generation.py runs
      it;
  (d) the flavor the Sampler takes (`gen_flavor`) against the JAX
      Sampler's route condition (sampler.py:119-122), case by case, and
      the flavor the Sampler passes to the pitch loop;
  (e) a 2-bar `Sampler.generate` at G = 3 against the JAX Sampler: each
      stream's first differing draw lies within the edge of its
      probability (the LSTM time axis: the JAX Sampler refuses the linear
      one in bfloat16, which the port generates);
  (f) at the default gen_dtype, the port's notes equal those it drew
      before bfloat16 generation existed, bit for bit (digests taken from
      that tree at test widths, LSTM and linear, both gate flavors).

The bars: draws compared with `draws_agree` at EDGE and VOLUME_ATOL of
2^-6; measured on this CPU, (b) is bit for bit, (c) agrees on every
draw with volumes at most 6.2e-4 apart (an h that rounds to the other
bfloat16 neighbour), (e) writes equal notes; (a) holds values to
STEP_ATOL.  The bfloat16 kernels
run only on the card: chip_smoke.py phase 2 holds them to these plain
versions.
"""

from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data.dataset import compute_genre as jax_genre
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.generation.sampler import _velocity_grid
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.ops.pallas_notegen import pallas_note_sample
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.dataset import compute_genre
from music_generator_tpu_torch.generation import sampler as port_sampler
from music_generator_tpu_torch.generation.sampler import Sampler, gen_flavor
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import notegen
from music_generator_tpu_torch.params import params_from_numpy
from music_generator_tpu_torch.tools.analyze_divergence import forced_draws

torch.set_num_threads(2)

EDGE = 2.0 ** -6
VOLUME_ATOL = 2.0 ** -6
BF16 = torch.bfloat16
G = 3


def _flat(params) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _weights(overrides: dict, seed: int):
    """The JAX config at bfloat16 generation, its Params and the port's
    model from the same arrays, every 1-d leaf (the biases) nudged by
    N(0, 0.2^2) drawn from `seed`."""
    cfg = jax_test_config(gen_dtype="bfloat16", **overrides)
    rng = np.random.default_rng(seed)
    flat = {k: (v + rng.normal(0, 0.2, v.shape).astype(np.float32)
                if v.ndim == 1 else v)
            for k, v in _flat(init_params(jax.random.key(seed), cfg)).items()}
    tmpl = jax.tree_util.tree_flatten_with_path(init_params(
        jax.random.key(0), cfg))
    params = jax.tree_util.tree_unflatten(
        tmpl[1], [jnp.asarray(flat[jax.tree_util.keystr(k)])
                  for k, _ in tmpl[0]])
    port = build_model(port_test_config(gen_dtype="bfloat16", **overrides),
                       "cpu", state=params_from_numpy(flat))
    return cfg, params, port


def _inputs(cfg, seed: int):
    rng = np.random.default_rng(100 + seed)
    feats = rng.uniform(-1, 1, (G, cfg.num_notes, cfg.time_axis_units)
                        ).astype(np.float32)
    us = rng.random((G, cfg.num_notes, 2), dtype=np.float32)
    emb = rng.standard_normal((G, cfg.style_units)).astype(np.float32)
    return feats, us, emb


def _check(want, got, args, flavor):
    """draws_agree at the bars, with the probabilities of `want`'s
    trajectory in the flavor's arithmetic."""
    want = torch.as_tensor(np.array(want))
    probs = notegen.tempered_probs(args[0], want, *args[2:8], BF16, flavor)
    ok, err, report = notegen.draws_agree(want, got, args[1], probs, EDGE,
                                          VOLUME_ATOL)
    assert ok, report
    assert got.shape == want.shape and got.dtype == torch.float32
    return err


def _port_args(port, feats, us, temp, emb, act, quantize):
    vg = (torch.from_numpy(_velocity_grid(port.cfg.max_velocity))
          if quantize else None)
    return (torch.from_numpy(feats), torch.from_numpy(us),
            torch.from_numpy(temp), port.note_axis, port.note_dense,
            port.volume_dense, torch.from_numpy(emb).to(BF16), act, vg)


# -- (a) the time-axis step ------------------------------------------------

# The port keeps each layer's style term float32 (`notegen.style_term`), as
# XLA keeps it where the Sampler's scan hoists it; the JAX step jitted on
# its own rounds it to bfloat16 before the sum.  Measured over the 4 steps:
# at most 1.1e-3 (LSTM) and 3.9e-3 (linear, one bfloat16 ULP of h).
STEP_ATOL = 2.0 ** -7

@pytest.mark.parametrize("kind", ["lstm", "linear"])
def test_time_axis_step_matches_jax(kind):
    cfg, params, port = _weights(dict(time_axis_kind=kind), seed=3)
    jm = JaxDeepJ(cfg.replace(compute_dtype="bfloat16"))
    rng = np.random.default_rng(8)
    styles = rng.random((G, cfg.num_styles), dtype=np.float32)
    jemb = jm.style_embedding(params, jnp.asarray(styles))
    temb = port.style_embedding(torch.from_numpy(styles))
    assert temb.dtype == BF16
    np.testing.assert_array_equal(
        np.asarray(jemb.astype(jnp.float32)), temb.float().numpy())
    jstate, tstate = jm.init_time_state(G), port.init_time_state(G)
    step = jax.jit(jm.time_axis_step)
    for t in range(4):
        notes = (rng.random((G, cfg.num_notes, 3)) < 0.3).astype(np.float32)
        notes[..., 2] *= rng.random((G, cfg.num_notes)).astype(np.float32)
        beat = np.eye(cfg.notes_per_bar, dtype=np.float32)[[t] * G]
        jx, jstate = step(params, jnp.asarray(notes), jnp.asarray(beat),
                          jemb, jstate)
        with torch.no_grad():
            tx, tstate = port.time_axis_step(
                torch.from_numpy(notes), torch.from_numpy(beat), temb,
                tstate)
        # The features and every state tensor keep the JAX step's dtype,
        # and their values lie within STEP_ATOL of its own.
        assert str(tx.dtype).split(".")[-1] == str(jx.dtype)
        pairs = [(jx, tx)] + list(zip(
            jax.tree_util.tree_leaves(jstate),
            [x for layer in tstate for x in layer]))
        for js, ts in pairs:
            assert str(ts.dtype).split(".")[-1] == str(js.dtype)
            np.testing.assert_allclose(np.asarray(js.astype(jnp.float32)),
                                       ts.float().numpy(), rtol=0,
                                       atol=STEP_ATOL)


# -- (b) the scan flavor ---------------------------------------------------

@pytest.mark.parametrize("L, act, quantize, T", [
    (2, "sigmoid", False, 1.0), (2, "hard_sigmoid", True, 0.9),
    (1, "sigmoid", True, 1.2), (3, "hard_sigmoid", False, 1.0)])
def test_scan_flavor_matches_jax_note_scan(L, act, quantize, T):
    cfg, params, port = _weights(dict(
        note_axis_layers=L, lstm_recurrent_activation=act,
        gen_volume_quantize=quantize), seed=L)
    feats, us, emb = _inputs(cfg, L)
    temp = np.full((G,), T, np.float32)
    js = JaxSampler(JaxDeepJ(cfg), params)
    want = js._note_scan(params, jnp.asarray(feats),
                         jnp.asarray(emb).astype(jnp.bfloat16),
                         jnp.asarray(temp), jnp.asarray(us))
    args = _port_args(port, feats, us, temp, emb, act, quantize)
    calls = notegen.note_sample_reference.calls
    got = notegen.note_sample(*args, compute_dtype=BF16, flavor="scan")
    assert notegen.note_sample_reference.calls == calls + 1
    # Measured: 0.0 (bit for bit).
    assert _check(want, got, args, "scan") <= VOLUME_ATOL


# -- (c) the fused flavor --------------------------------------------------

@pytest.mark.parametrize("act, T", [("sigmoid", 1.0), ("hard_sigmoid", 0.9),
                                    ("sigmoid", 1.3)])
def test_fused_flavor_matches_pallas_interpret(act, T):
    cfg, params, port = _weights(dict(lstm_recurrent_activation=act), seed=5)
    feats, us, emb = _inputs(cfg, 5)
    temp = np.full((G,), T, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_note_sample(
            jnp.asarray(feats), jnp.asarray(us), jnp.asarray(temp),
            params.note_axis[0], params.note_axis[1], params.note_dense,
            params.volume_dense, jnp.asarray(emb).astype(jnp.bfloat16),
            compute_dtype=jnp.bfloat16, recurrent_activation=act)
    args = _port_args(port, feats, us, temp, emb, act, False)
    got = notegen.note_sample(*args, compute_dtype=BF16, flavor="fused")
    # Measured: at most 6.2e-4.
    assert _check(want, got, args, "fused") <= VOLUME_ATOL


def test_flavors_differ_in_bfloat16_and_agree_in_float32():
    """The two flavors are two arithmetics in bfloat16 (their heads
    differ) and one in float32 (the same notes)."""
    cfg, params, port = _weights({}, seed=6)
    feats, us, emb = _inputs(cfg, 6)
    temp = np.ones((G,), np.float32)
    args = _port_args(port, feats, us, temp, emb, "sigmoid", False)
    notes = notegen.note_sample(*args, compute_dtype=BF16, flavor="scan")
    scan, fused = (notegen.tempered_probs(args[0], notes, *args[2:8], BF16,
                                          f) for f in ("scan", "fused"))
    assert not torch.equal(scan, fused)
    f32 = args[:6] + (args[6].float(),) + args[7:]
    assert torch.equal(notegen.note_sample(*f32, flavor="scan"),
                       notegen.note_sample(*f32, flavor="fused"))
    with pytest.raises(ValueError, match="flavor"):
        notegen.note_sample(*args, compute_dtype=BF16, flavor="xla")


def test_draws_agree_holds_the_first_differing_draw():
    """A play that flips on a knife edge flips its replay of 1 with it
    (replay is replay * play): only the play draw is held to the edge.  A
    replay that flips alone, or a play far from its edge, fails."""
    u = torch.tensor([[[0.500, 0.08], [0.3, 0.3]]])
    p = torch.tensor([[[0.505, 0.39], [0.9, 0.9]]])
    a = torch.tensor([[[1.0, 1.0, 0.5], [1.0, 0.0, 0.5]]])
    b = torch.tensor([[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    assert notegen.draws_agree(a, b, u, p, edge=0.01)[0]
    assert not notegen.draws_agree(a, b, u, p, edge=0.001)[0]
    replay_only = a.clone()
    replay_only[0, 0, 1] = 0.0
    assert not notegen.draws_agree(a, replay_only, u, p, edge=0.01)[0]
    p_edge = p.clone()
    p_edge[0, 0, 1] = 0.085
    assert notegen.draws_agree(a, replay_only, u, p_edge, edge=0.01)[0]


# -- (d) the route ---------------------------------------------------------

def _jax_takes_pallas(cfg, G_: int, L: int) -> bool:
    """The JAX Sampler's condition (sampler.py:119-122), on this host."""
    return bool(cfg.fused_gen_kernel
                and JaxDeepJ(cfg)._kernel() == "pallas" and L == 2
                and G_ <= cfg.fused_gen_max_batch
                and not cfg.gen_volume_quantize)


@pytest.mark.parametrize("lstm_kernel", ["auto", "pallas", "xla"])
def test_route_matches_the_jax_sampler(lstm_kernel):
    seen = set()
    for fused in (False, True):
        for quantize in (False, True):
            for L in (1, 2, 3):
                for G_ in (1, 4, 8, 9, 64):
                    over = dict(lstm_kernel=lstm_kernel, note_axis_layers=L,
                                fused_gen_kernel=fused,
                                gen_volume_quantize=quantize,
                                fused_gen_max_batch=8)
                    want = _jax_takes_pallas(jax_test_config(**over), G_, L)
                    got = gen_flavor(port_test_config(**over), G_, L)
                    assert got == ("fused" if want else "scan"), (over, G_)
                    seen.add(got)
    assert seen == ({"scan", "fused"} if lstm_kernel == "pallas"
                    else {"scan"})


@pytest.mark.parametrize("G_, flavor", [(2, "fused"), (9, "scan")])
def test_sampler_passes_its_flavor(G_, flavor, monkeypatch):
    over = dict(lstm_kernel="pallas", fused_gen_kernel=True,
                fused_gen_max_batch=8, gen_dtype="bfloat16")
    cfg = port_test_config(**over)
    model = build_model(cfg, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(1))
    seen = []
    real = port_sampler.note_sample

    def spy(*args):
        seen.append(args[9:11])
        return real(*args)
    monkeypatch.setattr(port_sampler, "note_sample", spy)
    Sampler(model).generate([compute_genre(0, cfg)] * G_, num_bars=0)
    Sampler(model).generate([compute_genre(0, cfg)] * G_, num_bars=1,
                            chunk_bars=1)
    assert len(seen) == cfg.notes_per_bar
    assert set(seen) == {(BF16, flavor)}


# -- (e) a whole generation ------------------------------------------------

def test_generate_matches_jax_within_the_edge():
    cfg, params, port = _weights({}, seed=9)
    styles = [jax_genre(i, cfg) for i in range(G)]
    want = JaxSampler(JaxDeepJ(cfg), params).generate(
        styles, num_bars=2, seed=4).notes
    sampler = Sampler(port)
    got = sampler.generate([compute_genre(i, port.cfg) for i in range(G)],
                           num_bars=2, seed=4).notes
    assert got.shape == want.shape
    N = cfg.num_notes
    for g in range(G):
        w, o = want[g].reshape(-1, 3), got[g].reshape(-1, 3)
        diff = np.nonzero((w[:, :2] != o[:, :2]).any(-1))[0]
        stop = int(diff[0]) if len(diff) else len(w)
        assert np.abs(w[:stop, 2] - o[:stop, 2]).max(initial=0.0) \
            <= VOLUME_ATOL
        if stop == len(w):
            continue
        t, n = divmod(stop, N)
        k = int((w[stop, :2] != o[stop, :2]).argmax())
        style = torch.from_numpy(np.stack([styles[g]]))
        with torch.no_grad():
            gaps = [abs(float(u[k] - probs[0, k])) for tt, nn, _, probs, u
                    in forced_draws(sampler.model, sampler, style, want[g],
                                    4, g, t, walk=lambda s: s == t)
                    if nn == n]
        assert gaps and gaps[0] < EDGE, (g, t, n, k, gaps)


def test_linear_time_axis_generates_in_bfloat16():
    """The JAX Sampler cannot run the linear time axis in bfloat16 (its
    scan's carry starts float32 and the GLRU step returns bfloat16, a
    TypeError); the port keeps the step's bfloat16 state and generates."""
    cfg, params, port = _weights(dict(time_axis_kind="linear"), seed=2)
    with pytest.raises(TypeError, match="carry"):
        JaxSampler(JaxDeepJ(cfg), params).generate([jax_genre(0, cfg)],
                                                   num_bars=1)
    res = Sampler(port).generate([compute_genre(i, port.cfg)
                                  for i in range(G)], num_bars=1, seed=2)
    assert res.notes.shape == (G, cfg.notes_per_bar, cfg.num_notes, 3)
    assert np.isfinite(res.notes).all() and res.notes[..., 0].any()


# -- (f) float32 unchanged -------------------------------------------------

# sha256 of the notes [3, 32, 48, 3] of `Sampler.generate` (3 genres, 2
# bars, seed 3, temperatures 1.0, 0.9, 1.2) at test widths from weights
# reset_parameters draws from seed 7, taken on the tree before bfloat16
# generation existed (the same there with compute_dtype bfloat16, which
# generation now does not read).
DIGESTS = {
    ("lstm", "sigmoid"):
        "4332936ccd8bab1f6d2ef991f7c74b5c3ede788ea8f873a188b300d57a4a918d",
    ("lstm", "hard_sigmoid"):
        "59fdbb096e2507c2e4c84955cbefdfd739baa08e13e514fdb28be83bd5394c53",
    ("linear", "sigmoid"):
        "ea6ad49d30cfef4a10e6852e3a2138ea613ac93f4bc467f0774ec15f15733b96",
    ("linear", "hard_sigmoid"):
        "91cd2765136779f20996e0e16466776081cb6ecd808b8eaea17cecee1cd9f545",
}


@pytest.mark.parametrize("kind, act, compute_dtype", [
    ("lstm", "sigmoid", "bfloat16"), ("lstm", "hard_sigmoid", "float32"),
    ("linear", "sigmoid", "float32"), ("linear", "hard_sigmoid", "bfloat16")])
def test_float32_generation_is_unchanged(kind, act, compute_dtype):
    cfg = port_test_config(time_axis_kind=kind, lstm_recurrent_activation=act,
                           gen_volume_quantize=act == "hard_sigmoid",
                           compute_dtype=compute_dtype)
    assert cfg.gen_dtype == "float32"
    model = build_model(cfg, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(7))
    sampler = Sampler(model)
    assert sampler._weights is None
    res = sampler.generate([compute_genre(i, cfg) for i in range(3)],
                           num_bars=2, seed=3, temperature=[1.0, 0.9, 1.2])
    digest = hashlib.sha256(np.ascontiguousarray(res.notes).tobytes())
    assert digest.hexdigest() == DIGESTS[kind, act]
