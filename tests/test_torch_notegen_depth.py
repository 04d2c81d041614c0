"""The pitch loop at note-axis depths other than 2 (music_generator_tpu_torch/
ops/notegen.py, generation/sampler.py, tools/common.py::depth_params):

  * `note_sample_reference` (the CPU branch of `note_sample`) against the
    JAX `Sampler._note_scan`, which at these depths runs its scan of
    `note_axis_cell`, held as tests/test_torch_notegen.py holds depth 2:
    play and replay equal except at a draw whose uniform lies within 1e-5
    of its probability, volumes within atol 1e-5 (float32 sums in another
    order, XLA:CPU's logistic and log against ATen's);
  * `note_sample_staged` (the kernels' association: acc_F up front, z_l =
    (h_{l-1} W_l + a_l) + h_l U_l) against the plain loop, the same way;
  * `notegen_plan(G, L, F, H, N)` at the flagship widths: the cluster
    kernel on 8-block clusters at depths 1-2 and 16-block ones at 3-5,
    the streamed kernel at 6-8, and ValueError where nothing fits;
  * tools/notegen_depth_probe.py stopping where there is no card;
  * `Sampler.generate` at depths 1 and 3 writing the JAX package's bytes
    from the same numpy weights (`depth_params`), at test widths and at the
    flagship widths (artifacts/note_depth_r17, written by the JAX package).
The CUDA kernels run only on the card: chip_smoke.py phase 3l holds them
to this plain version and to each other at every depth.
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.data.dataset import compute_genre as jax_genre
from music_generator_tpu.generation.sampler import Sampler as JaxSampler
from music_generator_tpu.generation.sampler import write_file as jax_write
from music_generator_tpu.models.deepj import DeepJ as JaxDeepJ
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.config import test_config as port_test_config
from music_generator_tpu_torch.data.dataset import compute_genre
from music_generator_tpu_torch.generation.sampler import (Sampler,
                                                          _velocity_grid,
                                                          write_file)
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.ops import notegen
from music_generator_tpu_torch.params import params_from_numpy
from music_generator_tpu_torch.tools.common import depth_params

torch.set_num_threads(2)

EDGE = 1e-5
VOLUME_ATOL = 1e-5
G = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "artifacts", "trained_model_r4", "params.npz")
SAMPLES = os.path.join(ROOT, "artifacts", "note_depth_r17", "samples")


def _flat(params) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _jax_params(flat: dict, cfg):
    """keystr-keyed arrays as the JAX Params pytree of `cfg`."""
    tmpl = jax.tree_util.tree_flatten_with_path(
        init_params(jax.random.key(0), cfg))
    assert len(tmpl[0]) == len(flat)
    return jax.tree_util.tree_unflatten(
        tmpl[1], [jnp.asarray(flat[jax.tree_util.keystr(k)])
                  for k, _ in tmpl[0]])


def _setup(L: int, act: str, quantize: bool, seed: int):
    overrides = dict(note_axis_layers=L, lstm_recurrent_activation=act,
                     gen_volume_quantize=quantize)
    cfg = jax_test_config(**overrides)
    params = init_params(jax.random.key(29 + L), cfg)
    port = build_model(port_test_config(**overrides), "cpu",
                       state=params_from_numpy(_flat(params)))
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1, 1, (G, cfg.num_notes, cfg.time_axis_units)
                        ).astype(np.float32)
    us = rng.random((G, cfg.num_notes, 2), dtype=np.float32)
    emb = rng.standard_normal((G, cfg.style_units), dtype=np.float32)
    return cfg, params, port, feats, us, emb


def _port_args(port, feats, us, temp, emb, act, quantize):
    vg = (torch.from_numpy(_velocity_grid(port.cfg.max_velocity))
          if quantize else None)
    return (torch.from_numpy(feats), torch.from_numpy(us),
            torch.from_numpy(temp), port.note_axis, port.note_dense,
            port.volume_dense, torch.from_numpy(emb), act, vg)


def _check(want, got, args):
    want = torch.as_tensor(np.array(want))
    probs = notegen.tempered_probs(args[0], want, *args[2:8])
    ok, err, report = notegen.draws_agree(want, got, args[1], probs, EDGE,
                                          VOLUME_ATOL)
    assert ok, report
    assert err <= VOLUME_ATOL
    assert got.shape == want.shape and got.dtype == torch.float32


GATES = pytest.mark.parametrize("act, quantize, T", [
    ("sigmoid", False, 1.0), ("hard_sigmoid", True, 0.9)])


@GATES
@pytest.mark.parametrize("L", [1, 3, 4])
def test_reference_matches_jax_note_scan(L, act, quantize, T):
    cfg, params, port, feats, us, emb = _setup(L, act, quantize, seed=L)
    temp = np.full((G,), T, np.float32)
    js = JaxSampler(JaxDeepJ(cfg), params)
    want = js._note_scan(params, jnp.asarray(feats), jnp.asarray(emb),
                         jnp.asarray(temp), jnp.asarray(us))
    args = _port_args(port, feats, us, temp, emb, act, quantize)
    calls = notegen.note_sample_reference.calls
    launches = notegen.note_sample.launches
    got = notegen.note_sample(*args)
    # A CPU tensor takes the plain version; no kernel launch is counted.
    assert notegen.note_sample_reference.calls == calls + 1
    assert notegen.note_sample.launches == launches
    _check(want, got, args)


@GATES
@pytest.mark.parametrize("L", [1, 3])
def test_staged_matches_reference(L, act, quantize, T):
    _, _, port, feats, us, emb = _setup(L, act, quantize, seed=10 + L)
    temp = np.full((G,), T, np.float32)
    args = _port_args(port, feats, us, temp, emb, act, quantize)
    _check(notegen.note_sample_reference(*args),
           notegen.note_sample_staged(*args), args)


# notegen_plan at the flagship widths (F 256, H 128, N 48): (kernel, C,
# Gc) at G = 3 and 64, and the shared memory of a block at G = 64.
PLANS = {
    1: ("cluster", 8, 199168), 2: ("cluster", 8, 231936),
    3: ("cluster", 16, 166016), 4: ("cluster", 16, 198784),
    5: ("cluster", 16, 231552), 6: ("streamed", 0, 9248),
    7: ("streamed", 0, 10272), 8: ("streamed", 0, 11296),
}


@pytest.mark.parametrize("L", sorted(PLANS))
def test_plan_by_depth_at_flagship_widths(L):
    F, H, N = 256, 128, 48
    kernel, C, smem64 = PLANS[L]
    for G_, gc in ((3, 3), (64, 8)):
        p = notegen.notegen_plan(G_, L, F, H, N)
        assert (p.kernel, p.C) == (kernel, C), (G_, p)
        assert p.smem <= notegen.SMEM_MAX
        if kernel == "cluster":
            assert p.Gc == gc and p.clusters == -(-G_ // gc)
            assert p.smem == notegen._smem_bytes(C, gc, L, N, F, H)
        else:
            assert (p.Gc, p.clusters) == (1, G_)
    assert p.smem == smem64
    if kernel == "cluster" and L > 2:
        # No 8-block cluster holds the weights of more than 2 layers.
        assert notegen._smem_bytes(8, 1, L, N, F, H) > notegen.SMEM_MAX


@pytest.mark.parametrize("L, widths", [
    (0, dict(F=256, H=128, N=48)),       # no layer
    (9, dict(F=256, H=128, N=48)),       # past the kernels' 8 layers
    (6, dict(F=256, H=1024, N=48)),      # no cluster serves even 1 layer
    (3, dict(F=258, H=128, N=48)),       # F not a multiple of 4
])
def test_plan_raises_where_nothing_fits(L, widths):
    with pytest.raises(ValueError, match="notegen_plan"):
        notegen.notegen_plan(3, L, widths["F"], widths["H"], widths["N"])


def test_depth_probe_refuses_without_a_card(monkeypatch):
    """tools/notegen_depth_probe.py times the CUDA kernel's depth-2
    instance against its run-time loop: with no card it stops before
    building or timing anything."""
    from music_generator_tpu_torch.tools import notegen_depth_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        notegen_depth_probe.main(["--reps", "1"])


def test_depth_params_keeps_the_checkpoint_and_matches_jax_shapes():
    with np.load(R4) as data:
        r4 = {k: data[k] for k in data.files}
    assert depth_params(r4, 2).keys() == r4.keys()
    for L in (1, 3, 8):
        got = depth_params(r4, L, seed=0)
        cfg = default_config().replace(note_axis_layers=L)
        want = {jax.tree_util.keystr(path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    jax.eval_shape(lambda: init_params(jax.random.key(0),
                                                       cfg)))[0]}
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.shape == want[k] and v.dtype == np.float32, k
            if k in r4:
                assert np.array_equal(v, r4[k]), k
        again = depth_params(r4, L, seed=0)
        assert all(np.array_equal(again[k], v) for k, v in got.items())
    with pytest.raises(ValueError, match="depth_params"):
        depth_params(r4, 9)


def _generate_both(cfg_jax, cfg_port, flat, out):
    """The JAX and the port Sampler from the same arrays: 3 genres, 2
    bars, seed 0, each written by its package's write_file."""
    res = JaxSampler(JaxDeepJ(cfg_jax), _jax_params(flat, cfg_jax)).generate(
        [jax_genre(i, cfg_jax) for i in range(3)], num_bars=2, seed=0)
    want = jax_write("jax", res, cfg_jax.replace(out_dir=str(out)))
    model = build_model(cfg_port, "cpu", state=params_from_numpy(flat))
    res = Sampler(model).generate(
        [compute_genre(i, cfg_port) for i in range(3)], num_bars=2, seed=0)
    got = write_file("port", res, cfg_port.replace(out_dir=str(out)))
    return want, got


@pytest.mark.parametrize("L", [1, 3])
def test_generate_matches_jax_bytes(L, tmp_path):
    """Test widths: a depth-2 test checkpoint rebuilt by depth_params."""
    flat = depth_params(_flat(init_params(jax.random.key(41),
                                          jax_test_config())), L, seed=1)
    want, got = _generate_both(jax_test_config(note_axis_layers=L),
                               port_test_config(note_axis_layers=L), flat,
                               tmp_path)
    assert len(got) == 3
    for a, b in zip(want, got):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.mark.parametrize("L", [1, 3])
def test_generate_writes_the_committed_jax_samples(L, tmp_path):
    """Flagship widths, the r4 checkpoint rebuilt for depth L: the port's
    CPU generation writes artifacts/note_depth_r17's bytes."""
    with np.load(R4) as data:
        flat = depth_params({k: data[k] for k in data.files}, L, seed=0)
    cfg = default_config().replace(note_axis_layers=L,
                                   out_dir=str(tmp_path))
    model = build_model(cfg, "cpu", state=params_from_numpy(flat))
    res = Sampler(model).generate([compute_genre(i, cfg) for i in range(3)],
                                  num_bars=2, seed=0)
    for i, p in enumerate(write_file(f"depth{L}", res, cfg)):
        assert filecmp.cmp(p, os.path.join(SAMPLES, f"depth{L}_{i}.mid"),
                           shallow=False), p
