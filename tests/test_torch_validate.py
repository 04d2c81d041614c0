"""The port's on-card validators (music_generator_tpu_torch/tools/
validate_lstm2.py and validate_biax.py) on the CPU, at small sizes.

  * validate_lstm2's checks 1-2 run at T = 4, B = 16, D = 10, H = 8 and
    meet their bars; the plain rebuild they hold the stack to (two layers
    of the plain recurrence, layer 1 reading hs0 * masks + s1m) equals the
    JAX validator's rebuild in plain JAX (`lstm_scan(kernel="xla")`) fed
    the port's masks as numpy: forward atol 1e-5, gradients atol 1e-4.
    The JAX `extract_masks` itself cannot run here (the Pallas
    interpreter's TPU PRNG is a stub, tests/test_pallas_lstm2.py), so the
    masks come from the port's `dump_masks`.
  * validate_biax runs at test_config() dims on both gate flavors and
    passes its own bars; its TPU readings are the committed r5 logs.
On the CPU every wrapper runs its plain version; the kernels are held to
these checks on the card (chip_smoke.py phase 3g).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generator_tpu.ops.lstm import LSTMParams
from music_generator_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from music_generator_tpu_torch.config import test_config as small_config
from music_generator_tpu_torch.ops import lstm2
from music_generator_tpu_torch.tools import validate_biax, validate_lstm2
from music_generator_tpu_torch.tools.common import CheckFailed

torch.set_num_threads(2)

SMALL = dict(T=4, B=16, D=10, H=8)


def test_validate_lstm2_checks_pass_small():
    r = validate_lstm2.check(**SMALL, device="cpu")
    assert r["p0_fwd"] <= 1e-4 and r["p05_fwd"] <= 1e-4
    assert r["p0_grad_rel"] <= 1e-3 and r["p05_grad_rel"] <= 1e-3
    assert 0.3 < r["keep_fraction"] < 0.7


def test_validate_lstm2_main_on_the_cpu(capsys):
    """The module's entry point at the JAX tool's sizes, --device cpu."""
    validate_lstm2.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "mask keep fraction" in out and "ALL CHECKS PASSED" in out
    assert "timing: on the card only" in out


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_rebuild_matches_the_jax_validators_rebuild(p):
    T, B, D, H = SMALL["T"], SMALL["B"], SMALL["D"], SMALL["H"]
    ws, xs, s1m = validate_lstm2.inputs(T, B, D, H, "cpu")
    masks = lstm2.dump_masks(validate_lstm2.SEED, T, B, H, p)
    got, got_g = validate_lstm2.forward_and_grads(
        lambda w: validate_lstm2.plain_stack(w, xs, s1m, masks), ws)

    n = lambda t: jnp.asarray(t.numpy())
    p0 = LSTMParams(n(ws[0]), n(ws[1]), n(ws[2]))
    p1 = LSTMParams(n(ws[3]), n(ws[4]), n(ws[5]))
    jm = None if masks is None else n(masks)

    def ref_out(p0, p1):
        hs0, _ = jax_lstm_scan(p0, n(xs), kernel="xla")
        x1 = hs0 + n(s1m) if jm is None else hs0 * jm + n(s1m)
        hs1, _ = jax_lstm_scan(p1, x1, kernel="xla")
        return hs1

    want = ref_out(p0, p1)
    g0, g1 = jax.grad(lambda a, b: jnp.sum(ref_out(a, b)[:2, :4, :16] ** 2),
                      argnums=(0, 1))(p0, p1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for g, w in zip(got_g, (g0.kernel, g0.recurrent, g1.kernel,
                            g1.recurrent)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("gates", ["sigmoid", "hard_sigmoid"])
def test_validate_biax_passes_its_bars_at_test_dims(gates, monkeypatch,
                                                    capsys):
    """main() with default_config() cut to test_config() dims."""
    monkeypatch.setattr(validate_biax, "default_config", small_config)
    r = validate_biax.main(["--gates", gates, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ALL CHECKS PASSED" in out and "(TPU r5: " in out
    # On the CPU the "fused" variants are the plain stacks themselves.
    assert r["loss_rel_fused_vs_plain_bf16"] == 0.0 and r["gap"] == 0.0
    assert r["worst_cos"] > 0.98 and r["parity_cos"] >= 0.999


def test_tpu_r5_readings_are_the_committed_logs():
    assert validate_biax.tpu_r5_parity("sigmoid") == (2.102e-4, 0.99944,
                                                      1.48e-4)
    assert validate_biax.tpu_r5_parity("hard_sigmoid") == (2.959e-4,
                                                           0.99941, 2.39e-4)


# (f32 loss rel, f32 grad rel, param err, bf16 loss rel, bf16 cos, gap,
#  bf16 plain loss rel, bf16 plain cos) -> passes
@pytest.mark.parametrize("readings,ok", [
    ((0, 0, 0, 2e-4, 0.9999, 1e-4, 1e-4, 0.9999), True),
    ((0, 0, 0, 6e-4, 0.9999, 1e-4, 6e-4, 0.9999), True),    # plain misses
    ((0, 0, 0, 6e-4, 0.9999, 1e-4, 1e-4, 0.9999), False),   # plain meets
    ((0, 0, 0, 6e-4, 0.9999, 9e-4, 6e-4, 0.9999), False),   # gap too big
    ((2e-5, 0, 0, 2e-4, 0.9999, 1e-4, 1e-4, 0.9999), False),
    ((0, 2e-3, 0, 2e-4, 0.9999, 1e-4, 1e-4, 0.9999), False),
    ((0, 0, 2e-4, 2e-4, 0.9999, 1e-4, 1e-4, 0.9999), False),
])
def test_step_bars(readings, ok):
    """PARITY_BAR, or the bfloat16 plain step where the bfloat16 plain
    path misses the bar too; the float32 readings always."""
    if ok:
        validate_biax.step_bars(readings, "case", log=lambda *a: None)
    else:
        with pytest.raises(CheckFailed):
            validate_biax.step_bars(readings, "case", log=lambda *a: None)


def test_bf16_against_plain_at_test_dims():
    """bf16_against_plain on the linear kind at test_config() dims: on the
    CPU the kernels are the plain stacks, so the bfloat16 step agrees with
    itself exactly and the post-update gap splits into two zero parts."""
    from music_generator_tpu_torch.data.synth import random_batch
    from music_generator_tpu_torch.models.deepj import build_model
    cfg = small_config(time_axis_kind="linear")
    batch = tuple(torch.from_numpy(a)
                  for a in random_batch(cfg, seed=0, rolled_targets=True))
    state = build_model(cfg, "cpu", seed=1).state_dict()
    runs = validate_biax.steps(cfg, state, batch, "sigmoid")
    lines = []
    loss, cos, flips, evaluation, update = validate_biax.bf16_against_plain(
        cfg, batch, "sigmoid", runs, log=lines.append)
    assert (loss, flips, evaluation, update) == (0.0, 0.0, 0.0, 0.0)
    assert cos == pytest.approx(1.0, abs=1e-12)     # a @ a / |a|^2
    assert lines[0].startswith("  sigmoid bfloat16 kernels vs bfloat16 "
                               "plain: loss rel diff 0, worst-leaf "
                               "gradient cosine 1.000000")
