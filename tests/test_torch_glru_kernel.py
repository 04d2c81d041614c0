"""The linear time axis's fused kernels (`csrc/glru_scan.cu`,
ops/linear_scan.py) and their plain version `glru_scan_fused_reference`.

On the CPU, at test_config() dims:

  * at float32 the plain version is `glru_scan_sequential` bit for bit
    (forward), and its hand-written backward agrees with autograd through
    the sequential loop;
  * at bfloat16 its outputs and gradients stay within stated tolerances of
    the float32 sequential result, and the tree (`glru_scan` on the CPU,
    state rounded to bfloat16 at every combine) misses them;
  * the CPU route of `glru_scan` is still the tree: no kernel, no plain
    version, the spans of the tree;
  * the launch plan, and the wrappers refusing CPU tensors.

Marked `card` (they skip without one; on a machine with a card, where the
JAX package is not installed: `python -m pytest
tests/test_torch_glru_kernel.py --noconftest -m card`): the kernels held to
the plain version forward and backward at float32 and bfloat16, at T 128
and an odd T; a DeepJ training step of the linear kind launching them once
a layer a direction; and tensors the kernels do not take, which raise."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from music_generator_tpu_torch.config import test_config as small_config
from music_generator_tpu_torch.ops import linear_scan
from music_generator_tpu_torch.ops.linear_scan import (
    GLRUParams, glru_bwd, glru_bwd_reference, glru_fwd, glru_fwd_reference,
    glru_scan, glru_scan_fused_reference, glru_scan_sequential, launch_plan)
from music_generator_tpu_torch.utils import spans

torch.set_num_threads(2)

CFG = small_config(time_axis_kind="linear")
H = CFG.time_axis_units
B = CFG.batch_size * CFG.num_notes
D = 24          # a layer's input width

# Relative norm errors ||got - want|| / ||want|| at bfloat16 against the
# float32 sequential result, T 128, B 96 rows of H 16 units from a width of
# 24.  The floor of any bfloat16 route is the product P = xs W rounded to
# bfloat16 (2^-9 relative an element of the pre-activations), which the
# gates carry into every h and gradient: the float32-state plain version
# reads hs 3.62e-3, dxs 5.19e-3, dW 5.14e-3, db 3.73e-3 here.  Keeping the
# state in bfloat16 (the tree) adds the rounding of a, b and every combine,
# which compounds along the gates' memory: 5.19e-3, 7.39e-3, 6.97e-3,
# 5.05e-3.  Each limit lies between the two readings.
BF16_REL = {"hs": 4.4e-3, "dxs": 6.3e-3, "dW": 6.0e-3, "db": 4.4e-3}


def _glru(seed: int, d_in: int = D, hidden: int = H) -> GLRUParams:
    rng = np.random.default_rng(seed)
    p = GLRUParams(d_in, hidden)
    with torch.no_grad():
        p.kernel.copy_(torch.from_numpy(
            rng.uniform(-0.6, 0.6, (d_in, 2 * hidden)).astype(np.float32)))
        p.bias.copy_(torch.from_numpy(
            rng.uniform(-0.1, 0.1, 2 * hidden).astype(np.float32)))
    return p


def _inputs(seed: int, T: int, rows: int = B, d_in: int = D,
            hidden: int = H):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, rows, d_in)).astype(np.float32)
    cot = rng.standard_normal((T, rows, hidden)).astype(np.float32)
    return torch.from_numpy(xs), torch.from_numpy(cot)


def _run(fn, p, xs, cot, dtype):
    """hs (float32) and the gradients of sum(hs * cot) by xs, W, b."""
    p.zero_grad()
    x = xs.clone().requires_grad_(True)
    hs = fn(p, x, dtype)
    assert hs.dtype == dtype
    (hs.float() * cot).sum().backward()
    return {"hs": hs.detach().float(), "dxs": x.grad,
            "dW": p.kernel.grad.clone(), "db": p.bias.grad.clone()}


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("T", [128, 33])
def test_plain_version_is_sequential_at_float32(T):
    p = _glru(0)
    xs, cot = _inputs(1, T)
    seq = _run(glru_scan_sequential, p, xs, cot, torch.float32)
    got = _run(glru_scan_fused_reference, p, xs, cot, torch.float32)
    assert torch.equal(got["hs"], seq["hs"])
    # The hand-written backward against autograd through the loop: the
    # same float32 terms, summed in another order.
    for k in ("dxs", "dW", "db"):
        assert _rel(got[k], seq[k]) < 1e-6, k


def test_plain_version_at_bfloat16_within_tolerances():
    p = _glru(0)
    xs, cot = _inputs(1, 128)
    want = _run(glru_scan_sequential, p, xs, cot, torch.float32)
    got = _run(glru_scan_fused_reference, p, xs, cot, torch.bfloat16)
    for k, limit in BF16_REL.items():
        assert _rel(got[k], want[k]) <= limit, (k, _rel(got[k], want[k]))


def test_bfloat16_state_misses_the_tolerances():
    """The tree in bfloat16 (the CPU route, JAX's arithmetic) on the same
    inputs: every reading above its limit."""
    p = _glru(0)
    xs, cot = _inputs(1, 128)
    want = _run(glru_scan_sequential, p, xs, cot, torch.float32)
    tree = _run(glru_scan, p, xs, cot, torch.bfloat16)
    missed = {k: _rel(tree[k], want[k]) for k, limit in BF16_REL.items()
              if _rel(tree[k], want[k]) > limit}
    assert set(missed) == set(BF16_REL), missed


def test_cpu_route_is_the_tree(monkeypatch):
    """glru_scan on CPU tensors: the gates and associative_scan, spans
    `linear_scan.tree` and its backward; no kernel launch and no call of
    the plain version of the kernels."""
    calls = []
    tree = linear_scan.associative_scan
    monkeypatch.setattr(linear_scan, "associative_scan",
                        lambda a, b: calls.append(a.shape) or tree(a, b))
    p = _glru(2)
    xs, _ = _inputs(3, 33)
    counts = (glru_scan.fwd_launches, glru_scan.bwd_launches,
              glru_scan_fused_reference.calls)
    with spans.recording() as rec:
        hs = glru_scan(p, xs, torch.float32)
        hs.sum().backward()
    a, b = linear_scan.glru_gates(p, xs, torch.float32)
    assert torch.equal(hs, tree(a, b)[1])
    assert calls[0] == a.shape
    assert [s.name for s in rec.spans] == ["linear_scan.tree",
                                           "linear_scan.tree.bwd"]
    assert (glru_scan.fwd_launches, glru_scan.bwd_launches,
            glru_scan_fused_reference.calls) == counts


def test_plain_version_backward_opens_its_span():
    p = _glru(4)
    xs, _ = _inputs(5, 9)
    with spans.recording() as rec:
        glru_scan_fused_reference(p, xs).sum().backward()
    assert [s.name for s in rec.spans] == ["linear_scan.tree.bwd"]


@pytest.mark.parametrize("R, hidden, dtype, want", [
    (3072, 256, torch.bfloat16, (32, 8, 384)),    # the cells' shape
    (3072, 256, torch.float32, (32, 8, 384)),
    (100, 16, torch.bfloat16, (2, 128, 1)),
    (300, 64, torch.float32, (16, 16, 19)),
])
def test_launch_plan(R, hidden, dtype, want):
    assert launch_plan(R, hidden, dtype) == want
    bx, by, _ = want
    assert bx * by <= linear_scan.THREADS


@pytest.mark.parametrize("hidden, dtype", [(12, torch.bfloat16),
                                           (6, torch.float32)])
def test_launch_plan_refuses_ragged_units(hidden, dtype):
    with pytest.raises(ValueError, match="multiple of"):
        launch_plan(8, hidden, dtype)


def test_kernels_refuse_cpu_tensors():
    P = torch.zeros(4, 8, 2 * H)
    bias = torch.zeros(2 * H)
    hs = torch.zeros(4, 8, H)
    with pytest.raises(ValueError, match="CUDA tensors"):
        glru_fwd(P, bias)
    with pytest.raises(ValueError, match="CUDA tensors"):
        glru_bwd(P, bias, hs, hs)


# -- the card ----------------------------------------------------------------


@pytest.fixture
def card():
    """The card; the test skips when there is none (decided here, when the
    test runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_operands(seed, S, R, hidden, dtype, dev):
    gen = torch.Generator().manual_seed(seed)
    P = (torch.randn(S, R, 2 * hidden, generator=gen) * 1.5).to(dtype)
    bias = torch.randn(2 * hidden, generator=gen) * 0.3
    dhs = torch.randn(S, R, hidden, generator=gen).to(dtype)
    return P.to(dev), bias.to(dev), dhs.to(dev)


CARD_SHAPES = [(128, 100, 16), (33, 300, 64), (128, 200, 256)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S, R, hidden", CARD_SHAPES)
def test_kernels_match_the_plain_version(S, R, hidden, dtype, card):
    """Forward and backward against the plain version on the same card:
    hs and dP equal bit for bit (the same float32 operations in the same
    order, each rounded once); db within 1e-5 relative (a float32 sum of
    S R terms a unit, taken in blocks of rows)."""
    P, bias, dhs = _card_operands(S + hidden, S, R, hidden, dtype, card)
    before = (glru_scan.fwd_launches, glru_scan.bwd_launches)
    hs = glru_fwd(P, bias)
    dP, db = glru_bwd(P, bias, hs, dhs)
    torch.cuda.synchronize()
    assert (glru_scan.fwd_launches, glru_scan.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want_hs = glru_fwd_reference(P, bias)
    want_dP, want_db = glru_bwd_reference(P, bias, want_hs, dhs)
    assert hs.dtype == dP.dtype == dtype and db.dtype == torch.float32
    assert torch.equal(hs, want_hs), (hs.float() - want_hs.float()).abs().max()
    assert torch.equal(dP, want_dP), (dP.float() - want_dP.float()).abs().max()
    assert _rel(db, want_db) <= 1e-5
    again = glru_bwd(P, bias, hs, dhs)
    assert torch.equal(again[0], dP) and torch.equal(again[1], db)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_glru_scan_on_the_card_is_the_plain_version(dtype, card):
    """glru_scan on CUDA tensors through autograd against
    glru_scan_fused_reference on the same card: hs equal, the gradients of
    xs, W and b within 1e-5 relative (db's sum order; dxs and dW are the
    same cuBLAS products of equal dP, but P's dtype rounds them)."""
    p = _glru(6, hidden=32).to(card)
    xs, cot = _inputs(7, 33, hidden=32)
    xs, cot = xs.to(card), cot.to(card)
    got = _run(glru_scan, p, xs, cot, dtype)
    want = _run(glru_scan_fused_reference, p, xs, cot, dtype)
    assert torch.equal(got["hs"], want["hs"])
    for k in ("dxs", "dW", "db"):
        assert _rel(got[k], want[k]) <= 1e-5, k


@pytest.mark.card
def test_training_step_launches_once_a_layer(card):
    from music_generator_tpu_torch.data.synth import random_batch
    from music_generator_tpu_torch.models.deepj import build_model
    from music_generator_tpu_torch.parallel.train_step import (
        create_train_state, train_step)
    cfg = small_config(time_axis_kind="linear", compute_dtype="bfloat16")
    state = create_train_state(
        build_model(cfg, card, seed=0, trainable=True), seed=0)
    batch = tuple(torch.from_numpy(a).to(card)
                  for a in random_batch(cfg, seed=0, rolled_targets=True))
    before = (glru_scan.fwd_launches, glru_scan.bwd_launches,
              glru_scan_fused_reference.calls)
    loss = train_step(state, batch)["loss"]
    assert torch.isfinite(loss)
    L = cfg.time_axis_layers
    assert (glru_scan.fwd_launches, glru_scan.bwd_launches,
            glru_scan_fused_reference.calls) == (before[0] + L,
                                                 before[1] + L, before[2])


@pytest.mark.card
def test_kernels_refuse_what_they_do_not_take(card):
    P, bias, dhs = _card_operands(0, 4, 8, 16, torch.bfloat16, card)
    with pytest.raises(ValueError, match="multiple of"):
        glru_fwd(P[..., :24].contiguous(), bias[:24].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        glru_fwd(P.transpose(0, 1), bias)
    with pytest.raises(ValueError, match="float32"):
        glru_fwd(P, bias.to(torch.bfloat16))
    with pytest.raises(ValueError, match="compute dtype"):
        glru_fwd(P.half(), bias)
    hs = glru_fwd(P, bias)
    with pytest.raises(ValueError, match=r"\[S, R, H\]"):
        glru_bwd(P, bias, hs.float(), dhs)
