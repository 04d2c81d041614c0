"""The multi-tensor Nadam kernels of `csrc/nadam.cu` (`ops/nadam.py`).

On the CPU: CPU leaves take the plain per-leaf update, bit for bit the
update `Nadam.step` made before the kernels (`ParentNadam` below, its
code as it was), and the counters say so; the launch planner; the
optimizer's state dict as before, and one saved by the earlier `Nadam`
loads and steps.

Marked `card` (they skip without one; on a machine with a card, where the
JAX package is not installed: `python -m pytest
tests/test_torch_nadam_kernel.py --noconftest -m card`): the kernels held
bit for bit to the plain update over 20 steps on DeepJ's leaf sets and on
leaves without a gradient, at different counts, restored mid-run, of 1, 3
and 5 elements, misaligned, with strided gradients (copied contiguous),
and 70 leaves split over two launches; the
same bits on two calls; the autograd versions of what they write; and CUDA
leaves the kernels do not take, which raise."""

from __future__ import annotations

import ctypes
import functools
import io
import re
import shutil
import subprocess

import pytest
import torch

from music_generator_tpu_torch.config import default_config
from music_generator_tpu_torch.models.deepj import DeepJ
from music_generator_tpu_torch.ops import _build
from music_generator_tpu_torch.ops.nadam import (BLOCK_ELEMS, MAX_LEAVES,
                                                 Nadam, nadam_update,
                                                 nadam_update_reference,
                                                 _Leaves, plain_step,
                                                 plan_launches, takes_kernel)

SPLIT = MAX_LEAVES + 6          # leaves of the "split" set: two launches

STEPS = 20
STATE_KEYS = ("count", "m_schedule", "mu", "nu")


class ParentNadam(torch.optim.Optimizer):
    """`Nadam` as it was before the kernels: its step loop, op for op."""

    def __init__(self, params, lr=2e-3, beta1=0.9, beta2=0.999, eps=1e-7,
                 schedule_decay=0.004):
        super().__init__(params, dict(lr=lr, beta1=beta1, beta2=beta2,
                                      eps=eps, schedule_decay=schedule_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["beta1"], group["beta2"]
            eps, decay = group["eps"], group["schedule_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st.update(Nadam._fresh(p))
                t = st["count"] + 1.0
                mom_t = b1 * (1.0 - 0.5 * torch.pow(0.96, t * decay))
                mom_t1 = b1 * (1.0 - 0.5 * torch.pow(0.96, (t + 1.0) * decay))
                m_sched = st["m_schedule"] * mom_t
                m_sched_next = m_sched * mom_t1
                mu = st["mu"].mul_(b1).add_((1.0 - b1) * g)
                nu = st["nu"].mul_(b2).add_((1.0 - b2) * g * g)
                g_prime = g / (1.0 - m_sched)
                m_prime = mu / (1.0 - m_sched_next)
                v_prime = nu / (1.0 - torch.pow(b2, t))
                m_bar = (1.0 - mom_t) * g_prime + mom_t1 * m_prime
                p.add_(-lr * m_bar / (torch.sqrt(v_prime) + eps))
                st["count"] = t
                st["m_schedule"] = m_sched


@functools.lru_cache(maxsize=None)
def model_shapes(kind: str):
    """The leaf shapes of DeepJ at its published widths, time axis `kind`
    ("lstm": the `deepj` cell, "linear": `deepj_linear`)."""
    cfg = default_config().replace(time_axis_kind=kind)
    return tuple(tuple(p.shape) for p in DeepJ(cfg, "cpu").parameters())


SHAPES = {
    "deepj": lambda: model_shapes("lstm"),
    "deepj_linear": lambda: model_shapes("linear"),
    "odd": lambda: ((1,), (3,), (5,), (3, 5), (4097,), (0,), (8, 4)),
    "split": lambda: tuple((1 + i % 5,) for i in range(SPLIT - 1))
    + ((4097,),),
}


def leaves(shapes, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(device) for s in shapes]


def set_grads(params, gen, device, skip=()):
    for i, p in enumerate(params):
        p.grad = (None if i in skip else
                  torch.randn(p.shape, generator=gen).to(device))


def assert_same_bits(params_a, opt_a, params_b, opt_b):
    for i, (a, b) in enumerate(zip(params_a, params_b)):
        assert torch.equal(a, b), f"leaf {i}: p"
        sa, sb = opt_a.state[a], opt_b.state[b]
        assert bool(sa) == bool(sb), f"leaf {i}: state"
        for k in sa:
            assert sa[k].dtype == sb[k].dtype, f"leaf {i}: {k}"
            assert torch.equal(sa[k], sb[k]), f"leaf {i}: {k}"


def counters():
    return (nadam_update.launches, nadam_update.tensors,
            nadam_update_reference.calls)


# -- the CPU -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cpu_leaves_take_the_plain_path(name):
    """CPU leaves: the plain update, bit for bit the earlier `Nadam`, one
    plain call a leaf with a gradient, no launch."""
    shapes = SHAPES[name]()
    new, old = leaves(shapes, "cpu"), leaves(shapes, "cpu")
    opt, ref = Nadam(new), ParentNadam(old)
    gen = torch.Generator().manual_seed(1)
    before = counters()
    steps = 3
    for k in range(steps):
        set_grads(new, gen, "cpu", skip={0} if k == 0 else ())
        for p, q in zip(new, old):
            q.grad = None if p.grad is None else p.grad.clone()
        opt.step()
        ref.step()
        assert_same_bits(new, opt, old, ref)
    launches, tensors, calls = counters()
    assert (launches, tensors) == before[:2]
    assert calls - before[2] == steps * len(shapes) - 1
    assert float(opt.state[new[0]]["count"]) == steps - 1
    assert float(opt.state[new[1]]["count"]) == steps


@pytest.mark.parametrize("sizes", [
    (1269476,),
    tuple(range(1, 29)),
    (1, 3, 5, 4096, 4097, 0, 8192, 0),
    (0, 0, 4096),
    tuple(BLOCK_ELEMS * i + 1 for i in range(130)),
    (7,) * 10,
    (1,) * MAX_LEAVES,
    (1,) * (MAX_LEAVES + 1),
    (0,) * (2 * MAX_LEAVES + 3),
])
def test_plan_launches(sizes):
    """Every leaf once, in order; at most MAX_LEAVES a launch,
    ceil(L / MAX_LEAVES) launches; offsets the running sum of each leaf's
    blocks."""
    k = MAX_LEAVES
    plans = plan_launches(list(sizes))
    assert len(plans) == -(-len(sizes) // k)
    assert [i for idx, _ in plans for i in idx] == list(range(len(sizes)))
    for idx, starts in plans:
        assert 1 <= len(idx) <= k and len(starts) == len(idx) + 1
        assert starts[0] == 0
        for j, i in enumerate(idx):
            assert starts[j + 1] - starts[j] == -(-sizes[i] // BLOCK_ELEMS)


@pytest.mark.parametrize("name", ["deepj", "deepj_linear"])
def test_state_dict_as_before(name):
    """The state dict's keys, shapes and dtypes are the earlier
    `Nadam`'s."""
    shapes = SHAPES[name]()
    new, old = leaves(shapes, "cpu"), leaves(shapes, "cpu")
    opt, ref = Nadam(new), ParentNadam(old)
    gen = torch.Generator().manual_seed(2)
    for p, q in zip(new, old):
        p.grad = q.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    ref.step()
    got, want = opt.state_dict(), ref.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert sorted(got["state"]) == sorted(want["state"])
    for i, st in want["state"].items():
        assert sorted(got["state"][i]) == sorted(st) == sorted(STATE_KEYS)
        for k, v in st.items():
            assert got["state"][i][k].shape == v.shape
            assert got["state"][i][k].dtype == v.dtype


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_parent_state_dict_loads_and_steps(name):
    """A state dict the earlier `Nadam` saved after 3 steps loads, and the
    next 3 steps are the earlier `Nadam`'s bit for bit."""
    shapes = SHAPES[name]()
    old = leaves(shapes, "cpu")
    ref = ParentNadam(old)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        set_grads(old, gen, "cpu", skip={1})
        ref.step()
    buf = io.BytesIO()
    torch.save(ref.state_dict(), buf)
    new = [p.clone() for p in old]
    opt = Nadam(new)
    buf.seek(0)
    opt.load_state_dict(torch.load(buf))
    for _ in range(3):
        set_grads(old, gen, "cpu")
        for p, q in zip(new, old):
            p.grad = q.grad.clone()
        ref.step()
        opt.step()
    assert_same_bits(new, opt, old, ref)


def test_cpu_leaf_does_not_take_the_kernel():
    """A CPU leaf is not the kernels' and steps on the plain update."""
    p = torch.zeros(8)
    assert not takes_kernel(p, torch.zeros(8), Nadam._fresh(p))
    p.grad = torch.ones(8)
    before = counters()
    Nadam([p]).step()
    assert counters() == (before[0], before[1], before[2] + 1)


@pytest.fixture(scope="module")
def c_layout(tmp_path_factory):
    """{field: byte offset, "sizeof": size} of csrc/nadam.cu's
    NadamLeaves, its constants and struct built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/nadam.cu's NadamLeaves "
                    "for the host")
    src = (_build.CSRC / "nadam.cu").read_text()
    consts = re.findall(r"constexpr int k\w+ = \d+;", src)
    struct = re.search(r"struct NadamLeaves \{.*?\n\};\n", src, re.S)
    assert len(consts) == 3 and struct, "csrc/nadam.cu: NadamLeaves"
    fields = [name for name, _ in _Leaves._fields_]
    prints = "".join(
        f'  std::printf("{k} %zu\\n", offsetof(NadamLeaves, {k}));\n'
        for k in fields)
    d = tmp_path_factory.mktemp("nadam_layout")
    (d / "layout.cc").write_text(
        "#include <cstddef>\n#include <cstdio>\n" + "\n".join(consts)
        + "\n" + struct.group(0) + "int main() {\n" + prints
        + '  std::printf("sizeof %zu\\n", sizeof(NadamLeaves));\n}\n')
    subprocess.run([gxx, "-std=c++17", "-o", str(d / "layout"),
                    str(d / "layout.cc")], check=True, capture_output=True)
    out = subprocess.run([str(d / "layout")], check=True,
                         capture_output=True, text=True).stdout
    return {k: int(v) for k, v in (line.split() for line in
                                   out.splitlines())}


@pytest.mark.parametrize("field", [name for name, _ in _Leaves._fields_]
                         + ["sizeof"])
def test_leaves_layout_is_the_c_struct(field, c_layout):
    """The wrapper's ctypes block lays each field where csrc/nadam.cu's
    NadamLeaves has it (the library checks the size again at load)."""
    got = (ctypes.sizeof(_Leaves) if field == "sizeof"
           else getattr(_Leaves, field).offset)
    assert got == c_layout[field]
    assert ctypes.sizeof(_Leaves) <= 4096


# -- the card ----------------------------------------------------------------

@pytest.fixture
def card():
    """The card; the test skips when there is none (decided here, when the
    test runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def misaligned(shape, device):
    """A contiguous tensor one float past a 16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 1, device=device)[1:].view(shape)


def strided(t):
    """A copy of `t` whose elements lie two floats apart."""
    return torch.zeros(2 * t.numel(), device=t.device)[::2].view(
        t.shape).copy_(t)


CASES = ["deepj", "deepj_linear", "grad_none", "restored", "odd",
         "misaligned", "strided_grad", "split"]


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_over_20_steps(case, card):
    """The kernels against the plain update, bit for bit after each of 20
    steps: p, mu, nu, count and m_schedule of every leaf.  grad_none: two
    leaves without a gradient on some steps (their counts stay behind);
    restored: half the leaves start 5 steps late, and at step 10 the
    kernels' optimizer is rebuilt from the plain one's saved state dict;
    strided_grad: every gradient of the kernels' leaves strided;
    split: MAX_LEAVES + 6 leaves, two launches of the update a step."""
    name = {"grad_none": "deepj", "restored": "deepj",
            "misaligned": "odd", "strided_grad": "deepj"}.get(case, case)
    shapes = SHAPES[name]()
    L = len(shapes)
    a = leaves(shapes, card)
    b = [p.clone() for p in a]
    if case == "misaligned":
        a = [misaligned(p.shape, card).copy_(p) for p in a]
        assert all(p.data_ptr() % 16 for p in a if p.numel())
    opt_a, opt_b = Nadam(a), Nadam(b)
    gen = torch.Generator().manual_seed(4)
    k = MAX_LEAVES
    for step in range(STEPS):
        skip = ()
        if case == "grad_none":
            skip = {0, L - 1} if step % 3 else ()
        if case == "restored" and step < 5:
            skip = set(range(0, L, 2))
        set_grads(b, gen, card, skip)
        for p, q in zip(a, b):
            p.grad = None if q.grad is None else (
                misaligned(q.shape, card).copy_(q.grad)
                if case == "misaligned" else strided(q.grad)
                if case == "strided_grad" else q.grad.clone())
        with_grad = sum(p.grad is not None for p in a)
        before = counters()
        opt_a.step()
        plain_step(opt_b)
        launches, tensors, calls = counters()
        assert tensors - before[1] == with_grad
        assert launches - before[0] == 2 * -(-with_grad // k)
        assert calls - before[2] == with_grad            # opt_b's alone
        assert_same_bits(a, opt_a, b, opt_b)
        if case == "restored" and step == 9:
            buf = io.BytesIO()
            torch.save(opt_b.state_dict(), buf)
            buf.seek(0)
            a = [p.clone() for p in b]
            opt_a = Nadam(a)
            opt_a.load_state_dict(torch.load(buf))
            counts = {float(opt_a.state[p]["count"]) for p in a}
            assert counts == {5.0, 10.0}
    torch.cuda.synchronize()


@pytest.mark.card
def test_kernel_same_bits_twice(card):
    """The same leaves, gradients and state give the same bits on two
    calls."""
    shapes = SHAPES["deepj"]()
    runs = []
    for _ in range(2):
        ps = leaves(shapes, card, seed=5)
        opt = Nadam(ps)
        gen = torch.Generator().manual_seed(6)
        for _ in range(3):
            set_grads(ps, gen, card)
            opt.step()
        runs.append((ps, opt))
    assert_same_bits(runs[0][0], runs[0][1], runs[1][0], runs[1][1])


@pytest.mark.card
def test_kernel_bumps_versions(card):
    """A step on the kernels bumps the autograd version of every tensor it
    writes, as the plain update's in-place ops do."""
    ps = leaves(SHAPES["odd"](), card, seed=8)
    opt = Nadam(ps)
    opt.init_state()
    set_grads(ps, torch.Generator().manual_seed(9), card)
    written = [t for p in ps for t in [p] + [opt.state[p][k]
                                             for k in STATE_KEYS]]
    before = [t._version for t in written]
    opt.step()
    assert all(t._version > v for t, v in zip(written, before))


@pytest.mark.card
@pytest.mark.parametrize("odd_leaf", ["bfloat16", "transposed"])
def test_cuda_leaves_the_kernel_does_not_take(odd_leaf, card):
    """A bfloat16 or a transposed CUDA leaf raises, before any launch or
    plain call, and leaves every parameter and state as it was."""
    gen = torch.Generator().manual_seed(7)
    r = lambda *shape: torch.randn(*shape, generator=gen).to(card)
    odd = (r(6, 5).bfloat16() if odd_leaf == "bfloat16" else r(5, 6).t())
    ps = [r(33), odd]
    for p in ps:
        p.grad = torch.randn(p.shape, generator=gen).to(card, p.dtype)
    assert [takes_kernel(p, p.grad, Nadam._fresh(p)) for p in ps] == [
        True, False]
    kept = [p.clone() for p in ps]
    opt = Nadam(ps)
    before = counters()
    with pytest.raises(ValueError, match="float32 contiguous CUDA leaves"):
        opt.step()
    assert counters() == before
    assert all(torch.equal(p, q) for p, q in zip(ps, kept))
    assert all(float(opt.state[p]["count"]) == 0 for p in ps)
