"""Nadam with Keras-2 momentum scheduling, as a `torch.optim.Optimizer`
(the JAX package's `ops/nadam.py`).

The reference compiles with Keras's `'nadam'` string (ref: model.py:152),
i.e. Keras 2 Nadam: lr 2e-3, beta1 0.9, beta2 0.999, eps 1e-7, and the
Dozat momentum schedule mu_t = beta1 * (1 - 0.5 * 0.96^(t * 0.004)).
PyTorch's stock NAdam uses another schedule, so the update is written out.
The step count and the running product of mu_t are float32 tensors, as in
the JAX version; every parameter's state holds the same two scalars beside
its moments, so `state_dict` round-trips.

A step sends every CUDA leaf to the multi-tensor kernels of
`csrc/nadam.cu` (`nadam_update`: two launches for up to MAX_LEAVES leaves,
bit for bit the plain update) and every CPU leaf to the plain per-leaf
update (`nadam_update_reference`).  A strided gradient (as
`torch.autograd.grad` may return) is copied contiguous first; a CUDA leaf
the kernels still do not take (p or its state not float32, not
contiguous, or on another device) raises.
The kernels advance each leaf's count and m_schedule in place, where the
plain update puts new tensors in the state, and bump the version counters
of every tensor they write, as in-place PyTorch ops do.  Launch counters:
`nadam_update.launches` and `.tensors` (leaves updated by the kernels);
the plain version counts `.calls`."""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from music_generator_tpu_torch.ops import _build

MAX_LEAVES = 64        # leaves one launch carries (csrc/nadam.cu kMaxLeaves)
BLOCK_ELEMS = 4096     # elements an update block takes (kBlockElems)


def nadam_update_reference(p: torch.Tensor, g: torch.Tensor, st: dict,
                           lr: float, b1: float, b2: float, eps: float,
                           decay: float) -> None:
    """One leaf's update in plain PyTorch ops: p, mu and nu in place; the
    state's count and m_schedule replaced by their next values."""
    nadam_update_reference.calls += 1
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


nadam_update_reference.calls = 0


def plan_launches(sizes: Sequence[int]) -> List[Tuple[List[int], List[int]]]:
    """The launches that update leaves of `sizes` elements, in order: one
    (leaf indices, block offsets) a launch, at most MAX_LEAVES leaves
    each; offset i is the first update block of the launch's leaf i, the
    last (one more than the leaves) the launch's grid."""
    plans = []
    for first in range(0, len(sizes), MAX_LEAVES):
        leaves = list(range(first, min(first + MAX_LEAVES, len(sizes))))
        starts = [0]
        for i in leaves:
            starts.append(starts[-1] + -(-sizes[i] // BLOCK_ELEMS))
        plans.append((leaves, starts))
    return plans


def takes_kernel(p: torch.Tensor, g: torch.Tensor, st: dict) -> bool:
    """Whether the kernels take the leaf: p, its gradient and its four
    state tensors float32, contiguous and on p's CUDA device, the count and
    m_schedule one element each."""
    if not p.is_cuda:
        return False
    mu, nu, count, m_schedule = (st["mu"], st["nu"], st["count"],
                                 st["m_schedule"])
    dev = p.get_device()
    for t in (p, g, mu, nu, count, m_schedule):
        if (t.dtype != torch.float32 or t.get_device() != dev
                or not t.is_contiguous()):
            return False
    return (p.shape == g.shape == mu.shape == nu.shape
            and count.numel() == m_schedule.numel() == 1)


_POINTERS = ("p", "g", "mu", "nu", "count", "m_schedule")
_STATE = ("mu", "nu", "count", "m_schedule")   # written by the kernels
_HYPER = ("b1", "b2", "one_minus_b1", "one_minus_b2", "neg_lr", "eps",
          "decay")


class _Leaves(ctypes.Structure):
    """csrc/nadam.cu's NadamLeaves."""
    _fields_ = ([(k, ctypes.c_void_p * MAX_LEAVES) for k in _POINTERS]
                + [("n", ctypes.c_longlong * MAX_LEAVES),
                   ("block_start", ctypes.c_int * (MAX_LEAVES + 1)),
                   ("leaves", ctypes.c_int)]
                + [(k, ctypes.c_float) for k in _HYPER])


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nadam_step": [_P, _I, _P], "nadam_layout": [_P, _P, _P]}


_lib = None


def _library() -> ctypes.CDLL:
    """The kernels, built at first use, their layout checked once."""
    global _lib
    if _lib is None:
        lib = _build.bind("nadam", _SIGNATURES)
        got = [ctypes.c_int() for _ in range(3)]
        lib.nadam_layout(*(ctypes.byref(v) for v in got))
        got = [v.value for v in got]
        want = [MAX_LEAVES, BLOCK_ELEMS, ctypes.sizeof(_Leaves)]
        if got != want:
            raise RuntimeError(f"csrc/nadam.cu's layout (leaves, block "
                               f"elements, bytes) {got} is not the "
                               f"wrapper's {want}")
        _lib = lib
    return _lib


def nadam_update(leaves: Sequence[Tuple[torch.Tensor, torch.Tensor, dict]],
                 lr: float, b1: float, b2: float, eps: float,
                 decay: float) -> None:
    """The update of `nadam_update_reference` on every (p, g, state) of
    `leaves`, each of which `takes_kernel`, all on one CUDA device: two
    launches of csrc/nadam.cu for every MAX_LEAVES leaves (the update of
    p, mu and nu, then count and m_schedule in place).  Counts
    `nadam_update.launches` and `.tensors`."""
    lib = _library()
    dev = leaves[0][0].device
    hyper = dict(b1=b1, b2=b2, one_minus_b1=1.0 - b1, one_minus_b2=1.0 - b2,
                 neg_lr=-lr, eps=eps, decay=decay)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for idx, starts in plan_launches([p.numel() for p, _, _ in leaves]):
            part = [leaves[i] for i in idx]
            k = len(part)
            a = _Leaves(leaves=k, **hyper)
            a.p[:k] = [p.data_ptr() for p, _, _ in part]
            a.g[:k] = [g.data_ptr() for _, g, _ in part]
            for key in _STATE:
                getattr(a, key)[:k] = [st[key].data_ptr() for _, _, st in part]
            a.n[:k] = [p.numel() for p, _, _ in part]
            a.block_start[:k + 1] = starts
            rc = lib.nadam_step(ctypes.byref(a), starts[-1], stream)
            if rc != 0:
                raise RuntimeError(f"nadam_step failed: CUDA error {rc}")
            nadam_update.launches += 2 if starts[-1] else 1
            nadam_update.tensors += k
    torch.autograd.graph.increment_version(
        [p for p, _, _ in leaves]
        + [st[key] for _, _, st in leaves for key in _STATE])


nadam_update.launches = 0
nadam_update.tensors = 0


class Nadam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-7,
                 schedule_decay: float = 0.004):
        super().__init__(params, dict(lr=lr, beta1=beta1, beta2=beta2,
                                      eps=eps, schedule_decay=schedule_decay))

    @staticmethod
    def _fresh(p: torch.Tensor) -> dict:
        return {"count": torch.zeros((), dtype=torch.float32,
                                     device=p.device),
                "m_schedule": torch.ones((), dtype=torch.float32,
                                         device=p.device),
                "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    @torch.no_grad()
    def init_state(self) -> None:
        """Give every parameter without state the state its first step
        would create (step 0's), so that every rank of a data-parallel fit
        holds the same tensors before rank 0's are broadcast."""
        for group in self.param_groups:
            for p in group["params"]:
                if not self.state[p]:
                    self.state[p].update(self._fresh(p))

    def leaves_with_grad(self):
        """(hyperparameters, p, grad, state) of every leaf with a gradient,
        in order, its state made fresh where it has none; the
        hyperparameters are (lr, beta1, beta2, eps, schedule_decay)."""
        for group in self.param_groups:
            hyper = (group["lr"], group["beta1"], group["beta2"],
                     group["eps"], group["schedule_decay"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(self._fresh(p))
                yield hyper, p, p.grad, st

    @torch.no_grad()
    def step(self, closure=None):
        """Every leaf with a gradient: the CUDA leaves of one device and
        hyperparameters together on the kernels, the CPU's one by one on
        the plain update (see the module docstring).  A leaf without a
        gradient keeps its state, count included."""
        loss = closure() if closure is not None else None
        fused = {}
        for hyper, p, g, st in self.leaves_with_grad():
            if not p.is_cuda:
                nadam_update_reference(p, g, st, *hyper)
                continue
            g = g.contiguous()
            if takes_kernel(p, g, st):
                fused.setdefault((p.device, hyper), []).append((p, g, st))
            else:
                raise ValueError(
                    f"Nadam's kernels take float32 contiguous CUDA leaves "
                    f"with their gradient and state on the leaf's device; "
                    f"got a {p.dtype} leaf of shape {tuple(p.shape)} on "
                    f"{p.device} (contiguous {p.is_contiguous()}), its "
                    f"gradient {g.dtype} on {g.device}, its state "
                    + ", ".join(f"{k} {st[k].dtype} on {st[k].device}"
                                for k in _STATE))
        for (_, hyper), leaves in fused.items():
            nadam_update(leaves, *hyper)
        return loss


@torch.no_grad()
def plain_step(opt: Nadam) -> None:
    """`Nadam.step` with every leaf on the plain update, whatever its
    device: the kernels' yardstick (tests, chip_smoke.py)."""
    for hyper, p, g, st in opt.leaves_with_grad():
        nadam_update_reference(p, g, st, *hyper)
