"""Nadam with Keras-2 momentum scheduling, as a `torch.optim.Optimizer`
(the JAX package's `ops/nadam.py`).

The reference compiles with Keras's `'nadam'` string (ref: model.py:152),
i.e. Keras 2 Nadam: lr 2e-3, beta1 0.9, beta2 0.999, eps 1e-7, and the
Dozat momentum schedule mu_t = beta1 * (1 - 0.5 * 0.96^(t * 0.004)).
PyTorch's stock NAdam uses another schedule, so the update is written out.
The step count and the running product of mu_t are float32 tensors, as in
the JAX version; every parameter's state holds the same two scalars beside
its moments, so `state_dict` round-trips."""

from __future__ import annotations

import torch


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

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["beta1"], group["beta2"]
            eps, decay = group["eps"], group["schedule_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st.update(self._fresh(p))
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
        return loss
