"""Optimizer extras of the port (``ssr_speech_tpu/training/optim_extras.py``):
D-Adaptation Adam and the cosine / inverse-sqrt / polynomial-decay LR
schedules of the audiocraft registry.

  - :class:`DAdaptAdam` (reference ``dadam.py:30-252``): Adam whose step
    size ``d`` is learned online. Each step it accumulates three
    whole-model scalars (``g_sq = Σ g²/denom``, ``sksq_weighted = Σ
    s²/denom``, ``sk_l1 = Σ|s|``), updates ``d ← max(d,
    min((sksq_weighted/(1-β2) - gsq_weighted)/sk_l1, d·growth))`` and applies
    ``p ← p - exp_avg/denom`` with decoupled weight decay.
  - :func:`cosine_schedule` (``cosine_lr_scheduler.py:13-48``),
    :func:`inverse_sqrt_schedule` (``inverse_sqrt_lr_scheduler.py:10-40``),
    :func:`polynomial_decay_schedule`
    (``polynomial_decay_lr_scheduler.py:10-49``): step -> lr, computed in
    float32 as the JAX functions compute them.

As in JAX, nothing here is wired into a trainer: it is a library. The
optimizer has the interface of ``training.optim`` (``init(params) -> state``,
``update_(grads, state, params)`` in place), and its state is the tuple
``(leaves, d, gsq_weighted, step)`` with ``leaves`` a tree like the params of
``(exp_avg, exp_avg_sq, s)``: leaf for leaf ``DAdaptAdamState(leaves, d,
gsq_weighted, step)`` of JAX with its ``_DAdaptLeaf`` leaves, so either
package resumes the other's state.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map

F32 = np.float32

# ------------------------------------------------------------------ schedules


def _f32_of(fn, x) -> np.float32:
    """``fn`` of a float32 argument, rounded once to float32: XLA's float32
    cos and rsqrt agree with the correctly rounded value at the steps of the
    JAX package's schedule tests, numpy's float32 versions do not."""
    return F32(fn(np.float64(x)))


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int,
                    lr_min_ratio: float = 0.0, cycle_length: float = 1.0
                    ) -> Callable[[int], float]:
    """reference cosine_lr_scheduler.py:34-45."""

    def schedule(step) -> float:
        step = F32(step)
        warm = step / F32(max(warmup_steps, 1)) if warmup_steps > 0 else F32(1.0)
        s = (step - F32(warmup_steps)) / F32(max(total_steps - warmup_steps, 1))
        ratio = F32(lr_min_ratio) + F32(0.5 * (1 - lr_min_ratio)) * (
            F32(1.0) + _f32_of(np.cos, F32(np.pi) * s / F32(cycle_length)))
        if step < warmup_steps:
            lr = warm
        elif step <= total_steps:
            lr = ratio
        else:
            lr = F32(lr_min_ratio)
        return float(F32(base_lr) * F32(lr))

    return schedule


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int,
                          warmup_init_lr: float = 0.0
                          ) -> Callable[[int], float]:
    """reference inverse_sqrt_lr_scheduler.py:28-36."""

    def schedule(step) -> float:
        step = F32(step)
        lr_step = (base_lr - warmup_init_lr) / max(warmup_steps, 1)
        if step < warmup_steps:
            return float(F32(warmup_init_lr) + step * F32(lr_step))
        return float(F32(base_lr * (warmup_steps ** 0.5))
                     * _f32_of(lambda x: 1.0 / np.sqrt(x), max(step, F32(1.0))))

    return schedule


def polynomial_decay_schedule(base_lr: float, total_steps: int,
                              warmup_steps: int, end_lr: float = 0.0,
                              zero_lr_warmup_steps: int = 0,
                              power: float = 1.0) -> Callable[[int], float]:
    """reference polynomial_decay_lr_scheduler.py:31-46."""

    def schedule(step) -> float:
        step = F32(step)
        total_warm = warmup_steps + zero_lr_warmup_steps
        if zero_lr_warmup_steps > 0 and step <= zero_lr_warmup_steps:
            return 0.0
        if warmup_steps > 0 and step <= total_warm:
            warm_ratio = (step - F32(zero_lr_warmup_steps)) / F32(
                max(warmup_steps, 1))
            return float(warm_ratio * F32(base_lr))
        if step >= total_steps:
            return float(F32(end_lr))
        pct = F32(1.0) - (step - F32(total_warm)) / F32(
            max(total_steps - total_warm, 1))
        return float(F32(base_lr - end_lr) * pct ** F32(power) + F32(end_lr))

    return schedule


# --------------------------------------------------------------- DAdaptAdam


class DAdaptAdam:
    """D-Adaptation Adam (decoupled weight decay), step for step with the
    reference (dadam.py:107-252) and with JAX's ``dadapt_adam``. Leave
    ``lr`` at 1.0 unless unstable. The whole-model sums run in fp32 on the
    parameters' device; ``d``, ``gsq_weighted`` and ``step`` stay there as
    0-d tensors."""

    def __init__(self, lr: float = 1.0,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, d0: float = 1e-6,
                 growth_rate: float = math.inf):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay, self.d0, self.growth_rate = weight_decay, d0, growth_rate

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p.detach())  # noqa: E731
        leaves = tree_map(lambda p: (zeros(p), zeros(p), zeros(p)), params)
        dev = tree_leaves(params)[0].device
        scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
        return (leaves, scalar(self.d0, torch.float32),
                scalar(0.0, torch.float32), scalar(0, torch.int32))

    def update_(self, grads, state, params) -> None:
        beta1, beta2 = self.betas
        leaves, d, gsq_weighted, step = state
        dlr = d * self.lr
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ss = tree_leaves(leaves)
        ss = [ss[i:i + 3] for i in range(0, len(ss), 3)]
        g_sq = torch.zeros((), dtype=torch.float32, device=d.device)
        sksq_weighted = torch.zeros_like(g_sq)
        sk_l1 = torch.zeros_like(g_sq)
        denoms = []
        with torch.no_grad():
            for g, (exp_avg, exp_avg_sq, s) in zip(gs, ss):
                exp_avg.copy_(beta1 * exp_avg + dlr * (1 - beta1) * g)
                exp_avg_sq.copy_(beta2 * exp_avg_sq + (1 - beta2) * g * g)
                s.copy_(beta2 * s + dlr * (1 - beta2) * g)
                denom = torch.sqrt(exp_avg_sq) + self.eps
                denoms.append(denom)
                g_sq = g_sq + torch.sum(g * g / denom)
                sksq_weighted = sksq_weighted + torch.sum(s ** 2 / denom)
                sk_l1 = sk_l1 + torch.sum(torch.abs(s))

            new_gsq = beta2 * gsq_weighted + g_sq * dlr ** 2 * (1 - beta2)
            d_hat = (sksq_weighted / (1 - beta2) - new_gsq) / torch.clamp(
                sk_l1, min=1e-30)
            growth = (d * self.growth_rate if math.isfinite(self.growth_rate)
                      else torch.full_like(d, math.inf))
            new_d = torch.maximum(d, torch.minimum(d_hat, growth))
            # the reference keeps d (and makes no update) until a gradient flows
            frozen = sk_l1 == 0
            new_d = torch.where(frozen, d, new_d)
            new_gsq = torch.where(frozen, gsq_weighted, new_gsq)

            for p, (exp_avg, _, _), denom in zip(ps, ss, denoms):
                upd = -exp_avg / denom
                if self.weight_decay:
                    upd = upd - self.weight_decay * dlr * p  # dadam.py:244-245
                p.add_(upd.to(p.dtype))
            d.copy_(new_d)
            gsq_weighted.copy_(new_gsq)
            step += 1


def dadapt_adam(lr: float = 1.0, betas: Tuple[float, float] = (0.9, 0.999),
                eps: float = 1e-8, weight_decay: float = 0.0,
                d0: float = 1e-6, growth_rate: float = math.inf
                ) -> DAdaptAdam:
    """JAX's constructor name for :class:`DAdaptAdam`."""
    return DAdaptAdam(lr, betas, eps, weight_decay, d0, growth_rate)
