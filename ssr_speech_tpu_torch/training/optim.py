"""Optimizers and LR schedules (port of ``ssr_speech_tpu/training/optim.py``):
ScaledAdam + Eden, Eve, and AdamW (clip by global norm, then AdamW) with the
linear warmup; and ``optax.adam``, which the codec trainer uses.

Each optimizer is an object with ``init(params) -> state`` and
``update_(grads, state, params)``, over a tree of tensors (the nesting of
:meth:`ParamTree.tree`). ``update_`` writes the new parameters and state in
place (JAX returns new arrays): the two param-sized fp32 moments take 8
bytes per parameter, and a second copy of them is what the in-place update
saves. The state is a tree of
tuples whose leaves line up, in ``jax.tree.leaves`` order, with the JAX
optax state (``ScaledAdamState``, ``EveState``, the optax AdamW chain), so a
state written by one package unflattens into the other's.

Semantics held to JAX:
- the schedule is read at the optimizer's step count before the increment
  (``schedule(state.step)``); schedules compute in float32 as jnp does;
- ScaledAdam keeps one state per stacked leaf: ``param_rms``, the learned
  scale and the clipping norm are taken over the whole ``[L, ...]`` tensor,
  not per layer; scalars are the leaves of size 1 (the positional alphas);
- AdamW clips the gradients by their global norm first.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..config import OptimConfig

from ..utils.tree import tree_leaves, tree_map

F32 = np.float32


# ------------------------------------------------------------------ schedules

def eden_schedule(base_lr: float, lr_batches: float, lr_epochs: float,
                  warmup_batches: float, pseudo_epoch_size: int
                  ) -> Callable[[int], float]:
    """Eden LR: base * ((step^2+B^2)/B^2)^-0.25 * ((epoch^2+E^2)/E^2)^-0.25
    * warmup (linear 0.5 -> 1 over ``warmup_batches``), with pseudo-epochs
    ``epoch = step // pseudo_epoch_size + 1``."""

    def schedule(step: int) -> float:
        step = F32(step)
        epoch = np.floor(step / F32(pseudo_epoch_size)) + F32(1.0)
        f_b = ((step ** 2 + F32(lr_batches ** 2)) / F32(lr_batches ** 2)) ** F32(-0.25)
        f_e = ((epoch ** 2 + F32(lr_epochs ** 2)) / F32(lr_epochs ** 2)) ** F32(-0.25)
        warm = (F32(1.0) if step >= F32(warmup_batches) else
                F32(0.5) + F32(0.5) * step / F32(max(warmup_batches, 1.0)))
        return float(F32(base_lr) * f_b * f_e * warm)

    return schedule


def linear_warmup_schedule(base_lr: float, total_steps: int,
                           warmup_fraction: float) -> Callable[[int], float]:
    """Linear warmup over ``total_steps * warmup_fraction`` steps, then
    linear decay to 0 at ``total_steps``."""
    warm = max(int(total_steps * warmup_fraction), 1)

    def schedule(step: int) -> float:
        step = F32(step)
        if step < F32(warm):
            return float(F32(base_lr) * (step / F32(warm)))
        down = max(F32(0.0), (F32(total_steps) - step) / F32(max(total_steps - warm, 1)))
        return float(F32(base_lr) * down)

    return schedule


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


# ----------------------------------------------------------------- ScaledAdam

class ScaledAdam:
    """ScaledAdam: an Adam step scaled by each tensor's RMS, a learned
    log-scale per tensor (the size update every ``size_update_period``
    steps), plain clamped Adam for scalars, and median-based clipping of the
    RMS-weighted global gradient norm. ``cfg.moments_dtype="bfloat16"``
    stores ``delta`` and ``exp_avg_sq`` in bf16 (arithmetic stays fp32).

    State: ``(step, leaves, norm_buffer, norm_threshold)``, ``leaves`` a
    tree like the params of ``(delta, exp_avg_sq, param_rms, scale_grads,
    scale_exp_avg_sq)``; ``step`` is an int32 CPU tensor."""

    def __init__(self, schedule: Callable[[int], float], cfg: OptimConfig):
        self.schedule, self.cfg = schedule, cfg

    def init(self, params):
        cfg = self.cfg
        mdt = torch.bfloat16 if cfg.moments_dtype == "bfloat16" else None

        def leaf(p):
            p = p.detach()
            bshape = (1,) * p.dim()
            zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                              device=p.device)
            rms = (zeros(bshape) if p.numel() == 1 else
                   p.float().square().mean().sqrt().reshape(bshape))
            return (torch.zeros_like(p, dtype=mdt or p.dtype),
                    torch.zeros_like(p, dtype=mdt or p.dtype), rms,
                    zeros((cfg.size_update_period,) + bshape), zeros(bshape))

        dev = tree_leaves(params)[0].device
        return (torch.zeros((), dtype=torch.int32),
                tree_map(leaf, params),
                torch.zeros(cfg.clipping_update_period, dtype=torch.float32,
                            device=dev),
                torch.full((), float("inf"), dtype=torch.float32, device=dev))

    def update_(self, grads, state, params) -> None:
        cfg = self.cfg
        beta1, beta2 = cfg.betas
        period, cup = cfg.size_update_period, cfg.clipping_update_period
        step_t, leaves, norm_buffer, norm_threshold = state
        step = int(step_t)
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ss = tree_leaves(leaves)
        ss = [tuple(ss[i:i + 5]) for i in range(0, len(ss), 5)]
        lr = _scalar(self.schedule(step), norm_buffer)
        size_lr = lr * cfg.scalar_lr_scale

        clip = 1.0
        if cfg.clipping_scale is not None:
            sumsq = [g.float().square().sum() if p.numel() == 1
                     else (g.float() * s[2]).square().sum()
                     for p, g, s in zip(ps, gs, ss)]
            tot_norm = torch.sqrt(sum(sumsq))
            norm_buffer[step % cup] = tot_norm
            if step % cup == 0 and step > 0:
                median = torch.sort(norm_buffer).values[(cup // 4) * 2]
                norm_threshold.copy_(cfg.clipping_scale * median)
            if step >= cup:
                clip = torch.where(torch.isfinite(norm_threshold),
                                   torch.clamp(norm_threshold / (tot_norm + 1e-20),
                                               max=1.0), 1.0)

        bc2 = F32(1.0) - F32(beta2) ** F32(step + 1)
        for p, g, (delta_s, eas_s, rms, scale_grads, sesq) in zip(ps, gs, ss):
            g = g.float() * clip
            pf = p.detach().float()
            delta = delta_s.float() * beta1
            eas = eas_s.float() * beta2 + (1 - beta2) * g * g
            if p.numel() == 1:  # plain Adam with clamping
                denom = torch.sqrt(eas / float(bc2)) + cfg.eps
                delta = delta - size_lr * (1 - beta1) * g / denom
                update = torch.clamp(pf, -cfg.scalar_max, cfg.scalar_max) + delta - pf
            else:
                # learned-size update every `period` steps
                scale_grads[step % period] = (pf * g).sum().reshape(rms.shape)
                at_size_step = step % period == period - 1
                if at_size_step:
                    rms.copy_(pf.square().mean().sqrt().reshape(rms.shape))
                    beta2c = beta2 ** period
                    sesq.copy_(sesq * beta2c + (1 - beta2c)
                               * scale_grads.square().mean(dim=0))
                    if step > 0:
                        bc2s = F32(1.0) - F32(beta2c) ** F32((step + 1) // period)
                        scale_step = (-size_lr * float(np.sqrt(max(bc2s, F32(0.0))))
                                      * scale_grads.sum(dim=0)
                                      / (torch.sqrt(sesq) + cfg.eps))
                        scale_step = torch.where(rms < cfg.param_min_rms, 0.0,
                                                 scale_step)
                        scale_step = torch.where(rms > cfg.param_max_rms,
                                                 -size_lr * period, scale_step)
                        delta = delta + (1 - beta1) * pf * scale_step
                # the RMS-scaled Adam step
                eas_used = eas / float(max(bc2, F32(1e-8))) if bc2 < 0.99 else eas
                alpha = -lr * (1 - beta1) * torch.clamp(rms, min=cfg.param_min_rms)
                delta = delta + (g / (torch.sqrt(eas_used) + cfg.eps)) * alpha
                update = delta
            delta_s.copy_(delta)
            eas_s.copy_(eas)
            with torch.no_grad():
                p.add_(update.to(p.dtype))
        step_t += 1


# ----------------------------------------------------------------------- Eve

class Eve:
    """Eve: AdamW whose weight decay applies only while a tensor's RMS
    exceeds ``target_rms``; scalars are never decayed. State:
    ``(step, leaves)``, ``leaves`` a tree of ``(exp_avg, exp_avg_sq)``."""

    def __init__(self, schedule: Callable[[int], float], betas=(0.9, 0.98),
                 eps: float = 1e-8, weight_decay: float = 1e-3,
                 target_rms: float = 0.1):
        self.schedule = schedule
        self.betas, self.eps = betas, eps
        self.weight_decay, self.target_rms = weight_decay, target_rms

    def init(self, params):
        leaf = lambda p: (torch.zeros_like(p.detach()), torch.zeros_like(p.detach()))
        return (torch.zeros((), dtype=torch.int32), tree_map(leaf, params))

    def update_(self, grads, state, params) -> None:
        beta1, beta2 = self.betas
        step_t, leaves = state
        step = int(step_t) + 1
        lr = F32(self.schedule(step - 1))
        bc1 = F32(1.0) - F32(beta1) ** F32(step)
        bc2 = F32(1.0) - F32(beta2) ** F32(step)
        ss = tree_leaves(leaves)
        for p, g, exp_avg, exp_avg_sq in zip(tree_leaves(params), tree_leaves(grads),
                                             ss[0::2], ss[1::2]):
            g = g.float()
            pf = p.detach().float()
            exp_avg.copy_(exp_avg * beta1 + (1 - beta1) * g)
            exp_avg_sq.copy_(exp_avg_sq * beta2 + (1 - beta2) * g * g)
            denom = torch.sqrt(exp_avg_sq) * float(bc2 ** F32(-0.5)) + self.eps
            new_p = pf
            if p.numel() > 1:
                above = torch.linalg.vector_norm(pf) > self.target_rms * p.numel() ** 0.5
                new_p = new_p * (1 - self.weight_decay * above.float())
            new_p = new_p - float(lr / bc1) * exp_avg / denom
            with torch.no_grad():
                p.add_((new_p - pf).to(p.dtype))
        step_t += 1


# --------------------------------------------------------------------- AdamW

class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay))``. State:
    ``((), ((count, mu, nu), (), (schedule_count,)))``, the optax chain's
    leaves."""

    def __init__(self, schedule: Callable[[int], float], cfg: OptimConfig,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.cfg = schedule, cfg
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p.detach())
        count = lambda: torch.zeros((), dtype=torch.int32)
        return ((), ((count(), tree_map(zeros, params), tree_map(zeros, params)),
                     (), (count(),)))

    def update_(self, grads, state, params) -> None:
        b1, b2 = self.b1, self.b2
        (count, mu, nu), _, (sched_count,) = state[1]
        gs = [g.float() for g in tree_leaves(grads)]
        g_norm = torch.sqrt(sum(g.square().sum() for g in gs))
        max_norm = self.cfg.gradient_clip_val
        gs = [torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm) for g in gs]
        n = int(count) + 1
        bc1 = float(F32(1.0) - F32(b1) ** F32(n))
        bc2 = float(F32(1.0) - F32(b2) ** F32(n))
        step_size = -F32(self.schedule(int(sched_count)))
        for p, g, m, v in zip(tree_leaves(params), gs, tree_leaves(mu),
                              tree_leaves(nu)):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            update = update + self.cfg.weight_decay * p.detach()
            with torch.no_grad():
                p.add_((float(step_size) * update).to(p.dtype))
        count += 1
        sched_count += 1


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` at a constant rate: bias correction
    at the incremented count, ``eps`` outside the square root. State:
    ``(count, mu, nu)``, the leaves of optax's ``(ScaleByAdamState(count,
    mu, nu), EmptyState())``; ``count`` is an int32 CPU tensor. The moments
    and parameters are updated in place with ``torch._foreach`` ops."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p.detach())
        return (torch.zeros((), dtype=torch.int32), tree_map(zeros, params),
                tree_map(zeros, params))

    def update_(self, grads, state, params) -> None:
        b1, b2 = self.b1, self.b2
        count, mu, nu = state
        n = F32(int(count) + 1)
        bc1 = float(F32(1.0) - F32(b1) ** n)
        bc2 = float(F32(1.0) - F32(b2) ** n)
        gs = [g.float() for g in tree_leaves(grads)]
        ms, vs = tree_leaves(mu), tree_leaves(nu)
        with torch.no_grad():
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - b2))
            denom = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(torch._foreach_div(ms, bc1), denom)
            torch._foreach_mul_(upd, -self.lr)
            torch._foreach_add_(tree_leaves(params), upd)
        count += 1


def build_optimizer(cfg: OptimConfig, total_steps: int = 100000
                    ) -> Tuple[object, Callable[[int], float]]:
    """(optimizer, schedule) by ``cfg.optimizer_name``, as the JAX
    ``build_optimizer``."""
    name = cfg.optimizer_name.lower()
    if name == "scaledadam":
        sched = eden_schedule(cfg.lr, cfg.reduce_lr_start_step,
                              cfg.reduce_lr_start_epoch, cfg.warmup_batches,
                              cfg.pseudo_epoch_size)
        return ScaledAdam(sched, cfg), sched
    if name == "adamw":
        sched = linear_warmup_schedule(cfg.lr, total_steps, cfg.warmup_fraction)
        return AdamW(sched, cfg), sched
    if name == "eve":
        sched = linear_warmup_schedule(cfg.lr, total_steps, cfg.warmup_fraction)
        return Eve(sched, betas=cfg.betas, eps=cfg.eps,
                   weight_decay=cfg.weight_decay), sched
    raise ValueError(cfg.optimizer_name)
