"""The icefall "scaling" toolbox (port of ``ssr_speech_tpu/ops/scaling.py``):
the activation and normalisation pieces the transformer can be configured
with.

- :func:`double_swish`: ``x * sigmoid(x - 1)`` in fp32;
- :func:`basic_norm`: ``x * (mean(x^2, ch) + exp(log_eps))^-0.5``;
- :func:`activation_balancer`: identity in the forward pass whose backward
  nudges the channel statistics (``grad -= |grad| * factor``);
- :func:`balanced_double_swish` / :func:`balanced_basic_norm`: the
  compositions;
- :func:`scaled_init`: an init function's result times ``initial_scale``;
- :func:`whiten` / :func:`whitening_metric`: the whitening gradient penalty;
- :func:`max_eig` / :func:`init_max_eig_direction`: the dominant
  eigendirection limiter with explicit power-method state;
- :func:`with_loss`: attach an auxiliary loss to a passthrough.

Each JAX ``custom_vjp`` is a ``torch.autograd.Function`` here, with the same
identity forward and the same gradient surgery in its backward. The balancer
draws nothing at random (it always applies, as JAX's does), so the port
matches JAX exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.tree import tree_map


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """double_swish(x) = x * sigmoid(x - 1), computed in fp32."""
    xf = x.float()
    return (xf * torch.sigmoid(xf - 1.0)).to(x.dtype)


def basic_norm(x: torch.Tensor, log_eps: torch.Tensor,
               channel_dim: int = -1) -> torch.Tensor:
    """BasicNorm: no weight or bias; a learnable log-eps ballast."""
    xf = x.float()
    scales = (xf.square().mean(dim=channel_dim, keepdim=True)
              + torch.exp(log_eps)) ** -0.5
    return (xf * scales).to(x.dtype)


def init_basic_norm(eps: float = 0.25) -> torch.Tensor:
    return torch.log(torch.tensor(eps, dtype=torch.float32))


def _other_dims(x: torch.Tensor, channel_dim: int) -> Tuple[int, ...]:
    return tuple(d for d in range(x.dim()) if d != channel_dim % x.dim())


def compute_scale_factor(x: torch.Tensor, channel_dim: int, min_abs: float,
                         max_abs: float, gain_factor: float,
                         max_factor: float) -> torch.Tensor:
    """Per channel: pushes the mean |x| into [min_abs, max_abs]."""
    x_abs_mean = x.abs().mean(dim=_other_dims(x, channel_dim)).float()
    below = (((min_abs - x_abs_mean) * (gain_factor / min_abs)
              ).clamp(0, max_factor) if min_abs != 0.0 else 0.0)
    above = ((x_abs_mean - max_abs) * (gain_factor / max_abs)
             ).clamp(0, max_factor)
    return below - above


def compute_sign_factor(x: torch.Tensor, channel_dim: int, min_positive: float,
                        max_positive: float, gain_factor: float,
                        max_factor: float) -> torch.Tensor:
    """Per channel: pushes the share of x > 0 into [min_positive,
    max_positive]."""
    prop_pos = (x > 0).float().mean(dim=_other_dims(x, channel_dim))
    f1 = (((min_positive - prop_pos) * (gain_factor / min_positive)
           ).clamp(0, max_factor) if min_positive != 0.0 else 0.0)
    f2 = (((prop_pos - max_positive) * (gain_factor / (1.0 - max_positive))
           ).clamp(0, max_factor) if max_positive != 1.0 else 0.0)
    return f1 - f2


class _BalancerApply(torch.autograd.Function):
    """Identity; the backward returns ``g - |g| * factor`` with
    ``factor = sign + scale * (1[x > 0] - 0.5)`` (the factors arrive shaped
    to broadcast against x)."""

    @staticmethod
    def forward(ctx, x, scale_factor, sign_factor):
        ctx.save_for_backward(x > 0, scale_factor, sign_factor)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        xgt0, scale_factor, sign_factor = ctx.saved_tensors
        factor = sign_factor + scale_factor * (xgt0.to(g.dtype) - 0.5)
        return g - g.abs() * factor, None, None


def activation_balancer(
    x: torch.Tensor,
    channel_dim: int = -1,
    min_positive: float = 0.05,
    max_positive: float = 0.95,
    min_abs: float = 0.2,
    max_abs: float = 100.0,
    sign_gain_factor: float = 0.01,
    scale_gain_factor: float = 0.02,
    max_factor: float = 0.04,
    deterministic: bool = False,
) -> torch.Tensor:
    """ActivationBalancer (core path, prob 1): identity whose backward pushes
    channel abs-means toward [min_abs, max_abs] and positive shares toward
    [min_positive, max_positive]. ``deterministic`` (inference) skips it."""
    if deterministic:
        return x
    channel_dim %= x.dim()
    with torch.no_grad():
        scale = compute_scale_factor(x, channel_dim, min_abs, max_abs,
                                     scale_gain_factor, max_factor)
        if min_positive == 0.0 and max_positive == 1.0:
            sign = torch.zeros_like(scale)
        else:
            sign = compute_sign_factor(x, channel_dim, min_positive,
                                       max_positive, sign_gain_factor,
                                       max_factor)
    bshape = [1] * x.dim()
    bshape[channel_dim] = x.shape[channel_dim]
    return _BalancerApply.apply(x, scale.reshape(bshape), sign.reshape(bshape))


def balanced_double_swish(x: torch.Tensor, channel_dim: int = -1,
                          deterministic: bool = False) -> torch.Tensor:
    """BalancedDoubleSwish: the balancer, then double_swish."""
    return double_swish(activation_balancer(x, channel_dim,
                                            deterministic=deterministic))


def balanced_basic_norm(x: torch.Tensor, log_eps: torch.Tensor,
                        channel_dim: int = -1,
                        deterministic: bool = False) -> torch.Tensor:
    """BalancedBasicNorm: the balancer (positive share in [0.45, 0.55]),
    then BasicNorm."""
    x = activation_balancer(x, channel_dim, min_positive=0.45,
                            max_positive=0.55, deterministic=deterministic)
    return basic_norm(x, log_eps, channel_dim)


def scaled_init(init_fn, initial_scale: float):
    """ScaledLinear / ScaledConv: the standard init times ``initial_scale``
    (over a tensor or a dict / list / tuple of tensors)."""
    def wrapped(*args, **kwargs):
        return tree_map(lambda p: p * initial_scale, init_fn(*args, **kwargs))
    return wrapped


# ------------------------------------------------------------------ whitening


def whitening_metric(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """1.0 iff every group's centred covariance is the same multiple of the
    identity; larger otherwise."""
    x = x.reshape(-1, x.shape[-1]).float()
    num_frames, num_channels = x.shape
    if num_channels % num_groups:
        raise ValueError(f"{num_channels} channels in {num_groups} groups")
    cpg = num_channels // num_groups
    x = x.reshape(num_frames, num_groups, cpg).permute(1, 0, 2)
    x = x - x.mean(dim=1, keepdim=True)
    x_covar = torch.matmul(x.transpose(1, 2), x)
    x_covar_mean_diag = torch.diagonal(x_covar, dim1=-2, dim2=-1).mean()
    x_covarsq_mean_diag = (x_covar * x_covar).sum() / (num_groups * cpg)
    return x_covarsq_mean_diag / (x_covar_mean_diag ** 2 + 1.0e-20)


def _rescaled_extra(g: torch.Tensor, extra: torch.Tensor,
                    grad_scale: float) -> torch.Tensor:
    """``extra`` scaled to ``grad_scale`` times the norm of ``g``."""
    gf = g.float()
    g_norm = torch.sqrt((gf * gf).sum())
    p_norm = torch.sqrt((extra * extra).sum())
    return extra * (grad_scale * (g_norm / (p_norm + 1.0e-20)))


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_groups, whitening_limit, grad_scale):
        ctx.save_for_backward(x)
        ctx.args = (num_groups, whitening_limit, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        num_groups, whitening_limit, grad_scale = ctx.args
        with torch.enable_grad():
            xf = x.detach().float().requires_grad_(True)
            metric = torch.relu(whitening_metric(xf, num_groups)
                                - whitening_limit)
            (penalty,) = torch.autograd.grad(metric, xf)
        extra = _rescaled_extra(g, penalty, grad_scale)
        return g + extra.to(g.dtype), None, None, None


def whiten(x: torch.Tensor, num_groups: int = 1, whitening_limit: float = 2.0,
           grad_scale: float = 0.01) -> torch.Tensor:
    """Forward identity; the backward adds ``grad(relu(metric - limit))``
    rescaled to ``grad_scale`` times the incoming gradient's norm. An exact
    passthrough while the metric is under ``whitening_limit``."""
    return _Whiten.apply(x, num_groups, whitening_limit, grad_scale)


# -------------------------------------------------------------------- MaxEig


def init_max_eig_direction(num_channels: int) -> torch.Tensor:
    """The power method's starting direction: the normalised arange."""
    d = torch.arange(num_channels, dtype=torch.float32)
    return d / torch.linalg.vector_norm(d)


def _channels_last(x: torch.Tensor, channel_dim: int) -> torch.Tensor:
    """[..., C, ...] -> [N, C], centred over N."""
    xm = x.transpose(channel_dim, -1).reshape(-1, x.shape[channel_dim])
    return xm - xm.mean(dim=0)


class _MaxEigApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeffs, direction, gate, channel_dim, grad_scale):
        ctx.save_for_backward(x, coeffs, direction, gate)
        ctx.args = (channel_dim, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x, coeffs, direction, gate = ctx.saved_tensors
        channel_dim, grad_scale = ctx.args
        with torch.enable_grad():
            xf = x.detach().float().requires_grad_(True)
            xm = _channels_last(xf, channel_dim)
            x_var = (xm ** 2).mean()
            resid = xm - coeffs * direction
            vp = (x_var - (resid ** 2).mean()) / (x_var + 1.0e-20)
            (pg,) = torch.autograd.grad(vp, xf)
        extra = _rescaled_extra(g, pg, grad_scale)
        return g + (gate * extra).to(g.dtype), None, None, None, None, None


def max_eig(x: torch.Tensor, direction: torch.Tensor, channel_dim: int = -1,
            max_var_per_eig: float = 0.2, grad_scale: float = 0.01
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MaxEig step. Returns ``(x_out, new_direction,
    variance_proportion)``: ``x_out`` is ``x`` with the gradient surgery
    attached (active iff the proportion reaches ``max_var_per_eig``),
    ``new_direction`` the updated power-method state (normalize(0.1 * prev +
    step), ``direction`` itself where that is not finite)."""
    channel_dim %= x.dim()
    with torch.no_grad():
        xm = _channels_last(x.float(), channel_dim)
        coeffs = (xm * direction).sum(dim=1, keepdim=True) + 1.0e-10
        cur_dir = (xm * coeffs).sum(dim=0) / ((coeffs ** 2).sum() + 1.0e-20)
        x_var = (xm ** 2).mean()
        resid = xm - coeffs * cur_dir
        vp = (x_var - (resid ** 2).mean()) / (x_var + 1.0e-20)
        mixed = 0.1 * direction + cur_dir
        mixed = mixed / torch.linalg.vector_norm(mixed)
        new_direction = torch.where(torch.isfinite(mixed.sum()), mixed,
                                    direction)
        gate = (vp >= max_var_per_eig).float()
    y = _MaxEigApply.apply(x, coeffs, cur_dir, gate, channel_dim, grad_scale)
    return y, new_direction, vp


class _WithLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.y_meta = (y.shape, y.dtype, y.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.y_meta
        return g, torch.ones(shape, dtype=dtype, device=device)


def with_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Returns ``x`` but adds ``y.sum()`` to whatever loss the output feeds
    (the backward sends ones into ``y``)."""
    return _WithLoss.apply(x, y)
