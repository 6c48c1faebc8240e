"""Codec training losses (port of ``ssr_speech_tpu/training/losses.py``):
time and spectral reconstruction, the multi-scale mel loss, the adversarial
criteria, feature matching, the watermark cross-entropy and the gradient
balancer.

The balancer works on gradients with respect to the generator's OUTPUT: the
caller takes one ``torch.autograd.grad`` per balanced loss on the output,
:func:`balancer_cotangent` combines them into one cotangent with the EMA
rescaling, and one pullback carries it through the generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..ops import stft as stft_ops


def l1_loss(x, y):
    """Mean |x - y| accumulated in fp32 (feature maps may be bf16)."""
    return (x - y).abs().mean(dtype=torch.float32)


def l2_loss(x, y):
    d = (x - y).float()
    return (d * d).mean()


def mel_l1_loss(x, y, sr: int, n_fft: int = 1024, hop: int = 256,
                win_length: int = 1024, n_mels: int = 64, f_min: float = 64.0,
                f_max=None, floor_level: float = 1e-5):
    """Log-mel L1 (MelSpectrogramL1Loss)."""
    kw = dict(log=True, floor_level=floor_level)
    sx = stft_ops.mel_spectrogram(x, sr, n_fft, hop, win_length, n_mels,
                                  f_min, f_max, **kw)
    sy = stft_ops.mel_spectrogram(y, sr, n_fft, hop, win_length, n_mels,
                                  f_min, f_max, **kw)
    return l1_loss(sx, sy)


def multiscale_mel_loss(x, y, sr: int, range_start: int = 6,
                        range_end: int = 11, n_mels: int = 64,
                        f_min: float = 64.0, f_max=None,
                        normalized: bool = True, alphas: bool = False,
                        floor_level: float = 1e-5):
    """MultiScaleMelSpectrogramLoss: per scale 2^i, L1 on the linear mel
    plus alpha times the MSE of the log mel."""
    loss = 0.0
    total = 0.0
    for i in range(range_start, range_end):
        n_fft = 2 ** i
        hop = n_fft // 4
        alpha = (2 ** i - 1) ** 0.5 if alphas else 1.0
        kw = dict(log=False, normalized=normalized, floor_level=floor_level)
        lin_x = stft_ops.mel_spectrogram(x, sr, n_fft, hop, n_fft, n_mels,
                                         f_min, f_max, **kw)
        lin_y = stft_ops.mel_spectrogram(y, sr, n_fft, hop, n_fft, n_mels,
                                         f_min, f_max, **kw)
        log_x = torch.log10(floor_level + lin_x)
        log_y = torch.log10(floor_level + lin_y)
        loss = loss + l1_loss(lin_x, lin_y) + alpha * l2_loss(log_x, log_y)
        total += alpha + 1.0
    if normalized:
        loss = loss / total
    return loss


def mrstft_loss(x, y, n_ffts=(1024, 2048, 512), factor_sc: float = 0.5,
                factor_mag: float = 0.5, eps: float = 1e-8):
    """Multi-resolution STFT loss: spectral convergence plus log-magnitude
    L1 over several resolutions."""
    loss = 0.0
    if x.dim() == 3:
        x = x[..., 0]
        y = y[..., 0]
    for n_fft in n_ffts:
        hop = n_fft // 4
        sx = stft_ops.stft(x, n_fft, hop).abs() + eps
        sy = stft_ops.stft(y, n_fft, hop).abs() + eps
        sc = (torch.linalg.vector_norm(sy - sx)
              / (torch.linalg.vector_norm(sy) + eps))
        mag = l1_loss(torch.log(sx), torch.log(sy))
        loss = loss + factor_sc * sc + factor_mag * mag
    return loss / len(n_ffts)


# ---------------------------------------------------------------- adversarial

def hinge_gen_loss(logits):
    """Generator hinge: -mean(D(fake))."""
    return -logits.mean(dtype=torch.float32)


def hinge_real_loss(logits):
    return -torch.clamp(logits - 1.0, max=0.0).mean(dtype=torch.float32)


def hinge_fake_loss(logits):
    return -torch.clamp(-logits - 1.0, max=0.0).mean(dtype=torch.float32)


def mse_gen_loss(logits):
    return l2_loss(logits, torch.ones_like(logits))


def mse_real_loss(logits):
    return l2_loss(logits, torch.ones_like(logits))


def mse_fake_loss(logits):
    return l2_loss(logits, torch.zeros_like(logits))


def feature_matching_loss(fmaps_fake: List[torch.Tensor],
                          fmaps_real: List[torch.Tensor]):
    """L1 feature matching averaged over layers."""
    loss = 0.0
    for ff, fr in zip(fmaps_fake, fmaps_real):
        loss = loss + l1_loss(ff, fr)
    return loss / max(len(fmaps_fake), 1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions (the watermark classifier's loss)."""
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - tgt).mean()


# ------------------------------------------------------------------ balancer

@dataclass
class BalancerState:
    """EMA of each balanced loss's gradient norm and the update count (for
    the EMA's bias correction); leaf for leaf the JAX ``BalancerState``."""

    ema: Dict[str, torch.Tensor]
    count: torch.Tensor


def init_balancer(names, device="cpu") -> BalancerState:
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return BalancerState(ema={n: zero() for n in names}, count=zero())


def balancer_cotangent(
    state: BalancerState,
    grads: Dict[str, torch.Tensor],
    weights: Dict[str, float],
    losses: Dict[str, torch.Tensor],
    *,
    total_norm: float = 1.0,
    ema_decay: float = 0.999,
    per_batch_item: bool = True,
    epsilon: float = 1e-12,
) -> Tuple[torch.Tensor, BalancerState, torch.Tensor]:
    """Combine the per-loss output gradients into one cotangent.

    ``grads[name]`` is d loss_name / d output, all of one shape. Returns
    (cotangent, new state, effective loss). The running average is
    ``avg * decay + v * (1 - decay)``, bias-corrected by
    ``1 - decay ** count``."""
    norms = {}
    for name, g in grads.items():
        if per_batch_item:
            dims = tuple(range(1, g.dim()))
            norms[name] = torch.sqrt((g * g).sum(dim=dims) + 0.0).mean()
        else:
            norms[name] = torch.sqrt((g * g).sum())
    count = state.count + 1.0
    bias = 1.0 - torch.tensor(ema_decay, dtype=torch.float32,
                              device=count.device) ** count
    new_ema = {n: state.ema[n] * ema_decay + norms[n] * (1.0 - ema_decay)
               for n in norms}
    avg_norms = {n: new_ema[n] / bias for n in norms}

    total_weights = sum(weights[n] for n in norms)
    out = None
    eff_loss = 0.0
    for name, avg in avg_norms.items():
        ratio = weights[name] / total_weights
        scale = ratio * total_norm / (epsilon + avg)
        contrib = grads[name] * scale
        out = contrib if out is None else out + contrib
        eff_loss = eff_loss + scale * losses[name].detach()
    return out, BalancerState(new_ema, count), eff_loss
