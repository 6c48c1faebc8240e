"""STFT and mel-spectrogram primitives (port of ``ssr_speech_tpu/ops/stft.py``).

They match the torchaudio transforms the reference losses use: frames of a
periodic Hann window with ``center=False``, the power spectrogram for the mel
losses and the complex one for the discriminators, ``normalized=True``
dividing by the window's L2 norm, and the HTK mel filterbank with no norm.
Frames come from ``Tensor.unfold`` ([..., frames, n_fft]) and one
``torch.fft.rfft`` (cuFFT on the card); the output has torchaudio's
[..., freq, frames] layout.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """torch.hann_window(periodic=True), as float32 numpy."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)


def frame(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """x [..., T] -> [..., n_frames, n_fft], center=False."""
    if x.shape[-1] < n_fft:
        return x.new_zeros(x.shape[:-1] + (0, n_fft))
    return x.unfold(-1, n_fft, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int,
         win_length: Optional[int] = None,
         normalized: bool = False) -> torch.Tensor:
    """x [..., T] -> complex [..., freq, frames]."""
    win_length = win_length or n_fft
    win = hann_window(win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        win = np.pad(win, (pad, n_fft - win_length - pad))
    frames = frame(x, n_fft, hop) * torch.from_numpy(win).to(x.device)
    if frames.shape[-2] == 0:  # no full frame (an empty FFT may not run)
        return torch.zeros(frames.shape[:-2] + (n_fft // 2 + 1, 0),
                           dtype=torch.complex64, device=x.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    if normalized:
        spec = spec / float(np.sqrt(np.sum(win ** 2)))
    return spec.transpose(-1, -2)


@functools.lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float,
                   f_max: Optional[float]) -> np.ndarray:
    """HTK-scale triangular filters [n_freqs, n_mels] (torchaudio
    melscale_fbanks, mel_scale='htk', norm=None). Cached: treat as
    read-only."""
    f_max = f_max if f_max is not None else sr / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sr: int, n_fft: int, hop: int,
                    win_length: Optional[int] = None, n_mels: int = 64,
                    f_min: float = 0.0, f_max: Optional[float] = None,
                    log: bool = False, normalized: bool = False,
                    floor_level: float = 1e-5) -> torch.Tensor:
    """The reference MelSpectrogramWrapper: reflect-pad (n_fft - hop) // 2
    each side, zero-pad the tail so every frame is full, power-2
    spectrogram, mel projection, optional log10 with a floor.

    x: [B, T] or [B, T, C] -> [B, n_mels * C, frames]."""
    x = x.movedim(-1, 1) if x.dim() == 3 else x[:, None, :]  # [B, C, T]
    p = int((n_fft - hop) // 2)
    x = F.pad(x, (p, p), mode="reflect")
    t = x.shape[-1]
    n_frames = math.ceil(max(t - n_fft, 0) / hop) + 1
    ideal = (n_frames - 1) * hop + n_fft
    if ideal > t:
        x = F.pad(x, (0, ideal - t))
    spec = stft(x, n_fft, hop, win_length, normalized=normalized)
    power = spec.abs() ** 2  # [B, C, freq, frames]
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, f_min, f_max)
                          ).to(power.device)
    mel = torch.einsum("bcft,fm->bcmt", power, fb)
    if log:
        mel = torch.log10(floor_level + mel)
    b, c, m, fr = mel.shape
    return mel.reshape(b, c * m, fr)
