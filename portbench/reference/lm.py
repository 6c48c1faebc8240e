"""The SSR-Speech LM in plain PyTorch over a whole sequence: no cache, no
kernels, no batching. Pre-norm transformer (LayerNorm, one packed QKV
product, causal softmax attention, ReLU FFN), a final LayerNorm, and the K
two-layer GELU heads; the input is [text ; audio], text embedded with a
sinusoid scaled by a learned alpha, audio as the sum of the K codebook
embeddings plus its own sinusoid (SSR-Speech ``models/ssr.py``).

It computes at the precision the configuration states (``dtype``): with
bfloat16 the residual stream, every product's inputs and outputs, the
biases, the attention probabilities and values are rounded to bfloat16,
while the LayerNorm statistics, the attention scores and softmax and the
heads stay fp32 (the serving dtypes of ``configs/ssr-e830m.json``); with
float32 nothing is rounded. ``fp8=True`` is the control, one step below:
the decoder's four products take float8 e4m3 inputs (the matrices with a
scale a column, the activations with a scale a row), accumulated in fp32.

Used teacher-forced: given a prompt and the tokens the program served, one
pass gives the logits of every served position.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def sine_table(n: int, d: int, device) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((n, d), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device, torch.float32)


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t through float8 e4m3 with a scale along ``dim`` (the amax over it
    maps to 448), back to fp32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


class LM:
    """``weights``: the tree of ``lib/weights.lm_weights``; ``cfg`` the
    configuration file; ``dtype`` the decoder's stated dtype."""

    def __init__(self, weights: Dict, cfg: dict, dtype=torch.float32,
                 fp8: bool = False):
        self.w, self.cfg, self.fp8 = weights, cfg, fp8
        self.dtype = dtype
        self.device = weights["text_emb"].device
        self.pe = sine_table(cfg["max_position"], cfg["d_model"], self.device)

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        """Rounded to the stated dtype, computed on in fp32."""
        return t if self.dtype == torch.float32 else t.to(self.dtype).float()

    def _layer(self, l: int, key: str) -> torch.Tensor:
        return self.w["decoder"]["layers"][key][l].float()

    def _prod(self, x: torch.Tensor, l: int, key: str) -> torch.Tensor:
        """x @ the layer's matrix ``key``, without its bias."""
        w = self._layer(l, key)
        if self.fp8:
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return self._r(x @ w)

    def _linear(self, x, l, key):
        return self._r(self._prod(x, l, key) + self._layer(l, key[:-1] + "b"))

    def _attend(self, q, k, v, causal) -> torch.Tensor:
        """Causal softmax attention [H, n, dh]: fp32 scores and softmax,
        probabilities and output at the stated dtype."""
        s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]) + causal
        return self._r(self._r(torch.softmax(s, -1)) @ v)

    @torch.no_grad()
    def hidden(self, text: np.ndarray, audio: np.ndarray) -> torch.Tensor:
        """text [Sx] ids, audio [K, Sa] ids -> the final-norm hidden state of
        every audio position [Sa, D]."""
        w, dev, r = self.w, self.device, self._r
        H, d = self.cfg["nhead"], self.cfg["d_model"]
        x = torch.as_tensor(np.asarray(text), device=dev, dtype=torch.long)
        y = torch.as_tensor(np.asarray(audio), device=dev, dtype=torch.long)
        h_x = w["text_emb"][x].float() + w["text_pos_alpha"].float() * self.pe[:len(x)]
        h_y = sum(w["audio_emb"][k][y[k]].float() for k in range(y.shape[0]))
        h_y = h_y + w["audio_pos_alpha"].float() * self.pe[:y.shape[1]]
        h = r(torch.cat([h_x, h_y], 0))
        n = h.shape[0]
        causal = torch.triu(torch.full((n, n), float("-inf"), device=dev), 1)
        for l in range(self.cfg["num_layers"]):
            hn = r(layer_norm(h, self._layer(l, "ln1_w"), self._layer(l, "ln1_b")))
            qkv = self._linear(hn, l, "qkv_w")
            q, k, v = (t.reshape(n, H, d // H).transpose(0, 1)
                       for t in qkv.split(d, -1))
            a = self._attend(q, k, v, causal).transpose(0, 1).reshape(n, d)
            h = r(h + self._linear(a, l, "out_w"))
            hn = r(layer_norm(h, self._layer(l, "ln2_w"), self._layer(l, "ln2_b")))
            ff = torch.relu(self._linear(hn, l, "ffn1_w"))
            # the last residual as served: (h + ff @ w2) + b2
            h = r(r(h + self._prod(ff, l, "ffn2_w")) + self._layer(l, "ffn2_b"))
        h = r(layer_norm(h, w["decoder"]["final_ln_w"].float(),
                         w["decoder"]["final_ln_b"].float()))
        return h[len(x):]

    @torch.no_grad()
    def logits(self, text, audio, last: int) -> torch.Tensor:
        """Logits [last, K, card] (fp32 heads) of the last ``last`` audio
        positions."""
        h = self.hidden(text, audio)[-last:]
        w = self.w
        hid = F.gelu(torch.einsum("nd,kdh->nkh", h, w["head1_w"].float())
                     + w["head1_b"].float())
        return (torch.einsum("nkh,khc->nkc", hid, w["head2_w"].float())
                + w["head2_b"].float())


def decode_logits(lm: LM, x: np.ndarray, prefix: np.ndarray, fed: np.ndarray,
                  *, uncond_text: Optional[np.ndarray], cfg_coef: float,
                  cfg_stride: int) -> torch.Tensor:
    """The guided logits [n, K, card] the decode sampled each of its n steps
    from: the conditional row over [x ; prefix ; fed], and, when
    ``uncond_text`` is given, the unconditional row over [uncond_text ;
    prefix ; fed], mixed as cfg_coef * cond + (1 - cfg_coef) * uncond on
    every ``cfg_stride``-th step of the span and the conditional row alone
    on the others."""
    n = fed.shape[1]
    audio = np.concatenate([prefix, fed], 1)
    cond = lm.logits(x, audio, n)
    if uncond_text is None:
        return cond
    uncond = lm.logits(uncond_text, audio, n)
    mix = torch.zeros(n, dtype=torch.bool, device=cond.device)
    mix[cfg_stride - 1::cfg_stride] = True
    return torch.where(mix[:, None, None],
                       cfg_coef * cond + (1.0 - cfg_coef) * uncond, cond)


def served_gap(ref: torch.Tensor, served: np.ndarray, vocab: int,
               pick: Optional[torch.Tensor] = None):
    """The gaps by which a served token's reference logit lies below the
    reference's best audio token, over the positions where the served
    token is an audio token (specials are forced by the decode's rules, not
    chosen). ``ref`` [n, K, card]; ``served`` [K, n]. With ``pick`` [n, K]
    (another run's choice at the same positions, e.g. the control's) that
    choice is read instead of the served token. Returns (widest gap, the
    gaps' sum, positions compared)."""
    tok = torch.as_tensor(np.asarray(served).T, device=ref.device, dtype=torch.long)
    free = tok < vocab
    audio = ref[..., :vocab]
    chosen = tok if pick is None else pick
    gap = audio.max(-1).values - audio.gather(-1, chosen.clamp(max=vocab - 1)
                                              [..., None])[..., 0]
    gap = torch.where(free, gap, torch.zeros_like(gap))
    if not bool(free.any()):
        return 0.0, 0.0, 0
    return float(gap.max()), float(gap.sum()), int(free.sum())
