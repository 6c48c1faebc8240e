"""The SSR LM with the MLA + MoE block in plain PyTorch, float32, over one
whole unpadded [text ; audio] sequence: no cache, no kernel, no batching.
It imports nothing of the port, so the tests hold the port's cached,
batched and kernel paths against an independent forward pass.

The block is DeepSeek-V3's layer as Moonlight-16B-A3B's ``config.json``
gives it (https://huggingface.co/moonshotai/Moonlight-16B-A3B): RMSNorm,
latent attention without a query LoRA (q from one product, [c | k_pe] from
another, c normalised, k_nope and v per head from c, RoPE on the rope dims
of q and on k_pe, which the heads share, softmax scale (nope + rope)^-0.5),
a dense SwiGLU first, then layers of sigmoid-routed experts (the top k of
score + e_bias, the chosen scores normalised to sum 1 and scaled) plus the
shared experts. Departures from the published model, each kept by the port
too:

- SSR-Speech's token space, input layer and heads in place of the
  163,840-id embedding and output head: the text ids embedded plus a
  sinusoid times alpha, the sum of the K codebook embeddings plus its own
  sinusoid times alpha, and SSR's K two-layer GELU heads;
- RoPE positions as SSR's sinusoids count: the text from 0 and the audio
  from 0 (DeepSeek-V3 counts the whole sequence);
- DeepSeek-V3's rotation of interleaved pairs, returned de-interleaved.

Layouts are those of the port's parameter tree (``models/mla_moe.py``),
read here by name: attention and dense matrices [in, out], the experts'
[out, in].
"""

from __future__ import annotations

import math
from typing import Optional

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


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x [n, ..., r] at positions pos [n]: pairs (2i, 2i+1) rotated by
    pos * theta^(-2i/r), evens first in the result."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float().reshape(-1, *([1] * (x.dim() - 1))) * inv
    ev, od = x[..., 0::2], x[..., 1::2]
    return torch.cat([ev * torch.cos(ang) - od * torch.sin(ang),
                      od * torch.cos(ang) + ev * torch.sin(ang)], -1)


class PlainMLAMoE:
    """``params``: the port's parameter tree (nested dicts of tensors);
    ``cfg``: an object with the block's sizes as attributes (the port's
    ``MLAMoEConfig`` names)."""

    def __init__(self, params, cfg):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p, self.cfg = params, cfg
        self.device = params["text_emb"].device

    def _t(self, *path) -> torch.Tensor:
        node = self.p
        for key in path:
            node = node[key]
        return node.float()

    def _moe(self, b, m):
        cfg = self.cfg
        s = torch.sigmoid(b @ self._t("decoder", "moe", "router")[m])
        idx = torch.topk(s + self._t("decoder", "moe", "e_bias")[m],
                         cfg.num_experts_per_tok, dim=-1).indices
        w = s.gather(-1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
        gu_all = self._t("decoder", "moe", "experts_gu")[m]
        dn_all = self._t("decoder", "moe", "experts_down")[m]
        Fe = gu_all.shape[1] // 2
        out = torch.zeros_like(b)
        for e in range(gu_all.shape[0]):
            rows, slots = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            x = b[rows]
            hmid = F.silu(x @ gu_all[e, :Fe].T) * (x @ gu_all[e, Fe:].T)
            out.index_add_(0, rows, w[rows, slots, None] * (hmid @ dn_all[e].T))
        gu, dn = self._t("decoder", "moe", "shared_gu")[m], self._t("decoder", "moe", "shared_down")[m]
        g, u = (b @ gu).chunk(2, -1)
        return out + (F.silu(g) * u) @ dn

    @torch.no_grad()
    def hidden(self, text, audio) -> torch.Tensor:
        """text [Sx] ids, audio [K, Sa] ids -> the final-norm hidden state of
        every audio position [Sa, D]."""
        cfg, dev = self.cfg, self.device
        H, nope, rope_d, r = (cfg.nhead, cfg.qk_nope_head_dim,
                              cfg.qk_rope_head_dim, cfg.kv_lora_rank)
        eps = cfg.rms_norm_eps
        x = torch.as_tensor(np.asarray(text), device=dev, dtype=torch.long)
        y = torch.as_tensor(np.asarray(audio), device=dev, dtype=torch.long)
        pe = sine_table(max(len(x), y.shape[1]), cfg.d_model, dev)
        h_x = self._t("text_emb")[x] + self._t("text_pos_alpha") * pe[:len(x)]
        h_y = sum(self._t("audio_emb")[k][y[k]] for k in range(y.shape[0]))
        h_y = h_y + self._t("audio_pos_alpha") * pe[:y.shape[1]]
        h = torch.cat([h_x, h_y], 0)
        n = h.shape[0]
        pos = torch.cat([torch.arange(len(x)), torch.arange(y.shape[1])]).to(dev)
        causal = torch.triu(torch.full((n, n), float("-inf"), device=dev), 1)
        L = self._t("decoder", "layers", "wq_kva").shape[0]
        n_dense = self._t("decoder", "dense", "gu").shape[0]
        for l in range(L):
            lay = lambda k: self._t("decoder", "layers", k)[l]
            a = rms_norm(h, lay("attn_norm"), eps)
            proj = a @ lay("wq_kva")
            q = proj[:, :H * (nope + rope_d)].reshape(n, H, nope + rope_d)
            c = rms_norm(proj[:, H * (nope + rope_d):H * (nope + rope_d) + r],
                         lay("kv_norm"), eps)
            k_pe = rope(proj[:, H * (nope + rope_d) + r:], pos, cfg.rope_theta)
            q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, cfg.rope_theta)], -1)
            k_nope = torch.einsum("tc,hnc->thn", c, lay("kvb_k"))
            v = torch.einsum("tc,hcv->thv", c, lay("kvb_v"))
            k = torch.cat([k_nope, k_pe[:, None].expand(n, H, rope_d)], -1)
            s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rope_d) + causal
            o = torch.einsum("hqk,khv->qhv", torch.softmax(s, -1), v)
            h = h + o.reshape(n, -1) @ lay("wo")
            b = rms_norm(h, lay("ffn_norm"), eps)
            if l < n_dense:
                g, u = (b @ self._t("decoder", "dense", "gu")[l]).chunk(2, -1)
                h = h + (F.silu(g) * u) @ self._t("decoder", "dense", "down")[l]
            else:
                h = h + self._moe(b, l - n_dense)
        h = rms_norm(h, self._t("decoder", "final_norm"), eps)
        return h[len(x):]

    @torch.no_grad()
    def logits(self, text, audio, last: int) -> torch.Tensor:
        """Logits [last, K, card] of the last ``last`` audio positions."""
        h = self.hidden(text, audio)[-last:]
        hid = F.gelu(torch.einsum("nd,kdh->nkh", h, self._t("head1_w"))
                     + self._t("head1_b"))
        return (torch.einsum("nkh,khc->nkc", hid, self._t("head2_w"))
                + self._t("head2_b"))


def decode_logits(lm: PlainMLAMoE, x, prefix, fed, *,
                  uncond_text: Optional[np.ndarray], cfg_coef: float,
                  cfg_stride: int) -> torch.Tensor:
    """The guided logits [n, K, card] of n decode steps of one span: the
    conditional row over [x ; prefix ; fed] and the unconditional row over
    [uncond_text ; prefix ; fed], mixed on every ``cfg_stride``-th step."""
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
