"""The SSR LM with Moonlight-16B-A3B's block (DeepSeek-V3's layer: latent
attention and sigmoid-routed experts) in plain PyTorch over a whole
sequence: no cache, no kernels, no batching. The benchmark's copy of
``tests/plain_mla_moe.py`` (which the CPU tests hold the port against),
here at the precision the configuration states.

Per layer, with no biases: a = RMSNorm(h); [q | c | k_pe] = a W_qkva; c =
RMSNorm(c); per head k_nope = c W_k^T and v = c W_v; RoPE (theta 50,000) on
the rope dims of q and on k_pe, which the heads share; softmax over
(q_nope.k_nope + q_pe.k_pe) / sqrt(192), causal; h += o W_o; b = RMSNorm(h);
then a dense SwiGLU (layer 0), or the top 6 of 64 experts by sigmoid score
+ e_bias, their scores normalised to sum 1 and scaled by 2.446, each a
SwiGLU, plus the shared SwiGLU. A final RMSNorm, then SSR-Speech's K heads.

Departures from the published model, all kept by the program too: SSR's
token space, input layer (text and the sum of the K codebook embeddings,
each plus its sinusoid times alpha) and heads in place of the 163,840-id
embedding and output head; RoPE positions counted as SSR's sinusoids count,
the text from 0 and the audio from 0; DeepSeek-V3's rotation of the
interleaved pairs of the rope dims, returned de-interleaved.

Precision (``dtype``): with bfloat16 the residual stream, every product's
inputs and outputs, the latents, the attention probabilities and values,
silu(gate) * up and each expert's output are rounded to bfloat16, while the
RMSNorm statistics, RoPE, the router's product and scores, the attention
scores and softmax, the weighted sum of the experts and the heads stay fp32
(``configs/ssr-moonlight-a3b-greedy.json`` ``dtypes``); with float32 nothing
is rounded. ``fp8=True`` is the control, one step below: every product of
the block (not the router's) takes float8 e4m3 inputs (the matrices with a
scale an output column, the activations with a scale a row), accumulated in
fp32.

The weights of one layer are widened to fp32 as the layer runs, so the
whole model is held once, in its served dtype.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.lm import fp8_round, sine_table


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, ..., r] at positions pos [n]: the pairs (2i, 2i+1) rotated by
    pos * theta^(-2i/r), evens first in the result (fp32)."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float().reshape(-1, *([1] * (x.dim() - 1))) * inv
    ev, od = x[..., 0::2], x[..., 1::2]
    return torch.cat([ev * torch.cos(ang) - od * torch.sin(ang),
                      od * torch.cos(ang) + ev * torch.sin(ang)], -1)


class LM:
    """``weights``: the tree of ``lib/weights_mla_moe.lm_weights``; ``cfg``
    the configuration file; ``dtype`` the block's stated dtype."""

    def __init__(self, weights: Dict, cfg: dict, dtype=torch.float32,
                 fp8: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.w, self.cfg, self.fp8, self.dtype = weights, cfg, fp8, dtype
        self.device = weights["text_emb"].device
        # with record_margins, each logits call appends to margins the least
        # margin over the MoE layers of its positions' routing: the k-th
        # best score + e_bias less the (k + 1)-th (how near the choice was
        # to a tie)
        self.record_margins, self.margins, self._margin = False, [], None

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        """Rounded to the stated dtype, computed on in fp32."""
        return t if self.dtype == torch.float32 else t.to(self.dtype).float()

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w ([in, out]) in fp32, rounded; fp8 inputs in the control."""
        w = w.float()
        if self.fp8:
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return self._r(x @ w)

    def _norm(self, x, w):
        eps = self.cfg["rms_norm_eps"]
        return self._r(x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
                       * w.float())

    def _swiglu(self, x, gate, up, down):
        """SwiGLU with gate, up and down given as [in, out]."""
        g, u = self._mm(x, gate), self._mm(x, up)
        return self._mm(self._r(F.silu(g) * u), down)

    def _moe(self, b: torch.Tensor, m: int) -> torch.Tensor:
        cfg, moe = self.cfg, self.w["decoder"]["moe"]
        s = torch.sigmoid(b @ moe["router"][m].float())
        k = cfg["num_experts_per_tok"]
        top = torch.topk(s + moe["e_bias"][m].float(), min(k + 1, s.shape[-1]),
                         dim=-1)
        idx = top.indices[:, :k]
        if self._margin is not None and top.values.shape[-1] > k:
            self._margin = torch.minimum(
                self._margin, top.values[:, k - 1] - top.values[:, k])
        wt = s.gather(-1, idx)
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
        Fe = cfg["moe_intermediate_size"]
        out = torch.zeros_like(b)
        for e in range(cfg["n_routed_experts"]):
            rows, slots = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            gu, dn = moe["experts_gu"][m, e], moe["experts_down"][m, e]
            y = self._swiglu(b[rows], gu[:Fe].T, gu[Fe:].T, dn.T)
            out.index_add_(0, rows, wt[rows, slots, None] * y)
        gu, dn = moe["shared_gu"][m], moe["shared_down"][m]
        half = gu.shape[1] // 2
        return self._r(out + self._swiglu(b, gu[:, :half], gu[:, half:], dn))

    def _embed(self, text, audio):
        """text [Sx] ids, audio [K, Sa] ids -> (the input layer's [Sx + Sa,
        D], the RoPE positions)."""
        cfg, w, dev = self.cfg, self.w, self.device
        x = torch.as_tensor(np.asarray(text), device=dev, dtype=torch.long)
        y = torch.as_tensor(np.asarray(audio), device=dev, dtype=torch.long)
        pe = sine_table(max(len(x), y.shape[1]), cfg["hidden_size"], dev)
        h_x = w["text_emb"][x].float() + w["text_pos_alpha"].float() * pe[:len(x)]
        h_y = sum(w["audio_emb"][k][y[k]].float() for k in range(y.shape[0]))
        h_y = h_y + w["audio_pos_alpha"].float() * pe[:y.shape[1]]
        pos = torch.cat([torch.arange(len(x)), torch.arange(y.shape[1])]).to(dev)
        return self._r(torch.cat([h_x, h_y], 0)), pos

    def _layer(self, l: int, h, pos, mask, before_moe=None):
        """Layer ``l`` over h [n, D] at RoPE positions ``pos`` [n], ``mask``
        [n, n] added to the scores (0 or -inf). ``before_moe(b, m)``, if
        given, sees a MoE layer's normalised input before its routing."""
        cfg, r = self.cfg, self._r
        H, nope, rope_d, lat = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                                cfg["qk_rope_head_dim"], cfg["kv_lora_rank"])
        lay, dense = self.w["decoder"]["layers"], self.w["decoder"]["dense"]
        n = h.shape[0]
        a = self._norm(h, lay["attn_norm"][l])
        proj = self._mm(a, lay["wq_kva"][l])
        q = proj[:, :H * (nope + rope_d)].reshape(n, H, nope + rope_d)
        c = self._norm(proj[:, H * (nope + rope_d):H * (nope + rope_d) + lat],
                       lay["kv_norm"][l])
        k_pe = r(rope(proj[:, H * (nope + rope_d) + lat:], pos, cfg["rope_theta"]))
        q = torch.cat([q[..., :nope],
                       r(rope(q[..., nope:], pos, cfg["rope_theta"]))], -1)
        kvb_k, kvb_v = lay["kvb_k"][l], lay["kvb_v"][l]  # [H, nope, lat], [H, lat, v]
        k_nope = torch.stack([self._mm(c, kvb_k[hh].T) for hh in range(H)], 1)
        v = torch.stack([self._mm(c, kvb_v[hh]) for hh in range(H)], 1)
        k = torch.cat([k_nope, k_pe[:, None].expand(n, H, rope_d)], -1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rope_d) + mask
        o = r(torch.einsum("hqk,khv->qhv", r(torch.softmax(s, -1)), v))
        h = r(h + self._mm(o.reshape(n, -1), lay["wo"][l]))
        b = self._norm(h, lay["ffn_norm"][l])
        n_dense = cfg["first_k_dense_replace"]
        if l < n_dense:
            gu = dense["gu"][l]
            half = gu.shape[1] // 2
            f = self._swiglu(b, gu[:, :half], gu[:, half:], dense["down"][l])
        else:
            if before_moe is not None:
                before_moe(b, l - n_dense)
            f = self._moe(b, l - n_dense)
        return r(h + f)

    @torch.no_grad()
    def hidden(self, text: np.ndarray, audio: np.ndarray) -> torch.Tensor:
        """text [Sx] ids, audio [K, Sa] ids -> the final-norm hidden state of
        every audio position [Sa, D]."""
        h, pos = self._embed(text, audio)
        n = h.shape[0]
        causal = torch.triu(torch.full((n, n), float("-inf"), device=self.device), 1)
        if self.record_margins:
            self._margin = torch.full((n,), float("inf"), device=self.device)
        for l in range(self.cfg["num_hidden_layers"]):
            h = self._layer(l, h, pos, causal)
        h = self._norm(h, self.w["decoder"]["final_norm"])
        if self.record_margins:
            self.margins.append(self._margin[len(text):])
            self._margin = None
        return h[len(text):]

    @torch.no_grad()
    def balance_e_bias(self, seqs, steps: int, gamma: float, decay: float):
        """DeepSeek-V3's bias update (``noaux_tc``: bias -= gamma *
        sign(load - mean load)) on every MoE layer's ``e_bias``, in place,
        over the sequences ``seqs`` ((text, audio) pairs) run together,
        layer by layer: from 0, ``steps`` updates of the layer's routing of
        every token on its own input, gamma shrinking by ``decay`` a step,
        before the layer's experts run on the balanced choice."""
        cfg = self.cfg
        E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
        parts = [self._embed(t, a) for t, a in seqs]
        h = torch.cat([p[0] for p in parts])
        pos = torch.cat([p[1] for p in parts])
        seg = torch.cat([torch.full((len(p[1]),), i, device=self.device)
                         for i, p in enumerate(parts)])
        i = torch.arange(len(pos), device=self.device)
        open_ = (seg[:, None] == seg[None, :]) & (i[None, :] <= i[:, None])
        mask = torch.zeros(open_.shape, device=self.device).masked_fill(
            ~open_, float("-inf"))
        moe = self.w["decoder"]["moe"]

        def balance(b, m):
            s = torch.sigmoid(b @ moe["router"][m].float())
            bias, g = torch.zeros(E, device=self.device), gamma
            for _ in range(steps):
                idx = torch.topk(s + bias, k, dim=-1).indices
                load = torch.bincount(idx.reshape(-1), minlength=E).float()
                bias -= g * torch.sign(load - load.mean())
                g *= decay
            moe["e_bias"][m].copy_(bias)

        for l in range(cfg["num_hidden_layers"]):
            h = self._layer(l, h, pos, mask, before_moe=balance)

    @torch.no_grad()
    def logits(self, text, audio, last: int) -> torch.Tensor:
        """Logits [last, K, card] (fp32 heads) of the last ``last`` audio
        positions."""
        h = self.hidden(text, audio)[-last:]
        if self.record_margins:
            self.margins[-1] = self.margins[-1][-last:]
        w = self.w
        hid = F.gelu(torch.einsum("nd,kdh->nkh", h, w["head1_w"].float())
                     + w["head1_b"].float())
        return (torch.einsum("nkh,khc->nkc", hid, w["head2_w"].float())
                + w["head2_b"].float())
