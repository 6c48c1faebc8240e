"""Pre-norm transformer decoder with a preallocated KV cache (port of
``ssr_speech_tpu/models/transformer.py``).

Parameters keep the JAX layout: every layer's tensors are stacked on a leading
[L] axis and matmul weights are [in, out] (``x @ w``), so the weights of a JAX
bundle are used as they are. The layer loop is a plain Python loop over views
of the stacked tensors. LayerNorm statistics, attention scores and softmax run
in fp32 whatever the compute dtype, as in JAX.

The full-sequence attention of the prefill and of the training forward goes
through ``ops.flash_attention.flash_attend_xy`` (the hand-written Hopper
kernels on CUDA, forward and backward); the one-token decode attention stays
plain matmul/softmax, as JAX leaves it to XLA einsums.

Matmul weights are cast to the activations' dtype at each use, as JAX casts
them: a no-op for the serving path's stored bf16 (or fp32) weights, and the
bf16 compute copy of the trainer's fp32 master weights. The training forward
draws its inverted dropout from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import SSRModelConfig

from ..ops.flash_attention import flash_attend_xy

LAYER_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b", "ln2_w",
              "ln2_b", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b")
# the decoder tensors that run in the compute dtype (bf16 on CUDA); norms stay
# fp32 because layer_norm applies its affine in fp32
MATMUL_KEYS = ("qkv_w", "qkv_b", "out_w", "out_b", "ffn1_w", "ffn1_b",
               "ffn2_w", "ffn2_b")


def _uniform(gen, shape, bound, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-bound, bound, generator=gen)


def _linear_init(gen, fan_in, shape_w, shape_b, device):
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return (_uniform(gen, shape_w, bound, device),
            _uniform(gen, shape_b, bound, device))


def init_transformer(gen: torch.Generator, cfg: SSRModelConfig,
                     device) -> Dict[str, object]:
    """Stacked parameters for L pre-norm layers + final norm, with the JAX
    init's distributions (xavier-uniform packed QKV, zero QKV bias, torch
    Linear default elsewhere)."""
    d, f, L = cfg.d_model, cfg.ffn_dim, cfg.num_layers
    limit = math.sqrt(6.0 / (d + 3 * d))
    ones = lambda *s: torch.ones(s, device=device)
    zeros = lambda *s: torch.zeros(s, device=device)
    out_w, out_b = _linear_init(gen, d, (L, d, d), (L, d), device)
    ffn1_w, ffn1_b = _linear_init(gen, d, (L, d, f), (L, f), device)
    ffn2_w, ffn2_b = _linear_init(gen, f, (L, f, d), (L, d), device)
    layers = dict(
        ln1_w=ones(L, d), ln1_b=zeros(L, d),
        qkv_w=_uniform(gen, (L, d, 3 * d), limit, device),
        qkv_b=zeros(L, 3 * d), out_w=out_w, out_b=out_b,
        ln2_w=ones(L, d), ln2_b=zeros(L, d),
        ffn1_w=ffn1_w, ffn1_b=ffn1_b, ffn2_w=ffn2_w, ffn2_b=ffn2_b)
    return dict(layers=layers, final_ln_w=ones(d), final_ln_b=zeros(d))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (JAX ``transformer._dropout``): keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate). The draw
    comes from ``generator``, so a seeded generator repeats it."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when not deterministic")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep, x / (1.0 - rate), zero)


def _split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, nhead, d // nhead).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _attend(q, k, v, bias):
    """q [B,H,Tq,Dh] x k/v [B,H,Tk,Dh] with additive fp32 bias [B,1,Tq,Tk]:
    fp32 scores and softmax, probabilities cast to q's dtype."""
    dh = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(dh) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _ffn_act(cfg: SSRModelConfig):
    if cfg.activation != "relu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported (the shipped SSR "
            "config uses relu)")
    return F.relu


def layer_params(params) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views [l] of the stacked decoder tensors."""
    stacked = {k: params["layers"][k] for k in LAYER_KEYS}
    n = stacked["qkv_w"].shape[0]
    return [{k: t[l] for k, t in stacked.items()} for l in range(n)]


def _linear(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _qkv(lp, hn, nhead):
    qkv = _linear(hn, lp["qkv_w"], lp["qkv_b"])
    return [_split_heads(t, nhead) for t in qkv.chunk(3, dim=-1)]


def _post_attention(lp, h, attn, act, *, bias_last: bool, drop=None):
    """out projection + residual, then the FFN block + residual; ``drop`` is
    the training forward's dropout at JAX's three places.

    ``bias_last`` keeps the JAX prefill/decode order of the last residual,
    ``(h + ff @ w2) + b2``; the training forward adds ``h + (ff @ w2 + b2)``.
    The two round differently in fp32, and greedy parity is held bit for
    bit."""
    drop = drop or (lambda x: x)
    h = h + drop(_linear(attn, lp["out_w"], lp["out_b"]))
    hn = layer_norm(h, lp["ln2_w"], lp["ln2_b"])
    ff = drop(act(_linear(hn, lp["ffn1_w"], lp["ffn1_b"])))
    if bias_last:
        return h + ff @ lp["ffn2_w"] + lp["ffn2_b"]
    return h + drop(_linear(ff, lp["ffn2_w"], lp["ffn2_b"]))


def transformer_forward(params, h: torch.Tensor, cfg: SSRModelConfig, *,
                        bias: Optional[torch.Tensor] = None,
                        key_valid: Optional[torch.Tensor] = None,
                        dtype: torch.dtype = torch.float32,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Full-sequence forward (training and eval). h: [B, S, D] -> [B, S, D]
    after the final LayerNorm. With ``cfg.attn_impl`` "flash"/"splash" the
    attention is the fused kernel over ``key_valid`` [B, S]; with "einsum" it
    is ``_attend`` over the additive ``bias`` [B, 1, S, S]. Unless
    ``deterministic``, ``cfg.trm_dropout`` is drawn from ``generator``."""
    act = _ffn_act(cfg)
    use_flash = cfg.attn_impl in ("flash", "splash")
    if use_flash and key_valid is None:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} needs key_valid")
    if not use_flash and bias is None:
        raise ValueError("attn_impl='einsum' needs bias")

    def drop(x):
        return dropout(x, cfg.trm_dropout, generator, deterministic)

    h = h.to(dtype)
    for lp in layer_params(params):
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = _qkv(lp, hn, cfg.nhead)
        if use_flash:
            attn = flash_attend_xy(q.contiguous(), k.contiguous(),
                                   v.contiguous(), key_valid)
        else:
            attn = _attend(q, k, v, bias.float())
        h = _post_attention(lp, h, _merge_heads(attn), act, bias_last=False,
                            drop=drop)
    return layer_norm(h, params["final_ln_w"], params["final_ln_b"])


@dataclass
class KVCache:
    """Preallocated per-layer key/value buffers and the current fill length.
    The buffers are written in place (JAX returns updated copies)."""

    k: torch.Tensor  # [L, B, H, Tmax, Dh]
    v: torch.Tensor  # [L, B, H, Tmax, Dh]
    length: int  # number of filled positions

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_kv_cache(cfg: SSRModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (cfg.num_layers, batch, cfg.nhead, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def transformer_prefill(params, h: torch.Tensor, cache: KVCache,
                        cfg: SSRModelConfig, *, key_valid: torch.Tensor,
                        dtype=torch.bfloat16) -> Tuple[torch.Tensor, KVCache]:
    """Forward over the prompt while filling the cache at ``cache.length``.

    Every layer's attention runs through ``flash_attend_xy`` with segment ids
    ``key_valid`` [B, S] (1 = attendable key, 0 = banned): a query of
    segment 1 attends exactly the causal prefix minus the banned keys, which
    is the JAX prefill's additive mask for every row whose output is read.
    Returns (hidden [B, S, D], cache)."""
    act = _ffn_act(cfg)
    h = h.to(dtype)
    start, s = cache.length, h.shape[1]
    for l, lp in enumerate(layer_params(params)):
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = (t.contiguous() for t in _qkv(lp, hn, cfg.nhead))
        cache.k[l, :, :, start:start + s] = k
        cache.v[l, :, :, start:start + s] = v
        attn = flash_attend_xy(q, k, v, key_valid)
        h = _post_attention(lp, h, _merge_heads(attn), act, bias_last=True)
    out = layer_norm(h, params["final_ln_w"], params["final_ln_b"])
    return out, KVCache(cache.k, cache.v, start + s)


def decode_bias(key_banned: torch.Tensor, length: int) -> torch.Tensor:
    """[B, 2] banned key range [lo, hi) -> additive bias [B, 1, 1, length]."""
    idx = torch.arange(length, device=key_banned.device)[None, :]
    banned = (idx >= key_banned[:, :1]) & (idx < key_banned[:, 1:2])
    zero = torch.zeros((), dtype=torch.float32, device=key_banned.device)
    return torch.where(banned, -1e9, zero)[:, None, None, :]


def transformer_decode_step(params, h_t: torch.Tensor, cache: KVCache,
                            key_banned: torch.Tensor, cfg: SSRModelConfig, *,
                            dtype=torch.bfloat16,
                            layers=None) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: h_t [B, D] at position ``cache.length``.

    key_banned: [B, 2] banned key range [lo, hi) per row (text padding and the
    CFG-unconditional row's hidden prompt). The step reads keys
    [0, length] only: JAX reads the whole buffer with the future masked,
    which adds exact zeros to the same softmax. Returns (out [B, D], cache
    advanced by one); the new K/V are written into the cache in place.
    ``layers`` may pass ``layer_params(params)`` precomputed."""
    act = _ffn_act(cfg)
    pos = cache.length
    if pos >= cache.max_len:
        raise ValueError(f"KV cache full ({cache.max_len} positions)")
    h = h_t.to(dtype)[:, None, :]
    bias = decode_bias(key_banned, pos + 1)
    for l, lp in enumerate(layers or layer_params(params)):
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = _qkv(lp, hn, cfg.nhead)
        cache.k[l, :, :, pos:pos + 1] = k
        cache.v[l, :, :, pos:pos + 1] = v
        attn = _attend(q, cache.k[l, :, :, :pos + 1],
                       cache.v[l, :, :, :pos + 1], bias)
        h = _post_attention(lp, h, _merge_heads(attn), act, bias_last=True)
    out = layer_norm(h, params["final_ln_w"], params["final_ln_b"])
    return out[:, 0, :], KVCache(cache.k, cache.v, pos + 1)
