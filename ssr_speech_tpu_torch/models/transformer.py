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

Activation checkpointing of the training forward (``remat``) wraps each layer
of the loop, with what each mode of JAX's ``wrap_remat`` keeps and none of
XLA's policy objects: ``full`` recomputes the whole layer in the backward,
``dots`` keeps the outputs of the matrix products (a selective checkpoint)
and recomputes the rest, ``dots_masks`` also keeps the dropout masks,
``mixed`` is ``dots`` (JAX's own ``mixed`` degrades to it under a layer
loop), ``none`` keeps everything. The attention kernel is no matrix product
of PyTorch's, so every mode but ``none`` launches it again in the recompute.
"""

from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..config import SSRModelConfig

from ..ops import scaling
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


# set while a dropout mask is computed: the dots_masks policy keeps what is
# made then (thread-local, as the policy runs on the forward's thread)
_in_mask = threading.local()


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (JAX ``transformer._dropout``): keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate). The draw
    comes from ``generator``, so a seeded generator repeats it."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when not deterministic")
    u = torch.rand(x.shape, generator=generator, device=x.device)
    _in_mask.on = True
    try:
        keep = u < 1.0 - rate
    finally:
        _in_mask.on = False
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


def _ffn_act(cfg: SSRModelConfig, deterministic: bool):
    """The FFN activation of ``cfg.activation``: relu (the shipped SSR
    config) or the icefall double-swish variants of ``ops.scaling``; the
    balancer's backward is active unless ``deterministic``."""
    if cfg.activation == "relu":
        return F.relu
    if cfg.activation == "double_swish":
        return scaling.double_swish
    if cfg.activation == "balanced_double_swish":
        return lambda x: scaling.balanced_double_swish(
            x, deterministic=deterministic)
    raise ValueError(cfg.activation)


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


REMAT_MODES = ("full", "dots", "dots_masks", "mixed", "none")
_MATMUL_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                         torch.ops.aten.bmm.default,
                         torch.ops.aten.baddbmm.default))


def _keep_policy(keep_masks: bool):
    """The selective checkpoint's choice per op: keep matrix products (and,
    with ``keep_masks``, the dropout masks), recompute everything else."""
    save = ckpt.CheckpointPolicy.MUST_SAVE
    recompute = ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    def policy(ctx, func, *args, **kwargs):
        if func in _MATMUL_OPS:
            return save
        if keep_masks and getattr(_in_mask, "on", False):
            return save
        return recompute

    return policy


def default_remat(attn_impl: str) -> str:
    """JAX ``train_lm``'s default: ``dots_masks`` with the fused attention,
    else ``full``."""
    return "dots_masks" if attn_impl in ("flash", "splash") else "full"


def checkpoint_layer(body, mode: str, generator: Optional[torch.Generator]):
    """``body(h) -> h`` under the remat ``mode``. A recompute draws its
    dropout from a copy of ``generator``'s state taken before the layer ran,
    and leaves ``generator`` where it was, so the masks are the forward's
    and the next step's draws are those of an un-checkpointed step."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat mode {mode!r}")
    if mode == "none":
        return body
    snap = None if generator is None else generator.get_state()
    calls = [0]

    def replayed(h):
        calls[0] += 1
        if calls[0] == 1 or snap is None:
            return body(h)
        now = generator.get_state()
        generator.set_state(snap)
        try:
            return body(h)
        finally:
            generator.set_state(now)

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if mode != "full":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _keep_policy(mode == "dots_masks"))
    return lambda h: ckpt.checkpoint(replayed, h, **kw)


def transformer_forward(params, h: torch.Tensor, cfg: SSRModelConfig, *,
                        bias: Optional[torch.Tensor] = None,
                        key_valid: Optional[torch.Tensor] = None,
                        dtype: torch.dtype = torch.float32,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None,
                        remat: str = "none") -> torch.Tensor:
    """Full-sequence forward (training and eval). h: [B, S, D] -> [B, S, D]
    after the final LayerNorm. With ``cfg.attn_impl`` "flash"/"splash" the
    attention is the fused kernel over ``key_valid`` [B, S]; with "einsum" it
    is ``_attend`` over the additive ``bias`` [B, 1, S, S]. Unless
    ``deterministic``, ``cfg.trm_dropout`` is drawn from ``generator``.
    ``remat`` (one of :data:`REMAT_MODES`) checkpoints each layer when
    autograd records."""
    act = _ffn_act(cfg, deterministic)
    use_flash = cfg.attn_impl in ("flash", "splash")
    if use_flash and key_valid is None:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} needs key_valid")
    if not use_flash and bias is None:
        raise ValueError("attn_impl='einsum' needs bias")

    def drop(x):
        return dropout(x, cfg.trm_dropout, generator, deterministic)

    def layer(lp, h):
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = _qkv(lp, hn, cfg.nhead)
        if use_flash:
            attn = flash_attend_xy(q.contiguous(), k.contiguous(),
                                   v.contiguous(), key_valid)
        else:
            attn = _attend(q, k, v, bias.float())
        return _post_attention(lp, h, _merge_heads(attn), act,
                               bias_last=False, drop=drop)

    if remat not in REMAT_MODES:
        raise ValueError(f"remat mode {remat!r}")
    mode = remat if torch.is_grad_enabled() else "none"
    h = h.to(dtype)
    for lp in layer_params(params):
        h = checkpoint_layer(functools.partial(layer, lp), mode, generator)(h)
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
    act = _ffn_act(cfg, deterministic=True)
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
    act = _ffn_act(cfg, deterministic=True)
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


def transformer_decode_step_shared(params, h_t: torch.Tensor, pfx: KVCache,
                                   gen: KVCache, key_banned: torch.Tensor,
                                   cfg: SSRModelConfig, *, n_groups: int,
                                   dtype=torch.bfloat16,
                                   layers=None) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode of ``n_groups * S`` chains over a shared prompt cache
    (JAX ``transformer_decode_step_shared``).

    h_t: [B, D], B = n_groups * S in group-major rows. ``pfx`` [L, G, H, Tp,
    Dh] holds each group's prompt once, read once a step for its S chains;
    ``gen`` [L, B, H, Tg, Dh] holds each chain's generated positions, and the
    new K/V are written into it in place at ``gen.length``. ``key_banned``
    is the banned prefix key range [G, 2] (keys at and beyond ``pfx.length``
    are banned too) or a bool mask [G, Tp] that the multi-prompt prefill
    builds True from ``pfx.length`` on. Keys [0, pfx.length) of the prefix
    and [0, gen.length] of the generated cache are read: JAX reads both
    whole buffers with the rest masked, which adds exact zeros to the same
    softmax. The arithmetic is JAX's: q scaled (in ``dtype``) before the
    products, fp32 scores and one softmax over [prefix ; generated],
    probabilities in ``dtype``, the last residual ``(h + ff @ w2) + b2``.
    Returns (out [B, D], gen advanced by one)."""
    act = _ffn_act(cfg, deterministic=True)
    b, d = h_t.shape
    s = b // n_groups
    nhead, dh = cfg.nhead, cfg.head_dim
    gpos, tp = gen.length, pfx.length
    if gpos >= gen.max_len:
        raise ValueError(f"generated KV cache full ({gen.max_len} positions)")
    if key_banned.dtype == torch.bool:
        pfx_banned = key_banned[:, :tp]
    else:
        idx = torch.arange(tp, device=key_banned.device)[None, :]
        pfx_banned = (idx >= key_banned[:, :1]) & (idx < key_banned[:, 1:2])
    zero = torch.zeros((), dtype=torch.float32, device=h_t.device)
    pfx_bias = torch.where(pfx_banned, -1e9, zero)[:, None, None, :]
    # JAX multiplies by the scale as a weakly typed constant: in ``dtype``
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=dtype, device=h_t.device)
    h = h_t.to(dtype)[:, None, :]
    for l, lp in enumerate(layers or layer_params(params)):
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = _qkv(lp, hn, nhead)  # [B, H, 1, Dh]
        gen.k[l, :, :, gpos:gpos + 1] = k
        gen.v[l, :, :, gpos:gpos + 1] = v
        qs = q * scale
        # prefix scores: the group's K read once for its S chains [G, H, S, Tp]
        qg = qs.reshape(n_groups, s, nhead, dh).transpose(1, 2)
        sp = torch.matmul(qg.float(), pfx.k[l, :, :, :tp].float()
                          .transpose(-1, -2)) + pfx_bias
        sg = torch.matmul(qs.float(), gen.k[l, :, :, :gpos + 1].float()
                          .transpose(-1, -2))  # [B, H, 1, gpos + 1]
        sg = sg.reshape(n_groups, s, nhead, gpos + 1).transpose(1, 2)
        p = torch.softmax(torch.cat([sp, sg], dim=-1), dim=-1).to(dtype)
        out_p = torch.matmul(p[..., :tp], pfx.v[l, :, :, :tp])  # [G, H, S, Dh]
        pg = p[..., tp:].transpose(1, 2).reshape(b, nhead, 1, gpos + 1)
        out_g = torch.matmul(pg, gen.v[l, :, :, :gpos + 1])  # [B, H, 1, Dh]
        attn = out_p.transpose(1, 2).reshape(b, nhead, 1, dh) + out_g
        h = _post_attention(lp, h, attn.reshape(b, 1, d), act, bias_last=True)
    out = layer_norm(h, params["final_ln_w"], params["final_ln_b"])
    return out[:, 0, :], KVCache(gen.k, gen.v, gpos + 1)


def transformer_decode_step_paged(params, h_t: torch.Tensor, pfx: KVCache,
                                  gen: KVCache, key_banned: torch.Tensor,
                                  gen_len: torch.Tensor, cfg: SSRModelConfig,
                                  *, dtype=torch.bfloat16, read_len=None,
                                  layers=None) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode with a generated-cache write column per row (JAX
    ``transformer_decode_step_paged``), for the continuous-batching server,
    which refills a finished chain's row with a new request that restarts
    at column 0 while the other rows are mid-flight.

    h_t: [B, D], one row per chain (cond rows, then uncond rows). ``pfx``
    [L, B, H, Tp, Dh] holds each row's prompt and ``key_banned`` [B, Tp]
    (bool) its dead keys; ``gen`` [L, B, H, Tg, Dh] the generated K/V, whose
    ``length`` is not used. Row r attends generated columns ``< gen_len[r]``
    only (the strict mask), so a refilled row never reads the previous
    occupant's K/V; the current token's score is one extra softmax column
    over [prefix | generated | current] in fp32, and the probabilities are
    cast to ``dtype`` before the three PV products. q is scaled (in
    ``dtype``) before the products, the prefix bias is -1e9 on
    ``key_banned`` and the last residual is ``(h + ff @ w2) + b2``.

    Reads: keys [0, pfx.length) of the prefix and columns [0, ``read_len``)
    of the generated cache, where ``read_len`` (default: all of Tg) must be
    at least ``max(gen_len)``; the caller passes a bound it keeps on the
    host. JAX reads both whole buffers; the columns left out are masked
    there, exact zeros of the same softmax. All layers' K/V land in one
    scatter after the layer loop, at column ``gen_len[r]`` of each row r
    (clamped to the buffer, where JAX drops an out-of-range write; a caller
    never lets a row reach it). Returns (out [B, D], gen), the cache
    written in place."""
    act = _ffn_act(cfg, deterministic=True)
    b, d = h_t.shape
    nhead, dh = cfg.nhead, cfg.head_dim
    tp, tg = pfx.length, gen.max_len
    rl = tg if read_len is None else min(int(read_len), tg)
    dev = h_t.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pfx_bias = torch.where(key_banned[:, :tp], -1e9, zero)[:, None, None, :]
    cols = torch.arange(rl, device=dev)[None, :]
    gen_bias = torch.where(cols < gen_len[:, None], zero,
                           -1e9)[:, None, None, :]  # [B, 1, 1, rl]
    # JAX multiplies by the scale as a weakly typed constant: in ``dtype``
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=dtype, device=dev)
    h = h_t.to(dtype)[:, None, :]
    ks, vs = [], []
    for l, lp in enumerate(layers or layer_params(params)):
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = _qkv(lp, hn, nhead)  # [B, H, 1, Dh]
        ks.append(k[:, :, 0])
        vs.append(v[:, :, 0])
        qs = q * scale
        sp = torch.matmul(qs.float(), pfx.k[l, :, :, :tp].float()
                          .transpose(-1, -2)) + pfx_bias  # [B, H, 1, Tp]
        sg = torch.matmul(qs.float(), gen.k[l, :, :, :rl].float()
                          .transpose(-1, -2)) + gen_bias  # [B, H, 1, rl]
        sc = (qs.float() * k.float()).sum(-1, keepdim=True)  # [B, H, 1, 1]
        p = torch.softmax(torch.cat([sp, sg, sc], dim=-1), dim=-1).to(dtype)
        out = torch.matmul(p[..., :tp], pfx.v[l, :, :, :tp])
        out = out + torch.matmul(p[..., tp:tp + rl], gen.v[l, :, :, :rl])
        out = out + p[..., -1:] * v
        h = _post_attention(lp, h, out.reshape(b, 1, d), act, bias_last=True)
    # one scatter for all layers: row r writes column gen_len[r]
    rows = torch.arange(b, device=dev)
    col = gen_len.clamp(max=tg - 1)
    gen.k[:, rows, :, col] = torch.stack(ks).to(gen.k.dtype).transpose(0, 1)
    gen.v[:, rows, :, col] = torch.stack(vs).to(gen.v.dtype).transpose(0, 1)
    out = layer_norm(h, params["final_ln_w"], params["final_ln_b"])
    return out[:, 0, :], gen
