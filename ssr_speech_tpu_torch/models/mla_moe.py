"""A second decoder block for the SSR LM: DeepSeek-V3's layer as
Moonlight-16B-A3B publishes it (latent attention, MLA, and sigmoid-routed
experts), behind SSR-Speech's own input layer and heads.

The LM keeps SSR's token space, its summed codebook embeddings with their
sinusoids times alpha, its K heads, the delayed codebooks, CFG and infilling
(``models/ssr.py``); only the block between them changes. With h the
residual stream and no biases anywhere in the block, each layer is

    a = RMSNorm(h)
    [q | c | k_pe] = a W_qkva                 q viewed [H, nope + rope]
    c = RMSNorm_kv(c)                          the latent, ``kv_lora_rank`` wide
    k_nope_h = c W_k,h^T,  v_h = c W_v,h       per head, from the latent
    q_pe, k_pe rotated by RoPE (theta ``rope_theta``), k_pe shared by the heads
    score = (q_nope . k_nope + q_pe . k_pe) (nope + rope)^-0.5, fp32 softmax
    h = h + concat_h(sum p v_h) W_o
    b = RMSNorm(h)
    layers < first_k_dense_replace: h = h + SwiGLU_dense(b)
    the others: s = sigmoid(b W_g) (fp32), idx = top-k(s + e_bias),
        w = s[idx] / sum s[idx] * routed_scaling_factor,
        h = h + sum_i w_i SwiGLU_expert(idx_i)(b) + SwiGLU_shared(b)

then a final RMSNorm and SSR's heads. RoPE positions follow SSR's
sinusoids: the text counts from 0 and the audio counts from 0, so a decode
step's position is its chain's audio position (``y_pos``) and no padding
moves a key. DeepSeek-V3 rotates the interleaved pairs (2i, 2i+1) of the
rope dims and returns them de-interleaved, evens first: :func:`rope` does
the same.

Cache: one latent a token a layer, [c | k_pe] (``kv_lora_rank`` +
``qk_rope_head_dim`` = 576 wide at the published sizes), in
:class:`LatentCache` [L, B, T, 576]. The prefill computes attention in the
expanded form (``scaled_dot_product_attention`` over [q_nope | q_pe] and
[k_nope | k_pe]); the decode steps in the absorbed form: q_lat,h = q_nope,h
W_k,h [latent], scores against the cached latents, out_h = (sum p c) W_v,h.
The paged step's attention is ``ops.mla_attention`` (K12 on the card), the
decode steps' experts ``ops.moe_experts`` (K11 on the card), the prefill's
experts one grouped product over the tokens sorted by expert
(``torch._grouped_mm``).

Dtypes: the decoder's matrices in the compute dtype (bf16 on CUDA), the
router, the norms' weights and statistics, ``e_bias``, the attention scores
and softmax in fp32; the embeddings and heads fp32 as for the e830M block.

Parameters (``params["decoder"]``), stacked on a leading layer axis; matmul
weights [in, out] (``x @ w``) except the experts', which are [out, in] rows
so that a kernel streams one output's weights contiguously:

    layers/attn_norm [L, D], layers/wq_kva [L, D, H*(nope+rope) + latent + rope],
    layers/kv_norm [L, latent], layers/kvb_k [L, H, nope, latent],
    layers/kvb_v [L, H, latent, v], layers/wo [L, H*v, D], layers/ffn_norm [L, D],
    dense/gu [Ld, D, 2*I], dense/down [Ld, I, D],
    moe/router [Lm, D, E], moe/e_bias [Lm, E], moe/experts_gu [Lm, E, 2*F, D],
    moe/experts_down [Lm, E, D, F], moe/shared_gu [Lm, D, 2*Fs],
    moe/shared_down [Lm, Fs, D], final_norm [D].

Not for this block: the shared-prompt step (``generate_batch``,
``generate_multi``), training, tensor and fully sharded parallelism and the
int8 paths refuse it (:func:`refuse`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..config import SSRModelConfig, TokenSpace
from ..ops import mla_attention, moe_experts
from .from_jax import ParamTree, _check_shape

LAYER_KEYS = ("attn_norm", "wq_kva", "kv_norm", "kvb_k", "kvb_v", "wo",
              "ffn_norm")
MOE_KEYS = ("router", "e_bias", "experts_gu", "experts_down", "shared_gu",
            "shared_down")
# decoder tensors kept in the compute dtype; the rest stay fp32
MATMUL_KEYS = {"layers": ("wq_kva", "kvb_k", "kvb_v", "wo"),
               "dense": ("gu", "down"),
               "moe": ("experts_gu", "experts_down", "shared_gu",
                       "shared_down")}


@dataclass(frozen=True)
class MLAMoEConfig(SSRModelConfig):
    """SSR's config plus the block's sizes (names as in DeepSeek-V3's
    ``config.json``); ``d_model``, ``nhead`` and ``num_layers`` are the
    hidden size, the heads and the layers. Defaults: Moonlight-16B-A3B."""

    num_layers: int = 27
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """The cached width a token a layer: [c | k_pe]."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def shared_width(self) -> int:
        return self.n_shared_experts * self.moe_intermediate_size

    def validate(self) -> None:
        super().validate()
        assert self.qk_rope_head_dim % 2 == 0
        assert 0 < self.num_experts_per_tok <= self.n_routed_experts
        assert 0 <= self.first_k_dense_replace <= self.num_layers


def is_mla_moe(cfg) -> bool:
    return isinstance(cfg, MLAMoEConfig)


def refuse(cfg, what: str) -> None:
    """Raise for a path this block does not run."""
    if is_mla_moe(cfg):
        raise ValueError(f"{what} does not run the MLA + MoE block "
                         f"(MLAMoEConfig): it runs on decode.generate and "
                         f"the continuous server only")


def refuse_params(params, what: str) -> None:
    """:func:`refuse` for a parameter tree (an MLA + MoE decoder holds
    ``layers/wq_kva``)."""
    dec = params["decoder"] if "decoder" in params else params
    if "layers" in dec and "wq_kva" in dec["layers"]:
        raise ValueError(f"{what} does not run the MLA + MoE block: it runs "
                         f"on decode.generate and the continuous server only")


def config_to_json(cfg: MLAMoEConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def config_from_json(text: str) -> MLAMoEConfig:
    data = json.loads(text)
    names = {f.name for f in dataclasses.fields(MLAMoEConfig)}
    kw = {k: v for k, v in data.items() if k in names}
    if isinstance(kw.get("tokens"), dict):
        kw["tokens"] = TokenSpace(**kw["tokens"])
    return MLAMoEConfig(**kw)


# ------------------------------------------------------------------ params

def decoder_shapes(cfg: MLAMoEConfig) -> Dict[str, Dict[str, tuple]]:
    """The decoder's leaves by group, with their shapes."""
    d, L, H = cfg.d_model, cfg.num_layers, cfg.nhead
    r, nope, rope, v = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                        cfg.qk_rope_head_dim, cfg.v_head_dim)
    Ld, Lm = cfg.first_k_dense_replace, cfg.n_moe_layers
    E, Fe, Fs, I = (cfg.n_routed_experts, cfg.moe_intermediate_size,
                    cfg.shared_width, cfg.intermediate_size)
    return dict(
        layers=dict(attn_norm=(L, d), wq_kva=(L, d, H * (nope + rope) + r + rope),
                    kv_norm=(L, r), kvb_k=(L, H, nope, r), kvb_v=(L, H, r, v),
                    wo=(L, H * v, d), ffn_norm=(L, d)),
        dense=dict(gu=(Ld, d, 2 * I), down=(Ld, I, d)),
        moe=dict(router=(Lm, d, E), e_bias=(Lm, E), experts_gu=(Lm, E, 2 * Fe, d),
                 experts_down=(Lm, E, d, Fe), shared_gu=(Lm, d, 2 * Fs),
                 shared_down=(Lm, Fs, d)))


def init_bounds(cfg: MLAMoEConfig) -> Dict[str, float]:
    """U(-b, b) bounds of the random init: torch's Linear default,
    1 / sqrt(fan_in), for every matrix (the router's too), and ``e_bias``
    at U(-0.1, 0.1), the spread of the sigmoid scores, so that it changes
    choices as a trained correction bias does."""
    d, r, I = cfg.d_model, cfg.kv_lora_rank, cfg.intermediate_size
    return dict(wq_kva=d ** -0.5, kvb_k=r ** -0.5, kvb_v=r ** -0.5,
                wo=(cfg.nhead * cfg.v_head_dim) ** -0.5, gu=d ** -0.5,
                down=I ** -0.5, router=d ** -0.5, e_bias=0.1,
                experts_gu=d ** -0.5,
                experts_down=cfg.moe_intermediate_size ** -0.5,
                shared_gu=d ** -0.5, shared_down=cfg.shared_width ** -0.5)


def init_params(generator: torch.Generator, cfg: MLAMoEConfig,
                device="cpu") -> Dict[str, object]:
    """Random fp32 parameters from ``generator``: SSR's embeddings (unit
    normal), unit alphas and heads (torch Linear default), the block's
    matrices U(+-:func:`init_bounds`), unit norm weights."""
    cfg.validate()
    d, card, hh, K = (cfg.d_model, cfg.cardinality, cfg.head_hidden_dim,
                      cfg.n_codebooks)
    kw = dict(generator=generator, device=device)

    def uni(shape, b):
        return (torch.rand(shape, **kw) * 2.0 - 1.0) * b

    bounds = init_bounds(cfg)
    dec: Dict[str, Dict[str, torch.Tensor]] = {}
    for group, leaves in decoder_shapes(cfg).items():
        dec[group] = {}
        for key, shape in leaves.items():
            if key.endswith("norm"):
                dec[group][key] = torch.ones(shape, device=device)
            else:
                dec[group][key] = uni(shape, bounds[key])
    dec["final_norm"] = torch.ones(d, device=device)
    return dict(
        text_emb=torch.randn((cfg.n_text_tokens, d), **kw),
        audio_emb=torch.randn((K, card, d), **kw),
        text_pos_alpha=torch.ones(1, device=device),
        audio_pos_alpha=torch.ones(1, device=device),
        decoder=dec,
        head1_w=uni((K, d, hh), d ** -0.5), head1_b=uni((K, hh), d ** -0.5),
        head2_w=uni((K, hh, card), hh ** -0.5),
        head2_b=uni((K, card), hh ** -0.5))


class MLAMoELM(ParamTree):
    """The LM's parameters (the nesting of :func:`init_params`) plus its
    config."""

    def __init__(self, params, cfg: MLAMoEConfig):
        super().__init__(params)
        self.cfg = cfg
        for group, leaves in decoder_shapes(cfg).items():
            for key, shape in leaves.items():
                _check_shape(self["decoder"][group][key], shape, key)
        _check_shape(self["audio_emb"],
                     (cfg.n_codebooks, cfg.cardinality, cfg.d_model), "audio_emb")


def lm_from_tree(params, cfg: MLAMoEConfig, *, device="cpu",
                 dtype: torch.dtype = torch.float32) -> MLAMoELM:
    """A parameter tree -> :class:`MLAMoELM` on ``device``, the decoder's
    matrices in ``dtype`` (the compute dtype), everything else fp32."""
    model = MLAMoELM(params, cfg).to(device)
    for group, keys in MATMUL_KEYS.items():
        node = model["decoder"][group]
        for key in keys:
            setattr(node, key, node[key].to(dtype))
    return model.eval()


def compute_dtype_of(params) -> torch.dtype:
    return params["decoder"]["layers"]["wq_kva"].dtype


def layer_params(dec) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views of the stacked decoder: attention keys, then
    ``dense`` or ``moe`` leaves (with the layer's MoE index ``m``)."""
    cfg_dense = dec["dense"]["gu"].shape[0]
    n = dec["layers"]["wq_kva"].shape[0]
    out = []
    for l in range(n):
        lp = {k: dec["layers"][k][l] for k in LAYER_KEYS}
        if l < cfg_dense:
            lp.update(gu=dec["dense"]["gu"][l], down=dec["dense"]["down"][l])
        else:
            m = l - cfg_dense
            lp.update({k: dec["moe"][k][m] for k in MOE_KEYS}, m=m)
        out.append(lp)
    return out


# ----------------------------------------------------------------- cache

@dataclass
class LatentCache:
    """Preallocated latents [L, B, T, latent] ([c | k_pe], written in place)
    and the fill: a host int, or a [1] int64 tensor on the device."""

    c: torch.Tensor
    length: Union[int, torch.Tensor]

    @property
    def max_len(self) -> int:
        return self.c.shape[2]

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        return (self.c,)


def init_cache(cfg: MLAMoEConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu", par=None) -> LatentCache:
    if par is not None and getattr(par, "tp_size", 1) > 1:
        refuse(cfg, "tensor parallelism")
    return LatentCache(torch.zeros((cfg.num_layers, batch, max_len,
                                    cfg.latent_dim), dtype=dtype,
                                   device=device), 0)


# ------------------------------------------------------------ the pieces

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w with fp32 statistics and weight, in
    x's dtype (one ``F.rms_norm`` over the widened input)."""
    return F.rms_norm(x.float(), (x.shape[-1],), w.float(), eps).to(x.dtype)


def rope_rotation(pos: torch.Tensor, cfg: MLAMoEConfig) -> torch.Tensor:
    """The unit complex numbers exp(i pos theta^(-2j/rope)) [..., rope / 2]
    of positions ``pos`` (complex64): one table a step, for every layer."""
    half = cfg.qk_rope_head_dim // 2
    inv = cfg.rope_theta ** -(torch.arange(0, half, device=pos.device,
                                           dtype=torch.float32) / half)
    ang = pos.float()[..., None] * inv
    return torch.polar(torch.ones_like(ang), ang)


def rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotary embedding of x [..., rope]: the pairs (2i,
    2i+1) as complex numbers times ``rot`` (:func:`rope_rotation`,
    broadcast), in fp32, returned de-interleaved (the rotated evens, then
    the odds) in x's dtype."""
    half = x.shape[-1] // 2
    z = torch.view_as_complex(x.float().contiguous().unflatten(-1, (half, 2)))
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    out.unflatten(-1, (2, half)).copy_(
        torch.view_as_real(z * rot).transpose(-1, -2))
    return out


def swiglu(x: torch.Tensor, gu: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """x @ [gate | up] -> silu(gate) * up (fp32 on the rounded products,
    rounded once) -> @ down; ``gu`` [D, 2I], ``down`` [I, D]."""
    g, u = (x @ gu.to(x.dtype)).float().chunk(2, dim=-1)
    return (F.silu(g) * u).to(x.dtype) @ down.to(x.dtype)


def route(b: torch.Tensor, router: torch.Tensor, e_bias: torch.Tensor,
          cfg: MLAMoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's ``noaux_tc`` gate with one group: sigmoid scores of
    the fp32 product, the top ``num_experts_per_tok`` of score + e_bias,
    their scores normalised to sum 1 and scaled by
    ``routed_scaling_factor``. b [N, D] -> (idx [N, k] int64, w [N, k]
    fp32)."""
    s = torch.sigmoid(b.float() @ router.float())
    idx = torch.topk(s + e_bias.float(), cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(-1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return idx, w


def moe_grouped(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                experts_gu: torch.Tensor, experts_down: torch.Tensor
                ) -> torch.Tensor:
    """The routed experts over many tokens (the prefill): the (token,
    choice) pairs sorted by expert, one grouped product for gate and up and
    one for down (``torch._grouped_mm`` over device offsets, so a graph
    captures it), the weighted outputs added in fp32. The same rounding as
    ``moe_experts``: the products and silu(gate) * up in x's dtype. x [N,
    D] -> [N, D] fp32."""
    n, k = idx.shape
    E = experts_gu.shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = counts.cumsum(0, dtype=torch.int32)
    xs = x[order // k]
    gu = torch._grouped_mm(xs, experts_gu.transpose(1, 2), offs=offs)
    g, u = gu.float().chunk(2, dim=-1)
    hmid = (F.silu(g) * u).to(x.dtype)
    y = torch._grouped_mm(hmid, experts_down.transpose(1, 2), offs=offs)
    y = y.float() * w.reshape(-1)[order, None]
    out = torch.zeros((n * k, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_copy_(0, order, y).view(n, k, -1).sum(1)


def _attn_in(lp, h, cfg: MLAMoEConfig, rot: torch.Tensor):
    """The attention inputs of h [B, S, D] at the positions of ``rot``
    (:func:`rope_rotation`, [S, rope / 2] or [B, S, rope / 2]): q_nope
    [B, S, H, nope], q_pe [B, S, H, rope] (rotated), the latent [B, S,
    latent] (c normalised | k_pe rotated)."""
    B, S, _ = h.shape
    H, nope, rope_d, r = (cfg.nhead, cfg.qk_nope_head_dim,
                          cfg.qk_rope_head_dim, cfg.kv_lora_rank)
    a = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    proj = a @ lp["wq_kva"].to(h.dtype)
    q = proj[..., :H * (nope + rope_d)].reshape(B, S, H, nope + rope_d)
    c = rms_norm(proj[..., H * (nope + rope_d):H * (nope + rope_d) + r],
                 lp["kv_norm"], cfg.rms_norm_eps)
    q_pe = rope(q[..., nope:], rot[..., None, :])
    k_pe = rope(proj[..., H * (nope + rope_d) + r:], rot)
    return q[..., :nope], q_pe, torch.cat([c, k_pe], -1)


def _ffn(lp, h, cfg: MLAMoEConfig, moe_step=None):
    """The FFN half of a layer: h + SwiGLU_dense(b), or h + the routed
    experts (``moe_step(b, idx, w, lp)``, fp32; default the grouped
    product) + the shared ones."""
    b = rms_norm(h, lp["ffn_norm"], cfg.rms_norm_eps)
    if "gu" in lp:
        return h + swiglu(b, lp["gu"], lp["down"])
    shape = b.shape
    b2 = b.reshape(-1, shape[-1])
    idx, w = route(b2, lp["router"], lp["e_bias"], cfg)
    if moe_step is None:
        routed = moe_grouped(b2, idx, w, lp["experts_gu"], lp["experts_down"])
    else:
        routed = moe_step(b2, idx, w, lp)
    shared = swiglu(b2, lp["shared_gu"], lp["shared_down"])
    return h + routed.add_(shared).to(h.dtype).reshape(shape)


def _absorb(lp, q_nope, q_pe):
    """The absorbed query [B, H, latent]: q_nope,h W_k,h | q_pe,h."""
    q_lat = torch.einsum("bhn,hnc->bhc", q_nope, lp["kvb_k"].to(q_nope.dtype))
    return torch.cat([q_lat, q_pe], -1)


def _attn_out(lp, o_lat, h):
    """sum p c [B, H, latent] -> h + concat_h(o_lat,h W_v,h) W_o."""
    o = torch.einsum("bhc,hcv->bhv", o_lat, lp["kvb_v"].to(o_lat.dtype))
    return h + o.reshape(*h.shape[:-1], -1) @ lp["wo"].to(h.dtype)


# --------------------------------------------------------------- prefill

def transformer_prefill(params, h: torch.Tensor, cache: LatentCache,
                        cfg: MLAMoEConfig, *, key_valid: torch.Tensor,
                        pos: torch.Tensor, dtype=torch.bfloat16
                        ) -> Tuple[torch.Tensor, LatentCache]:
    """Forward over the prompt h [B, S, D] (RoPE positions ``pos`` [S])
    while writing each layer's latents at the cache's host offset. The
    attention is the expanded form through ``scaled_dot_product_attention``:
    query i attends key j <= i that ``key_valid`` [B, S] leaves open (every
    row the decode reads sees its causal prefix minus the banned keys, as
    the e830M prefill's). The experts are :func:`moe_grouped`. Returns
    (final-norm hidden [B, S, D], cache with its fill as a [1] device
    tensor)."""
    start, S = cache.length, h.shape[1]
    if isinstance(start, torch.Tensor):
        raise TypeError("transformer_prefill fills from a host offset")
    B = h.shape[0]
    H, nope, r = cfg.nhead, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    h = h.to(dtype)
    idx = torch.arange(S, device=h.device)
    mask = (idx[None, :] <= idx[:, None])[None] & (key_valid != 0)[:, None, :]
    mask = mask[:, None]  # [B, 1, S, S]
    scale = cfg.qk_head_dim ** -0.5
    rot = rope_rotation(pos, cfg)
    for l, lp in enumerate(layer_params(params)):
        q_nope, q_pe, lat = _attn_in(lp, h, cfg, rot)
        cache.c[l, :, start:start + S] = lat.to(cache.c.dtype)
        c = lat[..., :r]
        k_nope = torch.einsum("bsc,hnc->bhsn", c, lp["kvb_k"].to(dtype))
        v = torch.einsum("bsc,hcv->bhsv", c, lp["kvb_v"].to(dtype))
        k_pe = lat[..., r:][:, None].expand(B, H, S, cfg.qk_rope_head_dim)
        q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
        k = torch.cat([k_nope, k_pe], -1)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
        h = h + o.transpose(1, 2).reshape(B, S, -1) @ lp["wo"].to(dtype)
        h = _ffn(lp, h, cfg)
    out = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return out, LatentCache(cache.c, torch.full(
        (1,), start + S, dtype=torch.int64, device=h.device))


# ------------------------------------------------------------ decode steps

def _moe_kernel_step(counts=None, live=None):
    def step(b, idx, w, lp):
        return moe_experts.moe_experts(
            b, idx, w, lp["experts_gu"], lp["experts_down"],
            counts=None if counts is None else counts[lp["m"]], live=live)
    return step


def decode_step(params, h_t: torch.Tensor, cache: LatentCache,
                key_banned: torch.Tensor, cfg: MLAMoEConfig, *,
                pos: torch.Tensor, dtype=torch.bfloat16, layers=None,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, LatentCache]:
    """One-token decode of ``decode.generate`` (the single path): h_t [B, D]
    at cache column ``cache.length`` (a [1] device tensor, or a host int)
    and RoPE positions ``pos`` [B]. The new latents are written at that
    column first; the attention is the absorbed form in plain PyTorch over
    columns [0, ``window``) (default the whole cache) with -1e9 on the
    banned range ``key_banned`` [B, 2] and past the column; the experts are
    ``ops.moe_experts``. Returns (out [B, D], cache advanced by one)."""
    from .transformer import _as_pos, decode_bias

    fill = cache.length
    w = cache.max_len if window is None else min(int(window), cache.max_len)
    col = _as_pos(fill, h_t.device)
    bias = decode_bias(key_banned, w, col)[:, :, 0]  # [B, 1, w]
    scale = cfg.qk_head_dim ** -0.5
    r = cfg.kv_lora_rank
    h = h_t.to(dtype)[:, None, :]
    step = _moe_kernel_step()
    rot = rope_rotation(pos[:, None], cfg)
    for l, lp in enumerate(layers or layer_params(params)):
        q_nope, q_pe, lat = _attn_in(lp, h, cfg, rot)
        buf = cache.c[l]
        buf.index_copy_(1, col.clamp(max=buf.shape[1] - 1),
                        lat.to(buf.dtype))
        q = _absorb(lp, q_nope[:, 0], q_pe[:, 0])  # [B, H, latent]
        keys = buf[:, :w]
        s = torch.matmul(q.float(), keys.float().transpose(1, 2)) * scale + bias
        p = torch.softmax(s, -1).to(dtype)
        h = _attn_out(lp, torch.matmul(p, keys[..., :r]), h)
        h = _ffn(lp, h, cfg, step)
    out = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return out[:, 0], LatentCache(cache.c, fill + 1)


def decode_step_paged(params, h_t: torch.Tensor, pfx: LatentCache,
                      gen: LatentCache, key_banned: torch.Tensor,
                      gen_len: torch.Tensor, cfg: MLAMoEConfig, *,
                      pos: torch.Tensor, dtype=torch.bfloat16, read_len=None,
                      layers=None, counts: Optional[torch.Tensor] = None,
                      live: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, LatentCache]:
    """The continuous server's step (the contract of
    ``transformer.transformer_decode_step_paged``) for this block: row r at
    RoPE position ``pos[r]`` attends its prompt latents [0, pfx.length)
    less ``key_banned`` [B, >= Tp], its generated latents [0, gen_len[r])
    (read through [0, ``read_len``)) and its own new latent, through
    ``ops.mla_attention.paged_mla_attention`` (K12 on the card); the
    experts through ``ops.moe_experts`` (K11) for the rows that ``live``
    ([B] bool, default all) marks, which add each MoE layer's routed tokens
    and touched experts to ``counts`` [Lm, 2, E]; a row that is not live
    gets no routed expert and reads none. All layers' latents land in one scatter
    after the loop, at column ``gen_len[r]``. Returns (out [B, D], gen)."""
    b = h_t.shape[0]
    tp, tg = pfx.length, gen.max_len
    rl = tg if read_len is None else min(int(read_len), tg)
    r = cfg.kv_lora_rank
    h = h_t.to(dtype)[:, None, :]
    step = _moe_kernel_step(counts, live)
    lats = []
    rot = rope_rotation(pos[:, None], cfg)
    for l, lp in enumerate(layers or layer_params(params)):
        q_nope, q_pe, lat = _attn_in(lp, h, cfg, rot)
        lats.append(lat[:, 0])
        q = _absorb(lp, q_nope[:, 0], q_pe[:, 0])
        o_lat = mla_attention.paged_mla_attention(
            q, lat[:, 0], pfx.c[l], gen.c[l], key_banned, gen_len, tp, rl,
            cfg.qk_head_dim ** -0.5, r)
        h = _attn_out(lp, o_lat, h)
        h = _ffn(lp, h, cfg, step)
    rows = torch.arange(b, device=h_t.device)
    col = gen_len.clamp(max=tg - 1)
    gen.c[:, rows, col] = torch.stack(lats).to(gen.c.dtype)
    out = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return out[:, 0], gen
