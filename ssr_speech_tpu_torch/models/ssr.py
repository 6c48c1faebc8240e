"""SSR-Speech LM over [phoneme tokens ; codec tokens] (port of
``ssr_speech_tpu/models/ssr.py``): embeddings, sinusoidal positions with a
learnable alpha, the K per-codebook GELU heads, and the masked-span training
loss with its metrics (unfused, or through the fused CE head kernels).
Functions take the :class:`from_jax.SSRLM` tree as ``params``, indexed with
the JAX keys; they are differentiable, and the serving and eval callers run
them under ``torch.no_grad()``.

Under tensor parallelism (``par``, or the ``parallel`` a sharded tree
carries) the heads are Megatron's: ``head1`` column-parallel (the rank's
block of the hidden), ``head2`` row-parallel (partial logits summed over tp
before the bias). The fused CE head gathers the hidden and ``head2_w`` over
tp and runs its kernels on the whole head on every tp rank, so K4-K6 see
the shapes they see on one device; the gradient of each gathered block goes
back to its rank.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import SSRModelConfig

from ..ops.fused_ce import fused_ce_head
from ..ops.masking import make_pad_mask, xy_attn_bias
from ..parallel import collectives as col
from ..utils import prng
from . import mla_moe
from . import transformer as trf


def sine_table(max_len: int, d_model: int, device="cpu") -> torch.Tensor:
    """Fixed sin/cos table [max_len, D] (fp32)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device) * -(math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def init_ssr(key: torch.Tensor, cfg: SSRModelConfig,
             device="cpu") -> Dict[str, object]:
    """Random LM parameters, JAX's ``init_ssr(key, cfg)`` drawn from the
    same threefry key (``utils.prng``; ``PRNGKey(seed)`` gives JAX's
    ``jax.random.PRNGKey(seed)``): a bundle-ready pytree of fp32 tensors,
    drawn on ``device``."""
    cfg.validate()
    d, card, hh, K = cfg.d_model, cfg.cardinality, cfg.head_hidden_dim, cfg.n_codebooks
    k = prng.split(key.to(device), 6)
    text_emb = prng.normal(k[0], (cfg.n_text_tokens, d))
    audio_emb = prng.normal(k[1], (K, card, d))
    heads = []
    for hk in prng.split(k[2], K):
        a, b = prng.split(hk)
        heads.append(trf._linear_init(a, d, (d, hh), (hh,))
                     + trf._linear_init(b, hh, (hh, card), (card,)))
    h1_w, h1_b, h2_w, h2_b = (torch.stack(ts) for ts in zip(*heads))
    return dict(
        text_emb=text_emb, audio_emb=audio_emb,
        text_pos_alpha=torch.ones((1,), device=device),
        audio_pos_alpha=torch.ones((1,), device=device),
        decoder=trf.init_transformer(k[3], cfg),
        head1_w=h1_w, head1_b=h1_b, head2_w=h2_w, head2_b=h2_b)


def _pos_slice(pe: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """pe[start:start+n] with start clamped so the slice fits (the
    ``dynamic_slice`` semantics of JAX)."""
    start = min(max(int(start), 0), pe.shape[0] - n)
    return pe[start:start + n]


def embed_text(params, cfg: SSRModelConfig, x: torch.Tensor, pe: torch.Tensor,
               start: int = 0) -> torch.Tensor:
    """x [B, Sx] int -> [B, Sx, D] with positional embedding added."""
    h = params["text_emb"][x]
    return h + params["text_pos_alpha"] * _pos_slice(pe, start, x.shape[1])[None]


def embed_audio_tokens(params, cfg: SSRModelConfig, y: torch.Tensor) -> torch.Tensor:
    """y [..., K] int -> [..., D]: sum of per-codebook embeddings."""
    embs = params["audio_emb"]  # [K, card, D]
    out = embs[0][y[..., 0]]
    for k in range(1, cfg.n_codebooks):
        out = out + embs[k][y[..., k]]
    return out


def apply_audio_pos(params, y_emb: torch.Tensor, pe: torch.Tensor,
                    start: int) -> torch.Tensor:
    return y_emb + params["audio_pos_alpha"] * _pos_slice(pe, start, y_emb.shape[-2])


def predict_logits(params, h: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """h [..., D] -> logits [..., K, card] through the K two-layer heads
    (exact-erf GELU), computed in ``dtype`` (fp32 for decoding)."""
    w1 = params["head1_w"].to(dtype)  # [K, D, Hh]
    b1 = params["head1_b"].to(dtype)
    w2 = params["head2_w"].to(dtype)  # [K, Hh, card]
    b2 = params["head2_b"].to(dtype)
    hidden = F.gelu(torch.einsum("...d,kdh->...kh", h.to(dtype), w1) + b1,
                    approximate="none")
    logits = torch.einsum("...kh,khc->...kc", hidden, w2)
    return col.reduce_from_tp(logits, trf.parallel_of(params)) + b2


def ssr_embed(params, cfg: SSRModelConfig, batch: Dict[str, torch.Tensor], *,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[x ; y] -> h [B, Sx+Sy, D], with the text and audio positional
    dropouts (in that order) unless ``deterministic``."""
    x, y = batch["x"], batch["y"]
    sx, sy = x.shape[1], y.shape[1]
    pe = sine_table(max(sx, sy), cfg.d_model, device=x.device)
    x_h = trf.dropout(embed_text(params, cfg, x, pe),
                      cfg.text_positional_embedding_dropout, generator,
                      deterministic)
    y_h = apply_audio_pos(params, embed_audio_tokens(params, cfg, y), pe, 0)
    y_h = trf.dropout(y_h, cfg.audio_positional_embedding_dropout, generator,
                      deterministic)
    return torch.cat([x_h, y_h], dim=1)


def ssr_loss_from_hidden(params, cfg: SSRModelConfig, y_out: torch.Tensor,
                         batch: Dict[str, torch.Tensor], *,
                         predict_mask_token: bool = True,
                         predict_all: bool = False,
                         codebook_weight: Optional[Tuple[float, ...]] = None,
                         head_dtype=torch.float32,
                         par: Optional[col.Parallel] = None
                         ) -> Dict[str, torch.Tensor]:
    """Heads + masked-span CE over the audio positions (y_out [B, Sy, D]):
    sum_k mean-CE_k * ntokens_k * weight_k, and the top-10 hit by rank
    counting (#logits > target < 10), not a sort. ``cfg.ce_impl`` "fused"
    runs the second head matmul and the CE through :func:`fused_ce_head`
    (fp32 logits from ``head_dtype`` operands); "unfused" materialises the
    logits in ``head_dtype``. Under tp ``y_out`` is the whole sequence on
    every tp rank, its gradient summed over tp by the caller
    (``collectives.copy_to_tp`` or ``gather_seq``). With a dp group in
    ``par`` the batch is this rank's rows of a global one: the token counts
    (``effective_ntoken``, the per-codebook denominators) are the global
    batch's, and ``loss``, ``top10acc`` and the per-codebook terms are this
    rank's share, so their sum over dp is the global batch's value."""
    par = par or trf.parallel_of(params)
    y, y_lens = batch["y"], batch["y_lens"]
    sy = y.shape[1]
    K = cfg.n_codebooks
    ts = cfg.tokens
    targets = y[:, 1:]  # [B, Sy-1, K]
    valid = ~make_pad_mask(y_lens, sy)[:, 1:]
    masks = (targets != ts.pad) & (targets != ts.empty) & valid[..., None]
    if not predict_mask_token:
        masks = masks & (targets < ts.mts)
    tmp_masks = masks
    if not predict_all:
        is_mts = (targets == ts.mts) & valid[..., None]
        pos = torch.arange(targets.shape[1], device=y.device)[None, :, None]
        last_mts = torch.where(is_mts, pos, -1).amax(dim=1, keepdim=True)
        tmp_masks = masks & (pos >= last_mts)

    if cfg.ce_impl == "fused":
        b, sm1 = targets.shape[:2]
        dt = head_dtype
        hid = F.gelu(torch.einsum("bsd,kdh->bskh", y_out[:, :-1].to(dt),
                                  params["head1_w"].to(dt))
                     + params["head1_b"].to(dt), approximate="none")
        hid = col.gather_replicated(hid, par, dim=-1)
        w2 = col.gather_replicated(params["head2_w"], par, dim=1)
        rows = hid.permute(2, 0, 1, 3).reshape(K, b * sm1, -1).contiguous()
        tgt_rows = targets.permute(2, 0, 1).reshape(K, b * sm1)
        nll_k, hit_k = fused_ce_head(rows, w2.to(dt).contiguous(),
                                     params["head2_b"].to(dt).contiguous(),
                                     tgt_rows.to(torch.int32).contiguous())
        nll = nll_k.reshape(K, b, sm1).permute(1, 2, 0)
        hit = hit_k.reshape(K, b, sm1).permute(1, 2, 0)
    else:
        logits = predict_logits(params, y_out, dtype=head_dtype)[:, :-1]
        logf = logits.float()
        logz = torch.logsumexp(logf, dim=-1)
        tgt_logit = torch.gather(logf, -1, targets[..., None].long())[..., 0]
        nll = logz - tgt_logit  # [B, S-1, K]
        rank = (logf > tgt_logit[..., None]).float().sum(dim=-1)
        hit = (rank < 10.0).float()

    sel = tmp_masks.float()
    ce_sum = (nll * sel).sum(dim=(0, 1))
    sel_cnt = sel.sum(dim=(0, 1))
    ntokens = masks.float().sum(dim=(0, 1))
    if par is not None and par.dp_group is not None:
        sel_cnt, ntokens = col.all_reduce(torch.stack([sel_cnt, ntokens]),
                                          par.dp_group)
    sel_cnt = sel_cnt.clamp_min(1.0)
    ce_mean = ce_sum / sel_cnt
    cw = (torch.ones(K, device=y.device) if codebook_weight is None
          else torch.tensor(codebook_weight, dtype=torch.float32, device=y.device))
    loss = (ce_mean * ntokens * cw).sum()
    acc_k = (hit * sel).sum(dim=(0, 1)) / sel_cnt
    return dict(loss=loss, effective_ntoken=ntokens.sum(),
                loss_by_codebook=ce_mean, top10acc_by_codebook=acc_k * ntokens,
                top10acc=(acc_k * ntokens).sum())


def ssr_forward(params, cfg: SSRModelConfig, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                compute_dtype=None, predict_mask_token: bool = True,
                predict_all: bool = False,
                codebook_weight: Optional[Tuple[float, ...]] = None,
                remat: str = "none", par: Optional[col.Parallel] = None,
                hidden_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Training/eval loss. batch: x [B,Sx], x_lens [B], y [B,Sy,K], y_lens
    [B]. With ``cfg.attn_impl`` "flash" the attention is the fused kernel
    over the key-validity mask derived here; "einsum" builds the additive
    [B, 1, S, S] bias instead. Unless ``deterministic``, the positional and
    transformer dropouts draw from ``generator`` in JAX's order.
    ``compute_dtype`` (also the heads' dtype) defaults to the dtype of the
    decoder's matmul weights. ``remat`` checkpoints each decoder layer
    (``transformer.REMAT_MODES``).

    ``par`` (default: what ``params`` carries): this rank's tensor-parallel
    blocks, the batch being this rank's dp rows; the result is the loss of
    those rows, the same on every tp rank. Under sequence parallelism a
    sequence that does not split over tp is padded at its end with
    positions no real query attends (they come after every real one)."""
    mla_moe.refuse(cfg, "training (ssr_forward)")
    par = par or trf.parallel_of(params)
    tp = col.tp_of(par)
    sp = tp > 1 and par.sequence_parallel
    if compute_dtype is None:
        compute_dtype = params["decoder"]["layers"]["qkv_w"].dtype
    sx, sy = batch["x"].shape[1], batch["y"].shape[1]
    h = ssr_embed(params, cfg, batch, deterministic=deterministic,
                  generator=generator)
    pad = -(sx + sy) % tp if sp else 0
    if pad:
        h = torch.cat([h, h.new_zeros((h.shape[0], pad, h.shape[2]))], dim=1)
    bias = key_valid = None
    if cfg.attn_impl in ("flash", "splash"):
        key_valid = ~torch.cat([make_pad_mask(batch["x_lens"], sx),
                                make_pad_mask(batch["y_lens"], sy + pad)], dim=1)
    else:
        bias = xy_attn_bias(batch["x_lens"], batch["y_lens"], sx, sy + pad)
    out = trf.transformer_forward(params["decoder"], h, cfg, bias=bias,
                                  key_valid=key_valid, dtype=compute_dtype,
                                  deterministic=deterministic,
                                  generator=generator, remat=remat, par=par,
                                  hidden_generator=hidden_generator)
    if sp:
        out = col.gather_seq(out, par)[:, :sx + sy]
    else:
        out = col.copy_to_tp(out, par)
    return ssr_loss_from_hidden(
        params, cfg, out[:, sx:], batch, predict_mask_token=predict_mask_token,
        predict_all=predict_all, codebook_weight=codebook_weight,
        head_dtype=compute_dtype, par=par)
