"""Watermark-codec trainer: GAN + watermark CE + balancer (port of
``ssr_speech_tpu/training/codec_trainer.py``).

- Only the watermark decoder trains; the encoder, decoder and quantizer are
  frozen and run without autograd.
- Each step: the watermark CE on masked audio plus 0.25 x the CE on clean
  audio; the MS-STFT hinge adversarial and feature-matching losses, L1 and
  the multi-scale mel loss, combined by the gradient balancer with the
  weights adv 4 / feat 4 / l1 0.1 / msspec 2.
- The discriminator trains every step on hinge real/fake losses.
- Adam lr 5e-4, betas (0.5, 0.9), for both; an EMA (decay 0.99) of the
  trained weights.

The balancer in torch: each balanced loss is a function of the generator
OUTPUT ``y_pred`` only, so its gradient is one ``torch.autograd.grad`` on a
detached copy of ``y_pred``; the balancer combines them into one cotangent,
and ONE ``torch.autograd.grad`` carries it, with the CE's cotangents, through
the watermark decoder. ``autograd.grad`` never writes ``.grad``, so the
discriminator's parameters carry no gradient from the generator's losses.

The state is a tree of plain tensors updated in place; the step returns the
same state object, so ``state, metrics = step(state, ...)`` reads as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..config import CodecConfig
from ..models.codec import quantize as q
from ..models.codec import seanet
from ..models.codec import wmencodec as wm
from ..utils.tree import tree_leaves, tree_map
from . import discriminators as disc_mod
from . import losses as L
from .optim import Adam

BALANCE_WEIGHTS = {"adv": 4.0, "feat": 4.0, "l1": 0.1, "msspec": 2.0}

# the rest of the reference's selectable reconstruction losses; any subset
# may be named in ``balance_weights``
RECON_LOSS_FNS = {
    "l1": lambda yp, x, sr: L.l1_loss(yp, x),
    "l2": lambda yp, x, sr: L.l2_loss(yp, x),
    "msspec": lambda yp, x, sr: L.multiscale_mel_loss(yp, x, sr),
    "mel": lambda yp, x, sr: L.mel_l1_loss(yp, x, sr),
    "mstft": lambda yp, x, sr: L.mrstft_loss(yp, x),
}

# adversarial objective family: (generator, disc-real, disc-fake)
ADV_LOSS_FNS = {
    "hinge": (L.hinge_gen_loss, L.hinge_real_loss, L.hinge_fake_loss),
    "mse": (L.mse_gen_loss, L.mse_real_loss, L.mse_fake_loss),
}


def _resolve_losses(balance_weights, adv_loss_mode):
    bw = dict(BALANCE_WEIGHTS if balance_weights is None else balance_weights)
    if "adv" not in bw or "feat" not in bw:
        raise ValueError("balance_weights must include 'adv' and 'feat'")
    unknown = [k for k in bw if k not in ("adv", "feat")
               and k not in RECON_LOSS_FNS]
    if unknown:
        raise ValueError(f"unknown loss keys {unknown}; "
                         f"choose from {sorted(RECON_LOSS_FNS)}")
    return bw, ADV_LOSS_FNS[adv_loss_mode]


@dataclass
class CodecTrainState:
    """Field for field the JAX ``CodecTrainState``. ``wm_params`` (and for
    the plain-codec step the encoder and decoder in ``frozen``) require
    grad; the optimizer states are ``Adam`` states."""

    wm_params: Any
    frozen: Any
    disc_params: Any
    g_opt: Any
    d_opt: Any
    balancer: L.BalancerState
    ema_params: Any
    step: torch.Tensor


def make_optimizers(lr: float = 5e-4):
    return Adam(lr, b1=0.5, b2=0.9), Adam(lr, b1=0.5, b2=0.9)


def _trainable(tree, device):
    return tree_map(lambda t: torch.as_tensor(t).to(device, torch.float32)
                    .detach().clone().requires_grad_(True), tree)


def _constant(tree, device):
    return tree_map(lambda t: torch.as_tensor(t).to(device), tree)


def init_codec_train_state(gen: torch.Generator, cfg: CodecConfig,
                           lr: float = 5e-4,
                           pretrained: Optional[Dict[str, Any]] = None,
                           balance_weights: Optional[Dict[str, float]] = None,
                           disc_scales: Optional[int] = None, device="cpu"):
    """-> (state, (g_opt, d_opt)). ``pretrained`` is a codec params tree
    (numpy or torch leaves); without it the codec is drawn from ``gen``.
    ``disc_scales`` < 5 trains against the first N MS-STFT scales."""
    params = (pretrained if pretrained is not None
              else wm.init_wmencodec(gen, cfg, device))
    wm_params = _trainable(params["wmdecoder"], device)
    frozen = _constant({k: params[k] for k in ("encoder", "decoder",
                                               "quantizer")}, device)
    disc = _trainable(disc_mod.init_msstftd(
        gen, n_scales=disc_scales or len(disc_mod.N_FFTS), device=device),
        device)
    g_opt_t, d_opt_t = make_optimizers(lr)
    state = CodecTrainState(
        wm_params=wm_params, frozen=frozen, disc_params=disc,
        g_opt=g_opt_t.init(wm_params), d_opt=d_opt_t.init(disc),
        balancer=L.init_balancer(list(balance_weights or BALANCE_WEIGHTS),
                                 device),
        ema_params=tree_map(lambda t: t.detach().clone(), wm_params),
        step=torch.zeros((), dtype=torch.int32))
    return state, (g_opt_t, d_opt_t)


def _caster(compute_dtype: Optional[str]):
    if compute_dtype in (None, "float32"):
        return lambda t: t
    dt = getattr(torch, compute_dtype)
    return lambda t: t.to(dt)


def _grads(outputs, leaves, grad_outputs=None):
    """``torch.autograd.grad`` with zeros for leaves the outputs do not
    reach (JAX's vjp gives zeros there)."""
    got = torch.autograd.grad(outputs, leaves, grad_outputs=grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(got, leaves)]


def _balanced_cotangent(state, y_pred, x, x_c, cast, bw, gen_loss, sr):
    """The balanced generator losses, each as f(y_pred): the adversarial and
    feature-matching pair from one graph through the discriminator as it is
    (before this step's update), then each reconstruction loss. Returns
    (cotangent on y_pred, balancer state, g_loss, losses)."""
    yp = y_pred.detach().requires_grad_(True)
    disc = state.disc_params
    logits_f, fmaps_f = disc_mod.msstftd_forward(disc, cast(yp))
    with torch.no_grad():
        _, fmaps_r = disc_mod.msstftd_forward(disc, x_c)
    adv = sum(gen_loss(lg) for lg in logits_f) / len(logits_f)
    feat = sum(L.feature_matching_loss(ff, fr)
               for ff, fr in zip(fmaps_f, fmaps_r)) / len(fmaps_f)
    g_adv, = torch.autograd.grad(adv, yp, retain_graph=True)
    g_feat, = torch.autograd.grad(feat, yp)
    losses = dict(adv=adv.detach(), feat=feat.detach())
    grads_out = dict(adv=g_adv, feat=g_feat)
    for k in bw:
        if k in ("adv", "feat"):
            continue
        loss = RECON_LOSS_FNS[k](yp, x, sr)
        grads_out[k], = torch.autograd.grad(loss, yp)
        losses[k] = loss.detach()
    cot, new_bal, g_loss = L.balancer_cotangent(state.balancer, grads_out, bw,
                                                losses)
    return cot, new_bal, g_loss, losses


def _discriminator_step(state, d_opt_t, y_det, x_c, real_loss, fake_loss):
    """One discriminator update on the detached generator output."""
    leaves = tree_leaves(state.disc_params)
    logits_f, _ = disc_mod.msstftd_forward(state.disc_params, y_det)
    logits_r, _ = disc_mod.msstftd_forward(state.disc_params, x_c)
    d_loss = sum(fake_loss(lf) + real_loss(lr_)
                 for lf, lr_ in zip(logits_f, logits_r)) / len(logits_f)
    g_d = _grads(d_loss, leaves)
    d_opt_t.update_(g_d, state.d_opt, state.disc_params)
    return d_loss.detach()


def make_codec_train_step(cfg: CodecConfig, optimizers, ema_decay: float = 0.99,
                          balance_weights: Optional[Dict[str, float]] = None,
                          adv_loss_mode: str = "hinge",
                          compute_dtype: Optional[str] = None,
                          wm_ce_weight: float = 1.0):
    """``step(state, wav [B, T, 1], labels [B, F] 0/1, keep [B, T]) ->
    (state, metrics)``; ``keep`` is 1 outside the watermarked spans.

    ``compute_dtype="bfloat16"`` runs the watermark decoder, the detector
    and the discriminator passes with bf16 activations; parameters, losses,
    the balancer and the optimizers stay fp32, as do the frozen encoder and
    RVQ. None / "float32" is the full-fp32 step."""
    g_opt_t, d_opt_t = optimizers
    sr, sn = cfg.sample_rate, cfg.seanet
    cast = _caster(compute_dtype)
    bw, (gen_loss, real_loss, fake_loss) = _resolve_losses(
        balance_weights, adv_loss_mode)

    def train_step(state: CodecTrainState, wav, labels, keep):
        x = wav
        labels = labels.long()
        with torch.no_grad():
            emb = seanet.encode(state.frozen["encoder"], x, sn)
            latents, _ = q.rvq_quantize(state.frozen["quantizer"], emb)
        latents = cast(latents)
        masked_wav = cast(x * keep[..., None])
        x_c = cast(x)

        wm_p = state.wm_params
        y_full, mark = seanet.wm_decode(wm_p, latents, labels, masked_wav, sn)
        y_pred = y_full[:, :x.shape[1]].to(x.dtype)
        mark = mark.to(x.dtype)
        clean = seanet.detect_watermark_logits(wm_p, x_c, sn).to(x.dtype)

        m_in = mark.detach().requires_grad_(True)
        c_in = clean.detach().requires_grad_(True)
        cls_loss = wm_ce_weight * (
            L.cross_entropy(m_in, labels) + 0.25 * L.cross_entropy(
                c_in, torch.zeros(c_in.shape[:-1], dtype=torch.long,
                                  device=c_in.device)))
        g_mark, g_clean = torch.autograd.grad(cls_loss, [m_in, c_in])

        cot, new_bal, g_loss, losses = _balanced_cotangent(
            state, y_pred, x, x_c, cast, bw, gen_loss, sr)
        wm_leaves = tree_leaves(wm_p)
        g_wm = _grads([y_pred, mark, clean], wm_leaves,
                      grad_outputs=[cot, g_mark, g_clean])
        del y_full, mark, clean
        g_opt_t.update_(g_wm, state.g_opt, wm_p)

        d_loss = _discriminator_step(state, d_opt_t, cast(y_pred.detach()),
                                     x_c, real_loss, fake_loss)
        with torch.no_grad():
            ema = tree_leaves(state.ema_params)
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, torch._foreach_mul(
                [p.detach() for p in wm_leaves], 1.0 - ema_decay))
        state.balancer = new_bal
        state.step += 1
        metrics = dict(cls_loss=cls_loss.detach() / wm_ce_weight,
                       d_loss=d_loss, g_loss=g_loss, **losses)
        return state, metrics

    return train_step


def make_compression_train_step(cfg: CodecConfig, optimizers,
                                straight_through: bool = True,
                                balance_weights: Optional[Dict[str, float]] = None,
                                adv_loss_mode: str = "hinge",
                                compute_dtype: Optional[str] = None):
    """The plain EnCodec step: the same adversarial and reconstruction
    losses, no watermark head, training the encoder and decoder. With
    ``straight_through`` the encoder gets the straight-through gradient of
    the quantizer; without it only the decoder trains (the fork's quantizer,
    whose estimator is commented out). The codebooks stay frozen."""
    g_opt_t, d_opt_t = optimizers
    sr, sn = cfg.sample_rate, cfg.seanet
    cast = _caster(compute_dtype)
    bw, (gen_loss, real_loss, fake_loss) = _resolve_losses(
        balance_weights, adv_loss_mode)

    def train_step(state: CodecTrainState, wav):
        x = wav
        x_c = cast(x)
        trainable = dict(encoder=state.frozen["encoder"],
                         decoder=state.frozen["decoder"])
        emb = seanet.encode(trainable["encoder"], x_c, sn)
        with torch.no_grad():
            # the nearest-code search in fp32 (bf16 distance ties are noisy)
            quant, _ = q.rvq_quantize(state.frozen["quantizer"],
                                      emb.to(x.dtype))
        if straight_through:
            latents = emb + (quant.to(emb.dtype) - emb).detach()
        else:
            latents = cast(quant)
        y_pred = seanet.decode(trainable["decoder"], latents, sn)
        y_pred = y_pred[:, :x.shape[1]].to(x.dtype)

        cot, new_bal, g_loss, losses = _balanced_cotangent(
            state, y_pred, x, x_c, cast, bw, gen_loss, sr)
        tr_leaves = tree_leaves(trainable)
        g_tr = _grads(y_pred, tr_leaves, grad_outputs=cot)
        g_opt_t.update_(g_tr, state.g_opt, trainable)

        d_loss = _discriminator_step(state, d_opt_t, cast(y_pred.detach()),
                                     x_c, real_loss, fake_loss)
        state.balancer = new_bal
        state.step += 1
        return state, dict(d_loss=d_loss, g_loss=g_loss, **losses)

    return train_step


def init_compression_train_state(gen: torch.Generator, cfg: CodecConfig,
                                 lr: float = 5e-4, pretrained=None,
                                 balance_weights=None, device="cpu"):
    """State of the plain-codec step: the generator's optimizer tracks the
    (encoder, decoder) tree, which trains in place inside ``frozen``."""
    params = (pretrained if pretrained is not None
              else wm.init_wmencodec(gen, cfg, device))
    frozen = dict(encoder=_trainable(params["encoder"], device),
                  decoder=_trainable(params["decoder"], device),
                  quantizer=_constant(params["quantizer"], device))
    disc = _trainable(disc_mod.init_msstftd(gen, device=device), device)
    g_opt_t, d_opt_t = make_optimizers(lr)
    wm_params = _constant(params["wmdecoder"], device)
    state = CodecTrainState(
        wm_params=wm_params, frozen=frozen, disc_params=disc,
        g_opt=g_opt_t.init(dict(encoder=frozen["encoder"],
                                decoder=frozen["decoder"])),
        d_opt=d_opt_t.init(disc),
        balancer=L.init_balancer(list(balance_weights or BALANCE_WEIGHTS),
                                 device),
        ema_params=tree_map(lambda t: t.clone(), wm_params),
        step=torch.zeros((), dtype=torch.int32))
    return state, (g_opt_t, d_opt_t)


def _choice(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct indices of range(n), drawn from ``gen``."""
    return torch.randperm(n, generator=gen)[:k]


@torch.no_grad()
def kmeans_init_codebooks(gen: torch.Generator, cfg: CodecConfig,
                          embeddings: torch.Tensor,
                          iters: int = 50) -> torch.Tensor:
    """k-means codebooks from encoder embeddings [N, D] (50 iterations, as
    the reference's kmeans_init); each residual stage is fitted on the
    residuals of the stages before. Returns [n_q, bins, D]."""
    n_q, bins = cfg.rvq.n_q, cfg.rvq.bins
    resid = embeddings.float()
    books = []
    for _ in range(n_q):
        idx = _choice(gen, resid.shape[0], bins).to(resid.device)
        means = resid[idx]
        for _ in range(iters):
            assign = q.nearest_code(means, resid)
            one_hot = torch.nn.functional.one_hot(assign, bins).float()
            counts = one_hot.sum(0)
            sums = one_hot.T @ resid
            new_means = sums / torch.clamp(counts[:, None], min=1.0)
            means = torch.where(counts[:, None] > 0, new_means, means)
        books.append(means)
        resid = resid - means[q.nearest_code(means, resid)]
    return torch.stack(books)


@torch.no_grad()
def reconstruct(state: CodecTrainState, cfg: CodecConfig,
                wav: torch.Tensor) -> torch.Tensor:
    """The watermark decoder's reconstruction of a batch with clean labels
    (the generate stage's payload)."""
    emb = seanet.encode(state.frozen["encoder"], wav, cfg.seanet)
    latents, _ = q.rvq_quantize(state.frozen["quantizer"], emb)
    labels = torch.zeros(latents.shape[:2], dtype=torch.long,
                         device=wav.device)
    y_pred, _ = seanet.wm_decode(state.wm_params, latents, labels, wav,
                                 cfg.seanet)
    return y_pred[:, :wav.shape[1]]


def evaluate_sisnr(state: CodecTrainState, cfg: CodecConfig,
                   wav: torch.Tensor) -> torch.Tensor:
    """Eval-stage SI-SNR of the watermark reconstruction (mean over rows)."""
    from ..utils.metrics import si_snr

    return si_snr(reconstruct(state, cfg, wav), wav).mean()
