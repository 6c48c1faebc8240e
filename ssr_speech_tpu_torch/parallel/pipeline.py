"""GPipe pipeline parallelism for the SSR LM (port of
``ssr_speech_tpu/parallel/pipeline.py``).

The mesh is ``(pp, dp, tp)``: a stage holds ``L / pp`` contiguous layers
(tensor-parallel inside the stage as ``models.transformer`` does it),
microbatches stream through the stages, and the activations ``[mb, S, D]``
and their gradients move between neighbouring stages by explicit
``send``/``recv``. The schedule is JAX's: with M microbatches and P stages
the forward takes M + P - 1 ticks (at tick t stage s works on microbatch
t - s; here a stage simply waits for its input), then the backward runs in
reverse, microbatch M - 1 first, each stage sending its input's gradient
back. Stage 0 embeds, the last stage runs the final norm, the heads and the
loss. The embeddings, heads and final norm stay replicated over pp, as in
JAX: their gradients are summed over pp (only stage 0, or only the last,
has one), so every stage's copy takes the same update.

``make_pp_train_step`` is ``training.trainer.make_train_step`` with
gradient accumulation over the microbatches: the per-microbatch loss is
normalised by the microbatch's (global) token count for the normalised
optimizers, the NaN/Inf skip and the metrics are the same.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import SSRModelConfig
from ..models import ssr as ssr_model
from ..models import transformer as trf
from ..ops.masking import make_pad_mask, xy_attn_bias
from ..utils.profiler import annotate
from . import collectives as col
from .mesh import QKV, Mesh


def make_pp_mesh(n_devices: Optional[int] = None, pp: int = 2,
                 tp: int = 1) -> Mesh:
    """``(pp, dp, tp)`` mesh over the process group's ranks: pp outermost
    (stage activations cross once per microbatch), tp innermost."""
    from .dist import world_size

    world = world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_pp_mesh({n_devices}): the world has {world} ranks")
    if n % (pp * tp):
        raise ValueError(f"{n} ranks do not split into pp={pp} x tp={tp}")
    return Mesh(("pp", "dp", "tp"), (pp, n // (pp * tp), tp))


def pp_param_specs() -> Dict[str, Any]:
    """Spec tree of the SSR parameters under the pp mesh: the layer stacks'
    leading dim over pp, Megatron tp inside, heads on tp, everything else
    replicated. JAX splits the packed qkv into q/k/v leaves first
    (``split_qkv``) so that its tp shards do not mix them; here ``QKV``
    gives each rank its [q | k | v] block of the packed leaf directly."""
    layers = dict(
        ln1_w=("pp", None), ln1_b=("pp", None),
        qkv_w=("pp", None, QKV), qkv_b=("pp", QKV),
        out_w=("pp", "tp", None), out_b=("pp", None),
        ln2_w=("pp", None), ln2_b=("pp", None),
        ffn1_w=("pp", None, "tp"), ffn1_b=("pp", "tp"),
        ffn2_w=("pp", "tp", None), ffn2_b=("pp", None))
    return dict(
        text_emb=(None, None), audio_emb=(None, None, None),
        text_pos_alpha=(None,), audio_pos_alpha=(None,),
        decoder=dict(layers=layers, final_ln_w=(None,), final_ln_b=(None,)),
        head1_w=(None, None, "tp"), head1_b=(None, "tp"),
        head2_w=(None, "tp", None), head2_b=(None, None))


class _Stage:
    """This rank's place in the pipeline: its stage, the stage count and
    the global ranks of its neighbours (same dp and tp coordinates)."""

    def __init__(self, mesh: Mesh):
        self.s, self.P = mesh.rank("pp"), mesh.size("pp")
        dp, tp = mesh.size("dp"), mesh.size("tp")
        here = (mesh.rank("dp") * tp + mesh.rank("tp"))
        self.prev = (self.s - 1) * dp * tp + here
        self.next = (self.s + 1) * dp * tp + here
        self.first, self.last = self.s == 0, self.s == self.P - 1


def _masks(cfg, x_lens, y_lens, sx, sy):
    if cfg.attn_impl in ("flash", "splash"):
        return None, ~torch.cat([make_pad_mask(x_lens, sx),
                                 make_pad_mask(y_lens, sy)], dim=1)
    return xy_attn_bias(x_lens, y_lens, sx, sy), None


def _stage_forward(dec, x, cfg, par, bias, key_valid, *, dtype, deterministic,
                   generator, hidden_generator, remat):
    return trf.run_layers(trf.layer_params(dec, par), x, cfg, bias=bias,
                          key_valid=key_valid, dtype=dtype,
                          deterministic=deterministic, generator=generator,
                          remat=remat, par=par,
                          hidden_generator=hidden_generator)


def pipeline_transformer(dec_params, h_mb: torch.Tensor, cfg: SSRModelConfig,
                         mesh: Mesh, *, bias_mb: Optional[torch.Tensor] = None,
                         key_valid_mb: Optional[torch.Tensor] = None,
                         deterministic: bool = True, generator=None,
                         hidden_generator=None, dtype=torch.float32,
                         remat: str = "none") -> torch.Tensor:
    """Pipelined ``transformer_forward`` over microbatches (forward only).

    ``dec_params``: this rank's decoder blocks (``pp_param_specs``); h_mb
    [M, mb, S, D] this rank's dp rows of every microbatch; bias_mb [M, mb, 1,
    S, S] (einsum attention) or key_valid_mb [M, mb, S] (fused). Returns
    [M, mb, S, D] after the final LayerNorm, broadcast from the last stage
    to every stage, as JAX's masked psum does."""
    st = _Stage(mesh)
    par = trf.parallel_of(dec_params) or mesh.parallel()
    M = h_mb.shape[0]
    outs = []
    with torch.no_grad():
        for m in range(M):
            x = (h_mb[m].to(dtype) if st.first
                 else col.recv(h_mb[m].to(dtype), st.prev))
            y = _stage_forward(dec_params, x, cfg, par,
                               None if bias_mb is None else bias_mb[m],
                               None if key_valid_mb is None else key_valid_mb[m],
                               dtype=dtype, deterministic=deterministic,
                               generator=generator,
                               hidden_generator=hidden_generator, remat=remat)
            if not st.last:
                col.send(y, st.next)
            outs.append(y)
        out = torch.stack(outs)
        if st.last:
            out = trf.layer_norm(out, dec_params["final_ln_w"],
                                 dec_params["final_ln_b"])
        g = mesh.group("pp")
        if g is not None:
            out = col.broadcast(out, st.P - 1, g)
    return out


def microbatches(batch: Dict[str, np.ndarray], n_micro: int, mesh: Mesh):
    """[B, ...] -> n_micro microbatches of contiguous rows, each this dp
    rank's contiguous block of its rows (JAX's reshape to [M, B/M] under
    ``P(None, "dp")``)."""
    B = batch["x"].shape[0]
    dp = mesh.size("dp")
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"n_micro={n_micro} microbatches")
    mb = B // n_micro
    if mb % dp:
        raise ValueError(f"microbatch of {mb} rows does not split over dp={dp}")
    loc = mb // dp
    r = mesh.rank("dp")
    return [{k: v[m * mb + r * loc:m * mb + (r + 1) * loc]
             for k, v in batch.items()} for m in range(n_micro)]


def _run_step(model, batch, cfg, tcfg, mesh: Mesh, device, n_micro, *,
              train: bool, generator=None, hidden_generator=None):
    """One pipelined pass over ``batch`` (the global batch): the forward
    schedule and, with ``train``, the backward. Returns the global sums
    (loss, top10acc, ntokens, top10acc_by_codebook)."""
    from ..training.trainer import _metrics_over, compute_dtype_of, to_device

    st = _Stage(mesh)
    par = trf.parallel_of(model)
    dtype = compute_dtype_of(tcfg)
    normalize = tcfg.optim.optimizer_name.lower() != "scaledadam"
    dec = model["decoder"]
    sx, sy = batch["x"].shape[1], batch["y"].shape[1]
    micro = [to_device(mb, device) for mb in microbatches(batch, n_micro, mesh)]
    K = cfg.n_codebooks
    zero = torch.zeros((), device=device)
    sums = [zero, zero, zero, torch.zeros(K, device=device)]
    kept = []
    grad_ctx = torch.enable_grad() if train else torch.no_grad()
    with grad_ctx:
        for mb in micro:  # forward: M + P - 1 ticks over the stages
            bias, kv = _masks(cfg, mb["x_lens"], mb["y_lens"], sx, sy)
            if st.first:
                x = ssr_model.ssr_embed(model, cfg, mb, deterministic=not train,
                                        generator=generator).to(dtype)
            else:
                like = torch.empty((mb["x"].shape[0], sx + sy, cfg.d_model),
                                   dtype=dtype, device=device)
                x = col.recv(like, st.prev).requires_grad_(train)
            y = _stage_forward(dec, x, cfg, par, bias, kv, dtype=dtype,
                               deterministic=not train, generator=generator,
                               hidden_generator=hidden_generator,
                               remat=cfg.remat if train else "none")
            if not st.last:
                col.send(y, st.next)
                kept.append((x, y))
                continue
            out = trf.layer_norm(y, dec["final_ln_w"], dec["final_ln_b"])
            res = ssr_model.ssr_loss_from_hidden(
                model, cfg, col.copy_to_tp(out, par)[:, sx:], mb,
                predict_mask_token=tcfg.masking.predict_mask_token,
                predict_all=tcfg.masking.predict_all,
                codebook_weight=tcfg.codebook_weight, head_dtype=dtype,
                par=par)
            loss = res["loss"]
            if normalize:  # the microbatch's global token count
                loss = loss / torch.clamp(res["effective_ntoken"].detach(),
                                          min=1.0)
            kept.append((x, loss))
            sums = [a + b.detach() for a, b in zip(sums, (
                res["loss"], res["top10acc"], res["effective_ntoken"],
                res["top10acc_by_codebook"]))]
    if train:
        for x, y in reversed(kept):  # backward: microbatch M - 1 first
            if st.last:
                y.backward()
            else:
                y.backward(col.recv(y, st.next))
            if not st.first:
                col.send(x.grad, st.prev)
    # the last stage's sums to every stage; the loss and hits over dp (the
    # token counts are global already)
    loss, top10, ntok, acc_cb = _metrics_over(mesh, "pp", *sums)
    loss, top10, acc_cb = _metrics_over(mesh, "dp", loss, top10, acc_cb)
    return loss, top10, ntok, acc_cb


def make_pp_train_step(cfg: SSRModelConfig, tcfg, optimizer, mesh: Mesh,
                       device, n_micro: Optional[int] = None):
    """The pipeline-parallel train step over a ``(pp, dp, tp)`` mesh:
    ``step(model, opt_state, batch, generator, hidden_generator=None) ->
    metrics`` with the semantics of ``make_train_step`` at gradient
    accumulation ``n_micro`` (default ``2 * pp``: bubble <= 1/3) over
    contiguous microbatches. ``batch``: the global x [B, Sx], x_lens, y [B,
    Sy, K], y_lens with B % n_micro == 0 and (B / n_micro) % dp == 0.
    ``model``: this rank's blocks under :func:`pp_param_specs`."""
    from ..training.trainer import any_rank, reduce_gradients
    from ..utils.tree import tree_leaves, tree_map

    pp = mesh.size("pp")
    n_micro = n_micro or 2 * pp
    if cfg.num_layers % pp:
        raise ValueError(f"{cfg.num_layers} layers do not split into pp={pp}")

    def gradients(model, batch, generator, hidden_generator=None):
        """The step's gradients (summed over the mesh) and global metrics."""
        loss_sum, top10, ntok, acc_cb = _run_step(
            model, batch, cfg, tcfg, mesh, device, n_micro, train=True,
            generator=generator, hidden_generator=hidden_generator)
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), model.tree())
        reduce_gradients(tree_leaves(grads), model.specs, mesh,
                         sequence_parallel=False)
        return grads, dict(loss=loss_sum, top10acc=top10, ntokens=ntok,
                           top10acc_by_codebook=acc_cb)

    def train_step(model, opt_state, batch, generator, hidden_generator=None):
        params = model.tree()
        grads, metrics = gradients(model, batch, generator, hidden_generator)
        finite = torch.stack([torch.isfinite(g).all() for g in tree_leaves(grads)])
        bad = not bool(torch.isfinite(metrics["loss"]) & finite.all())
        is_good = not any_rank(bad, mesh, device)
        if is_good:
            with annotate("train.update"):
                optimizer.update_(grads, opt_state, params)
        for p in tree_leaves(params):
            p.grad = None
        return dict(metrics, skipped=0.0 if is_good else 1.0)

    train_step.gradients = gradients
    return train_step


def make_pp_eval_step(cfg: SSRModelConfig, tcfg, mesh: Mesh, device,
                      n_micro: Optional[int] = None):
    """``eval_step(model, batch)``: the pipelined forward, deterministic,
    global metrics on every rank. A batch whose rows do not split into
    ``n_micro`` microbatches runs as one."""
    n_micro = n_micro or 2 * mesh.size("pp")

    def eval_step(model, batch):
        B, dp = batch["x"].shape[0], mesh.size("dp")
        m = n_micro if B % (n_micro * dp) == 0 else 1
        loss, top10, ntok, acc_cb = _run_step(model, batch, cfg, tcfg, mesh,
                                              device, m, train=False)
        return dict(loss=loss, top10acc=top10, ntokens=ntok,
                    top10acc_by_codebook=acc_cb)

    return eval_step


def shard_params_pp(mesh: Mesh, params, cfg: Optional[SSRModelConfig] = None):
    """This rank's blocks of the whole SSR parameters for pipeline training
    (``mesh.shard_model`` under :func:`pp_param_specs`)."""
    from .mesh import shard_model

    return shard_model(mesh, params, pp_param_specs(), mesh.parallel(), cfg=cfg)
