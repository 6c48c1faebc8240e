"""SSR LM trainer (port of ``ssr_speech_tpu/training/trainer.py``): the train
step and the host training loop, on one device or over a rank mesh.

- fp32 master parameters (``nn.Parameter``), forward and backward in the
  compute dtype (bf16 with ``precision="bfloat16"``), as the JAX trainer casts
  at each use;
- gradient accumulation over ``[A, B/A, ...]`` microbatches, gradients summed;
- ScaledAdam steps on the un-normalised weighted-sum loss, the other
  optimizers on loss / ntokens;
- the NaN/Inf skip: a step whose loss or any gradient is not finite leaves
  the parameters and the optimizer state untouched (the decision is taken
  before the in-place update, where JAX selects the old values after it);
- validation, best/last bundles, numbered step checkpoints, early stop,
  ``load_bundle`` for ``--resume`` and ``--load_model_from``, and
  ``benchmark_no_load``.

The parameters are JAX's ``Trainer``'s: ``init_ssr`` on the second key of
``split(PRNGKey(tcfg.seed))`` (``utils.prng``, JAX's threefry draw). The
dropout stream is a ``torch.Generator`` on the device seeded from
``tcfg.seed``; its state travels in the bundle as ``torch_rng_state`` (JAX's
key is ``rng_state``, so each package ignores the other's stream). Each
decoder layer is checkpointed as ``cfg.remat`` says (``models.transformer``).

Over a mesh (``parallel.mesh``; the JAX trainer's GSPMD step made
explicit): each rank holds its tensor-parallel (and, with fsdp, layer-stack)
blocks and takes its dp rows of every global batch. The gradients of
dp-replicated leaves are SUMMED over dp, because ScaledAdam steps on the
summed loss; the normalised optimizers divide each (micro)batch's loss by
its global token count. Under sequence parallelism the leaves that act on
the rank's block of the sequence (the norms, the row-parallel biases) are
summed over tp as well. The NaN/Inf skip is decided on all ranks together,
the metrics are global, and only rank 0 writes bundles and metrics.
``pp > 1`` runs the GPipe step of ``parallel.pipeline``. Not ported:
``unroll``, ``rng_impl``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..config import SSRModelConfig, TrainConfig
from ..models import ssr as ssr_model
from ..models.from_jax import lm_to_numpy, trainable_lm_from_jax
from ..models.transformer import parallel_of
from ..parallel import collectives as col
from ..parallel import mesh as meshlib
from ..parallel.dist import is_main
from ..utils.checkpoint import load_bundle, save_bundle, save_step_checkpoint
from ..utils.logging_utils import MetricsWriter
from ..utils import prng
from ..utils.metrics import AverageMeter
from ..utils.profiler import Profiler, annotate
from ..utils.tree import to_numpy_tree, tree_leaves, tree_map
from ..utils.watchdog import DeadlockDetect
from . import optim as optimlib

logger = logging.getLogger(__name__)

BATCH_KEYS = ("x", "x_lens", "y", "y_lens")


def compute_dtype_of(tcfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if tcfg.precision == "bfloat16" else torch.float32


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device) for k in BATCH_KEYS}


def split_microbatches(batch: Dict[str, np.ndarray], accum: int,
                       cfg: SSRModelConfig) -> Dict[str, np.ndarray]:
    """[B, ...] -> [A, ceil(B/A), ...]: microbatch j takes rows j::A (the
    reference trainer's slicing); zero-length rows (no loss, no tokens) fill
    B up to a multiple of A."""
    b = batch["x"].shape[0]
    pad = -b % accum
    if pad:
        fill = dict(x=cfg.text_pad_token, y=cfg.tokens.pad, x_lens=0, y_lens=0)
        batch = {k: np.concatenate([v, np.full((pad,) + v.shape[1:], fill[k],
                                                v.dtype)]) for k, v in batch.items()}
    return {k: np.stack([v[j::accum] for j in range(accum)])
            for k, v in batch.items()}


def dp_rows(batch: Dict[str, np.ndarray], mesh, row_axis: int = 0):
    """This rank's dp block of rows of a global batch (``mesh.batch_specs``:
    contiguous blocks in dp order, as ``P("dp")`` places them)."""
    if mesh is None or mesh.size("dp") == 1:
        return batch
    specs = meshlib.batch_specs(lead=row_axis)
    return {k: meshlib.local_block(mesh, torch.as_tensor(np.asarray(v)), specs[k])
            for k, v in batch.items()}


def _metrics_over(mesh, axis: str, *vals):
    """Scalars (and one vector) summed over a mesh axis in one all-reduce."""
    g = None if mesh is None else mesh.group(axis)
    if g is None:
        return vals
    flat = torch.cat([torch.as_tensor(v, dtype=torch.float32).reshape(-1)
                      for v in vals])
    flat = col.all_reduce(flat, g)
    out, i = [], 0
    for v in vals:
        n = torch.as_tensor(v).numel()
        out.append(flat[i:i + n].reshape(torch.as_tensor(v).shape))
        i += n
    return out


# elements (64 MiB in fp32) one gradient all-reduce carries at most
GRAD_BUCKET = 1 << 24


def _grad_buckets(gs, size: int):
    """Lists of flat pieces of the tensors ``gs``, in order, at most
    ``size`` elements a list: small tensors whole, large ones cut into
    slices (views, so a reduction of a piece lands in its tensor)."""
    bucket, n = [], 0
    for g in gs:
        flat = g.view(-1)
        i = 0
        while i < flat.numel():
            take = min(flat.numel() - i, size - n)
            bucket.append(flat[i:i + take])
            n += take
            i += take
            if n == size:
                yield bucket
                bucket, n = [], 0
    if bucket:
        yield bucket


def _sum_grads(grads, groups) -> None:
    """In place: each gradient summed over its process group, in buckets of
    at most ``GRAD_BUCKET`` elements (``collectives.all_reduce_``): no copy
    of the whole model's gradients is made. A sum over two ranks is a + b
    element by element, whatever the buckets."""
    by_group = {}
    for g, grp in zip(grads, groups):
        if grp is not None:
            by_group.setdefault(grp, []).append(g)
    for grp, gs in by_group.items():
        flat = [g if g.is_contiguous() else g.contiguous() for g in gs]
        for bucket in _grad_buckets(flat, GRAD_BUCKET):
            col.all_reduce_(bucket, grp)
        for g, f in zip(gs, flat):
            if f is not g:
                g.copy_(f)


# leaves read by index (an embedding lookup): their gradient is a scatter-add,
# whose float sums come out in a varying order (atomics on the card, threads
# on the CPU), so the tp ranks' copies could drift apart bit by bit
SCATTERED_LEAVES = ("text_emb", "audio_emb")


def reduce_gradients(grads, specs, mesh, *, sequence_parallel: bool) -> None:
    """The mesh's gradient sums, in place (``grads`` in leaf order, ``specs``
    the spec tree): over dp for every leaf the dp ranks do not share out (an fsdp
    stack's gradient was summed onto its owner in the backward), and under
    sequence parallelism over tp for the replicated leaves that act on the
    rank's sequence block."""
    if mesh is None:
        return
    items = meshlib.spec_items(specs)
    axes = [{meshlib._axis(e) for e in spec if e is not None}
            for _, spec in items]
    _sum_grads(grads, [mesh.group("dp") if "dp" not in a else None
                       for a in axes])
    # pipeline: the pp-replicated leaves (embeddings, heads, final norm)
    # have a gradient on one stage only
    _sum_grads(grads, [mesh.group("pp") if "pp" not in a else None
                       for a in axes])
    if sequence_parallel:  # the decoder's norms and row-parallel biases
        _sum_grads(grads, [mesh.group("tp") if path[0] == "decoder"
                           and "tp" not in a else None
                           for (path, _), a in zip(items, axes)])
    if mesh.group("tp") is not None:  # tp rank 0's, so the copies stay equal
        for g, (path, _) in zip(grads, items):
            if path[-1] in SCATTERED_LEAVES:
                g.copy_(col.broadcast(g, 0, mesh.group("tp")))


def any_rank(flag: bool, mesh, device) -> bool:
    """True on every rank when ``flag`` is True on any (the skip decision;
    over the whole group, a tensor on ``device`` as NCCL needs)."""
    if mesh is None or not torch.distributed.is_initialized():
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(col.all_reduce_max(t, None).item())


def make_train_step(cfg: SSRModelConfig, tcfg: TrainConfig, optimizer,
                    device, *, mesh=None,
                    sequence_parallel: bool = False) -> Callable:
    """``step(model, opt_state, batch, generator, hidden_generator=None) ->
    metrics``. ``batch`` holds numpy or torch arrays x [B,Sx], x_lens, y
    [B,Sy,K], y_lens; with gradient accumulation the leading dim is [A, B/A,
    ...]. Updates ``model``'s parameters and ``opt_state`` in place unless
    the step is skipped; metrics are device tensors (``skipped`` 0.0 or
    1.0).

    Over a ``mesh`` the batch is the global one and ``model`` this rank's
    blocks (``Trainer`` builds it with ``mesh.shard_model``; its
    ``parallel`` says tp and fsdp); ``hidden_generator`` draws the FFN
    hidden's dropout under tp. Metrics are global (summed over dp)."""
    dtype = compute_dtype_of(tcfg)
    normalize = tcfg.optim.optimizer_name.lower() != "scaledadam"
    accum = tcfg.gradient_accumulation_steps

    def loss_fn(model, batch, generator, hidden_generator, par):
        out = ssr_model.ssr_forward(
            model, cfg, batch, deterministic=False, generator=generator,
            compute_dtype=dtype,
            predict_mask_token=tcfg.masking.predict_mask_token,
            predict_all=tcfg.masking.predict_all,
            codebook_weight=tcfg.codebook_weight, remat=cfg.remat, par=par,
            hidden_generator=hidden_generator)
        loss = out["loss"]
        if normalize:  # the (global) batch's token count
            loss = loss / torch.clamp(out["effective_ntoken"].detach(), min=1.0)
        return loss, out

    def gradients(model, batch, generator, hidden_generator=None):
        """The step's gradients (summed over the mesh as the update needs
        them, a tree like the parameters) and its global metrics."""
        params = model.tree()
        par = None
        if mesh is not None:
            par = parallel_of(model)
            par = par.with_sequence_parallel(sequence_parallel) if par else None
            batch = dp_rows(batch, mesh, row_axis=0 if accum == 1 else 1)
        micro = ([batch] if accum == 1 else
                 [{k: v[j] for k, v in batch.items()} for j in range(accum)])
        loss_sum = top10_sum = ntok = acc_cb = 0.0
        for mb in micro:
            with annotate("train.forward"):
                loss, out = loss_fn(model, to_device(mb, device), generator,
                                    hidden_generator, par)
            with annotate("train.backward"):
                loss.backward()
            loss_sum = loss_sum + out["loss"].detach()
            top10_sum = top10_sum + out["top10acc"].detach()
            ntok = ntok + out["effective_ntoken"].detach()
            acc_cb = acc_cb + out["top10acc_by_codebook"].detach()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        if mesh is not None:
            reduce_gradients(tree_leaves(grads), model.specs, mesh,
                             sequence_parallel=sequence_parallel)
            # each rank's share of the loss and hits; the counts are global
            loss_sum, top10_sum, acc_cb = _metrics_over(
                mesh, "dp", loss_sum, top10_sum, acc_cb)
        return grads, dict(loss=loss_sum, top10acc=top10_sum, ntokens=ntok,
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


def make_eval_step(cfg: SSRModelConfig, tcfg: TrainConfig, device, *,
                   mesh=None) -> Callable:
    """``eval_step(model, batch) -> metrics`` (deterministic); over a mesh
    the batch is the global one and the metrics are global."""
    dtype = compute_dtype_of(tcfg)

    @torch.no_grad()
    def eval_step(model, batch):
        if mesh is not None:
            batch = dp_rows(batch, mesh)
        out = ssr_model.ssr_forward(
            model, cfg, to_device(batch, device), deterministic=True,
            compute_dtype=dtype,
            predict_mask_token=tcfg.masking.predict_mask_token,
            predict_all=tcfg.masking.predict_all,
            codebook_weight=tcfg.codebook_weight)
        m = (out["loss"], out["top10acc"], out["top10acc_by_codebook"])
        if mesh is not None:
            m = _metrics_over(mesh, "dp", *m)
        return dict(loss=m[0], top10acc=m[1], ntokens=out["effective_ntoken"],
                    top10acc_by_codebook=m[2])

    return eval_step


class Trainer:
    """Host-side training loop (the JAX ``Trainer``).

    ``device`` is a required keyword: a caller names the card or the CPU.
    Parameters start from JAX's ``Trainer``'s draw: ``init_ssr`` on the
    second key of ``split(PRNGKey(tcfg.seed))``, made on ``device``
    (``load_bundle`` replaces them); the dropout generator is seeded
    ``tcfg.seed``. ``history`` keeps one record
    per step: step, loss, ntokens, skipped, wall seconds (the step ends in a
    host sync, the skip decision, so they cover the device's work), the batch
    shape (B, Sx, Sy) and its unpadded positions.

    ``mesh`` (``parallel.mesh.make_mesh``, or ``pipeline.make_pp_mesh`` with
    ``pp > 1``): every rank builds the same whole parameters, keeps its
    blocks and initialises the optimizer on them (a whole state is never
    made); ``sequence_parallel`` (not with ``pp > 1``, as in JAX) splits the
    residual stream over tp. Each dp rank draws its own dropout masks; under
    tp the residual masks are the same on every tp rank and the FFN-hidden
    masks differ by tp rank. Bundles hold the whole (gathered) parameters and
    optimizer state, written by rank 0."""

    def __init__(self, cfg: SSRModelConfig, tcfg: TrainConfig,
                 train_loader: Callable[[int], Iterator[Dict[str, np.ndarray]]],
                 valid_loader: Optional[Callable[[], Iterator]] = None,
                 phn2num: Optional[Dict[str, int]] = None,
                 exp_dir: Optional[str] = None, *, device, mesh=None,
                 pp: int = 1, n_micro: Optional[int] = None,
                 sequence_parallel: bool = False):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = torch.device(device)
        self.train_loader, self.valid_loader = train_loader, valid_loader
        self.phn2num = phn2num or {}
        self.exp_dir = exp_dir or tcfg.data.exp_dir or "exp"
        self.mesh = mesh
        if pp > 1 and sequence_parallel:
            raise ValueError(
                "sequence_parallel is not supported with pp > 1 (the "
                "GPipe step shards activations by stage/microbatch; "
                "drop --sequence_parallel or use the tp step)")
        if is_main():
            os.makedirs(self.exp_dir, exist_ok=True)

        # dropout streams: one per dp rank and pipeline stage (rank 0's is
        # the single-device stream), the FFN hidden's one per tp rank too
        seed = tcfg.seed
        if mesh is not None:
            seed += 1000003 * mesh.rank("dp") + 104729 * mesh.rank("pp")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.hidden_generator = None
        if mesh is not None and mesh.size("tp") > 1:
            self.hidden_generator = torch.Generator(device=self.device)
            self.hidden_generator.manual_seed(seed + 7919 * (1 + mesh.rank("tp")))
        # the parameters are JAX's: PRNGKey(seed), split, init from the
        # second key (the first is JAX's dropout stream, which the port
        # draws from the generators above)
        init_key = prng.split(prng.PRNGKey(tcfg.seed, self.device))[1]
        params = ssr_model.init_ssr(init_key, cfg, self.device)
        total = tcfg.num_steps or 100000
        self.optimizer, self.schedule = optimlib.build_optimizer(tcfg.optim, total)
        if mesh is None:
            self.model = trainable_lm_from_jax(params, cfg, device=self.device)
        else:
            if pp > 1:
                from ..parallel import pipeline as pl

                specs = pl.pp_param_specs()
            else:
                specs = meshlib.ssr_param_specs()
            # shard BEFORE the optimizer's init: a whole state for the 830M
            # would transiently double optimizer memory
            self.model = meshlib.shard_model(mesh, params, specs,
                                             mesh.parallel(), cfg=cfg)
            self.optimizer.set_sharding(meshlib.shard_groups(mesh, specs))
        del params
        self.opt_state = self.optimizer.init(self.model.tree())
        if pp > 1:
            from ..parallel import pipeline as pl

            self.train_step = pl.make_pp_train_step(
                cfg, tcfg, self.optimizer, mesh, self.device, n_micro=n_micro)
        else:
            self.train_step = make_train_step(
                cfg, tcfg, self.optimizer, self.device, mesh=mesh,
                sequence_parallel=sequence_parallel)
        self.eval_step = (pl.make_pp_eval_step(cfg, tcfg, mesh, self.device,
                                               n_micro=n_micro) if pp > 1
                          else make_eval_step(cfg, tcfg, self.device, mesh=mesh))
        self.progress = dict(step=0, epoch=0, cur_step=0, best_step=0,
                             best_score=float("inf"))
        self.meters = {k: AverageMeter() for k in
                       ("train_loss", "train_top10acc", "data_time", "train_time")}
        self.total_step = total
        self.writer = MetricsWriter(self.exp_dir) if is_main() else _NoWriter()
        self.history: List[Dict[str, float]] = []
        self._watchdog: Optional[DeadlockDetect] = None

    # ------------------------------------------------------------- loop

    def train(self, benchmark_no_load: bool = False):
        """Main loop. ``benchmark_no_load`` repeats the first batch to
        benchmark the step loop without I/O."""
        tcfg = self.tcfg
        watchdog = DeadlockDetect(use=tcfg.deadlock_timeout > 0,
                                  timeout=tcfg.deadlock_timeout)
        prof = Profiler(logdir=os.path.join(self.exp_dir, "profile"),
                        enabled=tcfg.profile_steps > 0 and is_main(),
                        num_steps=tcfg.profile_steps)
        self._watchdog = watchdog
        try:
            with watchdog:
                self._train_loop(tcfg, benchmark_no_load, watchdog, prof)
        finally:
            prof.close()
            self._watchdog = None
        return self.progress

    def _train_loop(self, tcfg, benchmark_no_load, watchdog, prof):
        accum = tcfg.gradient_accumulation_steps
        flag = True
        bench_batch = None
        data_start = time.time()
        while flag:
            for batch in self.train_loader(self.progress["epoch"]):
                if benchmark_no_load:
                    if bench_batch is None:
                        bench_batch = batch
                    batch = bench_batch
                if self.progress["step"] > self.total_step:
                    flag = False
                    self.validate_and_save()
                    break
                data_end = time.time()
                shape = (batch["x"].shape[0], batch["x"].shape[1], batch["y"].shape[1])
                real = int(np.sum(batch["x_lens"]) + np.sum(batch["y_lens"]))
                if accum > 1:
                    batch = split_microbatches(batch, accum, self.cfg)
                watchdog.update("dispatch")
                with annotate("train_step"):
                    m = self.train_step(self.model, self.opt_state, batch,
                                        self.generator, self.hidden_generator)
                loss, ntok = float(m["loss"]), float(m["ntokens"])
                step_s = time.time() - data_end
                watchdog.update("step")
                prof.step()
                step = self.progress["step"]
                self.history.append(dict(
                    step=step, loss=loss, ntokens=ntok, skipped=m["skipped"],
                    seconds=step_s, batch_shape=shape, real_tokens=real))
                if step % tcfg.print_every_n_steps == 0:
                    ntok = max(ntok, 1.0)
                    self.meters["train_loss"].update(loss / ntok)
                    self.meters["train_top10acc"].update(float(m["top10acc"]) / ntok)
                    self.meters["data_time"].update(data_end - data_start)
                    self.meters["train_time"].update(step_s)
                    lr = self.schedule(step)
                    self.writer.add_scalars(step, dict(
                        lr=lr, loss=self.meters["train_loss"].val,
                        top10acc=self.meters["train_top10acc"].val,
                        ntokens=ntok, skipped=m["skipped"],
                        data_time=self.meters["data_time"].val,
                        train_time=self.meters["train_time"].val,
                    ), prefix="train/")
                    logger.info(
                        "step %d/%d lr %.6f loss %.4f (%.4f) top10acc %.4f skipped %.0f",
                        step, self.total_step, lr, self.meters["train_loss"].val,
                        self.meters["train_loss"].avg,
                        self.meters["train_top10acc"].val, m["skipped"])
                    if np.isnan(self.meters["train_loss"].avg):
                        raise RuntimeError("training diverged...")
                if step > 0 and step % tcfg.val_every_n_steps == 0:
                    if not self.validate_and_save():
                        flag = False
                        break
                self.progress["step"] += 1
                self.progress["cur_step"] += 1
                data_start = time.time()
            else:
                self.progress["epoch"] += 1
                self.progress["cur_step"] = 0
                continue
            break
        return self.progress

    # ------------------------------------------------------- validation

    def validate(self) -> float:
        if self.valid_loader is None:
            return float("nan")
        tot = np.zeros(3)
        for batch in self.valid_loader():
            if self._watchdog is not None:
                self._watchdog.update("valid_batch")
            m = self.eval_step(self.model, batch)
            tot += np.array([float(m["loss"]), float(m["top10acc"]),
                             float(m["ntokens"])])
        loss = tot[0] / max(tot[2], 1.0)
        logger.info("val loss %.4f top10acc %.4f ntokens %d",
                    loss, tot[1] / max(tot[2], 1.0), int(tot[2]))
        self.writer.add_scalars(self.progress["step"], dict(
            loss=loss, top10acc=tot[1] / max(tot[2], 1.0)), prefix="val/")
        return float(loss)

    def validate_and_save(self) -> bool:
        """Returns False when early stopping triggers."""
        score = self.validate()
        if self._watchdog is not None:
            self._watchdog.update("save")
        step = self.progress["step"]
        if not np.isnan(score) and score < self.progress["best_score"] - max(
                self.tcfg.early_stop_threshold, 0.0):
            self.progress["best_score"] = score
            self.progress["best_step"] = step
            self.save_bundle("best_bundle.pkl")
        self.save_bundle("bundle.pkl")
        if self.tcfg.keep_step_checkpoints > 0:
            entries = self._entries()
            if is_main():
                save_step_checkpoint(
                    os.path.join(self.exp_dir, "checkpoints"), step,
                    keep_last=self.tcfg.keep_step_checkpoints, **entries)
        if (self.tcfg.early_stop_step > 0
                and step - self.progress["best_step"] > self.tcfg.early_stop_step):
            logger.info("early stop at step %d (best %d)", step,
                        self.progress["best_step"])
            return False
        return True

    # ------------------------------------------------------ checkpoints

    def _entries(self) -> Dict[str, object]:
        """The bundle's entries: the whole parameters and optimizer state
        (gathered over the mesh: every rank must call this)."""
        if self.mesh is None:
            params, state = lm_to_numpy(self.model), to_numpy_tree(self.opt_state)
        else:
            tree = self.model.tree()
            params = meshlib.gather_tree(self.mesh, tree, self.model.specs)
            state = meshlib.gather_state(self.mesh, self.opt_state, tree,
                                         self.model.specs)
            params, state = to_numpy_tree(params), to_numpy_tree(state)
        return dict(params=params, opt_state=state,
                    progress=dict(self.progress),
                    model_config=self.cfg, train_config=self.tcfg,
                    phn2num=self.phn2num,
                    torch_rng_state=self.generator.get_state())

    def save_bundle(self, name: str):
        entries = self._entries()
        if is_main():
            save_bundle(os.path.join(self.exp_dir, name), **entries)

    def load_bundle(self, path: str, load_optimizer: bool = True):
        """Parameters, the dropout stream and (with ``load_optimizer``) the
        optimizer state from a bundle of either package; the leaves are
        matched in ``jax.tree.leaves`` order."""
        bundle = load_bundle(path)
        params, state = bundle["params"], bundle.get("opt_state")
        if self.mesh is not None:  # this rank's blocks of the whole trees
            as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
            whole = tree_map(as_t, params)
            params = meshlib.shard_tree(self.mesh, whole, self.model.specs)
            if state is not None:
                state = meshlib.shard_state(self.mesh, tree_map(as_t, state),
                                            whole, self.model.specs)
        _copy_leaves(tree_leaves(self.model.tree()), tree_leaves(params),
                     "params")
        if load_optimizer and state is not None:
            _copy_leaves(tree_leaves(self.opt_state), tree_leaves(state),
                         "opt_state")
        state = bundle.get("torch_rng_state")
        if state is not None:
            state = torch.as_tensor(np.asarray(state))
            if state.shape == self.generator.get_state().shape:
                self.generator.set_state(state)
            else:  # written on another device type: keep this run's stream
                logger.info("bundle's dropout stream is another device's; "
                            "continuing from --seed")
        self.progress.update(bundle.get("progress", {}))
        self.phn2num = bundle.get("phn2num", self.phn2num)
        if hasattr(self.train_loader, "set_epoch_resume"):
            self.train_loader.set_epoch_resume(
                self.progress.get("epoch", 0), self.progress.get("cur_step", 0))


class _NoWriter:
    """The metrics writer of ranks other than 0."""

    def add_scalars(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def _copy_leaves(dst: List[torch.Tensor], src: List, what: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"bundle {what}: {len(src)} arrays, this run has "
                         f"{len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, src):
            s = (s.detach().clone() if isinstance(s, torch.Tensor)  # a copy:
                 else torch.from_numpy(np.array(s)))  # bundle arrays may be read-only
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"bundle {what}: shape {tuple(s.shape)} for "
                                 f"{tuple(d.shape)}")
            d.copy_(s)
