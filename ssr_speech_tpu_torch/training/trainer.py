"""SSR LM trainer (port of ``ssr_speech_tpu/training/trainer.py``): the train
step and the host training loop, on one device.

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

The dropout stream is a ``torch.Generator`` on the device seeded from
``tcfg.seed``; its state travels in the bundle as ``torch_rng_state`` (JAX's
key is ``rng_state``, so each package ignores the other's stream). Each
decoder layer is checkpointed as ``cfg.remat`` says (``models.transformer``).
Not ported: the mesh, pipeline and sequence parallelism, ``unroll``,
``rng_impl``.
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
from ..utils.checkpoint import load_bundle, save_bundle, save_step_checkpoint
from ..utils.logging_utils import MetricsWriter
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


def make_train_step(cfg: SSRModelConfig, tcfg: TrainConfig, optimizer,
                    device) -> Callable:
    """``step(model, opt_state, batch, generator) -> metrics``. ``batch``
    holds numpy or torch arrays x [B,Sx], x_lens, y [B,Sy,K], y_lens; with
    gradient accumulation the leading dim is [A, B/A, ...]. Updates
    ``model``'s parameters and ``opt_state`` in place unless the step is
    skipped; metrics are device tensors (``skipped`` 0.0 or 1.0)."""
    dtype = compute_dtype_of(tcfg)
    normalize = tcfg.optim.optimizer_name.lower() != "scaledadam"
    accum = tcfg.gradient_accumulation_steps

    def loss_fn(model, batch, generator):
        out = ssr_model.ssr_forward(
            model, cfg, batch, deterministic=False, generator=generator,
            compute_dtype=dtype,
            predict_mask_token=tcfg.masking.predict_mask_token,
            predict_all=tcfg.masking.predict_all,
            codebook_weight=tcfg.codebook_weight, remat=cfg.remat)
        loss = out["loss"]
        if normalize:
            loss = loss / torch.clamp(out["effective_ntoken"], min=1.0)
        return loss, out

    def train_step(model, opt_state, batch, generator):
        params = model.tree()
        micro = ([batch] if accum == 1 else
                 [{k: v[j] for k, v in batch.items()} for j in range(accum)])
        loss_sum = top10_sum = ntok = acc_cb = 0.0
        for mb in micro:
            loss, out = loss_fn(model, to_device(mb, device), generator)
            loss.backward()
            loss_sum = loss_sum + out["loss"].detach()
            top10_sum = top10_sum + out["top10acc"].detach()
            ntok = ntok + out["effective_ntoken"].detach()
            acc_cb = acc_cb + out["top10acc_by_codebook"].detach()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        finite = torch.stack([torch.isfinite(g).all() for g in tree_leaves(grads)])
        is_good = bool(torch.isfinite(loss_sum) & finite.all())
        if is_good:
            optimizer.update_(grads, opt_state, params)
        for p in tree_leaves(params):
            p.grad = None
        return dict(loss=loss_sum, top10acc=top10_sum, ntokens=ntok,
                    top10acc_by_codebook=acc_cb, skipped=0.0 if is_good else 1.0)

    return train_step


def make_eval_step(cfg: SSRModelConfig, tcfg: TrainConfig, device) -> Callable:
    dtype = compute_dtype_of(tcfg)

    @torch.no_grad()
    def eval_step(model, batch):
        out = ssr_model.ssr_forward(
            model, cfg, to_device(batch, device), deterministic=True,
            compute_dtype=dtype,
            predict_mask_token=tcfg.masking.predict_mask_token,
            predict_all=tcfg.masking.predict_all,
            codebook_weight=tcfg.codebook_weight)
        return dict(loss=out["loss"], top10acc=out["top10acc"],
                    ntokens=out["effective_ntoken"],
                    top10acc_by_codebook=out["top10acc_by_codebook"])

    return eval_step


class Trainer:
    """Host-side training loop (the JAX ``Trainer`` on one device).

    ``device`` is a required keyword: a caller names the card or the CPU.
    Parameters start from the port's ``init_ssr`` with a generator seeded
    ``tcfg.seed + 1`` on ``device`` (``load_bundle`` replaces them); the
    dropout generator is seeded ``tcfg.seed``. ``history`` keeps one record
    per step: step, loss, ntokens, skipped, wall seconds (the step ends in a
    host sync, the skip decision, so they cover the device's work), the batch
    shape (B, Sx, Sy) and its unpadded positions."""

    def __init__(self, cfg: SSRModelConfig, tcfg: TrainConfig,
                 train_loader: Callable[[int], Iterator[Dict[str, np.ndarray]]],
                 valid_loader: Optional[Callable[[], Iterator]] = None,
                 phn2num: Optional[Dict[str, int]] = None,
                 exp_dir: Optional[str] = None, *, device):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = torch.device(device)
        self.train_loader, self.valid_loader = train_loader, valid_loader
        self.phn2num = phn2num or {}
        self.exp_dir = exp_dir or tcfg.data.exp_dir or "exp"
        os.makedirs(self.exp_dir, exist_ok=True)

        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        init_gen = torch.Generator(device=self.device).manual_seed(tcfg.seed + 1)
        self.model = trainable_lm_from_jax(
            ssr_model.init_ssr(init_gen, cfg, self.device), cfg, device=self.device)
        total = tcfg.num_steps or 100000
        self.optimizer, self.schedule = optimlib.build_optimizer(tcfg.optim, total)
        self.opt_state = self.optimizer.init(self.model.tree())
        self.train_step = make_train_step(cfg, tcfg, self.optimizer, self.device)
        self.eval_step = make_eval_step(cfg, tcfg, self.device)
        self.progress = dict(step=0, epoch=0, cur_step=0, best_step=0,
                             best_score=float("inf"))
        self.meters = {k: AverageMeter() for k in
                       ("train_loss", "train_top10acc", "data_time", "train_time")}
        self.total_step = total
        self.writer = MetricsWriter(self.exp_dir)
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
                        enabled=tcfg.profile_steps > 0,
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
                                        self.generator)
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
            save_step_checkpoint(
                os.path.join(self.exp_dir, "checkpoints"), step,
                keep_last=self.tcfg.keep_step_checkpoints, **self._entries())
        if (self.tcfg.early_stop_step > 0
                and step - self.progress["best_step"] > self.tcfg.early_stop_step):
            logger.info("early stop at step %d (best %d)", step,
                        self.progress["best_step"])
            return False
        return True

    # ------------------------------------------------------ checkpoints

    def _entries(self) -> Dict[str, object]:
        return dict(params=lm_to_numpy(self.model),
                    opt_state=to_numpy_tree(self.opt_state),
                    progress=dict(self.progress),
                    model_config=self.cfg, train_config=self.tcfg,
                    phn2num=self.phn2num,
                    torch_rng_state=self.generator.get_state())

    def save_bundle(self, name: str):
        save_bundle(os.path.join(self.exp_dir, name), **self._entries())

    def load_bundle(self, path: str, load_optimizer: bool = True):
        """Parameters, the dropout stream and (with ``load_optimizer``) the
        optimizer state from a bundle of either package; the leaves are
        matched in ``jax.tree.leaves`` order."""
        bundle = load_bundle(path)
        _copy_leaves(tree_leaves(self.model.tree()),
                     tree_leaves(bundle["params"]), "params")
        if load_optimizer and bundle.get("opt_state") is not None:
            _copy_leaves(tree_leaves(self.opt_state),
                         tree_leaves(bundle["opt_state"]), "opt_state")
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


def _copy_leaves(dst: List[torch.Tensor], src: List, what: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"bundle {what}: {len(src)} arrays, this run has "
                         f"{len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, src):
            s = torch.from_numpy(np.array(s))  # a copy: bundle arrays may be read-only
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"bundle {what}: shape {tuple(s.shape)} for "
                                 f"{tuple(d.shape)}")
            d.copy_(s)
