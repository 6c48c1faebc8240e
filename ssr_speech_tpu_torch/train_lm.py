"""LM training entry point of the PyTorch port (``ssr_speech_tpu/train_lm.py``).

The flags are the JAX CLI's, without its XLA knobs (``--unroll_layers
--rng_impl``), plus ``--device`` (default ``cuda``; asking for it without a
card is an error, never a silent CPU run) and ``--dist_backend``. Over
several ranks it is launched by ``torchrun``; ``--tp``, ``--pp``,
``--n_micro`` and ``--sequence_parallel`` are JAX's, and dp is the world
size over ``tp * pp``. Each rank reads the same global batches (the token
budget is the per-rank one times dp, times ``n_micro`` under pp, as in JAX)
and takes its rows. The dataset, batcher and prefetcher are the port's
own copies of the JAX package's modules. ``--remat`` checkpoints each decoder
layer as JAX's modes describe (``models.transformer.checkpoint_layer``), with
JAX's default: ``dots_masks`` with the fused attention, else ``full``.

Example (two H100s, one rank each, tensor parallel):
  torchrun --nproc_per_node 2 -m ssr_speech_tpu_torch.train_lm --device cuda \
    --tp 2 --exp_dir exp/e830M --dataset_dir data/gigaspeech ...

Example (the 830M e830M geometry on one H100):
  python -m ssr_speech_tpu_torch.train_lm --device cuda --exp_dir exp/e830M \\
    --dataset_dir data/gigaspeech --optimizer_name scaledadam --lr 0.05 \\
    --max_num_tokens 20000 --num_steps 50000 --codebook_weight 5,1,0.5,0.1 \\
    --attn_impl flash --ce_impl fused
"""

from __future__ import annotations

import argparse
import logging
import os


def build_parser():
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.train_lm")
    p.add_argument("--device", type=str, default="cuda",
                   help="cpu, cuda or cuda:N (under torchrun with nccl, "
                        "cuda is each rank's cuda:LOCAL_RANK)")
    # parallelism (launch with torchrun; dp = world / (tp * pp))
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (GPipe microbatch schedule)")
    p.add_argument("--n_micro", type=int, default=None,
                   help="pipeline microbatches per step (default 2*pp)")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="Megatron-SP: the residual stream split over the tp "
                        "group along the sequence")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend; default nccl on cuda (one "
                        "rank per GPU), gloo on cpu (gloo also lets ranks "
                        "share one card)")
    # general
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--precision", default="bfloat16")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--manifest_name", default="manifest")
    p.add_argument("--phn_folder_name", default="phonemes")
    p.add_argument("--encodec_folder_name", default="encodec_16khz_4codebooks")
    p.add_argument("--num_steps", type=int, default=50000)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--val_every_n_steps", type=int, default=400)
    p.add_argument("--print_every_n_steps", type=int, default=400)
    p.add_argument("--early_stop_step", type=int, default=3200)
    p.add_argument("--early_stop_threshold", type=float, default=-1.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--deadlock_timeout", type=float, default=0.0,
                   help=">0: stall watchdog — no loop beacon for this many "
                        "seconds dumps stacks and kills the process")
    p.add_argument("--profile_steps", type=int, default=0,
                   help=">0: torch.profiler-trace the first N steps to "
                        "exp_dir/profile")
    p.add_argument("--keep_step_checkpoints", type=int, default=0,
                   help=">0: also keep the last N numbered step checkpoints "
                        "under exp_dir/checkpoints")
    # optimizer
    p.add_argument("--optimizer_name", default="scaledadam")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--warmup_fraction", type=float, default=0.01)
    p.add_argument("--gradient_clip_val", type=float, default=1.0)
    p.add_argument("--reduce_lr_start_step", type=int, default=3000)
    p.add_argument("--reduce_lr_start_epoch", type=int, default=4)
    p.add_argument("--pseudo_epoch_size", type=int, default=3000)
    p.add_argument("--clipping_update_period", type=int, default=600)
    p.add_argument("--optim_moments_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 halves the param-sized ScaledAdam buffers")
    # data
    p.add_argument("--max_num_tokens", type=int, default=20000)
    p.add_argument("--num_buckets", type=int, default=6)
    p.add_argument("--bucket_warp", default="quantile",
                   choices=["quantile", "lognormal"],
                   help="bucket edges: data quantiles (default) or the "
                        "reference's lognorm(1) warping")
    p.add_argument("--audio_min_length", type=float, default=2.0)
    p.add_argument("--audio_max_length", type=float, default=20.0)
    p.add_argument("--text_min_length", type=int, default=10)
    p.add_argument("--text_max_length", type=int, default=400)
    p.add_argument("--drop_long", type=int, default=1)
    # masking
    p.add_argument("--mask_sample_dist", default="poisson1")
    p.add_argument("--max_n_spans", type=int, default=3)
    p.add_argument("--mask_len_min", type=int, default=1)
    p.add_argument("--mask_len_max", type=int, default=600)
    p.add_argument("--min_gap", type=int, default=5)
    p.add_argument("--max_mask_portion", type=float, default=0.9)
    p.add_argument("--tts_enhanced", type=int, default=1)
    p.add_argument("--cfg_enhanced", type=int, default=0)
    p.add_argument("--predict_mask_token", type=int, default=1)
    p.add_argument("--predict_all", type=int, default=0)
    p.add_argument("--shuffle_mask_embedding", type=int, default=0)
    p.add_argument("--codebook_weight", default=None,
                   help="comma separated, e.g. 5,1,0.5,0.1")
    # model
    p.add_argument("--d_model", type=int, default=2048)
    p.add_argument("--audio_embedding_dim", type=int, default=None,
                   help="default: d_model")
    p.add_argument("--nhead", type=int, default=16)
    # dropouts (reference config.py flags of the same names)
    p.add_argument("--trm_dropout", type=float, default=0.1)
    p.add_argument("--text_embedding_dropout", type=float, default=0.1)
    p.add_argument("--audio_embedding_dropout", type=float, default=0.0)
    p.add_argument("--text_positional_embedding_dropout", type=float,
                   default=0.1)
    p.add_argument("--audio_positional_embedding_dropout", type=float,
                   default=0.1)
    p.add_argument("--tb_write_every_n_steps", type=int, default=100)
    p.add_argument("--num_decoder_layers", type=int, default=16)
    p.add_argument("--audio_vocab_size", type=int, default=2048)
    p.add_argument("--text_vocab_size", type=int, default=100)
    p.add_argument("--n_codebooks", type=int, default=4)
    p.add_argument("--attn_impl", default=None,
                   choices=["einsum", "flash", "splash"],
                   help="training attention: flash (the hand-written kernels; "
                        "splash is the same) or einsum; default: flash on "
                        "CUDA when head_dim == 128 and precision is bfloat16")
    p.add_argument("--remat", default=None,
                   choices=["full", "dots", "dots_masks", "mixed", "none"],
                   help="activation checkpointing of each decoder layer: "
                        "full recomputes it in the backward, dots keeps the "
                        "matrix products, dots_masks also the dropout masks, "
                        "mixed is dots, none keeps everything; default: "
                        "dots_masks with flash attention, else full")
    p.add_argument("--ce_impl", default="unfused",
                   choices=["unfused", "fused"],
                   help="CE head: fused = the hand-written kernels (second "
                        "head matmul + log-softmax + top-10, no [N, C] logits "
                        "in memory); default unfused, as in JAX")
    p.add_argument("--load_model_from", default=None)
    p.add_argument("--benchmark_no_load", action="store_true",
                   help="repeat one batch to benchmark the step loop")
    return p


def configs_from_args(args, device):
    """(SSRModelConfig, TrainConfig) of parsed CLI arguments."""
    from .config import (DataConfig, MaskingConfig, OptimConfig,
                                       SSRModelConfig, TokenSpace, TrainConfig)

    from .models.transformer import default_remat

    attn_impl = args.attn_impl or (
        "flash" if device.type == "cuda" and args.d_model // args.nhead == 128
        and args.precision == "bfloat16" else "einsum")
    cfg = SSRModelConfig(
        d_model=args.d_model, nhead=args.nhead,
        num_layers=args.num_decoder_layers, n_codebooks=args.n_codebooks,
        audio_embedding_dim=args.audio_embedding_dim or args.d_model,
        text_vocab_size=args.text_vocab_size,
        tokens=TokenSpace(audio_vocab_size=args.audio_vocab_size,
                          max_n_spans=args.max_n_spans),
        attn_impl=attn_impl, remat=args.remat or default_remat(attn_impl),
        ce_impl=args.ce_impl,
        trm_dropout=args.trm_dropout,
        text_embedding_dropout=args.text_embedding_dropout,
        audio_embedding_dropout=args.audio_embedding_dropout,
        text_positional_embedding_dropout=(
            args.text_positional_embedding_dropout),
        audio_positional_embedding_dropout=(
            args.audio_positional_embedding_dropout),
    )
    cw = tuple(float(v) for v in args.codebook_weight.split(",")) \
        if args.codebook_weight else None
    tcfg = TrainConfig(
        seed=args.seed, precision=args.precision,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        num_epochs=args.num_epochs, num_steps=args.num_steps,
        val_every_n_steps=args.val_every_n_steps,
        print_every_n_steps=args.print_every_n_steps,
        early_stop_step=args.early_stop_step,
        early_stop_threshold=args.early_stop_threshold,
        tb_write_every_n_steps=args.tb_write_every_n_steps,
        codebook_weight=cw,
        deadlock_timeout=args.deadlock_timeout,
        profile_steps=args.profile_steps,
        keep_step_checkpoints=args.keep_step_checkpoints,
        optim=OptimConfig(
            optimizer_name=args.optimizer_name, lr=args.lr,
            weight_decay=args.weight_decay,
            warmup_fraction=args.warmup_fraction,
            gradient_clip_val=args.gradient_clip_val,
            reduce_lr_start_step=args.reduce_lr_start_step,
            reduce_lr_start_epoch=args.reduce_lr_start_epoch,
            pseudo_epoch_size=args.pseudo_epoch_size,
            clipping_update_period=args.clipping_update_period,
            moments_dtype=args.optim_moments_dtype,
        ),
        masking=MaskingConfig(
            mask_sample_dist=args.mask_sample_dist,
            max_n_spans=args.max_n_spans, mask_len_min=args.mask_len_min,
            mask_len_max=args.mask_len_max,
            min_gap=args.min_gap, max_mask_portion=args.max_mask_portion,
            tts_enhanced=args.tts_enhanced, cfg_enhanced=bool(args.cfg_enhanced),
            shuffle_mask_embedding=bool(args.shuffle_mask_embedding),
            predict_mask_token=bool(args.predict_mask_token),
            predict_all=bool(args.predict_all),
        ),
        data=DataConfig(
            dataset_dir=args.dataset_dir, manifest_name=args.manifest_name,
            phn_folder_name=args.phn_folder_name,
            encodec_folder_name=args.encodec_folder_name,
            exp_dir=args.exp_dir,
            audio_min_length=args.audio_min_length,
            audio_max_length=args.audio_max_length,
            text_min_length=args.text_min_length,
            text_max_length=args.text_max_length,
            drop_long=bool(args.drop_long), num_buckets=args.num_buckets,
            bucket_warp=args.bucket_warp,
            max_num_tokens=args.max_num_tokens,
        ),
    )
    return cfg, tcfg


def make_train_batcher(cfg, tcfg, seed: int, world_size: int = 1):
    """(training set, its bucket batcher): ``batcher(epoch)`` yields the
    batches ``main`` trains on, in order, the same for the same seed.
    ``world_size``: the number of row blocks a batch splits into (dp, times
    n_micro under pp)."""
    from .data.batching import BucketBatcher
    from .data.dataset import SpeechDataset

    train_ds = SpeechDataset(cfg, tcfg.data, tcfg.masking, "train", seed=seed)
    return train_ds, BucketBatcher(train_ds, cfg, tcfg.data,
                                   world_size=world_size, seed=seed)


def make_mesh_of(args, world: int):
    """(mesh or None, row blocks of a batch) for the parsed flags over a
    world of ``world`` ranks."""
    if world % (args.tp * args.pp):
        raise SystemExit(
            f"train_lm: --tp {args.tp} --pp {args.pp} needs a world that "
            f"divides into tp*pp={args.tp * args.pp} ranks, this one has "
            f"{world}: launch with torchrun --nproc_per_node N (N a multiple "
            f"of {args.tp * args.pp})")
    if world == 1:
        return None, 1
    dp = world // (args.tp * args.pp)
    if args.pp > 1:
        from .parallel.pipeline import make_pp_mesh

        return make_pp_mesh(pp=args.pp, tp=args.tp), dp * (args.n_micro
                                                           or 2 * args.pp)
    from .parallel.mesh import make_mesh

    return make_mesh(tp=args.tp), dp


def main(argv=None):
    """Train; returns the :class:`training.trainer.Trainer` (its ``history``
    holds each step's loss, ntokens, skip flag and wall seconds)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .data.batching import BucketBatcher
    from .data.dataset import SpeechDataset
    from .data.prefetch import prefetch
    from .utils.checkpoint import latest_checkpoint

    from .device import resolve_device, set_precision_policy
    from .training.trainer import Trainer

    from .parallel.dist import init_distributed

    device = resolve_device(args.device)
    _, world, device = init_distributed(args.dist_backend, device)
    set_precision_policy()
    cfg, tcfg = configs_from_args(args, device)
    mesh, blocks = make_mesh_of(args, world)
    train_ds, train_batcher = make_train_batcher(cfg, tcfg, args.seed, blocks)
    try:
        val_ds = SpeechDataset(cfg, tcfg.data, tcfg.masking, "validation",
                               seed=args.seed + 1)
        val_batcher = BucketBatcher(val_ds, cfg, tcfg.data, world_size=blocks,
                                    seed=args.seed + 1)
        valid_loader = lambda: val_batcher(0)
    except FileNotFoundError:
        valid_loader = None

    trainer = Trainer(cfg, tcfg, prefetch(train_batcher), valid_loader,
                      phn2num=train_ds.phn2num, exp_dir=args.exp_dir,
                      device=device, mesh=mesh, pp=args.pp,
                      n_micro=args.n_micro,
                      sequence_parallel=args.sequence_parallel)
    resume_path = os.path.join(args.exp_dir, "bundle.pkl")
    if args.resume:
        if not os.path.isfile(resume_path):
            # the newest numbered step checkpoint (keep_step_checkpoints > 0)
            resume_path = latest_checkpoint(
                os.path.join(args.exp_dir, "checkpoints"))
        if resume_path and os.path.isfile(resume_path):
            trainer.load_bundle(resume_path)
    if args.load_model_from:
        trainer.load_bundle(args.load_model_from, load_optimizer=False)
    trainer.train(benchmark_no_load=args.benchmark_no_load)
    return trainer


if __name__ == "__main__":
    main()
