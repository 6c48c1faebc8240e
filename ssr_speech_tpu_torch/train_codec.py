"""Watermark-codec training entry point (port of
``ssr_speech_tpu/train_codec.py``).

Load a trained (wm)encodec bundle, freeze its encoder, decoder and quantizer,
start the watermark decoder from the plain decoder and encoder weights, then
run the GAN + watermark-CE loop of ``training.codec_trainer``.

    python -m ssr_speech_tpu_torch.train_codec --manifest data.jsonl \\
        --codec_path codec.pkl --exp_dir exp/wmcodec --updates 2000

The JAX CLI's flags plus ``--device`` (default ``cuda``, which raises without
a card). ``--precision`` defaults to float32 on every device (JAX picks
bfloat16 on a TPU only). Published ``.th`` / ``.pth`` / ``.pt`` checkpoints
are refused: converting them waits for ``models/convert.py``. The bundle is
written as ``codec_bundle.pkl`` with ``params = {encoder, decoder,
quantizer, wmdecoder = the EMA}`` and the config, which both packages'
``load_bundle`` and both ``detect_cli``s read.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time


def bootstrap_wm_from_codec(params):
    """Start the watermark decoder from the trained plain codec:
    wmdecoder.decoder <- decoder, wm_encoder and skip_encoder <- encoder
    (new containers over the same leaves, which training never writes)."""
    from .utils.tree import tree_map

    copy_tree = lambda t: tree_map(lambda x: x, t)  # noqa: E731
    wmd = params["wmdecoder"]
    wmd["decoder"] = copy_tree(params["decoder"])
    wmd["wm_encoder"] = copy_tree(params["encoder"])
    wmd["skip_encoder"] = copy_tree(params["encoder"])
    return params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.train_codec")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--manifest", required=True, help="jsonl of {path,duration}")
    p.add_argument("--codec_path", default=None,
                   help="pretrained (wm)encodec bundle (.pkl) to start from")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--segment_duration", type=float, default=2.0)
    p.add_argument("--sample_on_duration",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--sample_on_weight",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="weight files by the manifest 'weight' field")
    p.add_argument("--min_segment_ratio", type=float, default=0.5)
    p.add_argument("--max_read_retry", type=int, default=10)
    p.add_argument("--max_audio_duration", type=float, default=None)
    p.add_argument("--updates", type=int, default=2000,
                   help="steps per epoch")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--ema_decay", type=float, default=0.99)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--generate_every", type=int, default=0,
                   help="store watermark reconstructions every N steps "
                        "(0 = only at the end of training)")
    p.add_argument("--samples_dir", default=None,
                   help="SampleManager root (default <exp_dir>/samples)")
    p.add_argument("--visqol_bin", default=None,
                   help="path to a google/visqol install for the generate "
                        "stage's MOS-LQO (optional)")
    p.add_argument("--loss_weights", default=None,
                   help="balancer weights, e.g. 'adv=4,feat=4,l1=0.1,"
                        "msspec=2' (+ optional mel/mstft/l2)")
    p.add_argument("--adv_loss_mode", default="hinge",
                   choices=["hinge", "mse"])
    p.add_argument("--wm_ce_weight", type=float, default=1.0,
                   help="scale on the watermark CE losses")
    p.add_argument("--wm_min_regions", type=int, default=0,
                   help="minimum watermark spans sampled per item")
    p.add_argument("--disc_scales", type=int, default=None,
                   help="number of MS-STFT discriminator scales (default 5)")
    p.add_argument("--precision", default="float32",
                   choices=["float32", "bfloat16"],
                   help="activation dtype of the watermark decoder, detector "
                        "and discriminator passes (parameters, losses and "
                        "optimizers stay fp32)")
    p.add_argument("--deadlock_timeout", type=float, default=0.0,
                   help=">0: stall watchdog; no loop beacon for this many "
                        "seconds dumps stacks and kills the process")
    p.add_argument("--profile_steps", type=int, default=0,
                   help=">0: torch.profiler-trace the first N steps to "
                        "exp_dir/profile (trace.json, summary.json)")
    p.add_argument("--config_json", default=None,
                   help="codec geometry as a CodecConfig JSON file "
                        "(default: encodec_large_nq4_s320)")
    p.add_argument("--loader_threads", type=int, default=8,
                   help="C++ threaded WAV batch loader threads (0 = python "
                        "loop); batches are also prefetched two steps ahead")
    p.add_argument("--data_parallel", action="store_true",
                   help="a no-op on one device; more than one is refused "
                        "until the port has data parallelism")
    return p


def main(argv=None):
    """Train. Returns a dict: ``state`` (the final ``CodecTrainState``),
    ``history`` (each step's metrics as floats, with its wall seconds),
    ``eval_sisnr`` ((step, dB) pairs), ``bundle`` (the last bundle's path or
    None), ``samples_dir`` and ``steps``."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("train_codec")

    import numpy as np
    import torch

    from .config import CodecConfig, codec_config_from_json, config_to_json
    from .data.audio_dataset import AudioSegmentDataset
    from .data.prefetch import PrefetchIterator
    from .device import resolve_device, set_precision_policy
    from .models.codec import wmencodec as wm
    from .models.pretrained import _bundle_path
    from .training import codec_trainer
    from .utils import checkpoint as ckpt
    from .utils.profiler import Profiler
    from .utils.sample_manager import SampleManager
    from .utils.tree import tree_map
    from .utils.watchdog import DeadlockDetect

    device = resolve_device(args.device)
    set_precision_policy()
    if (args.data_parallel and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "--data_parallel over more than one device is not ported yet "
            "(ROADMAP.md, queue 1 item 8: parallelism)")
    if args.config_json:
        with open(args.config_json) as f:
            cfg = codec_config_from_json(f.read())
    else:
        cfg = CodecConfig()
    pretrained = None
    if args.codec_path:
        pretrained = bootstrap_wm_from_codec(
            ckpt.load_bundle(_bundle_path(args.codec_path))["params"])

    bw = None
    if args.loss_weights:
        bw = {k: float(v) for k, v in
              (kv.split("=") for kv in args.loss_weights.split(","))}
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, opts = codec_trainer.init_codec_train_state(
        gen, cfg, lr=args.lr, pretrained=pretrained, balance_weights=bw,
        disc_scales=args.disc_scales, device=device)
    logger.info("compute precision: %s", args.precision)
    step_fn = codec_trainer.make_codec_train_step(
        cfg, opts, args.ema_decay, balance_weights=bw,
        adv_loss_mode=args.adv_loss_mode, compute_dtype=args.precision,
        wm_ce_weight=args.wm_ce_weight)

    ds = AudioSegmentDataset(args.manifest, cfg, args.segment_duration,
                             seed=args.seed,
                             loader_threads=args.loader_threads,
                             sample_on_duration=args.sample_on_duration,
                             sample_on_weight=args.sample_on_weight,
                             min_segment_ratio=args.min_segment_ratio,
                             max_read_retry=args.max_read_retry,
                             max_audio_duration=args.max_audio_duration)
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.exp_dir, exist_ok=True)
    # the resolved geometry, which --config_json of a later run reads
    with open(os.path.join(args.exp_dir, "config.json"), "w") as f:
        f.write(config_to_json(cfg))
    hop = cfg.hop_length
    frames = int(args.segment_duration * cfg.sample_rate) // hop
    on_device = lambda a: torch.as_tensor(np.asarray(a)).to(device)  # noqa: E731

    samples_dir = args.samples_dir or os.path.join(args.exp_dir, "samples")
    samples = SampleManager(samples_dir)
    visqol = None
    if args.visqol_bin:
        from .utils.visqol import ViSQOL

        visqol = ViSQOL(args.visqol_bin, mode="speech")

    def generate_stage(epoch: int, step: int):
        # store watermark reconstructions of an eval batch with provenance
        wav_eval = np.asarray(next(ds.batches(args.batch_size, 1)))
        recon = codec_trainer.reconstruct(state, cfg, on_device(wav_eval)
                                          ).cpu().numpy()
        for i in range(recon.shape[0]):
            # [C, T]: SampleManager writes a 2-D array as channels x samples
            # (JAX's train_codec passes [T, C], which stores T channels)
            samples.add_sample(recon[i].T, cfg.sample_rate, epoch=epoch,
                               conditioning=dict(step=step, index=i),
                               prompt_wav=wav_eval[i])
        if visqol is not None:
            score = visqol([w[:, 0] for w in wav_eval],
                           [r[:, 0] for r in recon], sr=cfg.sample_rate)
            logger.info("generate stage: %d samples, visqol %.3f",
                        recon.shape[0], score)
        else:
            logger.info("generate stage: %d samples stored", recon.shape[0])

    def save(step: int) -> str:
        path = os.path.join(args.exp_dir, "codec_bundle.pkl")
        params = dict(encoder=state.frozen["encoder"],
                      decoder=state.frozen["decoder"],
                      quantizer=state.frozen["quantizer"],
                      wmdecoder=state.ema_params)
        ckpt.save_bundle(path, params=tree_map(lambda t: t.detach(), params),
                         config=dataclasses.asdict(cfg), step=step)
        return path

    history, evals, bundle = [], [], None
    step = 0
    epoch = 0
    watchdog = DeadlockDetect(use=args.deadlock_timeout > 0,
                              timeout=args.deadlock_timeout)
    prof = Profiler(logdir=os.path.join(args.exp_dir, "profile"),
                    enabled=args.profile_steps > 0,
                    num_steps=args.profile_steps)
    try:
        with watchdog:
            for epoch in range(args.epochs):
                for wav in PrefetchIterator(
                        ds.batches(args.batch_size, args.updates), depth=2):
                    labels, keep = wm.sample_watermark_mask(
                        rng, wav.shape[0], frames, hop,
                        min_regions=args.wm_min_regions)
                    t0 = time.perf_counter()
                    watchdog.update("dispatch")
                    state, metrics = step_fn(state, on_device(wav),
                                             on_device(labels), on_device(keep))
                    row = {k: float(v) for k, v in metrics.items()}
                    row["wall_s"] = time.perf_counter() - t0
                    history.append(row)
                    watchdog.update("step")
                    prof.step()
                    step += 1
                    if step % 50 == 0:
                        logger.info("epoch %d step %d %s", epoch, step,
                                    {k: round(v, 4) for k, v in row.items()})
                    if step % args.eval_every == 0:
                        watchdog.update("eval")
                        wav_eval = on_device(next(ds.batches(args.batch_size, 1)))
                        sisnr = float(codec_trainer.evaluate_sisnr(
                            state, cfg, wav_eval))
                        evals.append((step, sisnr))
                        logger.info("eval si-snr %.2f dB", sisnr)
                    if args.generate_every and step % args.generate_every == 0:
                        watchdog.update("generate")
                        generate_stage(epoch, step)
                    if step % args.save_every == 0:
                        watchdog.update("save")
                        bundle = save(step)
    finally:
        prof.close()
    if step:
        generate_stage(epoch, step)
    logger.info("done: %d steps", step)
    return dict(state=state, history=history, eval_sisnr=evals, bundle=bundle,
                samples_dir=samples_dir, steps=step)


if __name__ == "__main__":
    main()
