"""Tiny geometries of the cells, for the CPU tests: the same files, with
widths cut so that a CPU runs a window in seconds."""

from __future__ import annotations

import torch

from portbench.lib import common, harness

EDIT = "e830m-edit-1client"
ENCODE = "wmencodec-prep-encode"


def tiny_codec(codec: dict) -> dict:
    codec["seanet"].update(n_filters=4, dimension=16)
    codec["rvq"].update(dimension=16, bins=64)
    return codec


def tiny_lm(name: str = "ssr-e830m") -> dict:
    cfg = common.config(name)
    cfg.update(d_model=64, nhead=2, num_layers=2, head_hidden=32)
    cfg["tokens"] = dict(audio_vocab_size=64, n_special=5, max_n_spans=3)
    tiny_codec(cfg["codec"])
    return cfg


def edit_context(seed: int = 2 ** 31 + 12345, seconds: float = 3.0,
                 trace: bool = False, control: bool = False) -> harness.Context:
    mix = common.traffic_params("edit-1client")
    # with this seed the first request is greedy, so that a slow CPU that
    # finishes one request in the window still has one to judge
    mix["block"] = [[19, 6, True], [23, 8, True], [27, 10, False], [31, 4, True]]
    mix["max_gen_per_span"] = 16
    wl = common.workload(EDIT)
    wl["judge_steps"] = 20
    wl["limits"] = dict(wl["limits"], logit_gap_mean=1e-5, wav_rel_err=1e-4,
                        min_tokens_compared=10)
    return harness.Context(cell=EDIT, workload=wl, cfg=tiny_lm(), mix=mix,
                           device=torch.device("cpu"), seed=seed,
                           seconds=seconds, trace=trace, control=control)


def encode_context(seed: int = 7, seconds: float = 2.0, trace: bool = False,
                   control: bool = False) -> harness.Context:
    cfg = tiny_codec(common.config("wmencodec-nq4-s320"))
    mix = common.traffic_params("prep-encode")
    mix.update(n_waves=12, seconds=[1, 3], batch=4, bucket_frames=32)
    wl = common.workload(ENCODE)
    wl["limits"] = dict(wl["limits"], latent_rel_err=1e-4, code_gap=1e-6,
                        min_frames_compared=50)
    return harness.Context(cell=ENCODE, workload=wl, cfg=cfg, mix=mix,
                           device=torch.device("cpu"), seed=seed,
                           seconds=seconds, trace=trace, control=control)


def measure(ctx: harness.Context):
    from portbench import run

    return run.measure(common.benchmark(), ctx)


SERVE = "e830m-serve-open"


def serve_context(seed: int = 2 ** 31 + 99, seconds: float = 4.0,
                  trace: bool = False, control: bool = False,
                  rate: float = 3.0) -> harness.Context:
    mix = common.traffic_params("serve-open")
    mix.update(rate_per_s=rate, edit_block=[[19, 6], [23, 8]],
               tts_block=[[10, 13], [12, 15]], max_gen_per_span=32, lanes=2,
               chunk_steps=8)
    wl = common.workload(SERVE)
    wl["judge_steps"] = 200
    wl["limits"] = dict(wl["limits"], logit_gap_mean=1e-6, min_tokens_compared=10)
    return harness.Context(cell=SERVE, workload=wl, cfg=tiny_lm(wl["config"]),
                           mix=mix,
                           device=torch.device("cpu"), seed=seed,
                           seconds=seconds, trace=trace, control=control)
