"""``lib/judge_lm.py``'s teacher-forced comparison for the LM with
Moonlight-16B-A3B's block: the served greedy tokens against the plain
reference ``reference/lm_mla_moe.py`` (at the configured dtypes, on weights
drawn again from the run's seed), the mean gap by which a served audio
token's reference logit lies below the reference's best. A control run
judges the fp8 control's own picks in the served tokens' place, by the same
comparison and limit.

The gap is split by how near the reference's own routing of the token's
position came to a tie: its margin, the least over the MoE layers of the
k-th best score + e_bias less the (k + 1)-th, over the rows the token's
logits came from (the conditional row, and the unconditional one on the
steps that CFG mixes in). Where the margin is below the rounding of the program's stated
dtypes (``near_tie_margin`` of the cell), the program may choose the other
expert, and the token moves by a whole expert's share: such a token is not
compared. The judged gap (``logit_gap_mean``) is the mean over the others;
the all-token and near-tie means, and the gap by margin band, are logged
beside it."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench.lib import weights_mla_moe
from portbench.reference import lm as lm_ref
from portbench.reference import lm_mla_moe as moe_ref
from portbench.reference import patterns

BANDS = (0.0, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, float("inf"))


def judge(ctx, items: List[dict], lm_dtype):
    """``items`` as ``judge_lm.judge``'s. Returns (mean gap over the
    tokens with no near-tie, tokens compared there, the reference's rebuilt
    (prefix, kept intervals) per item)."""
    cfg = ctx.cfg
    ts, dec = cfg["tokens"], cfg["decode"]
    sp = patterns.special_ids(ts)
    K, vocab = cfg["n_codebooks"], ts["audio_vocab_size"]
    if dec["aug_text"] and not dec["cfg_pretrained"]:
        raise ValueError("the reference follows CFG rows of the pretrained "
                         "unconditional token only")
    uncond = (np.array([cfg["text_vocab_size"] - 1]) if dec["aug_text"]
              else None)
    tie = ctx.workload["near_tie_margin"]
    W = weights_mla_moe.lm_weights(cfg, ctx.seed, ctx.device, lm_dtype)
    ref = moe_ref.LM(W, cfg, lm_dtype)
    ref.record_margins = True
    low = moe_ref.LM(W, cfg, lm_dtype, fp8=True) if ctx.control else None
    bands = np.zeros((len(BANDS) - 1, 2))  # gap sum, tokens
    built = []
    for it in items:
        prefix, _, kept = patterns.inference_prefix(it["y"], [it["span"]], ts)
        built.append((prefix, kept))
        stream = it["stream"]
        fed = np.concatenate([np.full((K, 1), sp["mts"], stream.dtype),
                              stream[:, :-1]], 1)
        kw = dict(uncond_text=uncond, cfg_coef=dec["cfg_coef"],
                  cfg_stride=dec["cfg_stride"])
        ref.margins.clear()
        logits = lm_ref.decode_logits(ref, it["x"], prefix, fed, **kw)
        margin = ref.margins[0]
        if len(ref.margins) > 1:  # decode_logits' mix: every stride-th step
            mixed = torch.zeros_like(margin, dtype=torch.bool)
            mixed[dec["cfg_stride"] - 1::dec["cfg_stride"]] = True
            margin = torch.where(mixed, torch.minimum(margin, ref.margins[1]),
                                 margin)
        margin = margin.cpu().numpy()
        pick = None
        if low is not None:
            pick = lm_ref.decode_logits(low, it["x"], prefix, fed,
                                        **kw)[..., :vocab].argmax(-1)
        for j in range(len(BANDS) - 1):
            inside = (margin >= BANDS[j]) & (margin < BANDS[j + 1])
            if not inside.any():
                continue
            only = np.where(inside[None, :], stream, vocab)
            _, s, c = lm_ref.served_gap(logits, only, vocab, pick)
            bands[j] += (s, c)
    cut = int(np.searchsorted(BANDS, tie))
    if BANDS[cut] != tie:
        raise ValueError(f"near_tie_margin {tie} is not one of {BANDS}")
    clear, near, every = bands[cut:].sum(0), bands[:cut].sum(0), bands.sum(0)
    mean = lambda v: float(v[0] / max(v[1], 1))
    side = "served" if low is None else "control"
    ctx.log(f"logit gap over {int(every[1])} {side} tokens: mean "
            f"{mean(every)!r}; {int(near[1])} with a routing margin below "
            f"{tie}: mean {mean(near)!r}; {int(clear[1])} clear: mean "
            f"{mean(clear)!r}; by margin band "
            + ", ".join(f"[{BANDS[j]:g}, {BANDS[j + 1]:g}) {int(bands[j, 1])}: "
                        f"{mean(bands[j]):.3e}" for j in range(len(BANDS) - 1)))
    return mean(clear), int(clear[1]), built
