"""The served tokens of greedy requests against the plain reference's
logits, teacher-forced: one pass of the reference (at the decoder's
configured dtype, ``lm_dtype``) over each prompt with its served tokens
gives the guided logits of every step. At each served audio token, the gap
by which its reference logit lies below the reference's best; the number
compared is the mean gap over every such token of the sample
(``logit_gap_mean``), and the widest gap is printed beside it. A control
run (``ctx.control``) puts the control in the program's place: the
reference with fp8 products picks its own first token at each served
position, and those picks are judged in place of the served tokens, by
the same comparison and limit.

Why the mean and not the widest gap: a flip happens only at a near-tie,
and its gap is bounded by the local error, so the widest gap over
thousands of tokens grows only linearly with the error scale (the fp8
control read 1.9-3.3 times the program, PERF.md); the mean grows with its
square (flips grow with the error, and so does each flip's gap) and is
steady from seed to seed."""

from __future__ import annotations

from typing import List

import numpy as np

from portbench.lib import weights
from portbench.reference import lm as lm_ref
from portbench.reference import patterns


def served_stream(stream: np.ndarray, gen_frames: int, K: int) -> np.ndarray:
    """The steps of one span's stream: the span's frames plus K (the EOG
    column and its K - 1 cascade steps)."""
    return np.asarray(stream)[:, :gen_frames + K]


def codes_mismatch(unit: dict, item: dict, kept, K: int):
    """The codes and labels the program assembled from a request's served
    stream (``unit["codes"]``, ``unit["marks"]``) against the reference's
    own: the span undelayed, its EOG frame dropped, spliced between the
    kept source segments. Returns (the count of entries that differ, every
    entry when the shapes differ; the reference's codes, labels and kept
    intervals in the new timeline)."""
    span = patterns.generated_span(item["stream"], item["stream"].shape[1], K)
    codes, marks, out_iv = patterns.splice_codes(item["y"], kept, [span])
    got_c, got_m = np.asarray(unit["codes"])[0], np.asarray(unit["marks"])[0]
    if got_c.shape != codes.shape or got_m.shape != marks.shape:
        return float(codes.size + marks.size), codes, marks, out_iv
    return (float((got_c != codes).sum() + (got_m != marks).sum()), codes,
            marks, out_iv)


def judge(ctx, items: List[dict], lm_dtype):
    """``items``: dicts with the request's ``x``, ``y``, ``span`` (one
    masked interval) and the served ``stream`` [K, steps]. Returns (mean
    gap, tokens compared, the reference's rebuilt (prefix, kept intervals)
    per item); in a control run the gap is the control's picks'."""
    cfg = ctx.cfg
    ts, dec = cfg["tokens"], cfg["decode"]
    sp = patterns.special_ids(ts)
    K, vocab = cfg["n_codebooks"], ts["audio_vocab_size"]
    if dec["aug_text"] and not dec["cfg_pretrained"]:
        raise ValueError("the reference follows CFG rows of the pretrained "
                         "unconditional token only")
    uncond = (np.array([cfg["text_vocab_size"] - 1]) if dec["aug_text"]
              else None)
    W = weights.lm_weights(cfg, ctx.seed, ctx.device, lm_dtype)
    ref = lm_ref.LM(W, cfg, lm_dtype)
    low = lm_ref.LM(W, cfg, lm_dtype, fp8=True) if ctx.control else None
    widest, total, compared, built = 0.0, 0.0, 0, []
    for it in items:
        prefix, _, kept = patterns.inference_prefix(it["y"], [it["span"]], ts)
        built.append((prefix, kept))
        stream = it["stream"]
        fed = np.concatenate([np.full((K, 1), sp["mts"], stream.dtype),
                              stream[:, :-1]], 1)
        kw = dict(uncond_text=uncond, cfg_coef=dec["cfg_coef"],
                  cfg_stride=dec["cfg_stride"])
        logits = lm_ref.decode_logits(ref, it["x"], prefix, fed, **kw)
        pick = None
        if low is not None:
            pick = lm_ref.decode_logits(low, it["x"], prefix, fed,
                                        **kw)[..., :vocab].argmax(-1)
        w, s, c = lm_ref.served_gap(logits, stream, vocab, pick)
        widest, total, compared = max(widest, w), total + s, compared + c
    side = "served" if low is None else "control"
    ctx.log(f"logit gap over {compared} {side} tokens: widest {widest!r}")
    return total / max(compared, 1), compared, built
