"""The SSR-Speech token layout in plain numpy: the delay pattern, the
rearranged [kept segments, sentinels, masked spans] sequence, the inference
prefix, and the splice of generated spans back into the source codes and
waveform (SSR-Speech ``models/ssr.py``, VoiceCraft's delayed codebooks).

A frozen copy of the semantics, held apart from the program so that the
reference rebuilds every derived input itself."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Interval = Tuple[int, int]


def special_ids(tokens: dict) -> dict:
    """empty, eog, pad, eos, sos, then the mask sentinels (mts + i)."""
    v = tokens["audio_vocab_size"]
    return dict(empty=v, eog=v + 1, pad=v + 2, eos=v + 3, sos=v + 4, mts=v + 5)


def delay(tokens: np.ndarray, empty: int) -> np.ndarray:
    """out[q, t + q] = tokens[q, t]; [K, T] -> [K, T + K - 1]."""
    K, T = tokens.shape
    out = np.full((K, T + K - 1), empty, dtype=tokens.dtype)
    for q in range(K):
        out[q, q:q + T] = tokens[q]
    return out


def undelay(pattern: np.ndarray) -> np.ndarray:
    """out[q, t] = pattern[q, t + q]; [K, S] -> [K, S - K + 1]."""
    K, S = pattern.shape
    return np.stack([pattern[q, q:q + S - K + 1] for q in range(K)])


def kept_intervals(spans: Sequence[Interval], n: int) -> List[Interval]:
    starts = [0] + [int(e) for _, e in spans]
    ends = [int(s) for s, _ in spans] + [int(n)]
    return list(zip(starts, ends))


def inference_prefix(y: np.ndarray, spans: Sequence[Interval], tokens: dict
                     ) -> Tuple[np.ndarray, int, List[Interval]]:
    """The prompt's audio tokens [K, P]: sos + the kept segments (eos after
    the last), each delayed, a sentinel after each but the last, up to the
    first masked span's sentinel, which the decode feeds itself. Returns
    (prefix, number of spans, kept intervals)."""
    sp = special_ids(tokens)
    K, n = y.shape
    kept = kept_intervals(spans, n)
    segs = []
    for i, (s, e) in enumerate(kept):
        seg = y[:, s:e]
        if i == 0:
            seg = np.concatenate([np.full((K, 1), sp["sos"], y.dtype), seg], 1)
        elif i == len(kept) - 1:
            seg = np.concatenate([seg, np.full((K, 1), sp["eos"], y.dtype)], 1)
        segs.append(delay(seg, sp["empty"]))
    pieces = []
    for j, seg in enumerate(segs):
        pieces.append(seg)
        if j < len(segs) - 1:
            pieces.append(np.full((K, 1), sp["mts"] + j, y.dtype))
    return np.concatenate(pieces, 1), len(spans), kept


def splice_codes(y: np.ndarray, kept: Sequence[Interval],
                 generated: Sequence[np.ndarray]):
    """Kept source segments interleaved with the generated spans ([K, L_i],
    undelayed). Returns (codes [K, T'], marks [T'] 1 on generated frames,
    kept intervals in the new timeline)."""
    pieces, marks, out_iv, pos = [], [], [], 0
    for (s, e), gen in zip(kept, generated):
        pieces += [y[:, s:e], gen]
        marks += [np.zeros(e - s, np.int64), np.ones(gen.shape[1], np.int64)]
        out_iv.append((pos, pos + e - s))
        pos += (e - s) + gen.shape[1]
    if y.shape[1] != kept[-1][1] + 1:
        s, e = kept[-1]
        pieces.append(y[:, s:e])
        marks.append(np.zeros(e - s, np.int64))
        out_iv.append((pos, pos + e - s))
    return np.concatenate(pieces, 1), np.concatenate(marks), out_iv


def splice_wave(wav: np.ndarray, n_frames: int, hop: int,
                kept: Sequence[Interval], out_iv: Sequence[Interval]):
    """The watermark decoder's input [1, n_frames * hop, 1]: the source
    samples of the kept segments at their new places, zeros elsewhere."""
    out = np.zeros((1, n_frames * hop, 1), np.float32)
    for (s, e), (ns, _) in zip(kept, out_iv):
        seg = wav[0, max(s, 0) * hop:e * hop]
        out[0, max(ns, 0) * hop:max(ns, 0) * hop + seg.shape[0]] = seg
    return out


def generated_span(stream: np.ndarray, steps: int, K: int) -> np.ndarray:
    """One span's frames from the decode's token stream [K, >= steps]
    (delayed, ending in the EOG column): undelayed, the EOG frame dropped."""
    span = stream[:, :steps]
    if span.shape[1] < K:
        return np.zeros((K, 0), stream.dtype)
    return undelay(span)[:, :-1]
