"""Codec-token sequence patterns: delay interleave, span rearrangement,
mask-sentinel insertion (the port's own copy of
``ssr_speech_tpu/ops/patterns.py``, without ``revert_delay_jnp``, the variant
for use inside ``jax.jit``).

Reimplements (vectorized, host-friendly) the token bookkeeping of the
reference:
  - delay pattern build/revert: reference ``models/ssr.py:408-464`` (O(K*T)
    python loops there; here a single scatter/gather),
  - span rearrangement with sos/eos/eog sentinels: ``models/ssr.py:381-406``
    and ``data/gigaspeech.py:106-131``,
  - mask-sentinel insertion + concat: ``models/ssr.py:472-502`` /
    ``data/gigaspeech.py:197-227``,
  - random span sampling: ``data/gigaspeech.py:66-103``.

All functions here are host-side (numpy): they operate on small [K, T] int
arrays (T <= ~1100) during data prep and inference prefix construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import MaskingConfig, TokenSpace

Interval = Tuple[int, int]


def delay_pattern(tokens: np.ndarray, empty_token: int) -> np.ndarray:
    """Apply the per-codebook delay pattern: out[q, t+q] = tokens[q, t].

    [K, T] -> [K, T + K - 1]; positions not covered hold ``empty_token``.
    Matches reference ``get_pattern_sequence`` with default delays
    (``models/ssr.py:408-436``).
    """
    tokens = np.asarray(tokens)
    K, T = tokens.shape
    out = np.full((K, T + K - 1), empty_token, dtype=tokens.dtype)
    rows = np.arange(K)[:, None]
    cols = np.arange(T)[None, :] + np.arange(K)[:, None]
    out[rows, cols] = tokens
    return out


def revert_delay_pattern(pattern: np.ndarray) -> np.ndarray:
    """Invert :func:`delay_pattern`: out[q, t] = pattern[q, t+q].

    [K, S] -> [K, S - K + 1]. Matches reference ``revert_pattern_sequence``
    (``models/ssr.py:438-464``).
    """
    pattern = np.asarray(pattern)
    K, S = pattern.shape
    T = S - K + 1
    rows = np.arange(K)[:, None]
    cols = np.arange(T)[None, :] + np.arange(K)[:, None]
    return pattern[rows, cols]


def non_mask_intervals(mask_intervals: Sequence[Interval], y_len: int) -> List[Interval]:
    """Complementary intervals: [(0,s0), (e0,s1), ..., (eN,y_len)].

    Matches reference ``data/gigaspeech.py:101`` / ``models/ssr.py:609-616``.
    """
    starts = [0] + [int(e) for _, e in mask_intervals]
    ends = [int(s) for s, _ in mask_intervals] + [int(y_len)]
    return list(zip(starts, ends))


def rearrange_spans(
    y: np.ndarray,
    mask_intervals: Sequence[Interval],
    non_mask: Sequence[Interval],
    ts: TokenSpace,
) -> List[np.ndarray]:
    """Cut y into [non-mask segments..., masked segments...] with sentinels.

    First non-mask segment is prefixed with sos; last is suffixed with eos;
    each masked segment is suffixed with eog. Empty boundary segments become
    a bare sentinel. Matches reference ``models/ssr.py:381-406``.
    """
    y = np.asarray(y)
    K = y.shape[0]
    sos = np.full((K, 1), ts.sos, dtype=y.dtype)
    eos = np.full((K, 1), ts.eos, dtype=y.dtype)
    eog = np.full((K, 1), ts.eog, dtype=y.dtype)
    segments: List[np.ndarray] = []
    n = len(non_mask)
    for i, (s, e) in enumerate(non_mask):
        seg = y[:, s:e]
        if i == 0:
            seg = sos if s == e else np.concatenate([sos, seg], axis=1)
        elif i == n - 1:
            seg = eos if s == e else np.concatenate([seg, eos], axis=1)
        segments.append(seg)
    for s, e in mask_intervals:
        segments.append(np.concatenate([y[:, s:e], eog], axis=1))
    return segments


def insert_mask_sentinels(
    shifted: Sequence[np.ndarray],
    ts: TokenSpace,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[np.ndarray], List[int]]:
    """Interleave mask-sentinel columns between segments.

    Layout: [seg0, m0, seg1, m1, ..., segN, m0, gen0, m1, gen1, ...] where the
    same sentinel id marks a span's slot in the prefix and again before its
    masked content at the tail. Returns (pieces, mask_positions) where
    mask_positions[j] is the column index of sentinel j (cumulative length of
    pieces before it). Matches reference ``models/ssr.py:472-494`` /
    ``data/gigaspeech.py:197-219``.
    """
    num_masks = (len(shifted) - 1) // 2
    assert len(shifted) == 2 * num_masks + 1, len(shifted)
    K = shifted[0].shape[0]
    emb_inds = list(range(ts.mts, ts.mts + ts.max_n_spans))
    if shuffle:
        assert rng is not None
        rng.shuffle(emb_inds)
    use = emb_inds[:num_masks]
    sentinel_ids = use + use
    pieces: List[np.ndarray] = []
    mask_positions: List[int] = []
    total = 0
    for j in range(len(shifted) - 1):
        pieces.append(shifted[j])
        total += shifted[j].shape[1]
        mask_positions.append(total)
        col = np.full((K, 1), sentinel_ids[j], dtype=shifted[0].dtype)
        pieces.append(col)
        total += 1
    pieces.append(shifted[-1])
    return pieces, mask_positions


def build_lm_sequence(
    y: np.ndarray,
    mask_intervals: Sequence[Interval],
    ts: TokenSpace,
    shuffle_mask_embedding: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Full pipeline: rearrange -> delay-shift -> sentinel insert -> concat.

    Returns (cated_y [K, S], mask_positions). This is the training-target
    construction of ``data/gigaspeech.py:272-276`` and the inference prefix
    source of ``models/ssr.py:619-622``.
    """
    nm = non_mask_intervals(mask_intervals, y.shape[1])
    segs = rearrange_spans(y, mask_intervals, nm, ts)
    shifted = [delay_pattern(s, ts.empty) for s in segs]
    pieces, mask_positions = insert_mask_sentinels(
        shifted, ts, shuffle=shuffle_mask_embedding, rng=rng
    )
    return np.concatenate(pieces, axis=1), mask_positions


def build_inference_prefix(
    y: np.ndarray,
    mask_intervals: Sequence[Interval],
    ts: TokenSpace,
) -> Tuple[np.ndarray, List[int], int, List[Interval]]:
    """Prefix fed to the decoder before generation: the full interleaved
    sequence truncated at the num_task-th sentinel slot (exclusive of the
    sentinel itself — the decode loop feeds each span's sentinel).

    Returns (prefix [K, P], mask_positions, num_task, non_mask_intervals).
    Matches reference ``models/ssr.py:609-625``.
    """
    cated, mask_positions = build_lm_sequence(y, mask_intervals, ts)
    num_task = len(mask_positions) // 2
    prefix = cated[:, : mask_positions[num_task]]
    return prefix, mask_positions, num_task, non_mask_intervals(mask_intervals, y.shape[1])


def sample_mask_intervals(
    rng: np.random.Generator, y_len: int, cfg: MaskingConfig
) -> Tuple[List[Interval], List[Interval]]:
    """Randomly sample training mask spans.

    Mirrors reference ``prepare_mask_intervals`` (``data/gigaspeech.py:66-103``):
    uniform or clamped-poisson span count, sorted starts with min_gap pruning,
    per-span length bounded by max_mask_portion budget, optional tts
    enhancement forcing the last span to reach the end with p=0.5.
    """
    if cfg.mask_sample_dist == "uniform":
        n_spans = int(rng.integers(1, cfg.max_n_spans + 1))
    elif cfg.mask_sample_dist.lower().startswith("poisson"):
        lam = float(cfg.mask_sample_dist[len("poisson"):])
        n_spans = int(np.clip(rng.poisson(lam), 1, cfg.max_n_spans))
    else:
        raise ValueError(cfg.mask_sample_dist)

    hi = y_len - cfg.mask_len_min
    assert hi >= 1, f"utterance too short to mask: y_len={y_len}"
    n_spans = min(n_spans, hi)
    starts = sorted(rng.choice(hi, size=n_spans, replace=False).tolist())
    for j in range(len(starts) - 1, 0, -1):
        if starts[j] - starts[j - 1] < cfg.min_gap:
            del starts[j]
    assert starts, f"no spans left, y_len={y_len}"

    budget = int(cfg.max_mask_portion * y_len / len(starts))
    ends = []
    for j, start in enumerate(starts):
        if j < len(starts) - 1:
            max_len = min(budget, starts[j + 1] - starts[j] - cfg.min_gap + 1)
        else:
            max_len = min(budget, y_len - start)
        max_len = max(max_len, cfg.mask_len_min)
        ends.append(start + int(rng.integers(cfg.mask_len_min, max_len + 1)))

    if cfg.tts_enhanced > 0 and rng.random() < 0.5:
        starts[-1] = max(starts[-1], y_len - budget)
        ends[-1] = y_len

    mask = list(zip(starts, ends))
    return mask, non_mask_intervals(mask, y_len)


def splice_generated(
    y: np.ndarray,
    nm_intervals: Sequence[Interval],
    generated_spans: Sequence[np.ndarray],
    y_total_len: int,
) -> Tuple[np.ndarray, np.ndarray, List[Interval]]:
    """Interleave original non-masked codec segments with generated spans.

    ``generated_spans`` are already delay-reverted, eog-stripped [K, L_i].
    Returns (codes [1, K, T'], marks [1, T'] with 1 on generated frames,
    out_intervals: locations of the original segments in the new stream).
    Matches reference ``models/ssr.py:786-805``.
    """
    pieces: List[np.ndarray] = []
    marks: List[np.ndarray] = []
    out_intervals: List[Interval] = []
    pos = 0
    for (s, e), gen in zip(nm_intervals, generated_spans):
        pieces.append(y[:, s:e])
        marks.append(np.zeros(e - s, dtype=np.int64))
        out_intervals.append((pos, pos + e - s))
        pieces.append(gen)
        marks.append(np.ones(gen.shape[1], dtype=np.int64))
        pos += (e - s) + gen.shape[1]
    # trailing non-mask segment (edit in the middle / tts) — reference
    # models/ssr.py:799-803 guards on y length vs last interval
    if y_total_len != nm_intervals[-1][1] + 1:
        s, e = nm_intervals[-1]
        pieces.append(y[:, s:e])
        marks.append(np.zeros(e - s, dtype=np.int64))
        out_intervals.append((pos, pos + e - s))
    codes = np.concatenate(pieces, axis=1)[None]
    mark = np.concatenate(marks)[None]
    return codes, mark, out_intervals
