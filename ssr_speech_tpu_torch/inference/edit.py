"""Edit-span detection: align original vs target transcripts and find the
token spans that must be regenerated (the port's own copy of
``ssr_speech_tpu/inference/edit.py``; nothing in it is JAX-specific).

Capability parity with reference ``edit_utils_en.py`` / ``edit_utils_zh.py``:
English diffs at the word level (edit_utils_en.py:104-110), Mandarin at the
character level (edit_utils_zh.py:103-109); adjacent/overlapping spans are
merged; TTS mode spans from the first difference to the end
(edit_utils_en.py:112-118).

Implemented as a numpy DP with explicit backpointers (the reference builds
operation strings during the DP, edit_utils_en.py:10-66).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

Span = Tuple[int, int]

_WORD_RE = re.compile(r"\b[\w']+\b", re.UNICODE)


def extract_words(sentence: str) -> List[str]:
    return _WORD_RE.findall(sentence)


def align_ops(src: Sequence[str], dst: Sequence[str]) -> List[Tuple[int, int, str]]:
    """Minimal-edit alignment. Returns ops as (src_start, src_end, kind) with
    kind in {d,i,s} for positions in the source sequence; matches are omitted.

    Tie-breaking follows the reference DP (deletion preferred over insertion
    over substitution when costs tie, edit_utils_en.py:29-39) so span output
    is identical. Uses the native C++ DP (``ssr_speech_tpu_torch.native``) when
    available; falls back to the numpy DP below.
    """
    from .. import native

    if native.available():
        vocab = {}
        ids = lambda toks: np.asarray(
            [vocab.setdefault(t, len(vocab)) for t in toks], np.int32)
        a, b = ids(src), ids(dst)
        ops = native.levenshtein_ops(a, b)
        if ops is not None:
            return ops
    n, m = len(src), len(dst)
    dist = np.zeros((n + 1, m + 1), np.int32)
    back = np.zeros((n + 1, m + 1), np.int8)  # 0=diag, 1=del, 2=ins
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    back[1:, 0] = 1
    back[0, 1:] = 2
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            cost = 0 if src[i - 1] == dst[j - 1] else 1
            dele = dist[i - 1, j] + 1
            ins = dist[i, j - 1] + 1
            sub = dist[i - 1, j - 1] + cost
            best = min(dele, ins, sub)
            dist[i, j] = best
            if best == dele:
                back[i, j] = 1
            elif best == ins:
                back[i, j] = 2
            else:
                back[i, j] = 0
    ops: List[Tuple[int, int, str]] = []
    i, j = n, m
    while i > 0 or j > 0:
        b = back[i, j]
        if i > 0 and b == 1:
            ops.append((i - 1, i, "d"))
            i -= 1
        elif j > 0 and b == 2:
            ops.append((i, i, "i"))
            j -= 1
        else:
            if src[i - 1] != dst[j - 1]:
                ops.append((i - 1, i, "s"))
            i -= 1
            j -= 1
    return ops[::-1]


def extract_spans(ops: Sequence[Tuple[int, int, str]], orig_len: int) -> List[Span]:
    """Merge consecutive same-kind ops into spans (edit_utils_en.py:68-89)."""
    if not ops:
        return []
    spans: List[Span] = []
    cs, ce, ck = ops[0]
    for s, e, k in ops[1:]:
        if k == ck and (s == ce or s == ce + 1):
            ce = e
        else:
            spans.append((cs, ce))
            cs, ce, ck = s, e, k
    spans.append((cs, ce))
    if spans[-1][0] >= orig_len:  # insertion at the very end
        spans[-1] = (orig_len, orig_len)
    return spans


def combine_nearby_spans(spans: List[Span]) -> List[Span]:
    """Merge spans that touch or overlap (edit_utils_en.py:91-102)."""
    if not spans:
        return spans
    out = [spans[0]]
    for s, e in spans[1:]:
        ls, le = out[-1]
        if le + 1 >= s:
            out[-1] = (ls, max(le, e))
        else:
            out.append((s, e))
    return out


def parse_edit_en(orig: str, target: str) -> List[Span]:
    w1, w2 = extract_words(orig), extract_words(target)
    return combine_nearby_spans(extract_spans(align_ops(w1, w2), len(w1)))


def parse_tts_en(orig: str, target: str) -> List[Span]:
    w1, w2 = extract_words(orig), extract_words(target)
    spans = extract_spans(align_ops(w1, w2), len(w1))
    return [(spans[0][0] if spans else len(w1), len(w1))]


def parse_edit_zh(orig: str, target: str) -> List[Span]:
    """Character-level diff (edit_utils_zh.py:103-109 passes raw transcripts)."""
    c1, c2 = list(orig), list(target)
    return combine_nearby_spans(extract_spans(align_ops(c1, c2), len(c1)))


def parse_tts_zh(orig: str, target: str) -> List[Span]:
    c1, c2 = list(orig), list(target)
    spans = extract_spans(align_ops(c1, c2), len(c1))
    return [(spans[0][0] if spans else len(c1), len(c1))]
