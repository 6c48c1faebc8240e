"""Host-side text normalization: digits -> spelled-out words (the port's own
copy of ``ssr_speech_tpu/utils/text_norm.py``; nothing in it is JAX-specific).

The reference applies ``num2words`` to every ASR segment before forced
alignment (``inference_v2.py:45-53``: spaces are inserted around digit runs,
then each run is replaced by its cardinal words). Real transcripts contain
digits, and phonemizing "42" vs "forty-two" changes the phoneme-id stream, so
this must run on both ASR output and the user-provided transcripts.

``num2words`` is an optional host dep; when absent, :func:`num_to_words_en`
reproduces its English cardinal output (same hyphen/"and"/comma rules from
num2words' lang_EN merge table) for non-negative integers, which is the only
shape the reference path can feed it (the regex only matches ``\\d+`` runs).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

try:  # optional host-side dependency, mirrors the reference import
    from num2words import num2words as _num2words

    HAVE_NUM2WORDS = True
except ImportError:  # pragma: no cover - exercised in this environment
    HAVE_NUM2WORDS = False

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 33, "decillion"), (10 ** 30, "nonillion"), (10 ** 27, "octillion"),
    (10 ** 24, "septillion"), (10 ** 21, "sextillion"),
    (10 ** 18, "quintillion"), (10 ** 15, "quadrillion"),
    (10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
    (10 ** 3, "thousand"),
]


def _under_hundred(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _under_thousand(n: int) -> str:
    if n < 100:
        return _under_hundred(n)
    hundreds, rest = divmod(n, 100)
    out = _ONES[hundreds] + " hundred"
    if rest:
        out += " and " + _under_hundred(rest)
    return out


def num_to_words_en(n: int) -> str:
    """Non-negative integer -> English cardinal, matching num2words(en):
    groups joined with ", ", except " and " before a final group < 100."""
    if n < 0:
        return "minus " + num_to_words_en(-n)
    if n < 1000:
        return _under_thousand(n)
    parts: List[Tuple[str, int]] = []
    for scale, name in _SCALES:
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append((num_to_words_en(q) + " " + name, scale))
    if n:
        sep = " and " if n < 100 else ", "
        return ", ".join(p for p, _ in parts) + sep + _under_thousand(n)
    return ", ".join(p for p, _ in parts)


def replace_numbers_with_words(sentence: str) -> str:
    """Space-pad digit runs, then spell each out (reference
    inference_v2.py:45-53)."""
    sentence = re.sub(r"(\d+)", r" \1 ", sentence)

    def _repl(match: re.Match) -> str:
        num = match.group(0)
        try:
            if HAVE_NUM2WORDS:
                return _num2words(num)
            return num_to_words_en(int(num))
        except Exception:  # reference keeps the raw token on failure
            return num
    return re.sub(r"\b\d+\b", _repl, sentence)


WordTime = Tuple[str, float, float]


def normalize_aligned_words(words: Sequence[WordTime]) -> List[WordTime]:
    """Apply digit->words normalization to an aligned word list, preserving
    the ``[(word, start, end)]`` contract.

    The reference normalizes segment *text* before forced alignment, so each
    spelled-out word gets its own aligned times (inference_v2.py:90-94). With
    precomputed alignments the original digit token owns one interval; we
    split it evenly across the expansion — an approximation that keeps edit
    spans anchored to the right region.
    """
    out: List[WordTime] = []
    for word, start, end in words:
        if not re.search(r"\d", word):
            out.append((word, start, end))
            continue
        pieces = replace_numbers_with_words(word).split()
        if len(pieces) <= 1:
            out.append((pieces[0] if pieces else word, start, end))
            continue
        step = (end - start) / len(pieces)
        for i, piece in enumerate(pieces):
            out.append((piece, start + i * step, start + (i + 1) * step))
    return out
