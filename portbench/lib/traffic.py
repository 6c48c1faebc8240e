"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<mix>.json``) and draws the inputs from the run's seed. The same
seed gives the same inputs. Every seed gets the same set of sizes, in
another order, so that a window of a given length holds about the same work
whatever the seed; the seed draws the order and the content.

Kinds:

- ``edit``: speech edits. A block lists (utterance frames, span frames,
  greedy) triples; each block of requests is the list in a seeded order. A
  request is random source codes [K, T] and a waveform of T hops, a span of
  the given length at a seeded place, and ``(T + prefix overhead) /
  length_cap_mult`` text ids, so that the decode's own length cap (x_len *
  length_cap_mult) ends the span after exactly its length: the prompt is T
  minus the span plus the overhead of the SSR-Speech layout, so the cap
  falls at T + overhead.
- ``waves``: a pool of waveforms at the quantile midpoints of a log-uniform
  length distribution, drawn on the device in one call and copied to the
  host once, grouped into padded batches by length bucket.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), *stream])


def prefix_overhead(cfg: dict) -> int:
    """Prompt positions beyond the kept frames for one masked span: sos, eos
    and one sentinel, plus K - 1 delay columns for each of the two kept
    segments (``reference/patterns.inference_prefix``)."""
    return 3 + 2 * (cfg["n_codebooks"] - 1)


def edit_sizes(mix: dict, seed: int, n: int) -> List[dict]:
    """The sizes of the first ``n`` requests: each block of the mix's list in
    a seeded order."""
    block = mix["block"]
    out = []
    for b in range(-(-n // len(block))):
        order = _rng(seed, 1, b).permutation(len(block))
        out += [dict(zip(("frames", "span", "greedy"), block[j])) for j in order]
    return out[:n]


def edit_request(mix: dict, cfg: dict, seed: int, i: int, size: dict,
                 wave: bool = True) -> Dict:
    """Request ``i``'s content: source codes, span, text ids and (with
    ``wave``) the source waveform."""
    rng = _rng(seed, 2, i)
    K = cfg["n_codebooks"]
    vocab = cfg["tokens"]["audio_vocab_size"]
    hop = math.prod(cfg["codec"]["seanet"]["ratios"])
    T, span = int(size["frames"]), int(size["span"])
    need = T + prefix_overhead(cfg)
    mult = mix["length_cap_mult"]
    if need % mult:
        raise ValueError(f"frames {T}: {need} is no multiple of {mult}")
    start = int(rng.integers(0, T - span + 1))
    req = dict(
        index=i, frames=T, span=(start, start + span), greedy=bool(size["greedy"]),
        # the last real text id is CFG's unconditional token: not drawn
        x=rng.integers(0, cfg["text_vocab_size"] - 1, size=need // mult),
        y=rng.integers(0, vocab, size=(K, T)))
    if wave:
        req["wav"] = (rng.standard_normal((1, T * hop, 1), dtype=np.float32)
                      * np.float32(mix["wave_scale"]))
    return req


def warm_sizes(mix: dict) -> List[dict]:
    """One request of every size the mix can draw."""
    return [dict(zip(("frames", "span", "greedy"), t)) for t in mix["block"]]


def wave_lengths(mix: dict, hop: int, rate: int) -> List[int]:
    """Sample counts of the pool: the quantile midpoints of a log-uniform
    distribution of seconds, whole hops."""
    lo, hi = (math.log(s) for s in mix["seconds"])
    n = mix["n_waves"]
    secs = [math.exp(lo + (j + 0.5) / n * (hi - lo)) for j in range(n)]
    return [max(1, round(s * rate / hop)) * hop for s in secs]


def wave_pool(mix: dict, seed: int, hop: int, rate: int, device) -> List[np.ndarray]:
    """The pool [n][samples] fp32 on the host, drawn on ``device`` in one
    call (lengths in a seeded order)."""
    lengths = wave_lengths(mix, hop, rate)
    order = _rng(seed, 3).permutation(len(lengths))
    lengths = [lengths[j] for j in order]
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 3) % (2 ** 63))
    flat = (torch.randn(sum(lengths), generator=gen, device=device)
            * mix["wave_scale"]).cpu().numpy()
    out, off = [], 0
    for n in lengths:
        out.append(flat[off:off + n])
        off += n
    return out


def wave_batches(mix: dict, pool: List[np.ndarray], hop: int, seed: int
                 ) -> List[dict]:
    """The pool as batches of at most ``batch`` waveforms of one length
    bucket (``bucket_frames`` codec frames), the same lengths in each batch
    whatever the seed, the batches in a seeded order:
    [{"idx": pool indices, "frames": true frames, "pad": padded frames}]."""
    bucket = mix["bucket_frames"]
    by_pad: Dict[int, List[int]] = {}
    for j, w in enumerate(pool):
        frames = len(w) // hop
        by_pad.setdefault(-(-frames // bucket) * bucket, []).append(j)
    batches = []
    for pad in sorted(by_pad):  # within a bucket by length: the same
        idx = sorted(by_pad[pad], key=lambda j: len(pool[j]))  # every seed
        for s in range(0, len(idx), mix["batch"]):
            part = idx[s:s + mix["batch"]]
            batches.append(dict(idx=part, pad=pad,
                                frames=[len(pool[j]) // hop for j in part]))
    order = _rng(seed, 4).permutation(len(batches))
    return [batches[j] for j in order]


def padded(pool: List[np.ndarray], batch: dict, hop: int,
           out: Optional[np.ndarray] = None) -> np.ndarray:
    """A batch as ``data/prep.py encode`` pads it: [B, pad * hop, 1], zeros
    after each waveform; written into ``out`` (of that shape) if given."""
    shape = (len(batch["idx"]), batch["pad"] * hop, 1)
    if out is None:
        wav = np.zeros(shape, np.float32)
    else:
        wav = out.reshape(shape)
        wav.fill(0.0)
    for r, j in enumerate(batch["idx"]):
        wav[r, :len(pool[j]), 0] = pool[j]
    return wav


def serve_requests(mix: dict, cfg: dict, seed: int, n: int) -> List[dict]:
    """``n`` requests of the open-loop mix: edits and TTS requests of the
    mix's two blocks, alternating blocks of each in a seeded order. A TTS
    request is a prompt's codes [K, P] with its span at the end (P, P) and
    ``(P + generated + overhead) / length_cap_mult`` text ids."""
    blocks = [("edit", t) for t in mix["edit_block"]] + [
        ("tts", t) for t in mix["tts_block"]]
    K = cfg["n_codebooks"]
    vocab = cfg["tokens"]["audio_vocab_size"]
    mult = mix["length_cap_mult"]
    out = []
    for b in range(-(-n // len(blocks))):
        for j in _rng(seed, 6, b).permutation(len(blocks)):
            i = len(out)
            kind, (a, c) = blocks[j]
            if kind == "edit":
                req = edit_request(mix, cfg, seed, i,
                                   dict(frames=a, span=c, greedy=True), wave=False)
            else:
                rng = _rng(seed, 7, i)
                need = a + c + prefix_overhead(cfg)
                if need % mult:
                    raise ValueError(f"tts {a}+{c}: {need} % {mult}")
                req = dict(index=i, frames=a + c, span=(a, a), greedy=True,
                           x=rng.integers(0, cfg["text_vocab_size"] - 1,
                                          size=need // mult),
                           y=rng.integers(0, vocab, size=(K, a)))
            req["kind"], req["gen"] = kind, c
            out.append(req)
    return out[:n]


def arrivals(rate: float, n: int, seed: int) -> np.ndarray:
    """Arrival times [n] s: the gaps are the quantile midpoints of an
    exponential of mean 1 / rate (the same gaps every seed), in a seeded
    order; the first request arrives at its gap."""
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    return np.cumsum(gaps[_rng(seed, 8).permutation(n)])
