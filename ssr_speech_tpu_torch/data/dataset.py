"""Training dataset: manifest -> (phoneme ids, codec tokens) -> masked-span
LM sequences (the port's own copy of ``ssr_speech_tpu/data/dataset.py``; it
yields numpy batches and nothing in it is JAX-specific).

Capability parity with reference ``data/gigaspeech.py``:
  - manifest TSV ``0\tsegid\tn_frames`` under <dataset_dir>/<manifest_name>/
    (gigaspeech.py:16-29), length filtering with drop_long,
  - vocab.txt ``idx phn`` -> phn2num (gigaspeech.py:31-36), symbol set
    <SIL>/<MUSIC>/<NOISE>/<OTHER> dropped from phoneme streams
    (gigaspeech.py:38,51),
  - per-utterance phoneme txt + codec txt (K rows of ints)
    (gigaspeech.py:43-64), corrupt/short/long items -> None and dropped at
    collate (gigaspeech.py:234-266 fault tolerance),
  - random span masking + delay pattern + sentinel insertion on the fly
    (gigaspeech.py:272-276, via ops.patterns),
  - cfg_enhanced: 10% of items replace text with the reserved CFG token
    (gigaspeech.py:268-270).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import DataConfig, MaskingConfig, SSRModelConfig
from ..ops import patterns

logger = logging.getLogger(__name__)

SYMBOL_SET = {"<SIL>", "<MUSIC>", "<NOISE>", "<OTHER>"}


def load_vocab(path: str) -> Dict[str, int]:
    phn2num = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx, phn = line.split(" ", 1)
            phn2num[phn] = int(idx)
    return phn2num


class SpeechDataset:
    def __init__(
        self,
        cfg: SSRModelConfig,
        data_cfg: DataConfig,
        mask_cfg: MaskingConfig,
        split: str,
        seed: int = 0,
    ):
        assert split in ("train", "validation", "test")
        self.cfg, self.dcfg, self.mcfg = cfg, data_cfg, mask_cfg
        self.split = split
        manifest = os.path.join(data_cfg.dataset_dir, data_cfg.manifest_name,
                                split + ".txt")
        with open(manifest) as f:
            rows = [l.strip().split("\t") for l in f if l.strip()]
        self.items: List[Tuple[str, int]] = []
        min_len = data_cfg.encodec_sr * data_cfg.audio_min_length
        max_len = data_cfg.encodec_sr * data_cfg.audio_max_length
        for row in rows:
            n = int(row[-1])
            if n < min_len:
                continue
            if data_cfg.drop_long and n > max_len:
                continue
            self.items.append((row[1], n))
        logger.info("%s split: %d items", split, len(self.items))
        self.phn2num = load_vocab(os.path.join(data_cfg.dataset_dir, "vocab.txt"))
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def lengths(self) -> np.ndarray:
        return np.asarray([n for _, n in self.items])

    def _load(self, idx: int):
        seg, _ = self.items[idx]
        pf = os.path.join(self.dcfg.dataset_dir, self.dcfg.phn_folder_name, seg + ".txt")
        ef = os.path.join(self.dcfg.dataset_dir, self.dcfg.encodec_folder_name, seg + ".txt")
        from .. import native

        try:
            with open(pf) as p:
                phns = p.read().strip()
            x = [self.phn2num[t] for t in phns.split(" ")
                 if t not in SYMBOL_SET and t in self.phn2num]
            y = native.parse_int_matrix(ef, max_rows=self.cfg.n_codebooks)
            if y is None or y.shape[0] != self.cfg.n_codebooks:
                return None, None
            y = y.astype(np.int64)
            if self.dcfg.special_first:
                y = y + self.cfg.tokens.n_special
        except Exception as e:  # corrupt file -> drop (gigaspeech.py:59-62)
            logger.info("load failed for %s: %s", seg, e)
            return None, None
        return x, y

    def __getitem__(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        x, y = self._load(idx)
        if x is None or len(x) == 0 or y.shape[1] == 0:
            return None
        y_len = y.shape[1]
        d, m, ts = self.dcfg, self.mcfg, self.cfg.tokens
        if y_len < d.encodec_sr * d.audio_min_length or len(x) < d.text_min_length:
            return None
        if d.drop_long and (len(x) > d.text_max_length
                            or y_len > d.encodec_sr * d.audio_max_length):
            return None
        if m.cfg_enhanced and self.rng.random() < 0.1:
            x = [self.cfg.text_vocab_size - 1]
        mask_iv, _ = patterns.sample_mask_intervals(self.rng, y_len, m)
        cated, _ = patterns.build_lm_sequence(
            y, mask_iv, ts, shuffle_mask_embedding=m.shuffle_mask_embedding,
            rng=self.rng,
        )
        if not (cated < ts.cardinality).all():
            return None
        return dict(x=np.asarray(x, np.int64), y=cated)
