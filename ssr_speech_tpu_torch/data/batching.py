"""Token-budget bucket batching with static per-bucket shapes (the port's own
copy of ``ssr_speech_tpu/data/batching.py``, same batches from the same seed).
PyTorch runs eagerly and does not need static shapes, but a fixed shape per
bucket keeps the allocator's cache and the kernels' checked shapes stable,
and keeps the two packages' batches identical.

Replaces the reference's ``DistributedDynamicBatchSampler``
(``steps/trainer_utils.py:175-632``): same token-budget semantics
(max_num_tokens per device, trainer_utils.py:315) and resumable
epoch/cur_step state (trainer_utils.py:96-99), but samples are padded to a
fixed per-bucket length instead of the reference's lognormal-warped variable
boundaries (trainer_utils.py:408-437).

Batches are built with a global token budget = per-device budget x
``world_size``; the port trains on one device so far (world_size 1).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import DataConfig, SSRModelConfig

logger = logging.getLogger(__name__)


def bucket_boundaries(lengths: np.ndarray, num_buckets: int) -> List[int]:
    """Quantile bucket upper bounds over raw codec lengths."""
    qs = np.quantile(lengths, np.linspace(0, 1, num_buckets + 1)[1:])
    out = sorted(set(int(np.ceil(q)) for q in qs))
    out[-1] = int(lengths.max())
    return out


def lognormal_boundaries(max_len: int, num_buckets: int) -> List[int]:
    """The reference's lognormal-warped boundaries
    (``_get_boundaries_through_warping``, trainer_utils.py:408-437): bucket
    edges are lognorm(1).ppf of a latent linspace, scaled so the last edge
    hits ``max_len``. Data-independent (a fixed prior over durations) —
    the quantile scheme adapts to the actual corpus and is the default;
    this exists for behavior parity (``DataConfig.bucket_warp``)."""
    lat = np.linspace(1 / (num_buckets + 1), num_buckets / (num_buckets + 1),
                      num_buckets)
    try:
        from scipy.stats import lognorm

        qs = lognorm.ppf(lat, 1)
    except ImportError:  # ppf of lognorm(s=1) is exp(probit(p))
        from statistics import NormalDist

        qs = np.asarray([np.exp(NormalDist().inv_cdf(p)) for p in lat])
    edges = qs * max_len / qs[-1]
    out = sorted(set(int(np.ceil(e)) for e in edges))
    out[-1] = int(max_len)
    return out


class BucketBatcher:
    """Groups dataset items into fixed-shape, token-budgeted batches."""

    def __init__(
        self,
        dataset,
        cfg: SSRModelConfig,
        data_cfg: DataConfig,
        max_num_tokens: Optional[int] = None,
        world_size: int = 1,
        seed: int = 1,
        pad_multiple: int = 32,
    ):
        self.ds = dataset
        self.cfg = cfg
        self.dcfg = data_cfg
        self.budget = (max_num_tokens or data_cfg.max_num_tokens) * world_size
        self.seed = seed
        self.pad_multiple = pad_multiple
        # batch ROWS padded up to a multiple of world_size so dp / pipeline
        # sharding stays valid even when corrupt items are dropped; pad rows
        # have x_lens = y_lens = 0 and contribute zero loss/metrics (all
        # their targets are masked; an all-banned bias row softmaxes to a
        # finite uniform distribution)
        self.rows_multiple = max(world_size, 1)
        lengths = dataset.lengths()
        if getattr(data_cfg, "bucket_warp", "quantile") == "lognormal":
            self.bounds = lognormal_boundaries(int(lengths.max()),
                                               data_cfg.num_buckets)
        else:
            self.bounds = bucket_boundaries(lengths, data_cfg.num_buckets)
        self.assignment = np.searchsorted(self.bounds, lengths)
        # static pad length per bucket: raw bound + worst-case sequence
        # overhead from sentinels/sos/eos/eog and the delay pattern
        ts = cfg.tokens
        overhead = (
            (2 * ts.max_n_spans + 1) * (cfg.n_codebooks - 1)  # delay per segment
            + 2 * ts.max_n_spans  # sentinel columns
            + 2 + ts.max_n_spans  # sos + eos + per-span eog
        )
        self.pad_y = [self._round(b + overhead) for b in self.bounds]
        self.pad_x = self._round(data_cfg.text_max_length)
        # resumable state (reference trainer_utils.py:96-99)
        self.epoch = 0
        self.cur_step = 0

    def _round(self, n: int) -> int:
        m = self.pad_multiple
        return ((n + m - 1) // m) * m

    def set_epoch_resume(self, epoch: int, cur_step: int):
        self.epoch, self.cur_step = epoch, cur_step

    def batches(self, epoch: int) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.ds))
        per_bucket: List[List[int]] = [[] for _ in self.bounds]
        plans: List[List[int]] = []
        for idx in order:
            b = self.assignment[idx]
            per_bucket[b].append(int(idx))
            cap = max(self.budget // self.pad_y[b], 1)
            if len(per_bucket[b]) >= cap:
                plans.append((b, per_bucket[b]))
                per_bucket[b] = []
        for b, rest in enumerate(per_bucket):
            if rest:
                plans.append((b, rest))
        rng.shuffle(plans)
        return plans

    def __call__(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        plans = self.batches(epoch)
        start = self.cur_step if epoch == self.epoch else 0
        for plan in plans[start:]:
            batch = self.collate(plan)
            if batch is not None:
                yield batch
        self.cur_step = 0

    def collate(self, plan) -> Optional[Dict[str, np.ndarray]]:
        """Pad to the bucket's static shape; drop failed items
        (reference gigaspeech.py:298-322)."""
        b, idxs = plan
        ts = self.cfg.tokens
        items = [self.ds[i] for i in idxs]
        items = [it for it in items if it is not None]
        if not items:
            return None
        n = len(items)
        m = self.rows_multiple
        n = ((n + m - 1) // m) * m  # zero-length pad rows fill the remainder
        sx, sy = self.pad_x, self.pad_y[b]
        x = np.full((n, sx), self.cfg.text_pad_token, np.int32)
        y = np.full((n, sy, self.cfg.n_codebooks), ts.pad, np.int32)
        x_lens = np.zeros(n, np.int32)
        y_lens = np.zeros(n, np.int32)
        for i, it in enumerate(items):
            lx = min(len(it["x"]), sx)
            ly = min(it["y"].shape[1], sy)
            x[i, :lx] = it["x"][:lx]
            y[i, :ly] = it["y"][:, :ly].T
            x_lens[i] = lx
            y_lens[i] = ly
        return dict(x=x, x_lens=x_lens, y=y, y_lens=y_lens)
