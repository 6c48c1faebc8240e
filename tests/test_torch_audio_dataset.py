"""The port's copy of ``AudioSegmentDataset`` (``ssr_speech_tpu_torch/data/
audio_dataset.py``), through the cases of tests/test_audio_dataset.py and
tests/test_codec_cli.py's segment tests; the same seeded batches as the
JAX package's are held in tests/test_torch_hostcopies.py."""

import json

import numpy as np
import pytest

from ssr_speech_tpu_torch.data.audio_dataset import AudioSegmentDataset
from tests.test_audio_dataset import TINY as DS_TINY
from tests.test_audio_dataset import _manifest, _zip_manifest
from tests.test_codec_cli import TINY as CLI_TINY
from tests.test_codec_cli import make_manifest
from tests.test_torch_hostcopies import port_config

TINY = port_config(DS_TINY)


def test_duration_weighted_sampling_distribution(tmp_path):
    mf = _manifest(tmp_path, [dict(duration=0.4), dict(duration=1.6)])
    ds = AudioSegmentDataset(mf, TINY, segment_duration=0.2, seed=3,
                             sample_on_duration=True, sample_on_weight=False)
    np.testing.assert_allclose(ds.sampling_probabilities, [0.2, 0.8])
    picks = np.asarray([ds._sample_file_idx() for _ in range(4000)])
    assert 0.75 < (picks == 1).mean() < 0.85
    uni = AudioSegmentDataset(mf, TINY, segment_duration=0.2, seed=3,
                              sample_on_duration=False, sample_on_weight=False)
    picks = np.asarray([uni._sample_file_idx() for _ in range(4000)])
    assert 0.45 < (picks == 1).mean() < 0.55


def test_weight_sampling_and_product(tmp_path):
    mf = _manifest(tmp_path, [dict(duration=1.0, weight=3.0),
                              dict(duration=2.0, weight=0.5)])
    ds = AudioSegmentDataset(mf, TINY, segment_duration=0.2, seed=0)
    np.testing.assert_allclose(ds.sampling_probabilities, [0.75, 0.25])
    only_w = AudioSegmentDataset(mf, TINY, segment_duration=0.2, seed=0,
                                 sample_on_duration=False)
    np.testing.assert_allclose(only_w.sampling_probabilities, [6 / 7, 1 / 7])


def test_min_segment_ratio_tail_padding(tmp_path):
    mf = _manifest(tmp_path, [dict(duration=1.0)])
    ds = AudioSegmentDataset(mf, TINY, segment_duration=0.5, seed=5,
                             min_segment_ratio=0.5)
    padded = sum(float(np.abs(ds.sample_segment()[-8:]).max()) == 0.0
                 for _ in range(50))
    assert padded > 0
    strict = AudioSegmentDataset(mf, TINY, segment_duration=0.5, seed=5,
                                 min_segment_ratio=1.0)
    for _ in range(50):
        assert np.abs(strict.sample_segment()[-8:]).max() > 0.0


def test_pad_false_raises_on_short_read(tmp_path):
    mf = _manifest(tmp_path, [dict(duration=0.3)])
    ds = AudioSegmentDataset(mf, TINY, segment_duration=1.0, seed=0,
                             min_audio_duration=0.1, pad=False)
    with pytest.raises(ValueError, match="pad=False"):
        ds.sample_segment(0)


def test_max_read_retry_resamples_then_raises(tmp_path):
    mf = _manifest(tmp_path, [dict(duration=1.0), dict(duration=1.0)])
    metas = [json.loads(line) for line in open(mf)]
    with open(metas[1]["path"], "wb") as f:
        f.write(b"not a wav")
    ds = AudioSegmentDataset(mf, TINY, segment_duration=0.2, seed=1,
                             max_read_retry=20)
    for _ in range(20):
        assert np.isfinite(ds.sample_segment()).all()
    with open(metas[0]["path"], "wb") as f:
        f.write(b"also not a wav")
    ds2 = AudioSegmentDataset(mf, TINY, segment_duration=0.2, seed=1,
                              max_read_retry=3)
    with pytest.raises(Exception):
        ds2.sample_segment()


def test_max_audio_duration_filter(tmp_path):
    mf = _manifest(tmp_path, [dict(duration=0.5), dict(duration=3.0)])
    ds = AudioSegmentDataset(mf, TINY, segment_duration=0.2,
                             max_audio_duration=1.0)
    assert len(ds) == 1


@pytest.mark.parametrize("gz", [False, True])
def test_zip_corpus_loads(tmp_path, gz):
    mf = _zip_manifest(tmp_path, [dict(duration=0.5), dict(duration=1.0)],
                       gz=gz)
    ds = AudioSegmentDataset(mf, TINY, segment_duration=0.25, seed=7)
    assert len(ds) == 2
    seg = ds.sample_segment()
    assert seg.shape == (ds.segment_samples,) and np.isfinite(seg).all()
    assert float(np.abs(seg).max()) > 0
    batches = list(ds.batches(batch_size=3, num_batches=2))
    assert all(b.shape == (3, ds.segment_samples, 1) for b in batches)
    ds_n = AudioSegmentDataset(mf, TINY, segment_duration=0.25, seed=7,
                               loader_threads=2)
    (b,) = list(ds_n.batches(batch_size=4, num_batches=1))
    assert b.shape == (4, ds_n.segment_samples, 1)
    assert np.isfinite(b).all() and (np.abs(b).max(axis=1) > 0).all()


def test_audio_segment_dataset(tmp_path):
    cfg = port_config(CLI_TINY)
    ds = AudioSegmentDataset(make_manifest(tmp_path), cfg, segment_duration=0.5,
                             seed=1)
    assert len(ds) == 3
    seg = ds.sample_segment()
    assert seg.shape[0] % cfg.hop_length == 0
    batches = list(ds.batches(2, 3))
    assert len(batches) == 3
    assert batches[0].shape == (2, seg.shape[0], 1)


def test_audio_segment_short_file_padded(tmp_path):
    ds = AudioSegmentDataset(make_manifest(tmp_path, n=1, dur=0.1),
                             port_config(CLI_TINY), segment_duration=1.0,
                             seed=1, min_audio_duration=0.05)
    seg = ds.sample_segment(0)
    assert seg.shape[0] == ds.segment_samples
    assert np.abs(seg[-100:]).max() == 0.0
