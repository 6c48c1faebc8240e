"""The port's data-prep CLI against ``ssr_speech_tpu.data.prep`` on the CPU:
one tiny corpus (the tiny codec of tests/test_codec_cli.py, wavs over two
frame buckets), ``encode`` with ``--start``/``--end`` sharding, then
``phonemize`` (with GigaSpeech tags), ``filemaker`` and ``vocab`` through
both packages must write byte-identical files. The port's phonemizer pool
spawns its workers; the JAX package's forks them, so here it runs in threads
(``multiprocessing.dummy``): a forked worker of a process that has started
JAX's threads may deadlock."""

import dataclasses
import json
import multiprocessing
import multiprocessing.dummy
import os

import jax
import numpy as np
import pytest

from ssr_speech_tpu.config import CodecConfig, RVQConfig, SEANetConfig
from ssr_speech_tpu.data import prep as jprep
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.utils import audio as jaudio
from ssr_speech_tpu.utils import checkpoint as jckpt
from ssr_speech_tpu_torch.data import prep as tprep

TINY = CodecConfig(  # tests/test_codec_cli.py
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(4, 2), lstm=1),
    rvq=RVQConfig(dimension=16, n_q=2, bins=7))
TEXTS = ["the model speaks <COMMA> slowly today <PERIOD>",
         "a short line <SIL> with a tag",
         "spans of masked tokens <MUSIC> and more <QUESTIONMARK>",
         "codec frames in buckets",
         "a transcript with #%# its own sentinel",  # skipped: aliases a tag
         "the last one <EXCLAMATIONPOINT>"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("prep")
    codec = str(d / "codec.pkl")
    jckpt.save_bundle(codec, params=jwm.init_wmencodec(jax.random.PRNGKey(0),
                                                       TINY),
                      config=dataclasses.asdict(TINY))
    rng = np.random.default_rng(3)
    rows, tsv = [], []
    hop = TINY.hop_length  # 8 samples: 2000 frames a second
    for i, frames in enumerate((30, 61, 9, 70, 33, 12, 64)):
        path = str(d / f"utt{i}.wav")
        jaudio.write_wav(path, (rng.standard_normal((1, frames * hop + 3))
                                * 0.1).astype(np.float32), 16000)
        rows.append({"path": path})
        if i < len(TEXTS):
            tsv.append(f"utt{i}\t{TEXTS[i]}")
    with open(d / "wavs.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))
    with open(d / "text.tsv", "w") as f:
        f.write("\n".join(tsv))
    return d


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def _run_both(corpus, argv_of):
    out = {}
    for name, mod, extra in (("jax", jprep, []),
                             ("torch", tprep, ["--device", "cpu"])):
        argv = argv_of(corpus / name)
        mod.main(argv + (extra if argv[0] == "encode" else []))
        out[name] = corpus / name
    return out


def test_prep_files_are_byte_identical(corpus, monkeypatch):
    monkeypatch.setattr(multiprocessing, "Pool", multiprocessing.dummy.Pool)
    for mod in (jprep, tprep):
        monkeypatch.setattr(mod, "_worker_tok", None)
    for name in ("jax", "torch"):
        (corpus / name).mkdir(exist_ok=True)
    # two shards: files 1..4 at batch 2 over buckets of 32 frames, then 4..7
    for start, end in ((1, 4), (4, -1)):
        _run_both(corpus, lambda d: [
            "encode", "--manifest", str(corpus / "wavs.jsonl"),
            "--codec_path", str(corpus / "codec.pkl"), "--save_dir",
            str(d / "codes"), "--batch_size", "2", "--bucket_frames", "32",
            "--start", str(start), "--end", str(end)])
    _run_both(corpus, lambda d: [
        "phonemize", "--manifest", str(corpus / "text.tsv"), "--save_dir",
        str(d / "phonemes"), "--num_workers", "2"])
    _run_both(corpus, lambda d: [
        "filemaker", "--manifest", str(corpus / "text.tsv"), "--phn_dir",
        str(d / "phonemes"), "--codes_dir", str(d / "codes"), "--output",
        str(d / "manifest" / "train.txt"), "--min_frames", "20"])
    _run_both(corpus, lambda d: [
        "vocab", "--phn_dir", str(d / "phonemes"), "--output",
        str(d / "vocab.txt")])

    for sub in ("codes", "phonemes", "manifest"):
        got, want = _files(corpus / "torch" / sub), _files(corpus / "jax" / sub)
        assert got == want, sub
    assert _files(corpus / "torch") == _files(corpus / "jax")  # vocab.txt

    codes = _files(corpus / "torch" / "codes")
    assert sorted(codes) == [f"utt{i}.txt" for i in range(1, 7)]
    rows = codes["utt3.txt"].decode().strip().split("\n")
    # 70 frames and 3 samples, padded to a hop multiple: 71 frames
    assert len(rows) == TINY.rvq.n_q and len(rows[0].split()) == 71
    phn = _files(corpus / "torch" / "phonemes")
    assert "utt4.txt" not in phn  # the sentinel transcript is skipped
    assert b"<SIL>" in phn["utt1.txt"] and b"<MUSIC>" in phn["utt2.txt"]
    manifest = _files(corpus / "torch" / "manifest")["train.txt"].decode()
    # both files present and >= 20 frames: utt1 (62) and utt3 (71); utt2
    # (10) and utt5 (13) are short, utt0 has no codes (the shards start at
    # 1), utt4 no phonemes
    assert manifest.split("\n") == ["0\tutt1\t62", "0\tutt3\t71"]
    assert b"<SIL>" in _files(corpus / "torch")["vocab.txt"]


def test_encode_returns_its_counts(corpus, tmp_path):
    stats = tprep.main(["encode", "--manifest", str(corpus / "wavs.jsonl"),
                        "--codec_path", str(corpus / "codec.pkl"),
                        "--save_dir", str(tmp_path), "--batch_size", "16",
                        "--bucket_frames", "128", "--device", "cpu"])
    assert stats["files"] == 7 and stats["batches"] == 1
    assert stats["audio_s"] == pytest.approx(
        sum((f * 8 + 3) for f in (30, 61, 9, 70, 33, 12, 64)) / 16000, abs=0.01)
    assert stats["seconds"] > 0 and stats["peak_gib"] is None
