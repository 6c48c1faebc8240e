"""The port's quality harness, external codecs and step timer against
``ssr_speech_tpu``'s on the CPU: the cases of tests/test_quality.py up to its
tool test (each metric equal to JAX's), of tests/test_external_codecs.py (a
random-weight ``EncodecModel`` from a config, no download; skips without
``transformers``) and the ``StepTimer`` case of
tests/test_watchdog_profiler.py."""

import time

import numpy as np
import pytest
import torch

from ssr_speech_tpu.utils import quality as jquality
from ssr_speech_tpu_torch.models.codec import external as texternal
from ssr_speech_tpu_torch.utils import profiler as tprofiler
from ssr_speech_tpu_torch.utils import quality as tquality

CPU = torch.device("cpu")


@pytest.mark.parametrize("fn,ref,hyp,lang,want", [
    ("wer", "hello world", "hello world", "en", 0.0),
    ("wer", "a b c d", "a x c", "en", 0.5),  # 1 sub + 1 del over 4 words
    ("wer", "a b", "a x b", "en", 0.5),  # an insertion
    ("wer", "I have 42 apples!", "i have forty-two apples", "en", 0.0),
    ("wer", "今天天气", "今天天气", "zh", 0.0),
    ("wer", "今天天气", "今天天好", "zh", 0.25),
    ("cer", "abcd", "abxd", "en", 0.25),
])
def test_error_rates_equal_jax(fn, ref, hyp, lang, want):
    got = getattr(tquality, fn)(ref, hyp, language=lang)
    assert got == getattr(jquality, fn)(ref, hyp, language=lang)
    assert got == pytest.approx(want)


def test_evaluate_pairs_reports_sisnr_and_skips():
    rng = np.random.default_rng(0)
    ref = rng.normal(size=16000).astype(np.float32) * 0.1
    gen = ref + rng.normal(size=16000).astype(np.float32) * 0.001
    report = tquality.evaluate_pairs([(ref, gen)], sr=16000)
    want = jquality.evaluate_pairs([(ref, gen)], sr=16000)
    assert report["n"] == 1 and report["skipped"] == want["skipped"]
    assert report["si_snr_db"] > 20
    assert report["si_snr_db"] == pytest.approx(want["si_snr_db"], abs=1e-4)
    assert any("wer" in s for s in report["skipped"])
    assert any("speaker_sim" in s for s in report["skipped"])
    assert any("visqol" in s for s in report["skipped"])


def test_evaluate_pairs_with_transcripts_and_asr_callable():
    ref = np.zeros(1600, np.float32)
    gen = np.zeros(1600, np.float32)
    for mod in (tquality, jquality):
        report = mod.evaluate_pairs(
            [(ref, gen)], sr=16000,
            transcripts=[("the cat sat", "the cat sat")])
        assert report["wer"] == 0.0 and report["cer"] == 0.0
        report = mod.evaluate_pairs(
            [(ref, gen)], sr=16000, ref_texts=["the cat sat"],
            asr=lambda wav, sr: "the dog sat")
        assert report["wer"] == pytest.approx(1 / 3)


def test_normalize_text_equals_jax():
    for text in ("I have 42 apples!", "Hello,   World.", "它 在 2 点"):
        for lang in ("en", "zh"):
            assert (tquality.normalize_text(text, lang)
                    == jquality.normalize_text(text, lang))


def test_speaker_embedder_imports_transformers_when_built(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_transformers(name, *a, **k):
        if name.split(".")[0] == "transformers":
            raise ModuleNotFoundError("No module named 'transformers'",
                                      name="transformers")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="transformers"):
        tquality.SpeakerEmbedder("m", CPU)
    with pytest.raises(ImportError, match="transformers"):
        texternal.HFEncodecCodec("m", device=CPU)


# --------------------------------------------- tests/test_external_codecs.py

@pytest.fixture(scope="module")
def tiny_hf_encodec():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.EncodecConfig(
        target_bandwidths=[0.2, 0.4], sampling_rate=16000, audio_channels=1,
        num_filters=4, num_residual_layers=1, upsampling_ratios=[8, 5, 4, 2],
        codebook_size=16, codebook_dim=8, hidden_size=8, num_lstm_layers=1)
    torch.manual_seed(0)
    return transformers.EncodecModel(cfg).eval()


def test_hf_encodec_wrapper_roundtrip(tiny_hf_encodec):
    from ssr_speech_tpu.models.codec.external import HFEncodecCodec

    codec = texternal.HFEncodecCodec(tiny_hf_encodec, device=CPU)
    assert codec.sample_rate == 16000 and codec.cardinality == 16
    hop = 8 * 5 * 4 * 2
    assert codec.frame_rate == pytest.approx(16000 / hop)
    assert codec.possible_num_codebooks == sorted(codec.possible_num_codebooks)
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(1, hop * 10, 1)) * 0.1).astype(np.float32)
    codes, scales = codec.encode(wav)
    assert codes.shape == (1, codec.num_codebooks, 10)
    assert codes.min() >= 0 and codes.max() < codec.cardinality
    out = codec.decode(codes, scales)
    assert out.shape[0] == 1 and out.shape[2] == 1 and np.isfinite(out).all()
    # the JAX package's wrapper of the same model gives the same numbers
    ref = HFEncodecCodec(tiny_hf_encodec)
    want_codes, want_scales = ref.encode(wav)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(out, ref.decode(want_codes, want_scales))


def test_hf_encodec_num_codebooks_switch(tiny_hf_encodec):
    codec = texternal.HFEncodecCodec(tiny_hf_encodec, device=CPU)
    low = min(codec.possible_num_codebooks)
    codec.set_num_codebooks(low)
    rng = np.random.default_rng(1)
    wav = (rng.normal(size=(1, 320 * 5, 1)) * 0.1).astype(np.float32)
    assert codec.encode(wav)[0].shape[1] == low
    with pytest.raises(ValueError):
        codec.set_num_codebooks(9999)


def test_dac_gated_like_reference():
    try:
        import dac  # noqa: F401
        pytest.skip("dac installed; gating not exercisable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="descript-audio-codec"):
        texternal.DACCodec(device=CPU)


# ---------------------------------------- tests/test_watchdog_profiler.py:78

def test_step_timer():
    t = tprofiler.StepTimer()
    time.sleep(0.02)
    t.data_done()
    time.sleep(0.02)
    t.step_done()
    assert t.data_time > 0 and t.train_time > 0
