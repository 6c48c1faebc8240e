"""Quality-evaluation harness of the port (host copy of
``ssr_speech_tpu/utils/quality.py``): WER, speaker similarity, SI-SNR,
ViSQOL.

The reference evaluates generated speech with external tooling (whisper WER
in the paper protocol; SI-SNR/ViSQOL in the codec eval stage,
``solvers/wmcompression.py:196-224``). ``evaluate_pairs`` computes every
metric the environment supports:

  - **WER/CER** — Levenshtein over words/chars (the edit aligner of
    ``inference.edit``), with the text normalization of the inference
    frontend (lowercase, digits->words, punctuation strip),
  - **ASR transcription** — any callable ``(wav, sr) -> text``, such as
    ``utils.asr.WhisperAligner``,
  - **speaker similarity** — :class:`SpeakerEmbedder`, a speaker-embedding
    model of ``transformers`` (imported when it is built) on the caller's
    device, with cosine similarity between reference and generated speech,
  - **SI-SNR** — ``utils.metrics.si_snr``,
  - **ViSQOL** — the external-binary hook ``utils.visqol.ViSQOL``.

Metrics whose dependency is absent are reported under ``skipped``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..inference.edit import align_ops
from .text_norm import replace_numbers_with_words


def normalize_text(text: str, language: str = "en") -> str:
    """The inference frontend's normalization, applied to both sides of the
    WER computation: digits->words, lowercase, punctuation stripped."""
    text = replace_numbers_with_words(text)
    if language == "en":
        text = text.lower()
    text = re.sub(r"[^\w\s]", " ", text, flags=re.UNICODE)
    return re.sub(r"\s+", " ", text).strip()


def _error_rate(ref_units: Sequence[str], hyp_units: Sequence[str]) -> float:
    if not ref_units:
        return 0.0 if not hyp_units else 1.0
    ops = align_ops(list(ref_units), list(hyp_units))
    errors = sum(1 for _, _, op in ops if op != "equal")
    return errors / len(ref_units)


def wer(ref: str, hyp: str, language: str = "en") -> float:
    """Word error rate (char error rate for zh, matching the char-level diff
    the zh pipeline uses, edit_utils_zh.py:106)."""
    ref_n = normalize_text(ref, language)
    hyp_n = normalize_text(hyp, language)
    if language == "zh":
        return _error_rate(list(ref_n.replace(" ", "")),
                           list(hyp_n.replace(" ", "")))
    return _error_rate(ref_n.split(), hyp_n.split())


def cer(ref: str, hyp: str, language: str = "en") -> float:
    ref_n = normalize_text(ref, language).replace(" ", "")
    hyp_n = normalize_text(hyp, language).replace(" ", "")
    return _error_rate(list(ref_n), list(hyp_n))


class SpeakerEmbedder:
    """Speaker-embedding model (mean-pooled hidden states of a local
    wav2vec2/WavLM checkpoint) on ``device``, the caller's, for cosine
    speaker similarity."""

    def __init__(self, model_id: str, device):
        from transformers import AutoFeatureExtractor, AutoModel

        self.extractor = AutoFeatureExtractor.from_pretrained(model_id)
        self.model = AutoModel.from_pretrained(model_id).to(device).eval()
        self.device = device

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        import torch

        mono = np.asarray(wav, np.float32).reshape(-1)
        target = getattr(self.extractor, "sampling_rate", 16000)
        if sr != target:
            from .visqol import _resample

            mono = _resample(mono, sr, target)
        inputs = self.extractor(mono, sampling_rate=target,
                                return_tensors="pt")
        with torch.no_grad():
            out = self.model(inputs.input_values.to(self.device))
        h = out.last_hidden_state.mean(dim=1)[0].cpu().numpy()
        return h / (np.linalg.norm(h) + 1e-12)


def speaker_similarity(embedder: SpeakerEmbedder, ref_wav: np.ndarray,
                       gen_wav: np.ndarray, sr: int) -> float:
    a = embedder.embed(ref_wav, sr)
    b = embedder.embed(gen_wav, sr)
    return float(np.dot(a, b))


def evaluate_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],  # (ref_wav, gen_wav) mono
    sr: int,
    transcripts: Optional[Sequence[Tuple[str, str]]] = None,  # (ref, hyp)
    language: str = "en",
    ref_texts: Optional[Sequence[str]] = None,
    asr=None,  # callable (wav [T] float32, sr) -> hypothesis text
    speaker_model: Optional[SpeakerEmbedder] = None,
    visqol=None,  # utils.visqol.ViSQOL instance (optional)
    sisnr_aligned: bool = True,
) -> Dict[str, object]:
    """Compute every available metric over (reference, generated) pairs.

    Returns a report dict; metrics that need unavailable dependencies are
    reported under ``skipped``.
    """
    import torch

    from .metrics import si_snr

    report: Dict[str, object] = {"n": len(pairs), "skipped": []}

    if sisnr_aligned:
        vals = []
        for ref, gen in pairs:
            ref = np.asarray(ref, np.float32).reshape(-1)
            gen = np.asarray(gen, np.float32).reshape(-1)
            n = min(ref.shape[0], gen.shape[0])
            if n == 0:
                continue
            vals.append(float(si_snr(torch.from_numpy(gen[None, :n]),
                                     torch.from_numpy(ref[None, :n]))[0]))
        if vals:
            report["si_snr_db"] = float(np.mean(vals))

    if transcripts is None and ref_texts is not None and asr is not None:
        transcripts = [(ref_text, asr(np.asarray(gen, np.float32).reshape(-1),
                                      sr))
                       for ref_text, (_, gen) in zip(ref_texts, pairs)]
    if transcripts is not None:
        wers = [wer(r, h, language) for r, h in transcripts]
        cers = [cer(r, h, language) for r, h in transcripts]
        report["wer"] = float(np.mean(wers))
        report["cer"] = float(np.mean(cers))
    else:
        report["skipped"].append("wer (no transcripts/asr)")

    if speaker_model is not None:
        sims = [speaker_similarity(speaker_model, r, g, sr) for r, g in pairs]
        report["speaker_sim"] = float(np.mean(sims))
    else:
        report["skipped"].append("speaker_sim (no --speaker_model)")

    if visqol is not None:
        report["visqol_moslqo"] = visqol([r for r, _ in pairs],
                                         [g for _, g in pairs], sr=sr)
    else:
        report["skipped"].append("visqol (no --visqol_bin)")
    return report
