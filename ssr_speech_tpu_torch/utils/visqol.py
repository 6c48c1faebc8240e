"""ViSQOL external-binary hook, optional like the reference's (the port's
own copy of ``ssr_speech_tpu/utils/visqol.py``).

Capability parity with ``audiocraft/audiocraft/metrics/visqol.py:22-180``:
a pre-built google/visqol bazel binary is driven in batch mode — wav pairs
and an ``input.csv`` are written to a temp dir, the binary is invoked with
``--batch_input_csv/--results_csv`` (plus ``--use_speech_mode`` at 16 kHz and
``--similarity_to_quality_model``), and the mean MOS-LQO is read back from
the results CSV. Audio mode expects 48 kHz input and speech mode 16 kHz;
signals at other rates are resampled host-side (polyphase, no torch dep) and
optionally padded with 0.5 s of silence like the reference.

This is host tooling: nothing here touches the device. In-process codec eval
uses :func:`ssr_speech_tpu_torch.utils.metrics.si_snr`.
"""

from __future__ import annotations

import csv
import logging
import shutil
import subprocess
import tempfile
import wave
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

logger = logging.getLogger(__name__)

SAMPLE_RATES_MODES = {"audio": 48_000, "speech": 16_000}


def _resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return x
    try:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(sr, target_sr)
        return resample_poly(x, target_sr // g, sr // g)
    except ImportError:  # linear fallback, adequate for a host-side metric
        n_out = int(round(x.shape[-1] * target_sr / sr))
        t_out = np.linspace(0.0, x.shape[-1] - 1, n_out)
        return np.interp(t_out, np.arange(x.shape[-1]), x)


def _write_pcm16(path: Path, x: np.ndarray, sr: int) -> None:
    x = np.clip(np.asarray(x, np.float32).reshape(-1), -0.99, 0.99)
    pcm = (x * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


class ViSQOL:
    """Run a pre-installed ViSQOL binary over (reference, degraded) pairs.

    Args:
        bin: path to the visqol install dir (containing ``bazel-bin/visqol``
            and ``model/``), exactly as the reference expects, OR a direct
            path to the executable (``model/`` then resolved next to it).
        mode: "audio" (48 kHz, max ~4.75) or "speech" (16 kHz, max 5.0).
        model: similarity-to-quality model filename under ``model/``.
    """

    def __init__(self, bin: Union[str, Path], mode: str = "speech",
                 model: Optional[str] = None):
        if mode not in SAMPLE_RATES_MODES:
            raise ValueError(f"mode must be one of {list(SAMPLE_RATES_MODES)}")
        bin = Path(bin)
        if bin.is_dir():
            self.executable = bin / "bazel-bin" / "visqol"
            self.install_dir = bin
        else:
            self.executable = bin
            self.install_dir = bin.parent
        if not self.executable.exists():
            raise FileNotFoundError(f"visqol binary not found: {self.executable}")
        self.mode = mode
        self.target_sr = SAMPLE_RATES_MODES[mode]
        if model is None:
            model = ("libsvm_nu_svr_model.txt" if mode == "audio"
                     else "lattice_tcditugenmeetpackhref_ls2_nl60_lr12_bs2048_learn.005_ep2400_train1_7_raw.tflite")
        self.model_path = self.install_dir / "model" / model

    def __call__(self, ref_sigs: Sequence[np.ndarray],
                 deg_sigs: Sequence[np.ndarray], sr: int,
                 pad_with_silence: bool = False) -> float:
        """Mean MOS-LQO over the batch of (reference, degraded) pairs."""
        if len(ref_sigs) != len(deg_sigs):
            raise ValueError(f"{len(ref_sigs)} refs vs {len(deg_sigs)} degraded")
        tmp = Path(tempfile.mkdtemp(prefix="visqol_"))
        try:
            input_csv = tmp / "input.csv"
            results_csv = tmp / "results.csv"
            pad = np.zeros(self.target_sr // 2, np.float32)
            with open(input_csv, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["reference", "degraded"])
                for i, (r, d) in enumerate(zip(ref_sigs, deg_sigs)):
                    r = _resample(np.asarray(r, np.float32).reshape(-1), sr,
                                  self.target_sr)
                    d = _resample(np.asarray(d, np.float32).reshape(-1), sr,
                                  self.target_sr)
                    if pad_with_silence:
                        r = np.concatenate([pad, r, pad])
                        d = np.concatenate([pad, d, pad])
                    rp, dp = tmp / f"ref_{i}.wav", tmp / f"deg_{i}.wav"
                    _write_pcm16(rp, r, self.target_sr)
                    _write_pcm16(dp, d, self.target_sr)
                    w.writerow([str(rp), str(dp)])
            cmd = [str(self.executable),
                   "--batch_input_csv", str(input_csv),
                   "--results_csv", str(results_csv)]
            if self.mode == "speech":
                cmd += ["--use_speech_mode"]
            if self.model_path.exists():
                cmd += ["--similarity_to_quality_model", str(self.model_path)]
            result = subprocess.run(cmd, capture_output=True, text=True)
            if result.returncode:
                logger.error("visqol failed:\n%s\n%s", result.stdout,
                             result.stderr)
                raise RuntimeError("visqol binary returned non-zero")
            with open(results_csv) as f:
                scores = [float(row["moslqo"]) for row in csv.DictReader(f)]
            return sum(scores) / len(scores) if scores else 0.0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
