"""Host-side audio I/O: pure-numpy WAV read/write + resampling (the port's own
copy of ``ssr_speech_tpu/utils/audio.py``; nothing in it is JAX-specific).

Replaces the reference's torchaudio/soundfile usage
(``data/tokenizer.py:141-159`` tokenize_audio,
``audiocraft/audiocraft/data/audio.py`` audio_read/audio_write) without
external audio libraries: RIFF/WAVE PCM 16/24/32-bit and IEEE float, mono
downmix, resample via ``scipy.signal.resample_poly``.
"""

from __future__ import annotations

import math
import struct
import threading
from typing import Optional, Tuple

import numpy as np

# -- zip-member paths ---------------------------------------------------
# The reference stores corpus files inside zip archives addressed as
# "<zip_path>:<member_path>" (audiocraft/audiocraft/data/zip.py:22 PathInZip,
# consumed by audio_dataset.py) with an LRU pool of open zipfile handles
# (zip.py:48-63). Same convention here; `read_wav` accepts either form.

_ZIP_SEP = ":"
_ZIP_POOL_SIZE = 32
_zip_pool: dict = {}
_zip_lock = threading.Lock()


def split_zip_path(path: str) -> Optional[Tuple[str, str]]:
    """"/a/foo.zip:inside/x.wav" -> ("/a/foo.zip", "inside/x.wav"); None for
    plain filesystem paths (no separator, or the prefix isn't a .zip)."""
    if _ZIP_SEP not in path:
        return None
    zip_path, _, member = path.partition(_ZIP_SEP)
    if not zip_path.lower().endswith(".zip"):
        return None
    return zip_path, member


def set_zip_cache_size(max_size: int) -> None:
    """Cap the open-handle pool (reference zip.py:55 set_zip_cache_size)."""
    global _ZIP_POOL_SIZE
    with _zip_lock:
        _ZIP_POOL_SIZE = max_size
        while len(_zip_pool) > _ZIP_POOL_SIZE:
            _zip_pool.pop(next(iter(_zip_pool))).close()


def _read_bytes(path: str) -> bytes:
    """File bytes; zip members read through the cached handle pool."""
    zp = split_zip_path(path)
    if zp is None:
        with open(path, "rb") as f:
            return f.read()
    zip_path, member = zp
    import zipfile

    with _zip_lock:
        zf = _zip_pool.pop(zip_path, None)
        if zf is None:
            zf = zipfile.ZipFile(zip_path, "r")
        _zip_pool[zip_path] = zf  # reinsert = move to MRU end
        while len(_zip_pool) > _ZIP_POOL_SIZE:
            _zip_pool.pop(next(iter(_zip_pool))).close()
        return zf.read(member)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples [C, T] float32 in [-1, 1], sample_rate). `path` may
    be a plain file or a zip member ("archive.zip:inside.wav")."""
    data = _read_bytes(path)
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", f"not a WAV: {path}"
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    assert fmt is not None and raw is not None, f"malformed WAV: {path}"
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported WAV bits={bits} format={audio_format}")
    x = x.reshape(-1, channels).T
    return np.ascontiguousarray(x), rate


def write_wav(path: str, wav: np.ndarray, rate: int) -> None:
    """wav: [C, T] or [T] float in [-1, 1]; writes 16-bit PCM."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None]
    c, t = wav.shape
    pcm = np.clip(wav.T, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, c, rate, rate * c * 2, c * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)


def convert_audio(wav: np.ndarray, sr: int, target_sr: int,
                  target_channels: int = 1) -> np.ndarray:
    """Downmix + resample (reference data/tokenizer.py:87-97 semantics)."""
    assert wav.ndim == 2
    if target_channels == 1:
        wav = wav.mean(axis=0, keepdims=True)
    elif wav.shape[0] == 1:
        wav = np.repeat(wav, target_channels, axis=0)
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = math.gcd(sr, target_sr)
        wav = resample_poly(wav, target_sr // g, sr // g, axis=-1).astype(np.float32)
    return wav.astype(np.float32)


def load_for_codec(path: str, sample_rate: int, hop: int = 320) -> np.ndarray:
    """Load + pad to a hop multiple, as the reference does before encoding
    (``data/tokenizer.py:141-159``). Returns [1, T, 1] float32."""
    wav, sr = read_wav(path)
    pad = (hop - (wav.shape[-1] % hop)) % hop
    if pad:
        wav = np.pad(wav, ((0, 0), (0, pad)))
    wav = convert_audio(wav, sr, sample_rate, 1)
    return wav.T[None]  # [1, T, 1]
