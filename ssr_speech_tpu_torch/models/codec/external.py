"""External codec wrappers of the port (``ssr_speech_tpu/models/codec/
external.py``) behind the AudioTokenizer-style contract.

Capability parity with the reference's alternative-codec adapters
(``audiocraft/audiocraft/models/encodec.py``): ``DAC`` (:261-317, the
descript-audio-codec models) and ``HFEncodecCompressionModel`` (:321-392,
HuggingFace transformers EnCodec). Both wrap torch models on the caller's
device and expose the ``encode(wav) -> codes`` / ``decode(codes) -> wav``
surface of ``data.tokenizer.AudioTokenizer`` (numpy in, numpy out), so prep
and evaluation tooling can swap codecs.

Each imports its package when it is built: DAC needs
``descript-audio-codec``, the HF wrapper ``transformers`` plus a local
checkpoint or a model object. A missing package raises ``ImportError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


class HFEncodecCodec:
    """HuggingFace EnCodec behind our tokenizer contract
    (reference encodec.py:321-392)."""

    def __init__(self, model_or_id="facebook/encodec_24khz",
                 num_codebooks: Optional[int] = None, *, device):
        from transformers import EncodecModel

        if isinstance(model_or_id, str):
            model = EncodecModel.from_pretrained(model_or_id)
        else:
            model = model_or_id
        self.device = device
        self.model = model.to(device).eval()
        cfg = self.model.config
        self.possible_num_codebooks = []
        for bw in cfg.target_bandwidths:
            nc = bw * 1000 / (self.frame_rate * math.log2(self.cardinality))
            assert abs(nc - round(nc)) <= 1e-3, nc
            self.possible_num_codebooks.append(int(round(nc)))
        self.set_num_codebooks(num_codebooks
                               or max(self.possible_num_codebooks))

    # ----- properties mirroring reference encodec.py:357-392
    @property
    def channels(self) -> int:
        return self.model.config.audio_channels

    @property
    def frame_rate(self) -> float:
        hop = int(np.prod(self.model.config.upsampling_ratios))
        return self.sample_rate / hop

    @property
    def sample_rate(self) -> int:
        return self.model.config.sampling_rate

    @property
    def cardinality(self) -> int:
        return self.model.config.codebook_size

    @property
    def total_codebooks(self) -> int:
        return max(self.possible_num_codebooks)

    @property
    def num_codebooks(self) -> int:
        return self._num_codebooks

    def set_num_codebooks(self, n: int) -> None:
        if n not in self.possible_num_codebooks:
            raise ValueError(
                f"Allowed values for num codebooks: "
                f"{self.possible_num_codebooks}")
        self._num_codebooks = n

    # ----- tokenizer contract
    def encode(self, wav: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """wav [B, T, C] float32 -> (codes [B, K, F], scales or None)."""
        import torch

        x = torch.from_numpy(np.asarray(wav, np.float32).transpose(0, 2, 1))
        idx = self.possible_num_codebooks.index(self.num_codebooks)
        bandwidth = self.model.config.target_bandwidths[idx]
        with torch.no_grad():
            res = self.model.encode(x.to(self.device), None, bandwidth)
        assert len(res.audio_codes) == 1
        codes = res.audio_codes[0].cpu().numpy()
        scales = res.audio_scales[0]
        return codes, (scales.cpu().numpy() if scales is not None else None)

    def decode(self, codes: np.ndarray,
               scales: Optional[np.ndarray] = None) -> np.ndarray:
        import torch

        c = torch.from_numpy(np.asarray(codes))[None].to(self.device)
        s = ([torch.from_numpy(np.asarray(scales)).to(self.device)]
             if scales is not None else [None])
        with torch.no_grad():
            out = self.model.decode(c, s)
        return out.audio_values.cpu().numpy().transpose(0, 2, 1)


class DACCodec:
    """descript-audio-codec behind our tokenizer contract
    (reference encodec.py:261-317)."""

    def __init__(self, model_type: str = "44khz",
                 num_codebooks: Optional[int] = None, *, device):
        try:
            import dac.utils
        except ImportError as e:  # the reference's gate, :263-268
            raise ImportError(
                "Could not import dac, make sure it is installed, please "
                "run `pip install descript-audio-codec`") from e
        self.device = device
        self.model = dac.utils.load_model(model_type=model_type).to(
            device).eval()
        self.n_quantizers = num_codebooks or self.total_codebooks

    @property
    def channels(self) -> int:
        return 1

    @property
    def sample_rate(self) -> int:
        return self.model.sample_rate

    @property
    def frame_rate(self) -> float:
        return self.model.sample_rate / self.model.hop_length

    @property
    def cardinality(self) -> int:
        return self.model.codebook_size

    @property
    def total_codebooks(self) -> int:
        return self.model.n_codebooks

    @property
    def num_codebooks(self) -> int:
        return self.n_quantizers

    def set_num_codebooks(self, n: int) -> None:
        assert 1 <= n <= self.total_codebooks
        self.n_quantizers = n

    def encode(self, wav: np.ndarray) -> Tuple[np.ndarray, None]:
        import torch

        x = torch.from_numpy(np.asarray(wav, np.float32).transpose(0, 2, 1))
        with torch.no_grad():
            codes = self.model.encode(x.to(self.device), self.n_quantizers)[1]
        return codes.cpu().numpy(), None

    def decode(self, codes: np.ndarray, scales=None) -> np.ndarray:
        import torch

        assert scales is None
        with torch.no_grad():
            z_q = self.model.quantizer.from_codes(
                torch.from_numpy(codes).to(self.device))[0]
            out = self.model.decode(z_q)
        return out.cpu().numpy().transpose(0, 2, 1)
