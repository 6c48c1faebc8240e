"""The port's objects built from a configuration file: its config
dataclasses, and its parameter trees made from ``lib/weights.py``'s draws.
Only the program's set-up is here; the harness drives its entry points
from ``loops/``."""

from __future__ import annotations

from . import weights


def lm_config(cfg: dict):
    from ssr_speech_tpu_torch.config import SSRModelConfig, TokenSpace

    return SSRModelConfig(
        d_model=cfg["d_model"], nhead=cfg["nhead"], num_layers=cfg["num_layers"],
        ffn_mult=cfg["ffn_mult"], n_codebooks=cfg["n_codebooks"],
        audio_embedding_dim=cfg["d_model"],
        text_vocab_size=cfg["text_vocab_size"], tokens=TokenSpace(**cfg["tokens"]),
        head_hidden=cfg["head_hidden"], max_position=cfg["max_position"],
        activation=cfg["activation"])


def codec_config(codec: dict):
    from ssr_speech_tpu_torch.config import CodecConfig, RVQConfig, SEANetConfig

    seanet = dict(codec["seanet"])
    seanet["ratios"] = tuple(seanet["ratios"])
    return CodecConfig(sample_rate=codec["sample_rate"],
                       frame_rate=codec["frame_rate"],
                       channels=codec["seanet"]["channels"],
                       seanet=SEANetConfig(**seanet), rvq=RVQConfig(**codec["rvq"]))


def decode_config(cfg: dict, **overrides):
    from ssr_speech_tpu_torch.config import DecodeConfig

    fields = dict(cfg["decode"])
    fields.update(overrides)
    if "silence_tokens" in fields:
        fields["silence_tokens"] = tuple(fields["silence_tokens"])
    return DecodeConfig(**fields)


def lm(cfg: dict, seed: int, device):
    """The LM as the serving path holds it: decoder matrices in the
    device's compute dtype, the rest fp32."""
    from ssr_speech_tpu_torch.device import compute_dtype
    from ssr_speech_tpu_torch.models.from_jax import lm_from_jax

    dtype = compute_dtype(device)
    return lm_from_jax(weights.lm_weights(cfg, seed, device, dtype),
                       lm_config(cfg), device=device, dtype=dtype)


def codec(codec_cfg: dict, seed: int, device):
    """The codec's parameter tree (fp32) and its config."""
    from ssr_speech_tpu_torch.models.from_jax import codec_from_jax

    ccfg = codec_config(codec_cfg)
    return codec_from_jax(weights.codec_weights(codec_cfg, seed, device), ccfg,
                          device=device), ccfg
