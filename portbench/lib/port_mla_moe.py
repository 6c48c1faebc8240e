"""The port's objects for a configuration with Moonlight-16B-A3B's block:
its ``MLAMoEConfig`` (SSR's fields as ``lib/port.py`` reads them, the
block's from the configuration's published keys) and its parameter tree
made from ``lib/weights_mla_moe.py``'s draws."""

from __future__ import annotations

from . import weights_mla_moe


def lm_config(cfg: dict):
    from ssr_speech_tpu_torch.config import TokenSpace
    from ssr_speech_tpu_torch.models.mla_moe import MLAMoEConfig

    s = weights_mla_moe.sizes(cfg)
    return MLAMoEConfig(
        d_model=s["d"], nhead=s["H"], num_layers=s["L"],
        n_codebooks=cfg["n_codebooks"], audio_embedding_dim=s["d"],
        text_vocab_size=cfg["text_vocab_size"], tokens=TokenSpace(**cfg["tokens"]),
        head_hidden=cfg["head_hidden"], max_position=cfg["max_position"],
        kv_lora_rank=s["r"], qk_nope_head_dim=s["nope"],
        qk_rope_head_dim=s["rope"], v_head_dim=s["v"], rope_theta=s["theta"],
        intermediate_size=s["I"], moe_intermediate_size=s["F"],
        n_routed_experts=s["E"], num_experts_per_tok=s["k"],
        n_shared_experts=s["shared"], first_k_dense_replace=s["dense"],
        routed_scaling_factor=s["scale"], rms_norm_eps=s["eps"])


def lm(cfg: dict, seed: int, device):
    """The LM as the serving path holds it: the block's matrices in the
    device's compute dtype, the rest fp32."""
    from ssr_speech_tpu_torch.device import compute_dtype
    from ssr_speech_tpu_torch.models.mla_moe import lm_from_tree

    dtype = compute_dtype(device)
    return lm_from_tree(weights_mla_moe.lm_weights(cfg, seed, device, dtype),
                        lm_config(cfg), device=device, dtype=dtype)
