"""Typed configuration tree of the PyTorch port (its own copy of
``ssr_speech_tpu/config.py``: same dataclasses, field names, defaults,
presets and JSON helpers, so a config dict stored in a bundle by either
package loads in the other).

Fields that only XLA or the TPU read (``TrainConfig.rng_impl``, the mesh and
compile-cache options) stay as inert fields: the port ignores them, and a
bundle's config dict round-trips unchanged. ``SSRModelConfig.remat`` is read
by the port's trainer (``models.transformer.checkpoint_layer``).

This replaces the reference's two disjoint config systems — the flat argparse
namespace of the LM trainer (reference ``config.py:4-92``) and audiocraft's
hydra tree (``audiocraft/config/**``) — with one dataclass hierarchy.

Token-space contract (reference ``models/ssr.py:121-130``):
  per-codebook cardinality = audio_vocab_size + n_special + max_n_spans
  empty = audio_vocab_size, eog = +1, pad = +2, eos = +3, sos = +4,
  mts = +5 .. +5+max_n_spans-1.
  text vocab = text_vocab_size + 1, pad == text_vocab_size; the last *real*
  text id (text_vocab_size - 1) is reserved for CFG-unconditional when
  ``cfg_pretrained`` (reference ``models/ssr.py:576``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class TokenSpace:
    """Special-token layout for the codec-token LM."""

    audio_vocab_size: int = 2048
    n_special: int = 5  # empty, eog, pad, eos, sos
    max_n_spans: int = 3

    @property
    def empty(self) -> int:
        return self.audio_vocab_size

    @property
    def eog(self) -> int:
        return self.audio_vocab_size + 1

    @property
    def pad(self) -> int:
        return self.audio_vocab_size + 2

    @property
    def eos(self) -> int:
        return self.audio_vocab_size + 3

    @property
    def sos(self) -> int:
        return self.audio_vocab_size + 4

    @property
    def mts(self) -> int:
        """First mask-sentinel token id; span i uses mts + i."""
        return self.audio_vocab_size + 5

    @property
    def cardinality(self) -> int:
        """Per-codebook vocab size including specials and mask sentinels."""
        return self.audio_vocab_size + self.n_special + self.max_n_spans

    def validate(self) -> None:
        assert self.n_special == 5, "layout assumes 5 special tokens"
        assert self.max_n_spans >= 1


@dataclass(frozen=True)
class SSRModelConfig:
    """SSR-Speech LM architecture (reference ``models/ssr.py:104-189``,
    hyperparameters of the 830M run per ``z_scripts/e830M.sh:38-49``)."""

    d_model: int = 2048
    nhead: int = 16
    num_layers: int = 16
    ffn_mult: int = 4
    n_codebooks: int = 4
    audio_embedding_dim: int = 2048  # must equal d_model (embeddings summed)
    text_vocab_size: int = 100  # number of *real* phoneme ids
    tokens: TokenSpace = field(default_factory=TokenSpace)
    # dropout (train-time only)
    text_embedding_dropout: float = 0.1
    audio_embedding_dropout: float = 0.0
    text_positional_embedding_dropout: float = 0.1
    audio_positional_embedding_dropout: float = 0.1
    trm_dropout: float = 0.1
    # head hidden width: reference uses audio_vocab_size // 2 (models/ssr.py:177)
    head_hidden: Optional[int] = None
    max_position: int = 4000  # positional table length (modules/embedding.py:67)
    # FFN activation: the reference transformer also accepts the icefall
    # DoubleSwish variants (models/modules/transformer.py:12-13); the shipped
    # SSR config uses relu (models/ssr.py:160-168)
    activation: str = "relu"  # relu | double_swish | balanced_double_swish
    # training-forward attention: "einsum" materializes [B,H,S,S] scores
    # (bit-locked by the parity goldens); "flash" runs the fused Pallas
    # online-softmax kernel (O(S) memory, lets the trainer relax per-layer
    # remat — ops/flash_attention.py). Decode paths are unaffected.
    attn_impl: str = "einsum"  # einsum | flash | splash
    # training-forward remat policy: "full" recomputes every layer in the
    # backward (lowest memory — required with einsum attention at the 830M
    # geometry, where saving dots would keep [B,H,S,S] scores); "dots" saves
    # matmul outputs and recomputes only elementwise (viable once attn_impl
    # is flash); "mixed" leaves every other unrolled layer un-rematted
    # (between "dots" and "none" in memory); "none" saves everything
    remat: str = "full"  # full | dots | mixed | none
    # training CE head: "unfused" materializes the [B,S,K,card] logits
    # (bit-locked numerics); "fused" runs the blocked Pallas CE kernel
    # (second head matmul + log-softmax + top-10 fused in VMEM —
    # ops/fused_ce.py). Decode paths are unaffected.
    ce_impl: str = "unfused"  # unfused | fused

    @property
    def text_pad_token(self) -> int:
        return self.text_vocab_size

    @property
    def n_text_tokens(self) -> int:
        return self.text_vocab_size + 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.nhead

    @property
    def ffn_dim(self) -> int:
        return self.d_model * self.ffn_mult

    @property
    def head_hidden_dim(self) -> int:
        return self.head_hidden if self.head_hidden is not None else self.tokens.audio_vocab_size // 2

    @property
    def cardinality(self) -> int:
        return self.tokens.cardinality

    def validate(self) -> None:
        self.tokens.validate()
        assert self.d_model % self.nhead == 0
        assert self.audio_embedding_dim == self.d_model, (
            "audio codebook embeddings are summed straight into the residual "
            "stream (reference models/ssr.py:191-198)"
        )


@dataclass(frozen=True)
class MaskingConfig:
    """Training-time span-masking policy (reference ``data/gigaspeech.py:66-103``
    and the flags in ``config.py:54-70``)."""

    mask_sample_dist: str = "uniform"  # or "poisson<float>"
    max_n_spans: int = 3
    mask_len_min: int = 1
    mask_len_max: int = 600
    min_gap: int = 5
    max_mask_portion: float = 0.7
    tts_enhanced: int = 1  # force final span to end of utt with p=0.5
    cfg_enhanced: bool = False  # 10% text-dropout to reserved CFG token
    shuffle_mask_embedding: bool = False
    predict_mask_token: bool = True
    predict_all: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset/manifest layout (reference ``config.py:37-52``,
    ``data/gigaspeech.py:11-64``)."""

    dataset_dir: str = ""
    manifest_name: str = "manifest"
    phn_folder_name: str = "phonemes"
    encodec_folder_name: str = "encodec_16khz_4codebooks"
    exp_dir: str = ""
    encodec_sr: int = 50  # codec frames per second (hop 320 @ 16 kHz)
    audio_min_length: float = 2.0
    audio_max_length: float = 20.0
    text_min_length: int = 10
    text_max_length: int = 400
    drop_long: bool = True
    special_first: bool = False
    n_workers: int = 4
    # static-shape bucketing for XLA (replaces DistributedDynamicBatchSampler,
    # reference steps/trainer_utils.py:175, with fixed pad-length buckets)
    num_buckets: int = 6
    max_num_tokens: int = 20000  # token budget per device per step
    bucket_warp: str = "quantile"  # or "lognormal": the reference's fixed
    # lognorm(1) bucket edges (trainer_utils.py:408-437)


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer/schedule (reference ``steps/optim.py:129,759`` and
    ``z_scripts/e830M.sh:20-36``)."""

    optimizer_name: str = "scaledadam"  # or "adamw"
    lr: float = 0.05
    weight_decay: float = 1e-2
    warmup_fraction: float = 0.01
    gradient_clip_val: float = 1.0
    # ScaledAdam specifics
    betas: Tuple[float, float] = (0.9, 0.98)
    clipping_scale: Optional[float] = 2.0
    scalar_lr_scale: float = 0.1
    eps: float = 1e-8
    param_min_rms: float = 1e-5
    param_max_rms: float = 3.0
    scalar_max: float = 10.0
    size_update_period: int = 4
    clipping_update_period: int = 600
    # storage dtype for the param-sized ScaledAdam buffers (delta momentum
    # + exp_avg_sq); "bfloat16" halves optimizer HBM (training/optim.py)
    moments_dtype: str = "float32"
    # Eden schedule
    reduce_lr_start_step: int = 3000  # lr_batches
    reduce_lr_start_epoch: int = 4  # lr_epochs
    pseudo_epoch_size: int = 3000
    warmup_batches: float = 500.0


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 1
    precision: str = "bfloat16"  # compute dtype; fp32 master params
    batch_size: int = 8
    gradient_accumulation_steps: int = 1
    num_epochs: int = 10
    num_steps: Optional[int] = None
    val_every_n_steps: int = 400
    print_every_n_steps: int = 400
    tb_write_every_n_steps: int = 100
    early_stop_step: int = 3200
    early_stop_threshold: float = -1.0
    codebook_weight: Optional[Tuple[float, ...]] = None  # e.g. (5, 1, 0.5, 0.1)
    # >0 arms the stall watchdog (reference DeadlockDetect,
    # audiocraft/utils/deadlock.py): no loop beacon for this many seconds
    # dumps all thread stacks and kills the process for the scheduler
    deadlock_timeout: float = 0.0
    # >0 traces the first N steps to exp_dir/profile (reference profiler
    # wrapper, solvers/base.py:536-549, on jax.profiler)
    profile_steps: int = 0
    # >0 also keeps the last N numbered step checkpoints under
    # exp_dir/checkpoints (reference checkpoint.py:104-122 history flushing)
    keep_step_checkpoints: int = 0
    dp_axis: str = "dp"
    num_devices: Optional[int] = None  # default: all visible
    # PRNG implementation for the per-step dropout keys ("threefry2x32" or
    # "rbg"). rbg maps to the TPU's hardware RngBitGenerator and removes
    # the threefry mask-generation tax from the train step (660 -> 605 ms,
    # 37.9 -> 41.3% MFU at 830M/B=8 — BENCHMARKS.md); threefry remains the
    # default because its counter-based streams are bit-identical across
    # shardings/layouts (rbg draws are layout-dependent, fine for dropout).
    # Param INIT always uses threefry so initial weights never depend on
    # this knob. train_lm defaults it to rbg on TPU backends.
    rng_impl: str = "threefry2x32"
    optim: OptimConfig = field(default_factory=OptimConfig)
    masking: MaskingConfig = field(default_factory=MaskingConfig)
    data: DataConfig = field(default_factory=DataConfig)


@dataclass(frozen=True)
class SEANetConfig:
    """SEANet autoencoder hyperparameters (reference
    ``audiocraft/config/model/encodec/default.yaml`` overridden by
    ``encodec_large_nq4_s320.yaml``: n_filters 64, rvq bins 2048, n_q 4)."""

    channels: int = 1
    dimension: int = 128
    n_filters: int = 64
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 5, 4, 2)  # decoder order; encoder reverses
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    compress: int = 2
    lstm: int = 2
    causal: bool = False
    pad_mode: str = "constant"
    norm: str = "weight_norm"
    true_skip: bool = True
    disable_norm_outer_blocks: int = 0
    trim_right_ratio: float = 1.0
    final_activation: Optional[str] = None

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out


@dataclass(frozen=True)
class RVQConfig:
    """Residual vector quantizer (reference
    ``audiocraft/audiocraft/quantization/vq.py:16``)."""

    dimension: int = 128
    n_q: int = 4
    bins: int = 2048
    q_dropout: bool = False
    decay: float = 0.99
    threshold_ema_dead_code: int = 2


@dataclass(frozen=True)
class CodecConfig:
    """Watermarked EnCodec (reference
    ``audiocraft/audiocraft/models/wmencodec.py:123``)."""

    sample_rate: int = 16000
    frame_rate: int = 50
    channels: int = 1
    renormalize: bool = False
    causal: bool = False
    seanet: SEANetConfig = field(default_factory=SEANetConfig)
    rvq: RVQConfig = field(default_factory=RVQConfig)

    @property
    def hop_length(self) -> int:
        return self.seanet.hop_length


@dataclass(frozen=True)
class DecodeConfig:
    """AR decode controls (reference ``models/ssr.py:504-552`` kwargs and
    ``inference_v2.py:158-188`` CLI flags)."""

    top_k: int = 0  # >0 enables top-k; note reference treats <=0 as disabled
    top_p: float = 0.8
    temperature: float = 1.0
    stop_repetition: int = 2
    # accepted for reference-CLI compatibility only: the compiled decode
    # always uses the preallocated KV cache (reference kvcache=0 re-ran the
    # full prefix per token, a slow path with identical outputs)
    kvcache: bool = True
    silence_tokens: Tuple[int, ...] = (1388, 1898, 131)
    cfg_coef: float = 1.5
    cfg_stride: int = 5
    aug_text: bool = True
    aug_context: bool = False
    cfg_pretrained: bool = False
    sample_batch_size: int = 1
    seed: int = 1  # informational; callers derive the PRNGKey themselves
    codec_sr: int = 50
    # static caps for XLA shapes
    max_gen_per_span: int = 1000  # hard cap on generated tokens per span
    length_cap_mult: int = 10  # stop if y exceeds x_len*mult (models/ssr.py:739)


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def config_to_json(cfg: Any) -> str:
    return json.dumps(_to_jsonable(cfg), indent=2, sort_keys=True)


def _from_dict(cls, data):
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in data.items():
        if key not in fields:
            continue
        ftype = fields[key].type
        sub = _DATACLASS_FIELDS.get((cls.__name__, key))
        if sub is not None and isinstance(val, dict):
            kwargs[key] = _from_dict(sub, val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


_DATACLASS_FIELDS = {
    ("SSRModelConfig", "tokens"): TokenSpace,
    ("TrainConfig", "optim"): OptimConfig,
    ("TrainConfig", "masking"): MaskingConfig,
    ("TrainConfig", "data"): DataConfig,
    ("CodecConfig", "seanet"): SEANetConfig,
    ("CodecConfig", "rvq"): RVQConfig,
}


def ssr_config_from_json(text: str) -> SSRModelConfig:
    return _from_dict(SSRModelConfig, json.loads(text))


def codec_config_from_json(text: str) -> CodecConfig:
    return _from_dict(CodecConfig, json.loads(text))


def tiny_ssr_config(**overrides) -> SSRModelConfig:
    """Small model for tests (analogous to audiocraft's debug model factories,
    reference ``audiocraft/audiocraft/models/builders.py:216,262``)."""
    defaults = dict(
        d_model=64,
        nhead=4,
        num_layers=2,
        n_codebooks=4,
        audio_embedding_dim=64,
        text_vocab_size=40,
        tokens=TokenSpace(audio_vocab_size=32),
        head_hidden=32,
        max_position=512,
    )
    defaults.update(overrides)
    return SSRModelConfig(**defaults)


def tiny_codec_config(**overrides) -> CodecConfig:
    defaults = dict(
        seanet=SEANetConfig(dimension=16, n_filters=4, lstm=1, ratios=(4, 2)),
        rvq=RVQConfig(dimension=16, n_q=2, bins=17),
        frame_rate=2000,
    )
    defaults.update(overrides)
    return CodecConfig(**defaults)
