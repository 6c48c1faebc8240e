"""The decode profiler's arithmetic (``tools/torch_profile_generate.py``) on
the CPU: the continuous chunk runner's step count is the int the chunk
returns (JSON-ready, not the server's [1] device counter), and
``loop_profile`` buckets, windows and divides synthetic device events as
the card's profile would give them."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from ssr_speech_tpu_torch.config import DecodeConfig, tiny_ssr_config
from ssr_speech_tpu_torch.inference import serve
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
from ssr_speech_tpu_torch.utils import prng

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_profile_generate as tpg  # noqa: E402


def _event(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_categories():
    assert tpg.category("void flash_fwd_kernel<128>") == "attention"
    assert tpg.category("void (anonymous namespace)::softmax_warp_forward") \
        == "attention"
    assert tpg.category("nvjet_tst_64x8_64x16_4x1_v_bz_TNN") == "gemm"
    assert tpg.category("void at::native::elementwise_kernel<128, 4, "
                        "bfloat16_copy_kernel_cuda>") == "copy/cast"
    assert tpg.category("void at::native::reduce_kernel<512, 1>") == "reduce"
    assert tpg.category("void at::native::vectorized_elementwise_kernel<4, "
                        "CUDAFunctor_add<float>>") == "elementwise"
    assert tpg.category("void at::native::vectorized_layer_norm_kernel") \
        == "other"


@pytest.mark.parametrize("n_flash", [0, 2])
def test_loop_profile_window_and_rates(n_flash):
    """With flash launches the loop starts after the last one ends; without
    (a profile around the chunk alone) every device event counts. Rates are
    per step; busy time is the union of the intervals."""
    prefill = [_event("flash_fwd_kernel", 0, 10), _event("gemm_a", 10, 12),
               _event("flash_fwd_kernel", 12, 20)][:3 if n_flash else 0]
    loop = [_event("gemm_b", 30, 40), _event("gemm_b", 35, 45),
            _event("reduce_kernel", 50, 52), _event("bfloat16_copy", 60, 64)]
    host = [_event("cudaGraphLaunch", 25, 26, DeviceType.CPU)]
    p = tpg.loop_profile(prefill + host + loop, n_flash, steps=2, rows=4,
                         unprofiled_ms=0.5)
    assert p["launches_per_step"] == 2.0
    assert p["launches_per_step_by_category"] == {
        "gemm": 1.0, "reduce": 0.5, "copy/cast": 0.5}
    assert p["device_ms_per_step"] == pytest.approx((10 + 10 + 2 + 4) / 2e3)
    assert p["device_busy_ms_per_step"] == pytest.approx((15 + 2 + 4) / 2e3)
    assert p["busy_share_of_profiled_span"] == pytest.approx(21 / 34)
    json.dumps(p)


def test_loop_profile_refuses_a_wrong_flash_count():
    with pytest.raises(RuntimeError, match="flash launches"):
        tpg.loop_profile([_event("flash_fwd_kernel", 0, 1)], 2, 1, 2, 1.0)


def test_chunk_runner_reports_the_chunks_int_steps():
    """One chunk of the tiny server through ``chunk_runner`` on the CPU: the
    steps are a Python int (what ``json.dumps`` and the per-step division
    need), within the budget, and a second run from fresh fills takes the
    same steps."""
    cfg = tiny_ssr_config()
    lm = lm_from_jax(tssr.init_ssr(prng.PRNGKey(0), cfg), cfg)
    dec = DecodeConfig(top_k=1, top_p=0.8, stop_repetition=2,
                       silence_tokens=(1388, 1898, 131), cfg_coef=1.5,
                       cfg_stride=5, aug_text=True, cfg_pretrained=True)
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.text_vocab_size - 1, size=68)
    y = rng.integers(0, cfg.tokens.audio_vocab_size, size=(cfg.n_codebooks, 300))
    run = tpg.chunk_runner(torch, serve, lm, cfg, dec, x, y, n_slots=2,
                           steps=12, sync=lambda: None)
    got = run()
    assert type(got["steps"]) is int and 0 < got["steps"] <= 12
    assert got["chunk_ms_per_step"] > 0
    json.dumps(got)
    assert run()["steps"] == got["steps"]
