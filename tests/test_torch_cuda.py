"""Hand-written CUDA kernels of the port against their plain PyTorch versions,
on the card. Skipped where torch.cuda.is_available() is false.

Run on a GPU machine (which needs neither JAX nor tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

ATOL = 2e-2  # bf16 inputs and output, unit-normal data, Dh = 128


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from ssr_speech_tpu_torch.device import resolve_device, set_precision_policy

    set_precision_policy()
    return resolve_device("cuda")


def _qkv(shape, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("b,h,s", [(1, 1, 1), (1, 2, 63), (2, 2, 64),
                                   (2, 3, 65), (1, 2, 130), (2, 16, 333),
                                   (2, 16, 1000)])
@pytest.mark.parametrize("pattern", ["prefill", "random"])
def test_flash_kernel_matches_plain(device, b, h, s, pattern):
    """Every row (not only valid ones) follows the segment semantics, so the
    kernel must agree with reference_attend on all of them."""
    q, k, v = _qkv((b, h, s, fa.HEAD_DIM), s + b, device)
    rng = np.random.default_rng(s)
    if pattern == "prefill":
        seg = np.ones((b, s), np.int32)
        sx = max(s // 3, 1)
        seg[:, max(sx - 7, 1):sx] = 0
        seg[1:, 1:sx] = 0
    else:
        seg = rng.integers(0, 3, size=(b, s)).astype(np.int32)
    seg = torch.from_numpy(seg).to(device)
    fa.reset_launches()
    got = fa.flash_attend_xy(q, k, v, seg)
    want = fa.reference_attend(q, k, v, seg, 1.0 / math.sqrt(fa.HEAD_DIM))
    torch.cuda.synchronize()
    assert fa.launches == 1
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATOL, err


def test_flash_kernel_refuses_what_it_cannot_take(device):
    q, k, v = _qkv((1, 2, 64, fa.HEAD_DIM), 0, device)
    seg = torch.ones((1, 64), dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        fa.flash_attend_xy(q.float(), k.float(), v.float(), seg)
    with pytest.raises(ValueError):
        fa.flash_attend_xy(q[..., :64], k[..., :64], v[..., :64], seg)
    with pytest.raises(ValueError):
        fa.flash_attend_xy(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), seg)
    with pytest.raises(RuntimeError):
        fa.flash_attend_xy(q.requires_grad_(), k, v, seg)


SMALL = dict(d_model=256, nhead=2, num_layers=2, n_codebooks=4,
             audio_embedding_dim=256, text_vocab_size=30, head_hidden=64,
             max_position=1024)


@pytest.fixture(scope="module")
def small_lm(device):
    from ssr_speech_tpu.config import SSRModelConfig
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models.from_jax import lm_from_jax

    cfg = SSRModelConfig(**SMALL)
    params = tssr.init_ssr(torch.Generator().manual_seed(0), cfg)
    return (cfg, lm_from_jax(params, cfg),
            lm_from_jax(params, cfg, device=device, dtype=torch.bfloat16))


def test_prefill_on_card_matches_cpu(device, small_lm):
    """The prefill through the kernel (bf16) against the port's fp32 CPU
    prefill: the cache at every attendable position."""
    from ssr_speech_tpu_torch.inference import decode as tdecode

    cfg, cpu, gpu = small_lm
    rng = np.random.default_rng(1)
    sx, P, x_len, p_len = 64, 256, 41, 200
    x = np.full((2, sx), cfg.text_pad_token, np.int64)
    x[0, :x_len] = rng.integers(0, cfg.text_vocab_size - 1, size=x_len)
    x[1, :x_len] = cfg.text_vocab_size - 1
    prefix = np.full((4, P), cfg.tokens.empty, np.int64)
    prefix[:, :p_len] = rng.integers(0, 2048, size=(4, p_len))
    kw = dict(cfg=cfg, tmax=512, cfg_pretrained=True, aug_text=True)
    c_cpu, ban = tdecode._prefill_impl(cpu, torch.from_numpy(x),
                                       torch.from_numpy(prefix), x_len, p_len,
                                       dtype=torch.float32, **kw)
    fa.reset_launches()
    c_gpu, ban_g = tdecode._prefill_impl(
        gpu, torch.from_numpy(x).to(device), torch.from_numpy(prefix).to(device),
        x_len, p_len, dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert fa.launches == cfg.num_layers
    assert torch.equal(ban_g.cpu(), ban)
    n = sx + p_len
    for b, (lo, hi) in enumerate(ban.tolist()):
        keep = torch.ones(n, dtype=torch.bool)
        keep[lo:hi] = False
        for name in ("k", "v"):
            want = getattr(c_cpu, name)[:, b, :, :n][:, :, keep]
            got = getattr(c_gpu, name)[:, b, :, :n][:, :, keep].float().cpu()
            err = (got - want).abs().max().item()
            # bf16 weights and activations through two layers
            assert err <= 3e-2 * want.abs().max().item(), (name, b, err)


def test_generate_on_card_is_deterministic(device, small_lm):
    from ssr_speech_tpu.config import DecodeConfig
    from ssr_speech_tpu_torch.inference import decode as tdecode

    cfg, _, gpu = small_lm
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2048, size=(4, 120))
    x = rng.integers(0, cfg.text_vocab_size - 1, size=(30,))
    dec = DecodeConfig(top_k=1, stop_repetition=2, aug_text=True,
                       cfg_pretrained=True, cfg_stride=5, max_gen_per_span=200)
    outs = []
    for _ in range(2):
        fa.reset_launches()
        stats = {}
        outs.append(tdecode.generate(gpu, cfg, dec, x, y, [(30, 60), (80, 100)],
                                     torch.Generator(device=device).manual_seed(0),
                                     stats=stats))
        assert fa.launches == cfg.num_layers
        assert stats["decode_steps"] > 0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][0].shape[1] == 4
