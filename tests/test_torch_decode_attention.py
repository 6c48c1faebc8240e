"""The paged step's decode attention (``ops/decode_attention.py``) on the
CPU: the route by device, dtype and head width (never by catching an
error), the plain version as what the CPU, fp32 and other head widths take,
the masking rule the kernel's skipping rests on, and the launch counter's
bookkeeping for CUDA graph replays. The kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.ops import cuda_build
from ssr_speech_tpu_torch.ops import decode_attention as da
from ssr_speech_tpu_torch.ops import flash_attention as fa


def _inputs(dtype, dh, seed=0, b=3, h=2, tp=24, pcap=32, gcap=16, rl=12):
    """One layer's operands: q, k, v [b, h, 1, dh], a prompt cache of
    ``pcap`` keys read to ``tp``, a generated cache of ``gcap`` columns read
    to ``rl``, some banned prompt keys, ragged gen_len (0 and rl - 1
    among them)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    banned = torch.from_numpy(rng.random((b, pcap)) < 0.3)
    banned[:, tp:] = True
    gen_len = torch.from_numpy(rng.integers(0, rl, size=b))
    gen_len[0], gen_len[1] = 0, rl - 1
    return (normal(b, h, 1, dh), normal(b, h, 1, dh), normal(b, h, 1, dh),
            normal(b, h, pcap, dh), normal(b, h, pcap, dh),
            normal(b, h, gcap, dh), normal(b, h, gcap, dh), banned, gen_len,
            tp, rl)


def test_route_by_device_dtype_and_head_width():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert da.uses_kernel(cuda, torch.bfloat16, 128)
    assert not da.uses_kernel(cpu, torch.bfloat16, 128)
    assert not da.uses_kernel(cuda, torch.float32, 128)
    assert not da.uses_kernel(cuda, torch.bfloat16, 16)


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 16)])
def test_cpu_takes_the_plain_version(monkeypatch, dtype, dh):
    """A CPU step, bf16 or fp32, at head width 128 or 16: the plain version,
    bit for bit, with the kernel never asked for and nothing counted."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel was asked for on the CPU")

    monkeypatch.setattr(da, "kernel_paged_attention", refuse)
    monkeypatch.setattr(da, "load_kernel", refuse)
    args = _inputs(dtype, dh)
    da.reset_launches()
    got = da.paged_attention(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.equal(got, da.plain_paged_attention(*args))
    assert da.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_ignores_dead_keys(dtype):
    """What the kernel's skipping rests on: a dead key's score carries -1e9,
    whose exponential is an exact zero in fp32, so finite junk in every
    dead key (banned prompt keys, the prompt buffer past tp, generated
    columns at and past gen_len) changes no output bit."""
    q, k, v, pk, pv, gk, gv, banned, gen_len, tp, rl = _inputs(dtype, 16, 1)
    want = da.plain_paged_attention(q, k, v, pk, pv, gk, gv, banned,
                                    gen_len, tp, rl)
    dead_p = banned[:, None, :, None].expand_as(pk)
    cols = torch.arange(gk.shape[2])
    dead_g = (cols[None, :] >= gen_len[:, None])[:, None, :, None].expand_as(gk)
    pk, pv, gk, gv = pk.clone(), pv.clone(), gk.clone(), gv.clone()
    pk[dead_p], pv[dead_p], gk[dead_g], gv[dead_g] = 300., -300., 300., -300.
    got = da.plain_paged_attention(q, k, v, pk, pv, gk, gv, banned, gen_len,
                                   tp, rl)
    assert torch.equal(got, want)


def test_recorded_launches_count_when_replayed():
    """Inside ``cuda_build.recording`` (a graph capture) every kernel's
    launches count apart; a replay adds what the capture recorded to each
    kernel's own counter."""
    da.reset_launches()
    fa.reset_launches()
    with cuda_build.recording() as rec:
        cuda_build.launched(da._count)
        cuda_build.launched(da._count)
        cuda_build.launched(fa._count_forward)
    assert rec.n == 3 and da.launches == fa.launches == 0
    rec.replay()
    cuda_build.launched(da._count)
    assert da.launches == 3 and fa.launches == 1
    da.reset_launches()
    fa.reset_launches()
