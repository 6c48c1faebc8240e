"""Decode attention of the continuous server's paged step
(``models.transformer.transformer_decode_step_paged``): one query a row over
[the row's prompt | its generated columns | the current token].

Kernel, hand-written for Hopper (sm_90a): ``csrc/decode_attention.cu``. It
replaces no TPU kernel (JAX's paged step leaves this attention to XLA
einsums) and takes the plain version's place on the card: one launch a layer
a step, reading the bf16 caches in place and only their live keys. The work
is bound by those bytes; the design is in the source.

Route (:func:`uses_kernel`), by what the query shows: a CUDA bf16 query at
head width 128 takes the kernel, everything else (the CPU, fp32, other head
widths) the plain version :func:`plain_paged_attention`, the step's own
arithmetic: q scaled in its dtype, fp32 scores with -1e9 on the dead keys,
one fp32 softmax over [prompt | generated | current], probabilities in q's
dtype, three PV products added in that dtype. The kernel keeps all of it but
the last: it adds the three partial outputs in fp32 and rounds once.

``launches`` counts the kernel's launches, those a CUDA graph replays
included (``cuda_build.launched``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .cuda_build import check_layout, launched, load
from .flash_attention import HEAD_DIM

_KERNEL = "decode_attention"

# kernel launches since the last reset (a plain integer; read by chip_smoke.py)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _count(n: int) -> None:
    """n launches (``cuda_build.launched``'s counter)."""
    global launches
    launches += n


def step_scale(dh: int, dtype, device) -> torch.Tensor:
    """The scale of a one-token step's query, 1 / sqrt(dh): JAX multiplies
    q by it as a weakly typed constant, so in ``dtype`` (a fill, so a
    captured graph holds no host copy)."""
    return torch.full((), 1.0 / math.sqrt(dh), dtype=dtype, device=device)


def uses_kernel(device: torch.device, dtype, head_dim: int) -> bool:
    """Whether the attention of a step whose query lies on ``device`` in
    ``dtype`` at ``head_dim`` is the kernel: CUDA, bf16 and 128."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and head_dim == HEAD_DIM)


def plain_paged_attention(q, k, v, pfx_k, pfx_v, gen_k, gen_v, key_banned,
                          gen_len, tp: int, read_len: int) -> torch.Tensor:
    """q, k, v [B, H, 1, Dh] (q not scaled); ``pfx_k``/``pfx_v`` [B, H, >=
    tp, Dh] a layer's prompt cache, keys [0, tp) read, ``key_banned`` [B, >=
    tp] bool its dead keys; ``gen_k``/``gen_v`` [B, H, >= read_len, Dh] the
    generated cache, columns [0, read_len) read, those at and past
    ``gen_len[r]`` dead. Returns [B, H, 1, Dh] in q's dtype."""
    dev, dtype, rl = q.device, q.dtype, read_len
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pfx_bias = torch.where(key_banned[:, :tp], -1e9, zero)[:, None, None, :]
    cols = torch.arange(rl, device=dev)[None, :]
    gen_bias = torch.where(cols < gen_len[:, None], zero,
                           -1e9)[:, None, None, :]  # [B, 1, 1, rl]
    qs = q * step_scale(q.shape[-1], dtype, dev)
    sp = torch.matmul(qs.float(), pfx_k[:, :, :tp].float()
                      .transpose(-1, -2)) + pfx_bias  # [B, H, 1, Tp]
    sg = torch.matmul(qs.float(), gen_k[:, :, :rl].float()
                      .transpose(-1, -2)) + gen_bias  # [B, H, 1, rl]
    sc = (qs.float() * k.float()).sum(-1, keepdim=True)  # [B, H, 1, 1]
    p = torch.softmax(torch.cat([sp, sg, sc], dim=-1), dim=-1).to(dtype)
    out = torch.matmul(p[..., :tp], pfx_v[:, :, :tp])
    out = out + torch.matmul(p[..., tp:tp + rl], gen_v[:, :, :rl])
    return out + p[..., -1:] * v


def load_kernel():
    """Build (first call only) and bind the kernel; returns the
    ``cuda_build.BuiltLibrary``."""
    built = load(_KERNEL)
    fn = built.lib.ssr_paged_decode_attention_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, p, p, i, p, p, i, p, ll, p, p,
                       i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return built


@functools.cache
def _bf16_scale(dh: int) -> float:
    """:func:`step_scale` in bf16, as the kernel takes it (a float)."""
    return float(step_scale(dh, torch.bfloat16, "cpu"))


def _check_kernel_args(q, k, v, pfx_k, pfx_v, gen_k, gen_v, key_banned,
                       gen_len, tp, rl):
    b, h, _, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or t.shape != (b, h, 1, dh)
                or t.device != q.device):
            raise ValueError(f"decode attention kernel: {name} must be bf16 "
                             f"[{b}, {h}, 1, {dh}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(1) != dh or t.stride(3) != 1 or t.data_ptr() % 16:
            raise ValueError(f"decode attention kernel: {name} needs heads "
                             f"of {dh} contiguous elements, 16-byte aligned")
    for name, t, n in (("pfx_k", pfx_k, tp), ("pfx_v", pfx_v, tp),
                       ("gen_k", gen_k, rl), ("gen_v", gen_v, rl)):
        if (t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[:2] != (b, h)
                or t.shape[3] != dh or t.shape[2] < n):
            raise ValueError(f"decode attention kernel: {name} must be bf16 "
                             f"[{b}, {h}, >= {n}, {dh}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if (key_banned.dtype != torch.bool or key_banned.dim() != 2
            or key_banned.shape[0] != b or key_banned.shape[1] < tp):
        raise ValueError(f"decode attention kernel: key_banned must be bool "
                         f"[{b}, >= {tp}], got {key_banned.dtype} "
                         f"{tuple(key_banned.shape)}")
    if gen_len.dtype != torch.int64 or gen_len.shape != (b,):
        raise ValueError(f"decode attention kernel: gen_len must be int64 "
                         f"[{b}], got {gen_len.dtype} {tuple(gen_len.shape)}")
    check_layout("decode attention", pfx_k=pfx_k, pfx_v=pfx_v, gen_k=gen_k,
                 gen_v=gen_v, key_banned=key_banned, gen_len=gen_len)


def kernel_paged_attention(q, k, v, pfx_k, pfx_v, gen_k, gen_v, key_banned,
                           gen_len, tp: int, read_len: int) -> torch.Tensor:
    """The kernel on checked CUDA tensors, as :func:`plain_paged_attention`.
    Inside ``cuda_build.recording`` (a graph capture) the launch counts
    there."""
    _check_kernel_args(q, k, v, pfx_k, pfx_v, gen_k, gen_v, key_banned,
                       gen_len, tp, read_len)
    lib = load_kernel().lib
    b, h, _, dh = q.shape
    out = torch.empty((b, h, 1, dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.ssr_paged_decode_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), k.stride(0),
            v.stride(0), pfx_k.data_ptr(), pfx_v.data_ptr(), pfx_k.shape[2],
            gen_k.data_ptr(), gen_v.data_ptr(), gen_k.shape[2],
            key_banned.data_ptr(), key_banned.stride(0), gen_len.data_ptr(),
            out.data_ptr(), b, h, tp, read_len, _bf16_scale(dh), stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {err} at q {tuple(q.shape)}, tp {tp}, "
                           f"window {read_len}")
    launched(_count)
    return out


def paged_attention(q, k, v, pfx_k, pfx_v, gen_k, gen_v, key_banned, gen_len,
                    tp: int, read_len: int) -> torch.Tensor:
    """The paged step's attention of one layer, by :func:`uses_kernel`'s
    route; arguments and result as :func:`plain_paged_attention`."""
    attend = (kernel_paged_attention
              if uses_kernel(q.device, q.dtype, q.shape[-1])
              else plain_paged_attention)
    return attend(q, k, v, pfx_k, pfx_v, gen_k, gen_v, key_banned, gen_len,
                  tp, read_len)
