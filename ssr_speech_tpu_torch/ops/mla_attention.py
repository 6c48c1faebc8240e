"""Latent (MLA) decode attention of the continuous server's paged step
(``models.mla_moe.decode_step_paged``), in the absorbed form: each row's 16
query heads over its own cached latents, [c | k_pe] a key.

Kernel, hand-written for Hopper (sm_90a): ``csrc/mla_attention.cu`` (K12),
K10's paged design over the latent cache. It replaces no TPU kernel (the
JAX package has no MLA block). One launch a layer a step reads the bf16
latents in place, only the live keys: the prompt's open keys, the
generated columns below ``gen_len[r]`` (the strict mask, so a refilled row
never reads the previous occupant's), and the row's own new latent. The
design is in the source.

Route (:func:`uses_kernel`): a CUDA bf16 query takes the kernel, which
refuses any but 16 heads over a 576-wide latent of which 512 are c; the
CPU and fp32 take the plain version :func:`plain_paged_mla_attention`:
fp32 scores scaled after the product, -1e9 on the dead keys, one fp32
softmax over [prompt | generated | current], probabilities in q's dtype,
one product with the latents' c. The kernel rounds exp(s - max) to bf16 and
divides by the sum once at the end in fp32 (an online softmax over tiles).

``launches`` counts the kernel's launches, those a CUDA graph replays
included (``cuda_build.launched``).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_layout, launched, load

_KERNEL = "mla_attention"
HEADS, LATENT, C_WIDTH = 16, 576, 512

# kernel launches since the last reset (a plain integer)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _count(n: int) -> None:
    global launches
    launches += n


def uses_kernel(q: torch.Tensor) -> bool:
    return q.device.type == "cuda" and q.dtype == torch.bfloat16


def plain_paged_mla_attention(q, cur, pfx_c, gen_c, key_banned, gen_len,
                              tp: int, read_len: int, scale: float,
                              c_width: int) -> torch.Tensor:
    """q [B, H, W] (absorbed, unscaled); ``cur`` [B, W] the rows' new
    latents; ``pfx_c`` [B, >= tp, W] the prompt latents, keys [0, tp) read,
    ``key_banned`` [B, >= tp] bool its dead keys; ``gen_c`` [B, >= read_len,
    W] the generated latents, columns [0, read_len) read, those at and past
    ``gen_len[r]`` dead. Returns sum_j p_j c_j [B, H, c_width] in q's
    dtype."""
    dev, rl = q.device, read_len
    keys = torch.cat([pfx_c[:, :tp], gen_c[:, :rl], cur[:, None]], 1)
    cols = torch.arange(rl, device=dev)[None, :]
    dead = torch.cat([key_banned[:, :tp], cols >= gen_len[:, None],
                      torch.zeros_like(key_banned[:, :1])], 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(dead, -1e9, zero)[:, None, :]
    s = torch.matmul(q.float(), keys.float().transpose(1, 2)) * scale + bias
    p = torch.softmax(s, -1).to(q.dtype)
    return torch.matmul(p, keys[..., :c_width])


def load_kernel():
    built = load(_KERNEL)
    fn = built.lib.ssr_mla_decode_attention_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, p, ctypes.c_longlong, p, p, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return built


def kernel_paged_mla_attention(q, cur, pfx_c, gen_c, key_banned, gen_len,
                               tp: int, read_len: int, scale: float,
                               c_width: int) -> torch.Tensor:
    """K12 on checked CUDA tensors, as :func:`plain_paged_mla_attention`."""
    b = q.shape[0]
    if (q.dtype != torch.bfloat16 or q.shape[1:] != (HEADS, LATENT)
            or c_width != C_WIDTH):
        raise ValueError(f"mla attention kernel: q must be bf16 [B, {HEADS}, "
                         f"{LATENT}] over a c of {C_WIDTH}, got {q.dtype} "
                         f"{tuple(q.shape)}, c {c_width}")
    for name, t, n in (("pfx_c", pfx_c, tp), ("gen_c", gen_c, read_len)):
        if (t.dtype != torch.bfloat16 or t.dim() != 3 or t.shape[0] != b
                or t.shape[2] != LATENT or t.shape[1] < n):
            raise ValueError(f"mla attention kernel: {name} must be bf16 "
                             f"[{b}, >= {n}, {LATENT}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if cur.dtype != torch.bfloat16 or cur.shape != (b, LATENT):
        raise ValueError(f"mla attention kernel: cur must be bf16 [{b}, "
                         f"{LATENT}], got {cur.dtype} {tuple(cur.shape)}")
    if (key_banned.dtype != torch.bool or key_banned.dim() != 2
            or key_banned.shape[0] != b or key_banned.shape[1] < tp):
        raise ValueError(f"mla attention kernel: key_banned must be bool "
                         f"[{b}, >= {tp}]")
    if gen_len.dtype != torch.int64 or gen_len.shape != (b,):
        raise ValueError(f"mla attention kernel: gen_len must be int64 [{b}]")
    check_layout("mla attention", q=q, cur=cur, pfx_c=pfx_c, gen_c=gen_c,
                 key_banned=key_banned, gen_len=gen_len)
    out = torch.empty((b, HEADS, C_WIDTH), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = load_kernel().lib.ssr_mla_decode_attention_bf16(
            q.data_ptr(), cur.data_ptr(), pfx_c.data_ptr(), pfx_c.shape[1],
            gen_c.data_ptr(), gen_c.shape[1], key_banned.data_ptr(),
            key_banned.stride(0), gen_len.data_ptr(), out.data_ptr(), b, tp,
            read_len, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"mla attention kernel launch failed: CUDA error "
                           f"{err} at B {b}, tp {tp}, window {read_len}")
    launched(_count)
    return out


def paged_mla_attention(q, cur, pfx_c, gen_c, key_banned, gen_len, tp: int,
                        read_len: int, scale: float, c_width: int
                        ) -> torch.Tensor:
    """One layer's latent attention by :func:`uses_kernel`'s route;
    arguments and result as :func:`plain_paged_mla_attention`."""
    fn = (kernel_paged_mla_attention if uses_kernel(q)
          else plain_paged_mla_attention)
    return fn(q, cur, pfx_c, gen_c, key_banned, gen_len, tp, read_len, scale,
              c_width)
