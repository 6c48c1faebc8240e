"""Collectives and Megatron's parallel operators as autograd functions.

Transport: every collective of the port goes through the functions of the
first section. Under ``nccl`` they are the library's calls on the tensors as
they are. Under ``gloo`` (ranks on the CPU, or several ranks sharing one card)
a CUDA tensor is copied to host memory, exchanged there and copied back: gloo
has no reduce-scatter, and no send/recv of device memory, so the port stages
every gloo collective of a CUDA tensor the same way and logs once per op that
it does so. That is the transport only: every product runs where the tensors
live. A failed collective raises; nothing is retried on one rank.

Operators (Megatron-LM's ``f``/``g`` and their sequence-parallel forms), each a
``torch.autograd.Function`` because the library's differentiable all-reduce
all-reduces the gradient again in its backward, which doubles a row-parallel
layer's input gradient over two ranks:

- :func:`copy_to_tp`: identity forward, all-reduce backward (in front of a
  column-parallel product);
- :func:`reduce_from_tp`: all-reduce forward, identity backward (after a
  row-parallel product);
- :func:`gather_seq` / :func:`scatter_seq`: all-gather forward and
  reduce-scatter backward along the sequence, and the reverse;
- :func:`split_seq`: this rank's sequence block, all-gather backward (where
  the replicated residual stream enters sequence parallelism);
- :func:`gather_replicated`: all-gather forward, this rank's block of the
  gradient backward (in front of a computation every rank repeats whole);
- :func:`fsdp_layer`: one layer of a stack that the dp ranks share out,
  broadcast from its owner; the backward sums the layer's gradient onto the
  owner, into its slot of the stack's ``.grad`` in place.

Sums of floating-point tensors are taken in fp32 and cast back, so two bf16
partial sums are added exactly and rounded once.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_staged_logged = set()


def _host_staged(t: torch.Tensor, group, op: str) -> bool:
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if op not in _staged_logged:
        _staged_logged.add(op)
        logger.info("gloo: %s of CUDA tensors goes through host memory", op)
    return True


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() and t.dtype != torch.float64 else t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor, ``t``'s dtype)."""
    buf = _wide(t).clone()
    if _host_staged(t, group, "all_reduce"):
        host = buf.cpu()
        dist.all_reduce(host, group=group)
        buf = host.to(t.device)
    else:
        dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def all_reduce_(parts: List[torch.Tensor], group) -> None:
    """In place: each of ``parts`` (contiguous tensors of one device, all
    floating point or all of one dtype) summed over ``group``, as one flat
    bucket. A single fp32 (or float64, or integer) part is reduced where it
    lies; otherwise the parts are packed into one bucket buffer (floats
    widened to fp32, so two bf16 partial sums are added exactly), reduced
    and copied back, rounded once. Under gloo, CUDA parts go through one
    host buffer, the bucket, and nothing else is allocated on the card."""
    floats = all(p.is_floating_point() and p.dtype != torch.float64
                 for p in parts)
    dtype = torch.float32 if floats else parts[0].dtype
    if not floats and any(p.dtype != dtype for p in parts):
        raise TypeError("all_reduce_: parts of mixed dtypes")
    staged = _host_staged(parts[0], group, "all_reduce")
    if not staged and len(parts) == 1 and parts[0].dtype == dtype:
        dist.all_reduce(parts[0], group=group)
        return
    n = sum(p.numel() for p in parts)
    buf = torch.empty(n, dtype=dtype,
                      device="cpu" if staged else parts[0].device)
    views, i = [], 0
    for p in parts:
        views.append(buf[i:i + p.numel()].view(p.shape))
        views[-1].copy_(p)
        i += p.numel()
    dist.all_reduce(buf, group=group)
    for p, v in zip(parts, views):
        p.copy_(v)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    buf = t.clone()
    if _host_staged(t, group, "all_reduce"):
        host = buf.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
        return host.to(t.device)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if _host_staged(t, group, "all_gather"):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``group``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks")
    if dist.get_backend(group) == "gloo":
        return all_reduce(t, group).chunk(n, dim=dim)[r].contiguous()
    src = _wide(t).movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).to(t.dtype).contiguous()


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank (``t`` gives the shape and
    dtype elsewhere); returns a new tensor."""
    gsrc = dist.get_global_rank(group, src)
    buf = t.detach().clone().contiguous()
    if _host_staged(t, group, "broadcast"):
        host = buf.cpu()
        dist.broadcast(host, src=gsrc, group=group)
        return host.to(t.device)
    dist.broadcast(buf, src=gsrc, group=group)
    return buf


def reduce_to(t: torch.Tensor, dst: int, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``, valid on group rank ``dst``."""
    gdst = dist.get_global_rank(group, dst)
    buf = _wide(t).clone().contiguous()
    if _host_staged(t, group, "reduce"):
        host = buf.cpu()
        dist.reduce(host, dst=gdst, group=group)
        buf = host.to(t.device)
    else:
        dist.reduce(buf, dst=gdst, group=group)
    return buf.to(t.dtype)


def send(t: torch.Tensor, dst: int) -> None:
    """Blocking send to global rank ``dst`` (over the default group)."""
    if _host_staged(t, None, "send"):
        dist.send(t.detach().cpu().contiguous(), dst)
    else:
        dist.send(t.detach().contiguous(), dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """Blocking receive of a tensor shaped as ``like`` from ``src``."""
    if _host_staged(like, None, "recv"):
        host = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(host, src)
        return host.to(like.device)
    buf = torch.empty_like(like)
    dist.recv(buf, src)
    return buf


# --------------------------------------------------------------- contexts

@dataclass(frozen=True)
class Parallel:
    """What a rank's forward needs to know of the mesh: its tensor-parallel
    group (heads and FFN hidden split over it), whether the residual stream
    is split over that group along the sequence, the group that shares out
    the layer stacks (fsdp), and the group that splits the batch rows (the
    loss's token counts are summed over it). Built by
    ``mesh.Mesh.parallel``."""

    dp_group: object = None
    tp_group: object = None
    tp_size: int = 1
    tp_rank: int = 0
    sequence_parallel: bool = False
    fsdp_group: object = None
    fsdp_size: int = 1
    fsdp_rank: int = 0

    def with_sequence_parallel(self, on: bool) -> "Parallel":
        if on and self.tp_size == 1:
            raise ValueError("sequence parallelism needs a tp axis > 1")
        return replace(self, sequence_parallel=on)


def tp_of(par: Optional[Parallel]) -> int:
    return 1 if par is None else par.tp_size


# -------------------------------------------------------------- operators

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def _block(x, group, dim):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    return x.chunk(n, dim=dim)[r].contiguous()


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _FsdpLayer(torch.autograd.Function):
    """Layer ``slot`` of the owner's stack, broadcast over the group. The
    backward sums the layer's gradient onto the owner and adds it in place
    into that slot of the owner's ``stack.grad`` (one buffer of the local
    stack, made at the step's first layer backward), and hands autograd no
    gradient: a layer's backward allocates one layer, where a gradient
    returned for ``stack`` would be a zero stack a layer."""

    @staticmethod
    def forward(ctx, stack, owner, slot, group):
        ctx.stack, ctx.owner, ctx.slot, ctx.group = stack, owner, slot, group
        return broadcast(stack[slot], owner, group)

    @staticmethod
    def backward(ctx, g):
        total = reduce_to(g, ctx.owner, ctx.group)
        stack = ctx.stack
        if dist.get_rank(ctx.group) == ctx.owner:
            if stack.grad is None:
                stack.grad = torch.zeros_like(stack)
            stack.grad[ctx.slot].add_(total.to(stack.dtype))
        return None, None, None, None


def copy_to_tp(x, par: Optional[Parallel]):
    return x if tp_of(par) == 1 else _CopyToTP.apply(x, par.tp_group)


def reduce_from_tp(x, par: Optional[Parallel]):
    return x if tp_of(par) == 1 else _ReduceFromTP.apply(x, par.tp_group)


def gather_seq(x, par: Parallel, dim: int = 1):
    return _GatherSeq.apply(x, par.tp_group, dim)


def scatter_seq(x, par: Parallel, dim: int = 1):
    return _ScatterSeq.apply(x, par.tp_group, dim)


def split_seq(x, par: Parallel, dim: int = 1):
    return _SplitSeq.apply(x, par.tp_group, dim)


def gather_replicated(x, par: Optional[Parallel], dim: int):
    return (x if tp_of(par) == 1
            else _GatherReplicated.apply(x, par.tp_group, dim))


def fsdp_layer(stack: torch.Tensor, layer: int, par: Parallel) -> torch.Tensor:
    """Layer ``layer`` of a stack whose leading dim the fsdp group shares out
    in contiguous blocks (rank r holds layers [r * n, (r + 1) * n)). The
    layer's gradient is summed onto its owner's ``stack.grad`` in place, so
    a stack that takes gradients must be a leaf."""
    if stack.requires_grad and not stack.is_leaf:
        raise ValueError("fsdp_layer adds gradients into the stack's .grad: "
                         "the stack must be a leaf tensor")
    n = stack.shape[0]
    owner, slot = divmod(layer, n)
    return _FsdpLayer.apply(stack, owner, slot, par.fsdp_group)


def sum_over(values: List[torch.Tensor], groups) -> List[torch.Tensor]:
    """Each scalar of ``values`` summed over the process groups in
    ``groups`` (a list of groups, or None to leave it) — one all-reduce per
    distinct group for all the values that share it."""
    out = list(values)
    by_group = {}
    for i, gs in enumerate(groups):
        for g in gs or ():
            by_group.setdefault(g, []).append(i)
    for g, idx in by_group.items():
        summed = all_reduce(torch.stack([out[i].float() for i in idx]), g)
        for j, i in enumerate(idx):
            out[i] = summed[j].to(values[i].dtype)
    return out
