"""The rank mesh and the sharding rules of the SSR LM (port of
``ssr_speech_tpu/parallel/mesh.py``).

JAX places parameters on a ``Mesh`` and lets GSPMD partition the math. Here
each rank holds its own blocks and the math is explicit Megatron
(``collectives``), so the rules below decide which block of each leaf a rank
keeps:

  - axis ``dp``: data parallel: a rank takes rows of the global batch, the
    parameters are replicated and their gradients summed over dp;
  - axis ``tp``: tensor parallel: q/k/v and ffn-in column-parallel (output
    dim on tp), attn-out and ffn-out row-parallel (input dim on tp), the
    per-codebook heads' hidden dim on tp;
  - ``fsdp``: the layer stacks' leading dim on dp as well (ZeRO-3): a rank
    keeps L/dp layers and a layer is broadcast from its owner where it is
    used.

A spec is a tuple with one entry per dim: None, an axis name, or
``(axis, n)`` for a dim that packs ``n`` blocks side by side. The packed
``qkv`` projection is ``[.., 3D]``: a rank's block of it is
``[q_local | k_local | v_local]`` for its own heads, not a contiguous third.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.tree import tree_map
from . import collectives as col
from .dist import world_size

QKV = ("tp", 3)  # the packed [q | k | v] output dim


class Mesh:
    """Ranks ``0..world-1`` laid out row-major over named axes, with this
    rank's coordinate and one process group per axis (None for an axis of
    size 1). The groups come from a ``torch.distributed.device_mesh.
    DeviceMesh``; a world of one rank needs no process group at all."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int]):
        self.names, self.sizes = tuple(names), tuple(int(s) for s in sizes)
        world = world_size()
        if math.prod(self.sizes) != world:
            raise ValueError(f"mesh {dict(zip(self.names, self.sizes))} needs "
                             f"{math.prod(self.sizes)} ranks, the world has "
                             f"{world}")
        rank = dist.get_rank() if dist.is_initialized() else 0
        coords, rest = [], rank
        for s in reversed(self.sizes):
            coords.append(rest % s)
            rest //= s
        self.coords = tuple(reversed(coords))
        self.device_mesh = None
        self.groups: Dict[str, Any] = {n: None for n in self.names}
        if world > 1:
            from torch.distributed.device_mesh import DeviceMesh

            backend = dist.get_backend()
            self.device_mesh = DeviceMesh(
                "cuda" if backend == "nccl" else "cpu",
                torch.arange(world).reshape(self.sizes),
                mesh_dim_names=self.names)
            for n, s in zip(self.names, self.sizes):
                if s > 1:
                    self.groups[n] = self.device_mesh.get_group(n)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        return (self.coords[self.names.index(axis)]
                if axis in self.names else 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def parallel(self, fsdp: bool = False,
                 sequence_parallel: bool = False) -> col.Parallel:
        fsdp = fsdp and self.size("dp") > 1
        return col.Parallel(
            dp_group=self.group("dp"), tp_group=self.group("tp"),
            tp_size=self.size("tp"), tp_rank=self.rank("tp"),
            fsdp_group=self.group("dp") if fsdp else None,
            fsdp_size=self.size("dp") if fsdp else 1,
            fsdp_rank=self.rank("dp") if fsdp else 0,
        ).with_sequence_parallel(sequence_parallel)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(n_devices: Optional[int] = None, tp: int = 1) -> Mesh:
    """``(dp, tp)`` mesh over the process group's ranks (``n_devices``, if
    given, must be the world size)."""
    world = world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n_devices}): the world has {world} ranks")
    if n % tp:
        raise ValueError(f"{n} ranks do not split into tp={tp}")
    return Mesh(("dp", "tp"), (n // tp, tp))


def ssr_param_specs(params=None, fsdp: bool = False) -> Dict[str, Any]:
    """Spec tree of the SSR LM parameters (Megatron TP; the layer stacks'
    leading dim on dp as well with ``fsdp``), JAX ``ssr_param_specs``'s."""
    lead = "dp" if fsdp else None
    layers = dict(
        ln1_w=(lead, None), ln1_b=(lead, None),
        qkv_w=(lead, None, QKV), qkv_b=(lead, QKV),
        out_w=(lead, "tp", None), out_b=(lead, None),
        ln2_w=(lead, None), ln2_b=(lead, None),
        ffn1_w=(lead, None, "tp"), ffn1_b=(lead, "tp"),
        ffn2_w=(lead, "tp", None), ffn2_b=(lead, None))
    return dict(
        text_emb=(None, None), audio_emb=(None, None, None),
        text_pos_alpha=(None,), audio_pos_alpha=(None,),
        decoder=dict(layers=layers, final_ln_w=(None,), final_ln_b=(None,)),
        head1_w=(None, None, "tp"), head1_b=(None, "tp"),
        head2_w=(None, "tp", None), head2_b=(None, None))


def batch_specs(lead: int = 0) -> Dict[str, tuple]:
    """The batch: rows over dp, as ``P("dp")`` (after ``lead`` leading
    dims, e.g. 1 for gradient accumulation's [A, B/A, ...])."""
    pre = (None,) * lead
    return dict(x=pre + ("dp", None), x_lens=pre + ("dp",),
                y=pre + ("dp", None, None), y_lens=pre + ("dp",))


def _axis(entry):
    return entry[0] if isinstance(entry, tuple) else entry


def shard_groups(mesh: Mesh, specs) -> Any:
    """The tree of process groups each leaf is sharded over (axes of size 1
    left out): what an optimizer reduces a leaf's statistics over."""
    def leaf(spec):
        axes = [_axis(e) for e in spec if e is not None]
        return [mesh.group(a) for a in dict.fromkeys(axes) if mesh.size(a) > 1]
    return _map_specs(leaf, specs)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def local_block(mesh: Mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``."""
    if isinstance(t, torch.Tensor) and t.dim() < len(spec):
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(t.shape)}")
    for dim, entry in enumerate(spec):
        axis = _axis(entry)
        n = mesh.size(axis) if axis else 1
        if n == 1:
            continue
        r = mesh.rank(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {axis}={n}")
        if isinstance(entry, tuple):  # packed blocks: split each one
            t = torch.cat([b.chunk(n, dim=dim)[r]
                           for b in t.chunk(entry[1], dim=dim)], dim=dim)
        else:
            t = t.chunk(n, dim=dim)[r]
    return t.contiguous()


def full_tensor(mesh: Mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """Inverse of :func:`local_block`: the whole tensor from every rank's
    block (a collective over the spec's axes; every rank gets it)."""
    for dim in reversed(range(len(spec))):
        entry = spec[dim]
        axis = _axis(entry)
        n = mesh.size(axis) if axis else 1
        if n == 1:
            continue
        full = col.all_gather(t, mesh.group(axis), dim)
        if isinstance(entry, tuple):  # rank blocks -> packed blocks
            blocks = [b.chunk(entry[1], dim=dim) for b in full.chunk(n, dim=dim)]
            full = torch.cat([blocks[r][j] for j in range(entry[1])
                              for r in range(n)], dim=dim)
        t = full
    return t.contiguous()


def shard_tree(mesh: Mesh, tree, specs):
    """Every leaf's local block (a tree of the same nesting)."""
    return tree_map(lambda t, s: local_block(mesh, t, s), tree,
                    _align(specs, tree))


def gather_tree(mesh: Mesh, tree, specs):
    """The whole tree from the ranks' blocks: the exact inverse of
    :func:`shard_tree`. Every rank must call it (it is a collective)."""
    return tree_map(lambda t, s: full_tensor(mesh, t, s), tree,
                    _align(specs, tree))


def _align(specs, tree):
    """``specs`` restricted to the keys of ``tree`` (a ParamTree's
    ``tree()`` or a plain dict)."""
    if isinstance(tree, dict):
        return {k: _align(specs[k], v) for k, v in tree.items()}
    return specs


def attach(module, par: Optional[col.Parallel]):
    """Set ``parallel`` on a ParamTree and every sub-tree: the transformer
    and the heads read it (computation follows the data, as GSPMD's does)."""
    for m in module.modules():
        m.parallel = par
    return module


def shard_params_for_serving(mesh: Mesh, params, fsdp: bool = False):
    """Place LM parameters (an ``SSRLM``, as ``lm_from_jax`` gives) for
    tensor-parallel serving: this rank's blocks under
    :func:`ssr_param_specs`, each leaf in its own dtype, as a ParamTree that
    carries ``cfg`` and the mesh's ``Parallel`` context. ``generate``,
    ``generate_batch``, ``generate_multi``, the continuous server and the
    streaming server run on it as they run on the whole model: the K/V
    caches hold the rank's heads, and each layer's two row-parallel products
    are summed over tp."""
    from ..models.from_jax import ParamTree
    from ..models.mla_moe import refuse_params

    refuse_params(params, "tensor-parallel and fsdp serving")
    local = shard_tree(mesh, params.tree(), ssr_param_specs(fsdp=fsdp))
    out = ParamTree(local).to(_device_of(params)).eval()
    out.cfg = getattr(params, "cfg", None)
    return attach(out, mesh.parallel(fsdp=fsdp))


def _device_of(params) -> torch.device:
    return next(t for t in _tensors(params.tree())).device


def spec_items(specs, path=()) -> list:
    """``(path, spec)`` in ``tree_leaves`` order of the parameters they
    describe (a spec tuple is a leaf here)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_items(specs[k], path + (k,))]
    return [(path, specs)]


def shard_model(mesh: Mesh, params, specs, par: col.Parallel, *,
                cfg=None, trainable: bool = True):
    """This rank's blocks of the whole parameter tree ``params`` (dicts of
    tensors) as a ParamTree of fp32 ``nn.Parameter`` (``trainable``) or
    buffers, carrying ``parallel`` (on every sub-tree), ``specs`` and
    ``cfg``."""
    from ..models.from_jax import ParamTree
    from ..models.mla_moe import refuse_params

    refuse_params(params, "tensor-parallel and fsdp training")
    dev = next(t for t in _tensors(params)).device
    model = ParamTree(shard_tree(mesh, params, specs), trainable).to(dev)
    attach(model, par)
    model.specs, model.cfg = specs, cfg
    return model


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _state_map(fn, state, params, specs):
    """``fn(tensor, param, spec)`` over every tensor of an optimizer state
    that sits where a parameter sits in a sub-tree shaped like the
    parameters (Adam moments, ScaledAdam's per-leaf tuples); other leaves
    (step counts, clipping buffers) are kept."""
    if isinstance(state, dict) and isinstance(params, dict) \
            and set(state) == set(params):
        return {k: _state_map(fn, state[k], params[k], specs[k]) for k in state}
    if isinstance(state, (list, tuple)):
        return type(state)(_state_map(fn, s, params, specs) for s in state)
    if isinstance(state, torch.Tensor) and isinstance(params, torch.Tensor):
        return fn(state, params, specs)
    return state


def gather_state(mesh: Mesh, state, params, specs):
    """The whole optimizer state from the ranks' blocks: each moment shaped
    like its (local) parameter is gathered under the parameter's spec."""
    def fn(t, p, spec):
        if t.shape == p.shape and t.dim() > 0:
            return full_tensor(mesh, t, spec)
        return t
    return _state_map(fn, state, params, specs)


def shard_state(mesh: Mesh, state, params, specs):
    """Inverse of :func:`gather_state`: ``state`` whole (as a bundle holds
    it), ``params`` the whole parameter tree."""
    def fn(t, p, spec):
        if t.shape == p.shape and t.dim() > 0:
            return local_block(mesh, t, spec)
        return t
    return _state_map(fn, state, params, specs)
