"""Pre-norm transformer decoder with a preallocated KV cache (port of
``ssr_speech_tpu/models/transformer.py``).

Parameters keep the JAX layout: every layer's tensors are stacked on a leading
[L] axis and matmul weights are [in, out] (``x @ w``), so the weights of a JAX
bundle are used as they are. The layer loop is a plain Python loop over views
of the stacked tensors. LayerNorm statistics, attention scores and softmax run
in fp32 whatever the compute dtype, as in JAX.

The full-sequence attention of the prefill and of the training forward goes
through ``ops.flash_attention.flash_attend_xy`` (the hand-written Hopper
kernels on CUDA, forward and backward) where its inputs are bf16 at head width
128, and through the einsum ``_attend`` otherwise (the prefill decides by
``prefill_uses_kernel``, training by ``cfg.attn_impl``). The paged step's
one-token attention goes through ``ops.decode_attention`` (a hand-written
kernel for bf16 at head width 128 on CUDA); the other one-token decode steps'
attention stays plain matmul/softmax, as JAX leaves it to XLA einsums. In
the prefill and the decode steps each bias + residual + LayerNorm chain is
one ``ops.add_layer_norm`` call (a hand-written kernel for a bf16 stream on
CUDA, the same arithmetic elsewhere); the training forward keeps PyTorch ops.

Matmul weights are cast to the activations' dtype at each use, as JAX casts
them: a no-op for the serving path's stored bf16 (or fp32) weights, and the
bf16 compute copy of the trainer's fp32 master weights. The training forward
draws its inverted dropout from an explicit ``torch.Generator``.

Tensor parallelism (``parallel.collectives.Parallel``, passed as ``par`` or
carried by a sharded ParamTree as ``parallel``): a rank holds ``nhead / tp``
heads and ``ffn_dim / tp`` of the FFN hidden; ``copy_to_tp`` goes in front of
the two column-parallel products and ``reduce_from_tp`` after the two
row-parallel ones, before their biases. With ``sequence_parallel`` the
residual stream, its norms and dropouts run on the rank's block of the
sequence, with ``gather_seq`` / ``scatter_seq`` around attention and FFN. With
an fsdp group each layer is broadcast from the rank that holds it inside the
layer's checkpointed body: under every remat mode but ``none`` the gathered
layer dies with the layer's forward and the recompute broadcasts it again;
``none`` keeps it for the products' backward (``_GatheredLayers``). Dropout
under tp: the residual masks come from ``generator``, the same on
every tp rank (under sequence parallelism the whole sequence's mask is drawn
and the rank's block kept), the FFN-hidden masks from ``hidden_generator``,
which differs by tp rank. Without ``par`` every path is the single-device one.

Activation checkpointing of the training forward (``remat``) wraps each layer
of the loop, with what each mode of JAX's ``wrap_remat`` keeps and none of
XLA's policy objects: ``full`` recomputes the whole layer in the backward,
``dots`` keeps the outputs of the matrix products (a selective checkpoint)
and recomputes the rest, ``dots_masks`` also keeps the dropout masks,
``mixed`` is ``dots`` (JAX's own ``mixed`` degrades to it under a layer
loop), ``none`` keeps everything. The attention kernel is no matrix product
of PyTorch's, so every mode but ``none`` launches it again in the recompute.
"""

from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..config import SSRModelConfig

from ..ops import add_layer_norm as aln
from ..ops import decode_attention, scaling
from ..ops.add_layer_norm import layer_norm
from ..ops.flash_attention import HEAD_DIM, flash_attend_xy
from ..parallel import collectives as col
from ..utils import prng

LAYER_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b", "ln2_w",
              "ln2_b", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b")
# the decoder tensors that run in the compute dtype (bf16 on CUDA); norms stay
# fp32 because layer_norm applies its affine in fp32
MATMUL_KEYS = ("qkv_w", "qkv_b", "out_w", "out_b", "ffn1_w", "ffn1_b",
               "ffn2_w", "ffn2_b")


def _uniform(key, shape, bound):
    return prng.uniform(key, shape, -bound, bound)


def _linear_init(key, fan_in, shape_w, shape_b):
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    kw, kb = prng.split(key)
    bound = 1.0 / math.sqrt(fan_in)
    return _uniform(kw, shape_w, bound), _uniform(kb, shape_b, bound)


def init_transformer(key: torch.Tensor, cfg: SSRModelConfig
                     ) -> Dict[str, object]:
    """Stacked parameters for L pre-norm layers + final norm, JAX's
    ``init_transformer`` draw from the same threefry ``key`` (a key a
    layer; xavier-uniform packed QKV, zero QKV bias, torch Linear default
    elsewhere), on the key's device."""
    d, f, L = cfg.d_model, cfg.ffn_dim, cfg.num_layers
    device = key.device
    limit = math.sqrt(6.0 / (d + 3 * d))
    ones = lambda *s: torch.ones(s, device=device)
    zeros = lambda *s: torch.zeros(s, device=device)
    per_layer = {k: [] for k in ("qkv_w", "out_w", "out_b", "ffn1_w",
                                 "ffn1_b", "ffn2_w", "ffn2_b")}
    for k in prng.split(key, L):
        k1, k2, k3, k4 = prng.split(k, 4)
        drawn = dict(qkv_w=_uniform(k1, (d, 3 * d), limit))
        drawn["out_w"], drawn["out_b"] = _linear_init(k2, d, (d, d), (d,))
        drawn["ffn1_w"], drawn["ffn1_b"] = _linear_init(k3, d, (d, f), (f,))
        drawn["ffn2_w"], drawn["ffn2_b"] = _linear_init(k4, f, (f, d), (d,))
        for name, t in drawn.items():
            per_layer[name].append(t)
    layers = {name: torch.stack(ts) for name, ts in per_layer.items()}
    layers.update(ln1_w=ones(L, d), ln1_b=zeros(L, d), qkv_b=zeros(L, 3 * d),
                  ln2_w=ones(L, d), ln2_b=zeros(L, d))
    return dict(layers=layers, final_ln_w=ones(d), final_ln_b=zeros(d))


# set while a dropout mask is computed: the dots_masks policy keeps what is
# made then (thread-local, as the policy runs on the forward's thread)
_in_mask = threading.local()


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool, seq_block=None) -> torch.Tensor:
    """Inverted dropout (JAX ``transformer._dropout``): keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate). The draw
    comes from ``generator``, so a seeded generator repeats it.
    ``seq_block=(n, r)``: ``x`` is block r of n along dim 1; the whole
    sequence's draw is made and block r kept (sequence parallelism)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when not deterministic")
    if seq_block is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        n, r = seq_block
        full = (x.shape[0], x.shape[1] * n) + tuple(x.shape[2:])
        u = torch.rand(full, generator=generator,
                       device=x.device).chunk(n, dim=1)[r]
    _in_mask.on = True
    try:
        keep = u < 1.0 - rate
    finally:
        _in_mask.on = False
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep, x / (1.0 - rate), zero)


def _split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, nhead, d // nhead).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _attend(q, k, v, bias):
    """q [B,H,Tq,Dh] x k/v [B,H,Tk,Dh] with additive fp32 bias [B,1,Tq,Tk]:
    fp32 scores and softmax, probabilities cast to q's dtype."""
    dh = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(dh) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _ffn_act(cfg: SSRModelConfig, deterministic: bool):
    """The FFN activation of ``cfg.activation``: relu (the shipped SSR
    config) or the icefall double-swish variants of ``ops.scaling``; the
    balancer's backward is active unless ``deterministic``."""
    if cfg.activation == "relu":
        return F.relu
    if cfg.activation == "double_swish":
        return scaling.double_swish
    if cfg.activation == "balanced_double_swish":
        return lambda x: scaling.balanced_double_swish(
            x, deterministic=deterministic)
    raise ValueError(cfg.activation)


def parallel_of(params) -> Optional[col.Parallel]:
    """The ``Parallel`` context a sharded ParamTree carries (None for a
    whole model or a plain dict)."""
    return getattr(params, "parallel", None)


def local_heads(cfg: SSRModelConfig, par: Optional[col.Parallel]) -> int:
    tp = col.tp_of(par)
    if cfg.nhead % tp:
        raise ValueError(f"nhead {cfg.nhead} does not split over tp={tp}")
    return cfg.nhead // tp


class _GatheredLayers:
    """Layer l of stacks the fsdp group shares out, broadcast from its
    owner each time it is read (so the whole stack is never held).

    ``run_layers`` reads layer l inside layer l's checkpointed body. Under
    ``full`` and ``dots_masks`` no gathered layer outlives its layer's
    forward (the products' saved inputs are dropped, and the recompute in
    the backward broadcasts the layer again). Under ``none`` the products
    keep their gathered weights for the backward, so every gathered layer
    lives until its backward: ``none`` is the mode that trades memory for
    no recompute, and a re-broadcast at unpack would be the recompute that
    ``none`` declines."""

    def __init__(self, stacked, par: col.Parallel):
        self.stacked, self.par = stacked, par
        self.n = stacked["qkv_w"].shape[0] * par.fsdp_size

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, l: int) -> Dict[str, torch.Tensor]:
        if not 0 <= l < self.n:
            raise IndexError(l)
        return {k: col.fsdp_layer(t, l, self.par) for k, t in self.stacked.items()}


def layer_params(params, par: Optional[col.Parallel] = None):
    """Per-layer views [l] of the stacked decoder tensors (broadcast from
    their owner, layer by layer as read, when an fsdp group shares the
    stacks out)."""
    par = par or parallel_of(params)
    stacked = {k: params["layers"][k] for k in LAYER_KEYS}
    if par is not None and par.fsdp_size > 1:
        return _GatheredLayers(stacked, par)
    n = stacked["qkv_w"].shape[0]
    return [{k: t[l] for k, t in stacked.items()} for l in range(n)]


def _linear(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _row_linear(x, w, b, par):
    """Row-parallel product: partial sums over the tp ranks' input blocks
    summed (or, under sequence parallelism, reduce-scattered over the
    sequence), then the bias; ``_linear`` without tp."""
    if col.tp_of(par) == 1:
        return _linear(x, w, b)
    y = x @ w.to(x.dtype)
    y = (col.scatter_seq(y, par) if par.sequence_parallel
         else col.reduce_from_tp(y, par))
    return y + b.to(x.dtype)


def _tp_in(x, par):
    """The input of a column-parallel product: the whole sequence, with its
    gradient summed over tp."""
    if col.tp_of(par) == 1:
        return x
    return col.gather_seq(x, par) if par.sequence_parallel else col.copy_to_tp(x, par)


def _qkv(lp, hn, nhead, par=None):
    qkv = _linear(_tp_in(hn, par), lp["qkv_w"], lp["qkv_b"])
    return [_split_heads(t, nhead) for t in qkv.chunk(3, dim=-1)]


def _post_attention(lp, h, attn, act, *, drop=None, drop_hidden=None,
                    par=None):
    """The training forward's out projection + residual, then the FFN block
    + residual ``h + (ff @ w2 + b2)``; ``drop`` is its dropout at JAX's two
    residual places and ``drop_hidden`` (default ``drop``) the FFN hidden's.
    The prefill and decode steps add JAX's ``(h + ff @ w2) + b2`` instead
    (:func:`_inference_layers`): the two round differently in fp32, and
    greedy parity is held bit for bit."""
    drop = drop or (lambda x: x)
    drop_hidden = drop_hidden or drop
    h = h + drop(_row_linear(attn, lp["out_w"], lp["out_b"], par))
    hn = layer_norm(h, lp["ln2_w"], lp["ln2_b"])
    ff = drop_hidden(act(_linear(_tp_in(hn, par), lp["ffn1_w"], lp["ffn1_b"])))
    return h + drop(_row_linear(ff, lp["ffn2_w"], lp["ffn2_b"], par))


def _tp_sum(y, par):
    """A row-parallel product's partial sums added over the tp ranks (JAX
    order: before the bias); ``y`` itself without tp."""
    return y if col.tp_of(par) == 1 else col.reduce_from_tp(y, par)


def _inference_layers(params, layers, h, attend, act, par, nhead):
    """The layer loop of the prefill and the decode steps, from the residual
    stream ``h`` [B, S, D] to the final norm's output. ``attend(l, q, k, v)``
    is layer l's attention, merged to [B, S, D].

    Each bias + residual + LayerNorm chain is one ``ops.add_layer_norm``
    call (K13 on the card): layer 0's first norm; the out projection's
    ``h + (y + b)`` with the layer's second norm; the FFN's ``(h + y) + b2``
    (JAX's order) with the next layer's first norm, or after the last layer
    the final norm. So each layer reads its own norm weights and carries
    the next layer's normed input across the loop."""
    h = h.contiguous()  # the kernel reads whole rows of D
    pending = None  # the previous layer's FFN product and bias
    for l, lp in enumerate(layers):
        if pending is None:
            h, hn = aln.add_layer_norm(h, None, None, lp["ln1_w"],
                                       lp["ln1_b"], aln.NORM)
        else:
            h, hn = aln.add_layer_norm(h, *pending, lp["ln1_w"], lp["ln1_b"],
                                       aln.RESIDUAL_THEN_BIAS)
        attn = attend(l, *_qkv(lp, hn, nhead, par))
        y = _tp_sum(attn @ lp["out_w"].to(attn.dtype), par)
        h, hn = aln.add_layer_norm(h, y, lp["out_b"], lp["ln2_w"],
                                   lp["ln2_b"], aln.BIAS_THEN_RESIDUAL)
        ff = act(_linear(_tp_in(hn, par), lp["ffn1_w"], lp["ffn1_b"]))
        pending = (_tp_sum(ff @ lp["ffn2_w"], par), lp["ffn2_b"])
    _, out = aln.add_layer_norm(h, *pending, params["final_ln_w"],
                                params["final_ln_b"], aln.RESIDUAL_THEN_BIAS)
    return out


REMAT_MODES = ("full", "dots", "dots_masks", "mixed", "none")
_MATMUL_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                         torch.ops.aten.bmm.default,
                         torch.ops.aten.baddbmm.default))


def _keep_policy(keep_masks: bool):
    """The selective checkpoint's choice per op: keep matrix products (and,
    with ``keep_masks``, the dropout masks), recompute everything else."""
    save = ckpt.CheckpointPolicy.MUST_SAVE
    recompute = ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    def policy(ctx, func, *args, **kwargs):
        if func in _MATMUL_OPS:
            return save
        if keep_masks and getattr(_in_mask, "on", False):
            return save
        return recompute

    return policy


def default_remat(attn_impl: str) -> str:
    """JAX ``train_lm``'s default: ``dots_masks`` with the fused attention,
    else ``full``."""
    return "dots_masks" if attn_impl in ("flash", "splash") else "full"


def checkpoint_layer(body, mode: str, generator):
    """``body(h) -> h`` under the remat ``mode``. A recompute draws its
    dropout from a copy of ``generator``'s state (a generator, or a tuple of
    them) taken before the layer ran, and leaves it where it was, so the
    masks are the forward's and the next step's draws are those of an
    un-checkpointed step."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat mode {mode!r}")
    if mode == "none":
        return body
    gens = tuple(g for g in (generator if isinstance(generator, tuple)
                             else (generator,)) if g is not None)
    snap = [g.get_state() for g in gens]
    calls = [0]

    def replayed(h):
        calls[0] += 1
        if calls[0] == 1 or not gens:
            return body(h)
        now = [g.get_state() for g in gens]
        for g, st in zip(gens, snap):
            g.set_state(st)
        try:
            return body(h)
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)

    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if mode != "full":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _keep_policy(mode == "dots_masks"))
    return lambda h: ckpt.checkpoint(replayed, h, **kw)


def transformer_forward(params, h: torch.Tensor, cfg: SSRModelConfig, *,
                        bias: Optional[torch.Tensor] = None,
                        key_valid: Optional[torch.Tensor] = None,
                        dtype: torch.dtype = torch.float32,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None,
                        remat: str = "none",
                        par: Optional[col.Parallel] = None,
                        hidden_generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Full-sequence forward (training and eval). h: [B, S, D] -> [B, S, D]
    after the final LayerNorm. With ``cfg.attn_impl`` "flash"/"splash" the
    attention is the fused kernel over ``key_valid`` [B, S]; with "einsum" it
    is ``_attend`` over the additive ``bias`` [B, 1, S, S]. Unless
    ``deterministic``, ``cfg.trm_dropout`` is drawn from ``generator``.
    ``remat`` (one of :data:`REMAT_MODES`) checkpoints each layer when
    autograd records.

    Under ``par`` (default: the one ``params`` carries) the layers are this
    rank's tensor-parallel blocks; ``h`` is the whole residual stream, the
    same on every tp rank, and so is the output, except under sequence
    parallelism, where the output is this rank's block of the sequence
    (``collectives.gather_seq`` gives the whole of it to a column-parallel
    consumer). ``hidden_generator`` draws the FFN hidden's dropout under tp."""
    par = par or parallel_of(params)
    sp = par is not None and par.sequence_parallel
    if sp:
        h = col.split_seq(h, par)
    h = run_layers(layer_params(params, par), h, cfg, bias=bias,
                   key_valid=key_valid, dtype=dtype,
                   deterministic=deterministic, generator=generator,
                   remat=remat, par=par, hidden_generator=hidden_generator)
    return layer_norm(h, params["final_ln_w"], params["final_ln_b"])


def run_layers(layers, h: torch.Tensor, cfg: SSRModelConfig, *, bias=None,
               key_valid=None, dtype=torch.float32, deterministic=True,
               generator=None, remat="none", par=None, hidden_generator=None
               ) -> torch.Tensor:
    """The layer loop of :func:`transformer_forward` over ``layers``
    (per-layer dicts), without the final norm; the pipeline's stages run it
    on their own layers."""
    act = _ffn_act(cfg, deterministic)
    use_flash = cfg.attn_impl in ("flash", "splash")
    if use_flash and key_valid is None:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} needs key_valid")
    if not use_flash and bias is None:
        raise ValueError("attn_impl='einsum' needs bias")
    nhead = local_heads(cfg, par)
    tp = col.tp_of(par)
    if tp > 1 and not deterministic and cfg.trm_dropout > 0 \
            and hidden_generator is None:
        raise ValueError("dropout under tp needs a hidden_generator")
    block = ((tp, par.tp_rank) if par is not None and par.sequence_parallel
             else None)

    def drop(x):
        return dropout(x, cfg.trm_dropout, generator, deterministic,
                       seq_block=block)

    def drop_hidden(x):
        return dropout(x, cfg.trm_dropout, hidden_generator or generator,
                       deterministic)

    def layer(lp, h):
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = _qkv(lp, hn, nhead, par)
        if use_flash:
            attn = flash_attend_xy(q.contiguous(), k.contiguous(),
                                   v.contiguous(), key_valid)
        else:
            attn = _attend(q, k, v, bias.float())
        return _post_attention(lp, h, _merge_heads(attn), act, drop=drop,
                               drop_hidden=drop_hidden if tp > 1 else None,
                               par=par)

    if remat not in REMAT_MODES:
        raise ValueError(f"remat mode {remat!r}")
    mode = remat if torch.is_grad_enabled() else "none"
    gens = (generator, hidden_generator) if tp > 1 else generator
    h = h.to(dtype)
    for l in range(len(layers)):
        # the layer is read inside the checkpointed body: under fsdp that
        # read is the broadcast, which a recompute repeats
        h = checkpoint_layer(lambda x, l=l: layer(layers[l], x), mode, gens)(h)
    return h


def cache_stage_sizes(tmax: int, max_buckets: int = 8):
    """Stage capacities of a decode cache: up to ``max_buckets`` multiples of
    a 128-aligned chunk ending at ``tmax`` (JAX ``cache_stage_sizes``). The
    decode loops read their caches through these windows: a graph is
    captured for each window, so a step reads at most one chunk of keys
    beyond the fill."""
    if tmax <= 128:
        return [tmax]
    raw = -(-tmax // max_buckets)  # ceil(tmax / max_buckets)
    chunk = max(128, -(-raw // 128) * 128)  # round up to 128
    n = -(-tmax // chunk)
    return [min((i + 1) * chunk, tmax) for i in range(n)]


def stage_window(sizes, need: int) -> int:
    """The smallest of ``sizes`` that holds ``need`` keys (the last if none
    does)."""
    return next((w for w in sizes if w >= need), sizes[-1])


@dataclass
class KVCache:
    """Preallocated per-layer key/value buffers and the current fill length.
    The buffers are written in place (JAX returns updated copies).
    ``length`` is a host int, or a [1] int64 tensor on the buffers' device
    (the decode loops' graphs read it there)."""

    k: torch.Tensor  # [L, B, H, Tmax, Dh]
    v: torch.Tensor  # [L, B, H, Tmax, Dh]
    length: Union[int, torch.Tensor]  # number of filled positions

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """The cache's buffers, rows on dim 1 (every block's cache answers
        this: the decode loops copy and splice caches through it)."""
        return (self.k, self.v)


def init_kv_cache(cfg: SSRModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu",
                  par: Optional[col.Parallel] = None) -> KVCache:
    """Zeroed buffers for every layer and this rank's heads (``par``)."""
    shape = (cfg.num_layers, batch, local_heads(cfg, par), max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def prefill_uses_kernel(cfg: SSRModelConfig, dtype) -> bool:
    """Whether the prefill's attention is the flash kernel: where its inputs
    are what the kernel takes, bf16 at head width 128. Every other prefill
    (fp32, or another head width) is the einsum ``_attend``, as JAX's
    prefill is at any shape and dtype."""
    return dtype == torch.bfloat16 and cfg.head_dim == HEAD_DIM


def prefill_bias(key_valid: torch.Tensor) -> torch.Tensor:
    """JAX's prefill mask as an additive fp32 bias [B, 1, S, S]: -1e9 on the
    keys after the query and on the banned keys (``key_valid`` 0) for every
    query, 0 elsewhere."""
    s = key_valid.shape[1]
    idx = torch.arange(s, device=key_valid.device)
    banned = (idx[None, :] > idx[:, None])[None] | (key_valid == 0)[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=key_valid.device)
    return torch.where(banned, -1e9, zero)[:, None]


def transformer_prefill(params, h: torch.Tensor, cache: KVCache,
                        cfg: SSRModelConfig, *, key_valid: torch.Tensor,
                        dtype=torch.bfloat16) -> Tuple[torch.Tensor, KVCache]:
    """Forward over the prompt while filling the cache at ``cache.length``,
    a host int (the prefills fill from 0): the K/V go in at a static offset,
    so the function reads nothing back from the device and a CUDA graph can
    capture it.

    ``key_valid`` [B, S]: 1 = attendable key, 0 = banned. The route is taken
    once, before the layer loop (:func:`prefill_uses_kernel`). On the kernel's
    route every layer's attention is ``flash_attend_xy`` with ``key_valid`` as
    segment ids: a query of segment 1 attends exactly the causal prefix minus
    the banned keys, which is the JAX prefill's additive mask for every row
    whose output is read. Otherwise it is ``_attend`` over
    :func:`prefill_bias`, JAX's mask on every row.
    Returns (hidden [B, S, D], cache with its fill as a [1] device
    tensor)."""
    act = _ffn_act(cfg, deterministic=True)
    par = parallel_of(params)
    nhead = local_heads(cfg, par)
    use_kernel = prefill_uses_kernel(cfg, dtype)
    bias = None if use_kernel else prefill_bias(key_valid)
    h = h.to(dtype)
    start, s = cache.length, h.shape[1]
    if isinstance(start, torch.Tensor):
        raise TypeError("transformer_prefill fills from a host offset; got "
                        "a device tensor as cache.length")

    def attend(l, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        cache.k[l, :, :, start:start + s] = k
        cache.v[l, :, :, start:start + s] = v
        return _merge_heads(flash_attend_xy(q, k, v, key_valid) if use_kernel
                            else _attend(q, k, v, bias))

    out = _inference_layers(params, layer_params(params), h, attend, act,
                            par, nhead)
    return out, KVCache(cache.k, cache.v, torch.full(
        (1,), start + s, dtype=torch.int64, device=h.device))


def _write_at(buf: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """buf [B, H, T, Dh] <- new [B, H, 1, Dh] at column ``pos`` ([1] int64 on
    the device), clamped to the buffer as JAX drops an out-of-range write
    (only a step past a loop's end writes there, and nothing reads it)."""
    buf.index_copy_(2, pos.clamp(max=buf.shape[2] - 1), new.to(buf.dtype))


def _as_pos(length, device) -> torch.Tensor:
    """A cache fill as a [1] int64 tensor on ``device``."""
    if isinstance(length, torch.Tensor):
        return length.reshape(1)
    return torch.full((1,), int(length), dtype=torch.int64, device=device)


def _read_window(length, window: Optional[int], size: int) -> int:
    """Keys a step reads: ``window`` when given, else the fill plus the new
    token when the fill is a host int (the whole buffer when it is on the
    device)."""
    if window is not None:
        return min(int(window), size)
    if isinstance(length, torch.Tensor):
        return size
    return min(length + 1, size)


def decode_bias(key_banned: torch.Tensor, length: int,
                pos=None) -> torch.Tensor:
    """[B, 2] banned key range [lo, hi) -> additive bias [B, 1, 1, length];
    keys beyond ``pos`` (an int or a [1] tensor: the current token's
    position) are banned too."""
    idx = torch.arange(length, device=key_banned.device)[None, :]
    banned = (idx >= key_banned[:, :1]) & (idx < key_banned[:, 1:2])
    if pos is not None:
        banned = banned | (idx > pos)
    zero = torch.zeros((), dtype=torch.float32, device=key_banned.device)
    return torch.where(banned, -1e9, zero)[:, None, None, :]


def transformer_decode_step(params, h_t: torch.Tensor, cache: KVCache,
                            key_banned: torch.Tensor, cfg: SSRModelConfig, *,
                            dtype=torch.bfloat16, layers=None,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: h_t [B, D] at position ``cache.length`` (a host int
    or a [1] device tensor, which a captured graph reads there).

    key_banned: [B, 2] banned key range [lo, hi) per row (text padding and the
    CFG-unconditional row's hidden prompt). The step writes the new K/V at
    the position with a device index and reads keys [0, ``window``)
    (default: [0, length] for a host int, the whole buffer for a device
    fill); keys past the position are masked with -1e9, which adds exact
    zeros to the same softmax, as JAX's read of its whole stage buffer does.
    Returns (out [B, D], cache advanced by one); the new K/V are written
    into the cache in place. ``layers`` may pass ``layer_params(params)``
    precomputed."""
    act = _ffn_act(cfg, deterministic=True)
    par = parallel_of(params)
    nhead = local_heads(cfg, par)
    pos = cache.length
    if not isinstance(pos, torch.Tensor) and pos >= cache.max_len:
        raise ValueError(f"KV cache full ({cache.max_len} positions)")
    w = _read_window(pos, window, cache.max_len)
    pos_t = _as_pos(pos, h_t.device)
    h = h_t.to(dtype)[:, None, :]
    bias = decode_bias(key_banned, w, pos_t)

    def attend(l, q, k, v):
        _write_at(cache.k[l], pos_t, k)
        _write_at(cache.v[l], pos_t, v)
        return _merge_heads(_attend(q, cache.k[l, :, :, :w],
                                    cache.v[l, :, :, :w], bias))

    out = _inference_layers(params, layers or layer_params(params), h,
                            attend, act, par, nhead)
    return out[:, 0, :], KVCache(cache.k, cache.v, pos + 1)


def transformer_decode_step_shared(params, h_t: torch.Tensor, pfx: KVCache,
                                   gen: KVCache, key_banned: torch.Tensor,
                                   cfg: SSRModelConfig, *, n_groups: int,
                                   dtype=torch.bfloat16, layers=None,
                                   window: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode of ``n_groups * S`` chains over a shared prompt cache
    (JAX ``transformer_decode_step_shared``).

    h_t: [B, D], B = n_groups * S in group-major rows. ``pfx`` [L, G, H, Tp,
    Dh] holds each group's prompt once, read once a step for its S chains;
    ``gen`` [L, B, H, Tg, Dh] holds each chain's generated positions, and the
    new K/V are written into it in place at ``gen.length``. ``key_banned``
    is the banned prefix key range [G, 2] or a bool mask [G, >= Tp] that the
    multi-prompt prefill builds; keys at and beyond ``pfx.length`` are
    banned too. Both lengths are host ints or [1] device tensors. Read: the
    prefix [0, pfx.length) for a host int, else the whole prefix buffer;
    the generated cache [0, ``window``) (default: [0, gen.length] for a
    host int, else the whole buffer), keys past the current position masked
    with -1e9: JAX reads both whole buffers with the rest masked, which adds
    exact zeros to the same softmax. The arithmetic is JAX's: q scaled (in
    ``dtype``) before the products, fp32 scores and one softmax over
    [prefix ; generated], probabilities in ``dtype``, the last residual
    ``(h + ff @ w2) + b2``. Returns (out [B, D], gen advanced by one)."""
    act = _ffn_act(cfg, deterministic=True)
    par = parallel_of(params)
    b, _ = h_t.shape
    s = b // n_groups
    nhead, dh = local_heads(cfg, par), cfg.head_dim
    d = nhead * dh
    dev = h_t.device
    gpos = gen.length
    if not isinstance(gpos, torch.Tensor) and gpos >= gen.max_len:
        raise ValueError(f"generated KV cache full ({gen.max_len} positions)")
    tp = (pfx.max_len if isinstance(pfx.length, torch.Tensor)
          else min(pfx.length, pfx.max_len))
    wg = _read_window(gpos, window, gen.max_len)
    gpos_t = _as_pos(gpos, dev)
    idx = torch.arange(tp, device=dev)[None, :]
    if key_banned.dtype == torch.bool:
        pfx_banned = key_banned[:, :tp]
    else:
        pfx_banned = (idx >= key_banned[:, :1]) & (idx < key_banned[:, 1:2])
    pfx_banned = pfx_banned | (idx >= pfx.length)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pfx_bias = torch.where(pfx_banned, -1e9, zero)[:, None, None, :]
    gcols = torch.arange(wg, device=dev)
    gen_bias = torch.where(gcols > gpos_t, -1e9, zero)  # [wg]
    scale = decode_attention.step_scale(dh, dtype, dev)
    h = h_t.to(dtype)[:, None, :]

    def attend(l, q, k, v):  # q, k, v [B, H, 1, Dh]
        _write_at(gen.k[l], gpos_t, k)
        _write_at(gen.v[l], gpos_t, v)
        qs = q * scale
        # prefix scores: the group's K read once for its S chains [G, H, S, Tp]
        qg = qs.reshape(n_groups, s, nhead, dh).transpose(1, 2)
        sp = torch.matmul(qg.float(), pfx.k[l, :, :, :tp].float()
                          .transpose(-1, -2)) + pfx_bias
        sg = torch.matmul(qs.float(), gen.k[l, :, :, :wg].float()
                          .transpose(-1, -2)) + gen_bias  # [B, H, 1, wg]
        sg = sg.reshape(n_groups, s, nhead, wg).transpose(1, 2)
        p = torch.softmax(torch.cat([sp, sg], dim=-1), dim=-1).to(dtype)
        out_p = torch.matmul(p[..., :tp], pfx.v[l, :, :, :tp])  # [G, H, S, Dh]
        pg = p[..., tp:].transpose(1, 2).reshape(b, nhead, 1, wg)
        out_g = torch.matmul(pg, gen.v[l, :, :, :wg])  # [B, H, 1, Dh]
        attn = out_p.transpose(1, 2).reshape(b, nhead, 1, dh) + out_g
        return attn.reshape(b, 1, d)

    out = _inference_layers(params, layers or layer_params(params), h,
                            attend, act, par, nhead)
    return out[:, 0, :], KVCache(gen.k, gen.v, gpos + 1)


def transformer_decode_step_paged(params, h_t: torch.Tensor, pfx: KVCache,
                                  gen: KVCache, key_banned: torch.Tensor,
                                  gen_len: torch.Tensor, cfg: SSRModelConfig,
                                  *, dtype=torch.bfloat16, read_len=None,
                                  layers=None) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode with a generated-cache write column per row (JAX
    ``transformer_decode_step_paged``), for the continuous-batching server,
    which refills a finished chain's row with a new request that restarts
    at column 0 while the other rows are mid-flight.

    h_t: [B, D], one row per chain (cond rows, then uncond rows). ``pfx``
    [L, B, H, Tp, Dh] holds each row's prompt and ``key_banned`` [B, Tp]
    (bool) its dead keys; ``gen`` [L, B, H, Tg, Dh] the generated K/V, whose
    ``length`` is not used. Row r attends generated columns ``< gen_len[r]``
    only (the strict mask), so a refilled row never reads the previous
    occupant's K/V; the current token's score is one extra softmax column
    over [prefix | generated | current] in fp32, and the probabilities are
    cast to ``dtype`` before the three PV products. q is scaled (in
    ``dtype``) before the products, the prefix bias is -1e9 on
    ``key_banned`` and the last residual is ``(h + ff @ w2) + b2``.

    Reads: keys [0, pfx.length) of the prefix and columns [0, ``read_len``)
    of the generated cache, a static window (default: all of Tg) that must
    hold ``max(gen_len)``; the server passes the stage window that bounds
    it for the graph's steps. JAX reads both whole buffers; the columns
    left out are masked there, exact zeros of the same softmax. All layers'
    K/V land in one scatter after the layer loop, at column ``gen_len[r]``
    of each row r (clamped to the buffer, where JAX drops an out-of-range
    write; a caller never lets a row reach it). Returns (out [B, D], gen),
    the cache written in place.

    Each layer's attention is ``ops.decode_attention.paged_attention``: on
    a CUDA bf16 step at head width 128 the hand-written kernel, which reads
    the bf16 caches in place and only their live keys, and adds the three
    partial outputs in fp32 before one rounding; elsewhere the plain
    arithmetic above."""
    act = _ffn_act(cfg, deterministic=True)
    par = parallel_of(params)
    b, _ = h_t.shape
    nhead, dh = local_heads(cfg, par), cfg.head_dim
    d = nhead * dh
    tp, tg = pfx.length, gen.max_len
    rl = tg if read_len is None else min(int(read_len), tg)
    dev = h_t.device
    h = h_t.to(dtype)[:, None, :]
    ks, vs = [], []

    def attend(l, q, k, v):  # q, k, v [B, H, 1, Dh]
        ks.append(k[:, :, 0])
        vs.append(v[:, :, 0])
        return decode_attention.paged_attention(
            q, k, v, pfx.k[l], pfx.v[l], gen.k[l], gen.v[l], key_banned,
            gen_len, tp, rl).reshape(b, 1, d)

    out = _inference_layers(params, layers or layer_params(params), h,
                            attend, act, par, nhead)
    # one scatter for all layers: row r writes column gen_len[r]
    rows = torch.arange(b, device=dev)
    col = gen_len.clamp(max=tg - 1)
    gen.k[:, rows, :, col] = torch.stack(ks).to(gen.k.dtype).transpose(0, 1)
    gen.v[:, rows, :, col] = torch.stack(vs).to(gen.v.dtype).transpose(0, 1)
    return out[:, 0, :], gen


# ------------------------------------------------------------ the block seam

@dataclass(frozen=True)
class DecoderBlock:
    """A decoder block as the inference layer runs it: ``models.ssr.
    decoder_block`` picks one a config, and ``inference/`` calls these and
    names no block. Each step takes its chains' audio positions ``y_pos``
    [S] (rows are [cond; uncond] under CFG), which a block with RoPE turns
    into its own positions and this module's block ignores.

    - ``init_cache(cfg, batch, max_len, *, dtype, device, par)``: a zeroed
      cache whose ``buffers()`` hold rows on dim 1;
    - ``layers(decoder)``: the per-layer views the steps take as ``layers``;
    - ``dtype(params)``: the compute dtype, that of the matmul weights;
    - ``prefill(decoder, h, cache, cfg, *, key_valid, dtype, sx)``, ``sx``
      the text block's width;
    - ``step(decoder, h, cache, banned, cfg, *, y_pos, dtype, layers,
      window)``: ``decode.generate``'s step;
    - ``shared_step(decoder, h, pfx, gen, banned, cfg, *, y_pos, n_groups,
      dtype, layers, window)``: the shared-prompt step, or None (then
      ``generate_batch`` and ``generate_multi`` refuse the block);
    - ``paged_step(decoder, h, pfx, gen, banned, gen_len, cfg, *, y_pos,
      dtype, read_len, layers, counts, live)``: the continuous server's;
    - ``counters(cfg, device)``: the tensor the paged steps count into
      (``counts``), or None; ``read_counters(counts)`` returns the counts
      since the last read as ``stats`` entries and resets them."""

    name: str
    init_cache: Callable
    layers: Callable
    dtype: Callable
    prefill: Callable
    step: Callable
    shared_step: Optional[Callable]
    paged_step: Callable
    counters: Callable = lambda cfg, device: None
    read_counters: Optional[Callable] = None

    def refuse(self, what: str) -> None:
        """Raise for ``what``, a path this block does not run."""
        raise ValueError(f"{what} does not run {self.name}: it runs on "
                         f"decode.generate and the continuous server only")

    def require_shared(self, what: str) -> None:
        """Raise for ``what``, a path of the shared-prompt step, unless the
        block has one."""
        if self.shared_step is None:
            self.refuse(what)


def _ignoring(fn, *names):
    """``fn`` taking the block's keywords ``names``, which it has no use
    for, and dropping them."""
    def call(*args, **kw):
        for name in names:
            del kw[name]
        return fn(*args, **kw)
    return call


BLOCK = DecoderBlock(
    name="the e830M block", init_cache=init_kv_cache, layers=layer_params,
    dtype=lambda params: params["decoder"]["layers"]["qkv_w"].dtype,
    prefill=_ignoring(transformer_prefill, "sx"),
    step=_ignoring(transformer_decode_step, "y_pos"),
    shared_step=_ignoring(transformer_decode_step_shared, "y_pos"),
    paged_step=_ignoring(transformer_decode_step_paged, "y_pos", "counts",
                         "live"))
