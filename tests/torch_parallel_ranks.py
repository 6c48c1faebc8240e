"""Rank bodies of the port's multi-rank tests.

``ssr_speech_tpu_torch.parallel.dist.spawn`` runs these in fresh
interpreters joined over gloo on the CPU. They import torch and the port
only (never JAX), take numpy inputs that the test made from a seed (and ran
through the JAX package in its own process), and return numpy results; each
spawn runs several checks, because starting the ranks costs seconds."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.parallel import collectives as col
from ssr_speech_tpu_torch.parallel import mesh as meshlib
from ssr_speech_tpu_torch.training import optim as toptim
from ssr_speech_tpu_torch.training.trainer import make_train_step
from ssr_speech_tpu_torch.utils.tree import tree_leaves, tree_map


def as_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def as_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


# ------------------------------------------------------------ collectives

def collective_grads(seed: int):
    """Each operator's forward and input gradient on a tp=world mesh, for
    the test to hold against the unsharded function: y = x @ a then a
    row-parallel b (copy_to_tp / reduce_from_tp), and the sequence forms
    (split_seq -> gather_seq / scatter_seq), and gather_replicated."""
    mesh = meshlib.make_mesh(tp=dist.get_world_size())
    par = mesh.parallel()
    n, r = par.tp_size, par.tp_rank
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 8, 4, generator=g)
    a = torch.randn(4, 6 * n, generator=g)
    b = torch.randn(6 * n, 5, generator=g)
    w = torch.randn(3, 8, 5, generator=g)
    out = {}
    # Megatron MLP: copy_to_tp -> column block -> row block -> reduce_from_tp
    xx = x.clone().requires_grad_(True)
    al = a.chunk(n, dim=1)[r].clone().requires_grad_(True)
    bl = b.chunk(n, dim=0)[r].clone().requires_grad_(True)
    y = col.reduce_from_tp(col.copy_to_tp(xx, par) @ al @ bl, par)
    (y * w).sum().backward()
    out["mlp"] = dict(y=y.detach().numpy(), dx=xx.grad.numpy(),
                      da=meshlib.full_tensor(mesh, al.grad, (None, "tp")).numpy(),
                      db=meshlib.full_tensor(mesh, bl.grad, ("tp", None)).numpy())
    # sequence parallel: split -> gather -> column -> row -> scatter -> gather
    xx = x.clone().requires_grad_(True)
    al = a.chunk(n, dim=1)[r].clone().requires_grad_(True)
    bl = b.chunk(n, dim=0)[r].clone().requires_grad_(True)
    xs = col.split_seq(xx, par)
    ys = col.scatter_seq(col.gather_seq(xs, par) @ al @ bl, par)
    y = col.gather_replicated(ys, par, dim=1)
    (y * w).sum().backward()
    out["sp"] = dict(y=y.detach().numpy(), dx=xx.grad.numpy(),
                     da=meshlib.full_tensor(mesh, al.grad, (None, "tp")).numpy(),
                     db=meshlib.full_tensor(mesh, bl.grad, ("tp", None)).numpy())
    # fsdp: a stack of 2n layers shared out, layer l broadcast from its owner
    stack = torch.randn(2 * n, 4, 4, generator=g)
    loc = stack.chunk(n, dim=0)[r].clone().requires_grad_(True)
    fpar = col.Parallel(fsdp_group=mesh.group("tp"), fsdp_size=n, fsdp_rank=r)
    h = x
    for l in range(2 * n):
        h = torch.tanh(h @ col.fsdp_layer(loc, l, fpar))
    (h * w[..., :4]).sum().backward()
    out["fsdp"] = dict(y=h.detach().numpy(),
                       dstack=meshlib.full_tensor(mesh, loc.grad, ("tp", None, None)).numpy())
    out["inputs"] = dict(x=x.numpy(), a=a.numpy(), b=b.numpy(), w=w.numpy(),
                         stack=stack.numpy())
    return out


# ---------------------------------------------------------------- the LM

def _model(mesh, params_np, cfg, fsdp=False, specs=None):
    specs = specs or meshlib.ssr_param_specs(fsdp=fsdp)
    return meshlib.shard_model(mesh, as_torch(params_np), specs,
                               mesh.parallel(fsdp=fsdp), cfg=cfg)


def _generators(mesh, seed=1):
    g = torch.Generator().manual_seed(seed + 1000003 * mesh.rank("dp"))
    h = torch.Generator().manual_seed(seed + 7919 * (1 + mesh.rank("tp")))
    return g, h


def lm_cases(cases, params_np, batch_np):
    """Run each case whose ``dp * tp`` is the world size. A case: dict(name,
    dp, tp, cfg, tcfg, sp=False, fsdp=False, step=False, poison=None).
    Returns {name: results}: the global loss and top-10 sums, the gathered
    gradients (rank 0), and with ``step`` the gathered parameters after one
    optimizer step, the skip flag, each rank's optimizer scalars and its
    local leaves (for the cross-rank checks)."""
    world = dist.get_world_size()
    out = {}
    for case in cases:
        if case["dp"] * case["tp"] != world:
            continue
        if case.get("memory"):
            out[case["name"]] = fsdp_memory(case["cfg"], batch_np)
            continue
        mesh = meshlib.make_mesh(tp=case["tp"])
        cfg, tcfg = case["cfg"], case["tcfg"]
        params = params_np
        if case.get("poison") is not None:  # a token only one dp rank sees
            params = tree_map(np.array, params_np)
            params["text_emb"][case["poison"]] = np.nan
        model = _model(mesh, params, cfg, fsdp=case.get("fsdp", False))
        specs = model.specs
        opt, _ = toptim.build_optimizer(tcfg.optim, 100)
        opt.set_sharding(meshlib.shard_groups(mesh, specs))
        state = opt.init(model.tree())
        step = make_train_step(cfg, tcfg, opt, torch.device("cpu"), mesh=mesh,
                               sequence_parallel=case.get("sp", False))
        gen, hgen = _generators(mesh)
        res = {}
        if case.get("step"):
            m = step(model, state, batch_np, gen, hgen)
            res["skipped"] = m["skipped"]
            res["params"] = as_numpy(meshlib.gather_tree(mesh, model.tree(), specs))
            res["local"] = as_numpy(model.tree())
            shapes = {tuple(p.shape) for p in tree_leaves(model.tree())}
            res["opt_scalars"] = [t.detach().numpy().copy() for t in
                                  tree_leaves(state)
                                  if tuple(t.shape) not in shapes or t.numel() == 1]
            res["opt_state"] = as_numpy(meshlib.gather_state(
                mesh, state, model.tree(), specs))
        else:
            grads, m = step.gradients(model, batch_np, gen, hgen)
            res["grads"] = as_numpy(meshlib.gather_tree(mesh, grads, specs))
            for p in tree_leaves(model.tree()):
                p.grad = None
        res["loss"] = float(m["loss"])
        res["top10acc"] = float(m["top10acc"])
        res["ntokens"] = float(m["ntokens"])
        res["coords"] = mesh.coords
        out[case["name"]] = res
    return out


class _Allocations(TorchDispatchMode):
    """Bytes of the new tensors the ops under it make (an op's output on
    storage none of its inputs hold)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        held = {t.untyped_storage().data_ptr() for t in
                pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in held):
                held.add(t.untyped_storage().data_ptr())
                self.bytes += t.untyped_storage().nbytes()
        return out


def fsdp_memory(cfg, batch_np):
    """What an fsdp step holds and allocates, against dp, on dp = world
    ranks: for fsdp in (False, True) and each remat mode, one forward and
    backward of the LM (no dropout) with

    - ``saved``: the bytes autograd keeps for the backward outside the
      parameters (``saved_tensors_hooks`` around the forward; storages
      counted once; a checkpointed layer's own saves are the checkpoint's);
    - ``alive``: the gathered layers of the forward still alive when the
      backward starts, and their bytes (weak references);
    - ``calls``: per ``_FsdpLayer.backward`` call, the bytes it allocates,
      the layer's bytes, the local stack's bytes and whether the call made
      the stack's ``.grad`` buffer.

    Also the bytes of one layer and of the local parameters."""
    import dataclasses
    import weakref

    from ssr_speech_tpu_torch.training.trainer import dp_rows
    from ssr_speech_tpu_torch.utils import prng

    mesh = meshlib.make_mesh(tp=1)
    params_np = as_numpy(tssr.init_ssr(prng.PRNGKey(0), cfg))
    batch = {k: torch.as_tensor(v) for k, v in dp_rows(batch_np, mesh).items()}
    gather, backward = col.fsdp_layer, col._FsdpLayer.backward
    out = {}
    for fsdp in (False, True):
        for remat in ("none", "full", "dots_masks"):
            c = dataclasses.replace(cfg, remat=remat)
            model = _model(mesh, params_np, c, fsdp=fsdp)
            params = tree_leaves(model.tree())
            own = {p.untyped_storage().data_ptr() for p in params}
            gathered, calls, saved = [], [], {}
            forward = [True]

            def spy_gather(stack, layer, par):
                t = gather(stack, layer, par)
                if forward[0]:
                    gathered.append((weakref.ref(t), t.nbytes))
                return t

            def spy_backward(ctx, g):
                before = ctx.stack.grad is None
                with _Allocations() as a:
                    res = backward(ctx, g)
                made = before and ctx.stack.grad is not None
                calls.append(dict(bytes=a.bytes, made=made,
                                  layer=ctx.stack[0].nbytes,
                                  stack=ctx.stack.nbytes))
                return res

            def pack(t):
                ptr = t.untyped_storage().data_ptr()
                if ptr not in own:
                    saved[ptr] = t.untyped_storage().nbytes()
                return t

            col.fsdp_layer, col._FsdpLayer.backward = spy_gather, spy_backward
            try:
                with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                    loss = tssr.ssr_forward(model, c, batch, deterministic=True,
                                            remat=remat, par=model.parallel)["loss"]
                forward[0] = False
                live = [n for ref, n in gathered if ref() is not None]
                loss.backward()
            finally:
                col.fsdp_layer, col._FsdpLayer.backward = gather, backward
            out[f"{'fsdp' if fsdp else 'dp'} {remat}"] = dict(
                saved=sum(saved.values()), alive=len(live),
                alive_bytes=sum(live), gathered=len(gathered), calls=calls,
                local_bytes=sum(p.nbytes for p in params))
    layers = params_np["decoder"]["layers"]
    out["layer_bytes"] = sum(v[0].nbytes for v in layers.values())
    out["layers"] = cfg.num_layers
    return out


def shard_round_trip(params_np):
    """shard_tree then gather_tree on a (dp, tp) = (world / 2, 2) mesh, with
    and without fsdp; and each rank's qkv block, for the test to check q, k
    and v were split. Returns {fsdp: results}."""
    mesh = meshlib.make_mesh(tp=2)
    full = as_torch(params_np)
    out = {}
    for fsdp in (False, True):
        specs = meshlib.ssr_param_specs(fsdp=fsdp)
        local = meshlib.shard_tree(mesh, full, specs)
        back = meshlib.gather_tree(mesh, local, specs)
        out[fsdp] = dict(back=as_numpy(back), coords=mesh.coords,
                         qkv_w=local["decoder"]["layers"]["qkv_w"].numpy().copy())
    return out


# --------------------------------------------------------------- pipeline

def pipeline_cases(cases):
    """Each case whose ``pp * tp`` is the world (dp = 1). ``forward``:
    ``pipeline_transformer`` on h_mb with bias_mb or key_valid_mb;
    ``step``: one ``make_pp_train_step`` step, the gathered parameters and
    the metrics."""
    from ssr_speech_tpu_torch.parallel import pipeline as tpl

    world = dist.get_world_size()
    out = {}
    for case in cases:
        if case["pp"] * case["tp"] != world:
            continue
        mesh = tpl.make_pp_mesh(pp=case["pp"], tp=case["tp"])
        cfg = case["cfg"]
        model = tpl.shard_params_pp(mesh, as_torch(case["params"]), cfg)
        if case["kind"] == "forward":
            kw = {k: torch.from_numpy(case[k]) for k in ("bias_mb", "key_valid_mb")
                  if case.get(k) is not None}
            y = tpl.pipeline_transformer(model["decoder"],
                                         torch.from_numpy(case["h_mb"]), cfg,
                                         mesh, remat=case.get("remat", "none"),
                                         **kw)
            out[case["name"]] = dict(out=y.numpy())
            continue
        tcfg = case["tcfg"]
        opt, _ = toptim.build_optimizer(tcfg.optim, 100)
        opt.set_sharding(meshlib.shard_groups(mesh, model.specs))
        state = opt.init(model.tree())
        step = tpl.make_pp_train_step(cfg, tcfg, opt, mesh, torch.device("cpu"),
                                      n_micro=case["n_micro"])
        m = step(model, state, case["batch"], torch.Generator().manual_seed(7))
        out[case["name"]] = dict(
            params=as_numpy(meshlib.gather_tree(mesh, model.tree(), model.specs)),
            loss=float(m["loss"]), ntokens=float(m["ntokens"]),
            top10acc=float(m["top10acc"]), skipped=m["skipped"])
    return out


def trainer_pp_loop(cfg, tcfg, root, exp_dir, n_micro):
    """``Trainer`` over a pp=2 mesh (dp and tp from the world) on a corpus:
    two steps; returns the history and whether this rank wrote files."""
    import os

    from ssr_speech_tpu_torch.data.batching import BucketBatcher
    from ssr_speech_tpu_torch.data.dataset import SpeechDataset
    from ssr_speech_tpu_torch.parallel import pipeline as tpl
    from ssr_speech_tpu_torch.training.trainer import Trainer

    mesh = tpl.make_pp_mesh(pp=2)
    ds = SpeechDataset(cfg, tcfg.data, tcfg.masking, "train")
    tb = BucketBatcher(ds, cfg, tcfg.data, world_size=mesh.size("dp") * n_micro)
    tr = Trainer(cfg, tcfg, tb, None, phn2num=ds.phn2num, exp_dir=exp_dir,
                 device="cpu", mesh=mesh, pp=2, n_micro=n_micro)
    progress = tr.train()
    return dict(step=progress["step"], history=tr.history, rank=dist.get_rank(),
                files=sorted(os.listdir(exp_dir)) if os.path.isdir(exp_dir) else [])


# ------------------------------------------------------ sharded checkpoints

def sharded_checkpoint(params_np, cfg, cases, batch):
    """Each case ``(path, (tp, fsdp) saved, (tp, fsdp) loaded)``:
    ``save_sharded`` over one layout of the world, then ``load_sharded``
    into the other; returns per case the restored blocks gathered and the
    restored layout's loss on ``batch``."""
    from ssr_speech_tpu_torch.training.trainer import dp_rows
    from ssr_speech_tpu_torch.utils import checkpoint as ck

    out = []
    for path, (tp_s, fsdp_s), (tp_l, fsdp_l) in cases:
        mesh = meshlib.make_mesh(tp=tp_s)
        specs = meshlib.ssr_param_specs(fsdp=fsdp_s)
        local = meshlib.shard_tree(mesh, as_torch(params_np), specs)
        ck.save_sharded(path, local, mesh, specs)
        mesh = meshlib.make_mesh(tp=tp_l)
        specs = meshlib.ssr_param_specs(fsdp=fsdp_l)
        template = tree_map(torch.zeros_like,
                            meshlib.shard_tree(mesh, as_torch(params_np), specs))
        restored = ck.load_sharded(path, template, mesh, specs)
        model = meshlib.shard_model(mesh, as_torch(params_np), specs,
                                    mesh.parallel(fsdp=fsdp_l), cfg=cfg,
                                    trainable=False)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(model.tree()), tree_leaves(restored)):
                dst.copy_(src)
            res = tssr.ssr_forward(model, cfg, {k: torch.from_numpy(np.asarray(v))
                                                for k, v in
                                                dp_rows(batch, mesh).items()})
        loss = res["loss"].reshape(1)
        if mesh.group("dp") is not None:
            loss = col.all_reduce(loss, mesh.group("dp"))
        out.append(dict(gathered=as_numpy(meshlib.gather_tree(mesh, restored,
                                                              specs)),
                        loss=float(loss[0])))
    return out


# ------------------------------------------------------------------ codec

def codec_dp_step(state_np, cfg, wav, labels, keep, lr):
    """One data-parallel watermark-codec step over the world: this rank's
    block of rows; returns the metrics and the whole state as numpy."""
    from ssr_speech_tpu_torch.models.from_jax import (
        codec_train_state_from_jax, codec_train_state_to_numpy)
    from ssr_speech_tpu_torch.training import codec_trainer as tct

    n, r = dist.get_world_size(), dist.get_rank()
    rows = slice(r * (wav.shape[0] // n), (r + 1) * (wav.shape[0] // n))
    state = codec_train_state_from_jax(state_np, cfg)
    step = tct.make_codec_train_step(cfg, tct.make_optimizers(lr), ema_decay=0.99,
                                     dp_group=dist.group.WORLD)
    state, m = step(state, *(torch.from_numpy(np.array(a[rows]))
                             for a in (wav, labels, keep)))
    return dict(metrics={k: float(v) for k, v in m.items()},
                state=codec_train_state_to_numpy(state))


# -------------------------------------------------------------------- CLIs

def run_train_lm(argv, resume_argv=None):
    """``train_lm.main`` on this rank (the group is the spawn's), then
    optionally a resumed run; returns each run's history."""
    from ssr_speech_tpu_torch import train_lm

    out = dict(rank=dist.get_rank(), history=train_lm.main(argv).history)
    if resume_argv is not None:
        out["resumed"] = train_lm.main(resume_argv).history
    return out


def run_train_codec(argv):
    from ssr_speech_tpu_torch import train_codec

    run = train_codec.main(argv)
    return dict(rank=dist.get_rank(), history=run["history"],
                bundle=run["bundle"], eval_sisnr=run["eval_sisnr"])


# ---------------------------------------------------------------- serving

def tp_serving(params_np, cfg, layouts, codec_np=None, codec_cfg=None):
    """For each layout ``(tp, fsdp, cases)`` (tp None: the world): the cases
    through the port's serving paths on parameters sharded over tp and,
    with ``fsdp``, the layer stacks over dp (``shard_params_for_serving``),
    fp32 on the CPU. A case: (name, kind, args) with kind generate /
    generate_batch / generate_multi / serve / stream; every run gets
    ``torch.Generator().manual_seed(0)``. Returns, per layout, {name:
    result} (None where this rank returns nothing)."""
    from ssr_speech_tpu_torch.inference import decode as tdecode
    from ssr_speech_tpu_torch.inference import serve as tserve
    from ssr_speech_tpu_torch.inference import stream as tstream
    from ssr_speech_tpu_torch.models.from_jax import codec_from_jax, lm_from_jax

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    results = []
    for tp, fsdp, cases in layouts:
        mesh = meshlib.make_mesh(tp=tp or dist.get_world_size())
        model = meshlib.shard_params_for_serving(
            mesh, lm_from_jax(params_np, cfg), fsdp=fsdp)
        out = {}
        for name, kind, args in cases:
            if kind == "generate":
                dec, x, y, mask = args
                out[name] = tdecode.generate(model, cfg, dec, x, y, mask, gen())
            elif kind == "generate_batch":
                dec, x, y, mask, n = args
                out[name] = tdecode.generate_batch(model, cfg, dec, x, y, mask,
                                                   gen(), n_samples=n)
            elif kind == "generate_multi":
                dec, prompts = args
                out[name] = tdecode.generate_multi(model, cfg, dec, prompts,
                                                   gen())
            elif kind == "serve":
                dec, reqs, n_slots = args
                out[name] = tserve.serve_requests(model, cfg, dec, reqs, gen(),
                                                  n_slots=n_slots)
            elif kind == "stream":
                dec, reqs, geom = args
                codec = codec_from_jax(codec_np, codec_cfg)
                srv = tstream.StreamingServer(model, cfg, dec, codec, codec_cfg,
                                              2, **geom)
                got = srv.run_online(reqs, [0.0, 0.0, 0.01], generator=gen())
                out[name] = None if got is None else got[0]
        results.append(out)
    return results


# ------------------------------------------------------ gradient buckets

def bucketed_sums(seed: int):
    """``trainer._sum_grads`` over the world (fp32, bf16 and a transposed
    gradient) at buckets of 7 elements and at the default size, beside one
    flat fp32 all-reduce of the same gradients cast back: the three as
    numpy lists."""
    from ssr_speech_tpu_torch.training import trainer

    def grads():
        g = torch.Generator().manual_seed(seed + dist.get_rank())
        return [torch.randn(5, 3, generator=g),
                torch.randn(11, generator=g).bfloat16(),
                torch.randn(4, 6, generator=g).t(),
                torch.randn(2, generator=g)]

    group = dist.group.WORLD
    flat_in = grads()
    flat = torch.cat([t.reshape(-1).float() for t in flat_in])
    dist.all_reduce(flat, group=group)
    ref, i = [], 0
    for t in flat_in:
        ref.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    out = [[t.float().numpy() for t in ref]]
    for size in (7, trainer.GRAD_BUCKET):
        gs = grads()
        real, trainer.GRAD_BUCKET = trainer.GRAD_BUCKET, size
        try:
            trainer._sum_grads(gs, [group] * len(gs))
        finally:
            trainer.GRAD_BUCKET = real
        out.append([t.float().numpy() for t in gs])
    return out
