"""The rank code of the LM train step and decode on a mesh.

``spawn_ranks`` pickles these functions by reference, so each rank imports
this module, which imports no JAX.  ``tests/test_torch_train_mesh.py``
holds what they return against the port's no-mesh step and decode and the
reference's on a host mesh.
"""

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer
from repro_torch.optim import optimizers as t_opt
from repro_torch.sharding.specs import distribute, is_dtensor, spec_leaves, spec_placements
from repro_torch.train import loop as t_loop
from repro_torch.train.serve import make_serve_step


# a preset cut further: its changes, applied after reduced_config in both packages
VARIANTS = {"smollm-360m-gqa2": ("smollm-360m", {"num_kv_heads": 2})}  # 2 query heads a KV head


def variant(name: str, reduce, get) -> object:
    """``name``'s reduced config from a package's ``reduced_config`` and
    ``get_config``: a preset, or one of ``VARIANTS``."""
    base, changes = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(reduce(get(base)), **changes)


def mesh_config(arch: str):
    """The reduced preset the mesh tests train (float32, MoE aux losses on)."""
    return dataclasses.replace(variant(arch, reduced_config, get_config), ssm_chunk=16)


def batch_layout(ctx, batch: dict, accum: int) -> dict:
    """Each leaf of a step's batch split along the batch axes (after the
    microbatch axis when ``accum`` > 1), as a DTensor on ``ctx.mesh``."""
    from torch.distributed.tensor import distribute_tensor

    lead = (None,) if accum > 1 else ()
    out = {}
    for k, v in batch.items():
        names = lead + ("batch",) + (None,) * (v.dim() - len(lead) - 1)
        out[k] = distribute_tensor(v, ctx.mesh, spec_placements(ctx.mesh, ctx.spec(*names)))
    return out


def local_slices_match(tree, specs, mesh) -> int:
    """Check that every DTensor leaf of ``tree`` holds, on this rank, the
    slice of its full value that ``specs`` gives this rank (the placements
    its spec names, the offsets DTensor computes for the rank's mesh
    coordinate); returns the number of leaves checked."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    n = 0
    for x, spec in zip(t_opt.tree_leaves(tree), spec_leaves(specs)):
        want = spec_placements(mesh, spec)
        assert tuple(x.placements) == want, (x.placements, want)
        full = x.full_tensor()
        shape, offset = compute_local_shape_and_global_offset(full.shape, mesh, want)
        piece = full[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
        assert torch.equal(x.to_local(), piece), (spec, shape, offset)
        n += 1
    return n


def greedy(params, cfg, ctx, prompt: torch.Tensor, gen: int, max_len: int,
           use_kernels: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompt`` and decode ``gen`` greedy tokens through
    ``make_serve_step(cfg, ctx)``, as ``greedy_generate`` does: the tokens
    ``[B, gen]`` and each step's float32 logits ``[gen, B, V]``, whole (a
    DTensor's gathered)."""
    _, cache = transformer.prefill(params, cfg, {"tokens": prompt}, max_len, ctx)
    step = make_serve_step(cfg, ctx, use_kernels=use_kernels)
    tok, tokens, logits = prompt[:, -1:], [], []
    for i in range(gen):
        tok, lg, cache = step(params, cache, tok, prompt.shape[1] + i - 1)
        tokens.append(tok.full_tensor() if is_dtensor(tok) else tok)
        logits.append((lg.full_tensor() if is_dtensor(lg) else lg)[:, 0].float())
    return torch.cat(tokens, dim=1), torch.stack(logits)


def rank_decode(mesh, jobs: list) -> dict:
    """For each ``(name, arch, params, prompt, gen, max_len, overrides)``
    of ``jobs``: a greedy decode on ``mesh`` (``make_ctx(mesh, cfg,
    overrides)``; the cache laid out by ``cache_specs``, its positions
    split over ``model``, or over ``data`` and ``model`` with the
    long_500k overrides) with ``use_kernels=True`` and with
    ``use_kernels=False``, returning both runs' tokens and logits, and
    for the kernel route the calls of ``ops.decode_attention_partials``
    and ``ops.decode_attention_merge`` (and how many partials were empty)
    on each rank, in rank order."""
    out = {}
    for name, arch, plain, prompt, gen, max_len, overrides in jobs:
        cfg = mesh_config(arch)
        ctx = transformer.make_ctx(mesh, cfg, overrides)
        params = distribute(plain, transformer.param_specs(plain, cfg, ctx, zero1=False), mesh)
        tok = batch_layout(ctx, {"t": prompt}, 1)["t"]
        calls = {"partials": 0, "empty": 0, "merge": 0}
        partials, merge = ops.decode_attention_partials, ops.decode_attention_merge

        def counted_partials(*a, **kw):
            m, l, acc = partials(*a, **kw)
            calls["partials"] += 1
            calls["empty"] += int(not bool(torch.any(l > 0)))
            return m, l, acc

        def counted_merge(*a, **kw):
            calls["merge"] += 1
            return merge(*a, **kw)

        ops.decode_attention_partials, ops.decode_attention_merge = counted_partials, counted_merge
        try:
            kernel = greedy(params, cfg, ctx, tok, gen, max_len, True)
        finally:
            ops.decode_attention_partials, ops.decode_attention_merge = partials, merge
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, calls)
        out[name] = {"kernel": kernel, "plain": greedy(params, cfg, ctx, tok, gen, max_len, False),
                     "calls": every}
    out["heads_error"] = _heads_split_refusal(mesh)
    return out


def _heads_split_refusal(mesh) -> str:
    """The message of the error the kernel route raises on a cache split
    over heads ("" if none)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    cfg = t_attn.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=32)
    k = distribute_tensor(torch.zeros((2, 8, 2, 32)), mesh, (Replicate(), Shard(2)))
    qg = distribute_tensor(torch.zeros((2, 2, 2, 32)), mesh, (Replicate(), Replicate()))
    try:
        t_attn._decode_local(qg, k, k, 3, 1.0, cfg)
    except ValueError as e:
        return str(e)
    return ""


def rank_train(mesh, jobs: list, accum: int, lr: float, decodes: list) -> dict:
    """For each ``(arch, state, batches)`` of ``jobs``: ``len(batches)``
    adamw train steps on ``mesh`` from the plain ``state`` (the same on
    every rank), returning per-step metrics, the gathered masters after
    the last step and the number of leaves whose local shard was checked
    against ``state_specs`` before and after; then :func:`rank_decode` of
    ``decodes``."""
    out = {}
    for arch, state, batches in jobs:
        cfg = mesh_config(arch)
        ctx = transformer.make_ctx(mesh, cfg)
        opt = t_opt.adamw(lr)
        specs = t_loop.state_specs(state, cfg, ctx)
        dstate = distribute(state, specs, mesh)
        checked = local_slices_match(dstate, specs, mesh)
        step = t_loop.make_train_step(cfg, ctx, opt, t_loop.TrainSettings(grad_accum=accum))
        metrics = []
        for batch in batches:
            dstate, m = step(dstate, batch_layout(ctx, batch, accum))
            metrics.append({k: v.clone() for k, v in m.items()})
        checked += local_slices_match(dstate, specs, mesh)
        out[arch] = {"metrics": metrics, "checked": checked,
                     "params": t_opt.tree_map(lambda p: p.full_tensor(), dstate["params"]),
                     "step": int(dstate["step"].full_tensor())}
    out["decode"] = rank_decode(mesh, decodes)
    return out
