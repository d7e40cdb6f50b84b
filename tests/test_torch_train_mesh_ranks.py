"""The rank code of the LM train step on a mesh.

``spawn_ranks`` pickles these functions by reference, so each rank imports
this module, which imports no JAX.  ``tests/test_torch_train_mesh.py``
holds what they return against the port's no-mesh step and the
reference's step on a host mesh.
"""

import dataclasses

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer
from repro_torch.optim import optimizers as t_opt
from repro_torch.sharding.specs import distribute, spec_leaves, spec_placements
from repro_torch.train import loop as t_loop


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


def rank_train(mesh, jobs: list, accum: int, lr: float) -> dict:
    """For each ``(arch, state, batches)`` of ``jobs``: ``len(batches)``
    adamw train steps on ``mesh`` from the plain ``state`` (the same on
    every rank), returning per-step metrics, the gathered masters after
    the last step and the number of leaves whose local shard was checked
    against ``state_specs`` before and after; then, once, what a
    ``flash_decode`` decode step raises on this mesh."""
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
    out["decode_error"] = _decode_refusal(mesh, jobs[0][0], jobs[0][1])
    return out


def _decode_refusal(mesh, arch: str, state: dict) -> str:
    """The message of the error a kernel-route decode step raises on a mesh
    whose ``model`` axis splits the cache ("" if none)."""
    cfg = mesh_config(arch)
    ctx = transformer.make_ctx(mesh, cfg)
    params = distribute(state["params"], transformer.param_specs(state["params"], cfg, ctx,
                                                                 zero1=False), mesh)
    cache = transformer.init_cache(cfg, 4, 16, ctx)
    tokens = batch_layout(ctx, {"t": torch.zeros((4, 1), dtype=torch.int32)}, 1)["t"]
    try:
        transformer.decode_step(params, cfg, cache, tokens, 3, ctx, use_kernels=True)
    except ValueError as e:
        return str(e)
    return ""
