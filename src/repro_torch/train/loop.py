"""The LM train step: loss, gradient accumulation, clipping, mixed
precision, ZeRO-1 parameter layout.

Port of ``repro.train.loop``.  The state is the reference's
``{"params": float32 masters, "opt": optimizer state, "step": 0-dim
int32}``.  Each step:

* casts the masters to the compute copy, every leaf with more than one
  dimension to ``cfg.dtype`` (the stacked ``[R, ...]`` block leaves, norm
  scales and SSD parameters included, as in the reference) and the rest
  (``final_norm``) kept float32;
* takes the gradients of the loss with respect to that copy
  (``torch.autograd.grad``), so they come back in the compute dtype, as
  ``jax.grad`` gives them; ``transformer.forward`` rematerialises each
  repeat of the pattern in the backward pass;
* with ``grad_accum`` A > 1 runs the A microbatches of a batch whose
  leaves are ``[A, B / A, ...]`` one after another, sums their gradients
  in float32 buffers and divides by A (the metrics likewise);
* clips by the global norm of the float32 squares,
  ``min(1, max_grad_norm / (norm + 1e-9))``;
* updates the float32 masters through the optimizer and returns a new
  state (the old one is untouched, so a caller may step twice from it).

On a mesh (``ctx.mesh``, a ``DeviceMesh``) the state is a nest of
DTensors laid out by :func:`state_specs` (:func:`repro_torch.sharding.specs.distribute`
puts it there) and the batch's leaves are DTensors split along the batch
axes (as ``launch.dryrun._batch_shardings`` lays them out).  Layout
contract, the reference's:

* masters (and adamw's ``m`` and ``v``) live float32, sharded
  feature-dim over ``model`` AND over the data axes (``zero1``);
* each step's compute copy is re-laid to ``param_specs(zero1=False)``
  (the ZeRO all-gathers over the data axes);
* each microbatch's gradients, and the accumulated ones, go to
  ``param_specs(zero1=True)`` (a reduce-scatter over the data axes of
  the partial sums), so the optimizer update is rank-local;
* the new masters are laid out by ``zero1=True`` again.

The metrics are 0-dim float32 tensors on the device (no host sync):
``loss``, ``ce``, ``lb_loss``, ``z_loss``, ``overflow_frac`` and, with
clipping, ``grad_norm``; on a mesh, plain tensors equal on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.sharding.specs import (
    P,
    ShardingCtx,
    distribute,
    from_shards,
    is_dtensor,
    local_offset,
    only_dims,
    split_ways,
    to_shard,
)

METRICS = ("loss", "ce", "lb_loss", "z_loss", "overflow_frac")


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.0
    grad_accum: int = 1
    lb_coef: float = 0.01  # MoE load-balance aux
    z_coef: float = 1e-3  # router z-loss
    max_grad_norm: float | None = 1.0


def cross_entropy(
    logits: torch.Tensor,  # [B, S, V] or [B, S, K, V] (float32)
    labels: torch.Tensor,  # [B, S] or [B, S, K] int32
    mask: torch.Tensor,  # [B, S]
    vocab_size: int,
) -> torch.Tensor:
    """Mean CE over unmasked positions (the K codebooks of a position
    summed, as the reference's mask broadcasts)."""
    if logits.dim() == 4 and labels.dim() == 3:
        mask = mask[..., None]  # broadcast over codebooks
    if is_dtensor(logits):
        nll = _sharded_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


class _LogSumExpOfShard(torch.autograd.Function):
    """A rank's log-sum-exp rows ``lse [B, S]`` (computed from every
    shard, passed in), with ``logsumexp``'s gradient with respect to the
    rank's logits shard ``x [B, S, V_l]``: ``g * exp(x - lse)``."""

    @staticmethod
    def forward(ctx, x, lse):
        ctx.save_for_backward(x, lse)
        return lse.clone()

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None]), None


def _sharded_nll(logits, labels) -> torch.Tensor:
    """``logsumexp(logits) - logits[labels]`` over the last axis of a
    DTensor, its vocabulary split or not, on each rank's shard: the
    log-sum-exp as ``logsumexp`` computes it, from the shards' max (an
    all-reduce of the max) and sum of exponentials (reduced at the
    ``log``), with ``logsumexp``'s gradient on each shard; each gold logit
    read by the rank that holds it and summed over the vocabulary shards.
    Only ``[B, S]`` values cross ranks, forward and backward (DTensor's
    own ``logsumexp`` and ``gather`` would gather the logits or their
    gradient).  Where one rank holds every logit of a row, ``logsumexp``
    and ``gather`` on its shard, the ops of the plain path."""
    from torch.distributed.tensor import Partial, Shard

    v = logits.dim() - 1
    mesh, layout = logits.device_mesh, tuple(logits.placements)
    rows = only_dims(layout, range(v))

    def over_vocab(local: torch.Tensor, op: str) -> torch.Tensor:
        """A rank's ``[B, S]`` piece as a DTensor pending ``op`` over the
        axes that split the vocabulary."""
        pending = tuple(Partial(op) if p == Shard(v) else q for p, q in zip(layout, rows))
        return from_shards(local, mesh, pending, labels.shape)

    local = to_shard(logits)
    if split_ways(logits, v) == 1:  # one rank holds every logit of a row
        lse = from_shards(torch.logsumexp(local, dim=-1), mesh, rows, labels.shape)
        return lse - from_shards(torch.gather(local, -1, labels.redistribute(mesh, rows)
                                              .to_local()[..., None].long())[..., 0],
                                 mesh, rows, labels.shape)
    with torch.no_grad():
        m = over_vocab(local.amax(dim=-1), "max").redistribute(mesh, rows).to_local()
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # as logsumexp does
        sumexp = torch.sum(torch.exp(local - m[..., None]), dim=-1)
        lse = (torch.log(over_vocab(sumexp, "sum").redistribute(mesh, rows).to_local()) + m)
    lse = from_shards(_LogSumExpOfShard.apply(local, lse), mesh, rows, labels.shape)
    shape, offset = local_offset(logits.shape, mesh, layout)
    ids = labels.redistribute(mesh, rows).to_local().long() - offset[v]
    inside = (ids >= 0) & (ids < shape[v])
    gold = torch.gather(local, -1, torch.where(inside, ids, 0)[..., None])[..., 0]
    gold = torch.where(inside, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    return lse - over_vocab(gold, "sum")


def loss_fn(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx, settings: TrainSettings):
    """-> (total loss, metrics): next-token CE, plus the MoE aux losses."""
    logits, aux = transformer.forward(params, cfg, batch, ctx)
    # next-token prediction: the final position has no next token, so it is
    # masked out (not cut off: the backward of a slice of a DTensor whose
    # vocabulary is split gathers the vocabulary)
    labels, mask = batch["labels"], aux["loss_mask"]
    la = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)
    ma = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
    ce = cross_entropy(logits, la, ma, cfg.vocab_size)
    total = ce
    if cfg.has_moe:
        total = total + settings.lb_coef * aux["lb_loss"] + settings.z_coef * aux["z_loss"]
    metrics = {
        "loss": total,
        "ce": ce,
        "lb_loss": aux["lb_loss"],
        "z_loss": aux["z_loss"],
        "overflow_frac": aux["overflow_frac"],
    }
    return total, metrics


def _global_norm(leaves: list) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in flatten order, of the float32 squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def make_train_step(
    cfg: ModelConfig,
    ctx: ShardingCtx,
    opt: Optimizer,
    settings: TrainSettings,
):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": float32 master tree, "opt": opt state, "step": int32}.
    Grad accumulation runs over the microbatch axis of ``batch`` leaves
    shaped [A, mb, ...] when settings.grad_accum > 1.
    """
    compute_dtype = transformer.DTYPES[cfg.dtype]
    mesh = ctx.mesh

    def layout(leaves: list, like, zero1: bool) -> list:
        """On a mesh, ``leaves`` (in ``like``'s flatten order) laid out by
        ``param_specs(like, zero1=zero1)``; the identity without one."""
        if mesh is None:
            return leaves
        specs = transformer.param_specs(like, cfg, ctx, zero1=zero1)
        return tree_leaves(distribute(tree_unflatten(like, leaves), specs, mesh))

    def cast_params(params):
        casted = tree_map(lambda p: p.to(compute_dtype) if p.dim() > 1 else p, params)
        casted = tree_unflatten(casted, layout(tree_leaves(casted), casted, zero1=False))
        return tree_map(lambda p: p.detach().requires_grad_(), casted)

    def grad_of(cparams, batch):
        """Gradients (leaves in flatten order, the compute dtype, the ZeRO-1
        layout on a mesh) and the detached metrics of one (micro)batch."""
        loss, metrics = loss_fn(cparams, cfg, batch, ctx, settings)
        grads = torch.autograd.grad(loss, tree_leaves(cparams), allow_unused=True,
                                    materialize_grads=True)
        return layout(list(grads), cparams, zero1=True), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        with ctx.replicate_plain():
            return step(state, batch)

    def step(state, batch):
        params = state["params"]
        cparams = cast_params(params)

        a = settings.grad_accum
        if a > 1:
            grads = None
            for i in range(a):
                g, m = grad_of(cparams, {k: v[i] for k, v in batch.items()})
                if grads is None:  # float32 buffers, laid out as the gradients
                    grads = [torch.zeros_like(gi, dtype=torch.float32) for gi in g]
                    metrics = {k: torch.zeros((), dtype=torch.float32, device=g[0].device)
                               for k in METRICS}
                torch._foreach_add_(grads, [gi.float() for gi in g])
                del g
                metrics = {k: metrics[k] + m[k] for k in metrics}
            torch._foreach_div_(grads, a)
            metrics = {k: v / a for k, v in metrics.items()}
        else:
            grads, metrics = grad_of(cparams, batch)
        del cparams

        if settings.max_grad_norm is not None:
            gnorm = _global_norm(grads)
            scale = torch.clamp_max(settings.max_grad_norm / (gnorm + 1e-9), 1.0)
            grads = [g.float() for g in grads]
            torch._foreach_mul_(grads, scale)
            metrics["grad_norm"] = gnorm

        updates, opt_state = opt.update(tree_unflatten(params, grads), state["opt"], params)
        del grads
        new_params = apply_updates(params, updates)
        new_params = tree_unflatten(new_params,
                                    layout(tree_leaves(new_params), new_params, zero1=True))
        if mesh is not None:
            metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        return {"params": new_params, "opt": opt_state, "step": state["step"] + 1}, metrics

    return train_step


def init_state(cfg: ModelConfig, seed: int, opt: Optimizer, tp: int = 16,
               device: torch.device | str | None = None):
    """The initial state: ``transformer.init_params`` from ``seed`` (the
    reference's PRNG key becomes the seed of a ``torch.Generator``, so the
    values differ by design) on ``device`` (``cuda`` unless the caller asks
    otherwise), bfloat16 leaves cast to float32 masters."""
    params = transformer.init_params(cfg, seed, device, tp)
    params = tree_map(lambda p: p.float() if p.dtype == torch.bfloat16 else p, params)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


def state_specs(state, cfg: ModelConfig, ctx: ShardingCtx):
    """Spec nest for the whole train state (the ZeRO-1 layout): the
    masters by ``param_specs(zero1=True)``, adamw's ``m`` and ``v`` the
    same, every other optimizer leaf and ``step`` replicated."""
    pspec = transformer.param_specs(state["params"], cfg, ctx, zero1=True)
    opt_state = state["opt"]
    if isinstance(opt_state, dict) and "m" in opt_state:
        ospec = {k: (pspec if k in ("m", "v") else P()) for k in opt_state}
    elif isinstance(opt_state, dict):
        ospec = {k: P() for k in opt_state}
    else:
        ospec = _replicated_like(opt_state)
    return {"params": pspec, "opt": ospec, "step": P()}


def _replicated_like(tree):
    """``P()`` for every tensor leaf of a nest."""
    if isinstance(tree, dict):
        return {k: _replicated_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_replicated_like(v) for v in tree]
        return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)
    return P()
