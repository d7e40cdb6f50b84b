"""The LM train step: loss, gradient accumulation, clipping, mixed precision.

Port of ``repro.train.loop``, single device.  The state is the
reference's ``{"params": float32 masters, "opt": optimizer state,
"step": 0-dim int32}``, on one device.  Each step:

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

The metrics are 0-dim float32 tensors on the device (no host sync):
``loss``, ``ce``, ``lb_loss``, ``z_loss``, ``overflow_frac`` and, with
clipping, ``grad_norm``.  The reference's ``state_specs`` and sharding
constraints (the ZeRO-1 layout) belong to the mesh rules, ROADMAP queue
1, as ``repro_torch.sharding.specs`` says.
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
from repro_torch.sharding.specs import ShardingCtx

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
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx, settings: TrainSettings):
    """-> (total loss, metrics): next-token CE, plus the MoE aux losses."""
    logits, aux = transformer.forward(params, cfg, batch, ctx)
    # next-token prediction: drop the final position (no next token)
    lo, la, ma = logits[:, :-1], batch["labels"][:, 1:], aux["loss_mask"][:, 1:]
    ce = cross_entropy(lo, la, ma, cfg.vocab_size)
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
    if ctx.mesh is not None:
        raise NotImplementedError("the mesh rules are not ported yet (ROADMAP queue 1)")
    compute_dtype = transformer.DTYPES[cfg.dtype]

    def cast_params(params):
        return tree_map(
            lambda p: (p.to(compute_dtype) if p.dim() > 1 else p).detach().requires_grad_(),
            params)

    def grad_of(cparams, batch):
        """Gradients (leaves in flatten order, the compute dtype) and the
        detached metrics of one (micro)batch."""
        loss, metrics = loss_fn(cparams, cfg, batch, ctx, settings)
        grads = torch.autograd.grad(loss, tree_leaves(cparams), allow_unused=True,
                                    materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        cparams = cast_params(params)

        a = settings.grad_accum
        if a > 1:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(cparams)]
            metrics = {k: torch.zeros((), dtype=torch.float32, device=grads[0].device)
                       for k in METRICS}
            for i in range(a):
                g, m = grad_of(cparams, {k: v[i] for k, v in batch.items()})
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
