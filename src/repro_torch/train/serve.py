"""Serving: prefill + batched single-token decode.

Port of ``repro.train.serve``.  ``pos`` is a host int, so a step never
waits on the card; the cache is updated in place (see
:func:`repro_torch.models.transformer.decode_step`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.sharding.specs import ShardingCtx


def make_serve_step(cfg: ModelConfig, ctx: ShardingCtx, *, use_kernels: bool = True):
    """serve_step(params, cache, tokens, pos) -> (next_tokens, logits, cache).

    One decode step for a batch of requests at a shared position.  Greedy
    sampling over the real vocabulary: the padded tail is masked with
    -1e30 before ``argmax`` (per codebook for audio: ``[B, 1, K]``).  ``use_kernels=False`` takes the plain decode
    attention on any device.
    """

    def serve_step(params, cache, tokens, pos):
        with ctx.replicate_plain():
            return step(params, cache, tokens, pos)

    def step(params, cache, tokens, pos):
        logits, cache = transformer.decode_step(
            params, cfg, cache, tokens, pos, ctx, use_kernels=use_kernels
        )
        v = cfg.vocab_size
        vpad = logits.shape[-1]
        if vpad > v:
            mask = torch.arange(vpad, device=logits.device) < v
            logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                            device=logits.device))
        # the vocabulary whole on a mesh: argmax over a split axis is DTensor's weak spot
        whole = ctx.constrain(logits, "batch", *([None] * (logits.dim() - 1)))
        next_tokens = torch.argmax(whole, dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return serve_step


def make_prefill(cfg: ModelConfig, ctx: ShardingCtx, max_len: int):
    def prefill_step(params, batch):
        return transformer.prefill(params, cfg, batch, max_len, ctx)

    return prefill_step


def greedy_generate(
    params,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    prompt: torch.Tensor,  # [B, S0] int (or [B, S0, K] audio)
    steps: int,
    max_len: int,
    extra: dict | None = None,
    *,
    use_kernels: bool = True,
) -> torch.Tensor:  # [B, steps] (or [B, steps, K]) int32
    """Prefill the prompt (with ``extra``, e.g. vision's ``patch_embeds``)
    then decode ``steps`` greedy tokens.  As in the reference, the first
    step re-decodes the last prompt token at position ``S0 - 1`` (after the
    ``num_patches`` positions of a vision prefix), rewriting its cache
    row."""
    batch = {"tokens": prompt, **(extra or {})}
    _, cache = transformer.prefill(params, cfg, batch, max_len, ctx)
    serve_step = make_serve_step(cfg, ctx, use_kernels=use_kernels)
    pos0 = prompt.shape[1] + (cfg.num_patches if cfg.modality == "vision" else 0)
    tok = prompt[:, -1:]
    tokens = []
    for i in range(steps):
        tok, _, cache = serve_step(params, cache, tok, pos0 + i - 1)
        tokens.append(tok)
    return torch.cat(tokens, dim=1)
