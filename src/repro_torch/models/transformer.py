"""Decoder stack for dense, global-attention, text LMs (qwen3-14b).

Port of ``repro.models.transformer`` for ``global``/``dense`` layer
templates.  A model is a repeating *pattern* of layer templates; the
parameters of each pattern position are stacked along a leading repeat
axis, the reference's layout: ``params["blocks"]`` is a tuple (one dict
per pattern position) whose leaves are ``[R, ...]`` (``wq [R, D, H, Dh]``,
``wo [R, H, Dh, D]``), and the cache is a tuple of ``{"k", "v"}`` with
leaves ``[R, B, S, Hkv, Dh]``.  The reference drives the stack with
``lax.scan`` (``models/unroll.py`` picks its unroll); here a Python loop
over the repeats replaces the scan, so ``unroll.py`` has no counterpart.
Parameters are plain tensors in dicts, never ``nn.Parameter``s, so no
autograd graph is built.

Three execution modes share the layer code:
  * ``forward``     — logits over all positions
  * ``prefill``     — forward + the serving cache, written straight into a
                      preallocated ``max_len`` cache
  * ``decode_step`` — one token in, one logits row out, the cache updated
                      IN PLACE (the reference returns a new cache)

MoE, SSM, vision and audio branches raise ``NotImplementedError`` (ROADMAP
queue 1 item 11); ``make_ctx``, ``param_specs`` and ``cache_specs`` come
with the multi-device slice (queue 10).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LayerTemplate, ModelConfig
from repro_torch.core.driver import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    embed_tokens,
    init_embedding,
    init_mlp,
    init_rms_scale,
    lm_logits,
    mlp,
    normal,
    rms_norm,
)
from repro_torch.sharding.specs import ShardingCtx

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NOT_PORTED = "is not ported to repro_torch yet (ROADMAP queue 1 item 11)"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# Config plumbing
# ---------------------------------------------------------------------------


def padded_vocab(cfg: ModelConfig, tp: int = 16) -> int:
    v = cfg.vocab_size
    if v % tp == 0:
        return v
    mult = 256
    return ((v + mult - 1) // mult) * mult


def attn_config(cfg: ModelConfig, tmpl: LayerTemplate) -> attn_lib.AttnConfig:
    return attn_lib.AttnConfig(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        window=cfg.sliding_window if tmpl.mixer == "local" else None,
        attn_softcap=cfg.attn_softcap,
        norm_eps=cfg.norm_eps,
        kv_chunk=cfg.attn_kv_chunk,
        q_chunk=cfg.attn_q_chunk,
    )


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.modality is not None:
        raise _unported(f"the {cfg.modality} modality")
    for tmpl in cfg.pattern:
        if tmpl.mixer not in ("global", "local"):
            raise _unported(f"the {tmpl.mixer!r} mixer")
        if tmpl.ffn != "dense":
            raise _unported(f"the {tmpl.ffn!r} ffn")


def _at(tree, r: int):
    """Repeat ``r`` of a stacked dict: views, so in-place writes land in
    the stacked tensors."""
    return {k: _at(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig, tmpl: LayerTemplate) -> dict:
    """One repeat's parameters of one pattern position, on the generator's device."""
    dtype = _dtype(cfg)
    p: dict[str, Any] = {"norm1": init_rms_scale(cfg.d_model, gen.device)}
    if tmpl.mixer in ("global", "local"):
        p["attn"] = attn_lib.init_attention(gen, cfg.d_model, attn_config(cfg, tmpl), dtype)
    else:
        raise _unported(f"the {tmpl.mixer!r} mixer")
    if cfg.post_norm:
        p["norm1_post"] = init_rms_scale(cfg.d_model, gen.device)
    if tmpl.ffn == "dense":
        p["norm2"] = init_rms_scale(cfg.d_model, gen.device)
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.mlp_gated)
    else:
        raise _unported(f"the {tmpl.ffn!r} ffn")
    if cfg.post_norm:
        p["norm2_post"] = init_rms_scale(cfg.d_model, gen.device)
    return p


def _copy_into(dst: dict, src: dict, r: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v, r)
        else:
            dst[k][r].copy_(v)


def _empty_stacked(one: dict, r: int) -> dict:
    return {
        k: _empty_stacked(v, r) if isinstance(v, dict)
        else torch.empty((r,) + tuple(v.shape), dtype=v.dtype, device=v.device)
        for k, v in one.items()
    }


def init_params(
    cfg: ModelConfig, seed: int = 0, device: torch.device | str | None = None, tp: int = 16
) -> dict:
    """Random weights from ``seed``, drawn on ``device`` (``cuda`` unless
    the caller asks otherwise) with an explicit ``torch.Generator``: each
    tensor in float32, cast to ``cfg.dtype``, one repeat at a time into
    the stacked leaves, so at full width nothing of model size is built
    on the host or twice on the card."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = _dtype(cfg)
    vpad = padded_vocab(cfg, tp)

    params: dict[str, Any] = {"embed": init_embedding(gen, vpad, cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (cfg.d_model, vpad), cfg.d_model ** -0.5, dtype)

    r = cfg.num_repeats
    blocks = []
    for tmpl in cfg.pattern:
        stacked = None
        for i in range(r):
            one = _init_block(gen, cfg, tmpl)
            if stacked is None:
                stacked = _empty_stacked(one, r)
            _copy_into(stacked, one, i)
            del one
        blocks.append(stacked)
    params["blocks"] = tuple(blocks)
    params["final_norm"] = init_rms_scale(cfg.d_model, device)
    return params


# ---------------------------------------------------------------------------
# Embedding of model inputs
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx):
    """-> (x [B, S, D], positions [B, S], loss_mask [B, S])."""
    if cfg.modality is not None:
        raise _unported(f"the {cfg.modality} modality")
    tokens = batch["tokens"]  # [B, S]
    x = embed_tokens(params["embed"], tokens, ctx, cfg.embed_scale)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, torch.ones((b, s), device=x.device)


def output_logits(params, cfg: ModelConfig, x: torch.Tensor, ctx: ShardingCtx):
    if cfg.modality is not None:
        raise _unported(f"the {cfg.modality} modality")
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return lm_logits(x, table, tied=cfg.tie_embeddings, cap=cfg.logit_softcap, ctx=ctx)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


_ZERO_AUX = {"lb_loss": 0.0, "z_loss": 0.0, "overflow_frac": 0.0}


def _apply_block_train(
    tmpl: LayerTemplate, p, x, positions, cfg: ModelConfig, ctx, collect_cache: bool
):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    cache_out = None
    if tmpl.mixer not in ("global", "local"):
        raise _unported(f"the {tmpl.mixer!r} mixer")
    y, (k, v) = attn_lib.attention_train(p["attn"], h, positions, attn_config(cfg, tmpl), ctx)
    if collect_cache:
        cache_out = {
            "k": ctx.constrain(k, "batch", "seq_kv", None, None),
            "v": ctx.constrain(v, "batch", "seq_kv", None, None),
        }
    if cfg.post_norm:
        y = rms_norm(y, p["norm1_post"], cfg.norm_eps)
    x = x + y
    aux = dict(_ZERO_AUX)
    if tmpl.ffn != "none":
        if tmpl.ffn != "dense":
            raise _unported(f"the {tmpl.ffn!r} ffn")
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        y = mlp(p["ffn"], h, cfg.act, ctx)
        if cfg.post_norm:
            y = rms_norm(y, p["norm2_post"], cfg.norm_eps)
        x = x + y
    return x, aux, cache_out


def _apply_block_decode(
    tmpl: LayerTemplate, p, x, cache, pos: int, cfg: ModelConfig, ctx, *, use_kernels: bool = True
):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if tmpl.mixer not in ("global", "local"):
        raise _unported(f"the {tmpl.mixer!r} mixer")
    y, new_cache = attn_lib.attention_decode(
        p["attn"], h, cache, pos, attn_config(cfg, tmpl), ctx, use_kernels=use_kernels
    )
    if cfg.post_norm:
        y = rms_norm(y, p["norm1_post"], cfg.norm_eps)
    x = x + y
    if tmpl.ffn != "none":
        if tmpl.ffn != "dense":
            raise _unported(f"the {tmpl.ffn!r} ffn")
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        y = mlp(p["ffn"], h, cfg.act, ctx)
        if cfg.post_norm:
            y = rms_norm(y, p["norm2_post"], cfg.norm_eps)
        x = x + y
    return x, new_cache


# ---------------------------------------------------------------------------
# Full model: forward / prefill / decode
# ---------------------------------------------------------------------------


def forward(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx):
    """-> (logits, aux).  aux carries the (zero) MoE losses and the loss mask."""
    x, positions, loss_mask = embed_inputs(params, cfg, batch, ctx)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in _ZERO_AUX}
    for r in range(cfg.num_repeats):
        x = ctx.constrain(x, "batch", "seq", "embed")
        for tmpl, p in zip(cfg.pattern, params["blocks"]):
            x, block_aux, _ = _apply_block_train(tmpl, _at(p, r), x, positions, cfg, ctx, False)
            aux = {k: aux[k] + block_aux[k] for k in aux}
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = output_logits(params, cfg, x, ctx)
    aux["loss_mask"] = loss_mask
    return logits, aux


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    ctx: ShardingCtx,
    device: torch.device | str = "cpu",
):
    """Stacked cache: tuple over pattern positions of ``{"k", "v"}``,
    leaves ``[R, B, max_len, Hkv, Dh]`` of zeros."""
    _check_supported(cfg)
    dtype = _dtype(cfg)
    r = cfg.num_repeats
    caches = []
    for tmpl in cfg.pattern:
        acfg = attn_config(cfg, tmpl)
        shape = (r, batch, max_len, acfg.num_kv_heads, acfg.head_dim)
        caches.append({
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        })
    return tuple(caches)


def decode_step(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,  # [B, 1]
    pos: int,  # host int position, the same for the whole batch
    ctx: ShardingCtx,
    extra: dict | None = None,
    *,
    use_kernels: bool = True,
):
    """-> (logits [B, 1, V], cache), the cache written in place at ``pos``.
    With ``use_kernels`` the attention core is the ``flash_decode`` kernel
    on the card (one launch per layer) and its plain version on the CPU;
    without, the plain version everywhere."""
    if cfg.modality is not None:
        raise _unported(f"the {cfg.modality} modality")
    x = embed_tokens(params["embed"], tokens, ctx, cfg.embed_scale)
    for r in range(cfg.num_repeats):
        for tmpl, p, c in zip(cfg.pattern, params["blocks"], cache):
            x, _ = _apply_block_decode(
                tmpl, _at(p, r), x, _at(c, r), pos, cfg, ctx, use_kernels=use_kernels
            )
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return output_logits(params, cfg, x, ctx), cache


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int, ctx: ShardingCtx):
    """Forward pass that also builds the serving cache.

    Returns (last_logits [B, 1, V], cache with the prefix written and room
    up to max_len).  Each layer's k and v go straight into the
    preallocated cache; logits are computed for the last position only."""
    x, positions, _ = embed_inputs(params, cfg, batch, ctx)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max(max_len, s), ctx, device=x.device)
    for r in range(cfg.num_repeats):
        x = ctx.constrain(x, "batch", "seq", "embed")
        for tmpl, p, c in zip(cfg.pattern, params["blocks"], cache):
            x, _, kv = _apply_block_train(tmpl, _at(p, r), x, positions, cfg, ctx, True)
            c["k"][r, :, :s] = kv["k"]
            c["v"][r, :, :s] = kv["v"]
            del kv
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return output_logits(params, cfg, x, ctx), cache
