"""Composable decoder stack covering all six architecture families.

Port of ``repro.models.transformer``.  A model is a repeating *pattern*
of layer templates (``configs/base.py``): dense LMs repeat (global
attention, dense FFN); gemma2 repeats (local, dense), (global, dense);
jamba repeats an 8-layer super-block of SSD/attention mixers with
alternating dense/MoE FFNs; mamba2 repeats a pure SSD block.  The
parameters of each pattern position are stacked along a leading repeat
axis, the reference's layout: ``params["blocks"]`` is a tuple (one dict
per pattern position) whose leaves are ``[R, ...]`` (``wq [R, D, H, Dh]``,
``wo [R, H, Dh, D]``), and the cache is a tuple with, per pattern
position, ``{"k", "v"}`` (leaves ``[R, B, S, Hkv, Dh]``) for an attention
mixer or ``{"conv" [R, B, W-1, C], "state" [R, B, H, P, N] float32}`` for
an SSD mixer.  The vision front end (paligemma) prepends
``num_patches`` projected patch embeddings to the text; the audio front
end (musicgen) sums ``num_codebooks`` token embeddings (``embed [K, V,
D]``) and emits K logit heads (``lm_head [K, D, V]``).  The reference
drives the stack with ``lax.scan`` (``models/unroll.py`` picks its
unroll); here a Python loop
over the repeats replaces the scan, so ``unroll.py`` has no counterpart.
Parameters are plain tensors in dicts, never ``nn.Parameter``s: serving
builds no autograd graph.  A training step (``repro_torch.train.loop``)
asks for gradients of a compute copy of the parameters; ``forward`` then
rematerialises each repeat of the pattern in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
scan body), so only each repeat's input stays alive between the passes.

Three execution modes share the layer code:
  * ``forward``     — logits over all positions
  * ``prefill``     — forward + the serving cache, written straight into a
                      preallocated ``max_len`` cache
  * ``decode_step`` — one token in, one logits row out, the cache updated
                      IN PLACE (the reference returns a new cache)

Sharding: every tensor is annotated with logical axes
(``sharding/specs.py``); :func:`make_ctx` degrades any rule whose
dimension doesn't divide the mesh axis to replication, so every (arch x
mesh) combination runs; :func:`param_specs` and :func:`cache_specs` give
the parameters' and the cache's specs (the parameters' leaves keep the
reference's leading, replicated repeat axis).  On a mesh the tensors are
DTensors; the model code is the same.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerTemplate, ModelConfig
from repro_torch.core.driver import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    embed_tokens,
    init_embedding,
    init_mlp,
    init_rms_scale,
    lm_logits,
    lookup,
    mlp,
    normal,
    rms_norm,
)
from repro_torch.sharding.specs import (
    RULES,
    PartitionSpec,
    ShardingCtx,
    from_shards,
    is_dtensor,
    local_offset,
    mesh_axes,
    spec_placements,
    with_dim,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------------------
# Config plumbing
# ---------------------------------------------------------------------------


def make_ctx(mesh, cfg: ModelConfig, overrides: dict | None = None) -> ShardingCtx:
    """Sharding context for one (model, mesh) pair.

    Head/kv-head counts that don't divide the ``model`` axis stay sharded
    (uneven shards, as GSPMD pads), which beats the redundant compute of
    replication.  Few kv heads (fewer than half the ``model`` axis, MQA
    included) stay replicated.  Experts, FFN width, the padded vocabulary
    and the SSD heads degrade to replication where they don't divide.
    """
    rules = dict(RULES)
    if mesh is not None:
        tp = mesh_axes(mesh).get("model", 1)

        def degrade(rule_name: str, dim: int):
            if dim and dim % tp != 0:
                rules[rule_name] = None

        if not cfg.shard_heads or (cfg.num_heads and cfg.num_heads < tp // 2):
            rules["heads"] = None
        if cfg.num_kv_heads and cfg.num_kv_heads < tp // 2:
            rules["kv_heads"] = None  # MQA/few-kv: replicate k/v activations
        degrade("experts", cfg.num_experts)
        degrade("mlp", cfg.d_ff)
        degrade("vocab", padded_vocab(cfg, tp))
        if cfg.has_ssm:
            degrade("ssm_heads", (cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim)
    if overrides:
        rules.update(overrides)
    return ShardingCtx(mesh=mesh, rules=rules)


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


def ssm_config(cfg: ModelConfig) -> ssm_lib.SSMConfig:
    return ssm_lib.SSMConfig(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        expand=cfg.ssm_expand,
        head_dim=cfg.ssm_head_dim,
        conv_width=cfg.ssm_conv,
        chunk=cfg.ssm_chunk,
        norm_eps=cfg.norm_eps,
        compute_dtype=cfg.ssm_compute_dtype,
    )


def moe_config(cfg: ModelConfig) -> moe_lib.MoEConfig:
    return moe_lib.MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff,
        num_experts=cfg.num_experts,
        top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        act=cfg.act,
    )


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` on a mixer, FFN or modality the stack does not know."""
    if cfg.modality not in (None, "vision", "audio-codec"):
        raise ValueError(f"unknown modality {cfg.modality!r}")
    for tmpl in cfg.pattern:
        if tmpl.mixer not in ("global", "local", "ssm"):
            raise ValueError(tmpl.mixer)
        if tmpl.ffn not in ("dense", "moe", "none"):
            raise ValueError(tmpl.ffn)


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
        p["ssm"] = ssm_lib.init_ssm(gen, ssm_config(cfg), dtype)
    if cfg.post_norm:
        p["norm1_post"] = init_rms_scale(cfg.d_model, gen.device)
    if tmpl.ffn == "dense":
        p["norm2"] = init_rms_scale(cfg.d_model, gen.device)
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.mlp_gated)
    elif tmpl.ffn == "moe":
        p["norm2"] = init_rms_scale(cfg.d_model, gen.device)
        p["moe"] = moe_lib.init_moe(gen, moe_config(cfg), dtype)
    if cfg.post_norm and tmpl.ffn != "none":
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

    params: dict[str, Any] = {}
    if cfg.modality == "audio-codec":
        k = cfg.num_codebooks
        params["embed"] = torch.stack(
            [init_embedding(gen, vpad, cfg.d_model, dtype) for _ in range(k)])  # [K, V, D]
        params["lm_head"] = torch.stack(
            [normal(gen, (cfg.d_model, vpad), cfg.d_model ** -0.5, dtype)
             for _ in range(k)])  # [K, D, V]
    else:
        params["embed"] = init_embedding(gen, vpad, cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = normal(gen, (cfg.d_model, vpad), cfg.d_model ** -0.5, dtype)
    if cfg.modality == "vision":
        params["vision_proj"] = normal(gen, (cfg.frontend_dim, cfg.d_model),
                                       cfg.frontend_dim ** -0.5, dtype)

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


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a parameter nest (dicts and tuples), keeping
    its structure; ``path`` is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, cfg: ModelConfig, ctx: ShardingCtx, zero1: bool = True):
    """Spec nest for the parameter nest (any tensors with shapes: plain,
    ``meta`` or DTensors).

    Feature axes ride the ``model`` axis (the paper's partition); when
    ``zero1`` a remaining large axis is additionally sharded over the data
    axes, which is where master params / optimizer state live (ZeRO-1).
    Block leaves carry a leading stacked repeat axis (always replicated).
    """
    z = "zero1" if zero1 else None

    def spec_of(path: tuple, x) -> PartitionSpec:
        keys = [k for k in path if isinstance(k, str)]
        leaf = keys[-1]
        nd = x.dim()
        shape = tuple(x.shape)

        def s(*names):  # block leaf: leading repeat axis
            assert len(names) + 1 == nd, (path, nd, names)
            return ctx.spec_div(shape, None, *names)

        if "vision_proj" in keys:
            return ctx.spec_div(shape, z, None)
        if "embed" in keys:
            if cfg.modality == "audio-codec":
                return ctx.spec_div(shape, None, "vocab", z)
            return ctx.spec_div(shape, "vocab", z)
        if "lm_head" in keys:
            if cfg.modality == "audio-codec":
                return ctx.spec_div(shape, None, z, "vocab")
            return ctx.spec_div(shape, z, "vocab")
        if "blocks" not in keys:  # final_norm etc.
            return ctx.spec(*([None] * nd))
        if leaf == "wq":
            return s(z, "heads", None)
        if leaf in ("wk", "wv"):
            return s(z, "kv_heads", None)
        if leaf == "wo":
            return s("heads", None, z)
        if leaf in ("w_gate", "w_up"):
            if nd == 4:  # stacked expert weights [R, E, D, F]
                return s("experts", z, "expert_mlp")
            return s(z, "mlp")
        if leaf == "w_down":
            if nd == 4:
                return s("experts", "expert_mlp", z)
            return s("mlp", z)
        if leaf in ("router", "in_proj", "out_proj"):
            return s(z, None)
        # norms, conv weights, scalars: replicated beyond the repeat axis
        return ctx.spec(*([None] * nd))

    return _map_with_path(spec_of, params)


def cache_specs(cfg: ModelConfig, ctx: ShardingCtx):
    """Spec nest matching :func:`init_cache`'s structure."""
    out = []
    for tmpl in cfg.pattern:
        if tmpl.mixer in ("global", "local"):
            out.append({
                "k": ctx.spec(None, "batch", "seq_kv", None, None),
                "v": ctx.spec(None, "batch", "seq_kv", None, None),
            })
        else:
            out.append({
                "conv": ctx.spec(None, "batch", None, None),
                "state": ctx.spec(None, "batch", "ssm_heads", None, None),
            })
    return tuple(out)


# ---------------------------------------------------------------------------
# Embedding of model inputs
# ---------------------------------------------------------------------------


def _embed_codebooks(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Audio: the sum of the K codebooks' embeddings of tokens [B, S, K]."""
    b, s, _ = tokens.shape
    x = torch.zeros((b, s, cfg.d_model), dtype=_dtype(cfg), device=tokens.device)
    for i in range(cfg.num_codebooks):
        x = x + lookup(params["embed"][i], tokens[:, :, i])
    return x


def embed_inputs(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx):
    """-> (x [B, S, D], positions [B, S], loss_mask [B, S])."""
    if cfg.modality == "vision":
        tokens = batch["tokens"]  # [B, S_text]
        patches = batch["patch_embeds"]  # [B, P, frontend_dim]
        tx = embed_tokens(params["embed"], tokens, ctx, cfg.embed_scale)
        px = torch.einsum("bpf,fd->bpd", patches.to(tx.dtype), params["vision_proj"])
        px = ctx.constrain(px, "batch", None, "embed")
        x = torch.cat([px, tx], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        loss_mask = torch.cat([torch.zeros((b, patches.shape[1]), device=x.device),
                               torch.ones((b, tokens.shape[1]), device=x.device)], dim=1)
        return x, positions, loss_mask
    if cfg.modality == "audio-codec":
        tokens = batch["tokens"]  # [B, S, K]
        b, s, _ = tokens.shape
        x = ctx.constrain(_embed_codebooks(params, cfg, tokens), "batch", "seq", "embed")
        positions = torch.arange(s, device=x.device).expand(b, s)
        return x, positions, torch.ones((b, s), device=x.device)
    tokens = batch["tokens"]  # [B, S]
    x = embed_tokens(params["embed"], tokens, ctx, cfg.embed_scale)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, torch.ones((b, s), device=x.device)


def output_logits(params, cfg: ModelConfig, x: torch.Tensor, ctx: ShardingCtx):
    """-> float32 logits [B, S, V], or [B, S, K, V] for audio."""
    if cfg.modality == "audio-codec":
        outs = [lm_logits(x, params["lm_head"][i], tied=False, cap=cfg.logit_softcap, ctx=ctx)
                for i in range(cfg.num_codebooks)]
        return torch.stack(outs, dim=2)
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
    if tmpl.mixer in ("global", "local"):
        y, (k, v) = attn_lib.attention_train(p["attn"], h, positions, attn_config(cfg, tmpl), ctx)
        if collect_cache:
            cache_out = {
                "k": ctx.constrain(k, "batch", "seq_kv", None, None),
                "v": ctx.constrain(v, "batch", "seq_kv", None, None),
            }
    else:
        y = ssm_lib.ssm_train(p["ssm"], h, ssm_config(cfg), ctx)
        if collect_cache:
            cache_out = ssm_prefill_cache(p["ssm"], h, cfg, ctx)
    if cfg.post_norm:
        y = rms_norm(y, p["norm1_post"], cfg.norm_eps)
    x = x + y
    aux = dict(_ZERO_AUX)
    if tmpl.ffn != "none":
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if tmpl.ffn == "dense":
            y = mlp(p["ffn"], h, cfg.act, ctx)
        else:
            y, aux = moe_lib.moe_ffn(p["moe"], h, moe_config(cfg), ctx)
        if cfg.post_norm:
            y = rms_norm(y, p["norm2_post"], cfg.norm_eps)
        x = x + y
    return x, aux, cache_out


def ssm_prefill_cache(p, h, cfg: ModelConfig, ctx) -> dict:
    """The SSD mixer's serving cache after a prefill pass over ``h [B, S, D]``:
    the last ``W - 1`` conv inputs and the final state, recomputed from one
    extra projection and the closed form of the recurrence (so
    ``ssm_train`` stays cache-free)."""
    scfg = ssm_config(cfg)
    b, s, _ = h.shape
    di, n, w = scfg.d_inner, scfg.d_state, scfg.conv_width
    proj = torch.einsum("bsd,de->bse", h, p["in_proj"])
    z, xbc, dt_raw = ssm_lib._split_proj(proj, scfg)
    conv = ssm_lib._causal_conv(xbc, p, w)
    xs = conv[..., :di].reshape(b, s, scfg.num_heads, scfg.head_dim)
    bmat = conv[..., di : di + n].float()
    dt = ssm_lib._softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    la = dt * a[None, None, :]  # [B, S, H]
    # state = sum_s exp(sum_{s' > s} la) * dt_s * B_s (x) x_s
    rev_cum = torch.flip(torch.cumsum(torch.flip(la, [1]), dim=1), [1]) - la
    xd = xs.float() * (dt * torch.exp(rev_cum))[..., None]  # [B, S, H, P]
    state = torch.einsum("bshp,bsn->bhpn", xd, bmat)
    if s >= w - 1:
        conv_tail = xbc[:, s - (w - 1):, :]
    else:
        conv_tail = F.pad(xbc, (0, 0, w - 1 - s, 0))
    return {
        "conv": conv_tail,
        "state": ctx.constrain(state, "batch", "ssm_heads", None, None),
    }


def _apply_block_decode(
    tmpl: LayerTemplate, p, x, cache, pos: int, cfg: ModelConfig, ctx, *, use_kernels: bool = True
):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if tmpl.mixer in ("global", "local"):
        y, new_cache = attn_lib.attention_decode(
            p["attn"], h, cache, pos, attn_config(cfg, tmpl), ctx, use_kernels=use_kernels
        )
    else:
        y, new_cache = ssm_lib.ssm_decode(p["ssm"], h, cache, ssm_config(cfg), ctx)
    if cfg.post_norm:
        y = rms_norm(y, p["norm1_post"], cfg.norm_eps)
    x = x + y
    if tmpl.ffn != "none":
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if tmpl.ffn == "dense":
            y = mlp(p["ffn"], h, cfg.act, ctx)
        else:
            y, _ = moe_lib.moe_ffn(p["moe"], h, moe_config(cfg), ctx)
        if cfg.post_norm:
            y = rms_norm(y, p["norm2_post"], cfg.norm_eps)
        x = x + y
    return x, new_cache


# ---------------------------------------------------------------------------
# Full model: forward / prefill / decode
# ---------------------------------------------------------------------------


def _unstack(tree, r: int) -> list:
    """The ``r`` repeats of a stacked dict, each leaf ``unbind``-ed once:
    the same views as ``_at``, and in a backward pass one ``stack`` of the
    repeats' gradients per leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, r) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(r)]
    return list(torch.unbind(tree, 0))


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _records(x: torch.Tensor, blocks) -> bool:
    """Does autograd record this forward pass?"""
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(
        t.requires_grad for p in blocks for t in _leaves(p))


def _leaves(tree: dict) -> list:
    return [t for v in tree.values() for t in (_leaves(v) if isinstance(v, dict) else [v])]


def forward(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx):
    """-> (logits, aux).  aux carries the MoE losses and the loss mask.
    While autograd records, each repeat of the pattern goes through
    :func:`_remat`."""
    with ctx.replicate_plain():
        return _forward(params, cfg, batch, ctx)


def _forward(params, cfg: ModelConfig, batch: dict, ctx: ShardingCtx):
    x, positions, loss_mask = embed_inputs(params, cfg, batch, ctx)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in _ZERO_AUX}
    repeats = [_unstack(p, cfg.num_repeats) for p in params["blocks"]]

    def body(x, aux, block_params):
        x = ctx.constrain(x, "batch", "seq", "embed")
        for tmpl, p in zip(cfg.pattern, block_params):
            x, block_aux, _ = _apply_block_train(tmpl, p, x, positions, cfg, ctx, False)
            aux = {k: aux[k] + block_aux[k] for k in aux}
        return x, aux

    remat = _records(x, params["blocks"])
    for r in range(cfg.num_repeats):
        block_params = tuple(rep[r] for rep in repeats)
        x, aux = _remat(body, x, aux, block_params) if remat else body(x, aux, block_params)
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
    """Stacked cache of zeros: tuple over pattern positions of ``{"k", "v"}``
    (leaves ``[R, B, max_len, Hkv, Dh]``) for attention mixers and of
    ``{"conv" [R, B, W-1, C], "state" [R, B, H, P, N] float32}`` for SSD
    mixers."""
    _check_supported(cfg)
    dtype = _dtype(cfg)
    r = cfg.num_repeats
    caches = []
    for tmpl, spec in zip(cfg.pattern, cache_specs(cfg, ctx)):
        if tmpl.mixer in ("global", "local"):
            acfg = attn_config(cfg, tmpl)
            shape = (r, batch, max_len, acfg.num_kv_heads, acfg.head_dim)
            caches.append({
                "k": _zeros(shape, dtype, device, ctx, spec["k"]),
                "v": _zeros(shape, dtype, device, ctx, spec["v"]),
            })
        else:
            scfg = ssm_config(cfg)
            conv = (r, batch, scfg.conv_width - 1, scfg.d_inner + 2 * scfg.d_state)
            state = (r, batch, scfg.num_heads, scfg.head_dim, scfg.d_state)
            caches.append({
                "conv": _zeros(conv, dtype, device, ctx, spec["conv"]),
                "state": _zeros(state, torch.float32, device, ctx, spec["state"]),
            })
    return tuple(caches)


def _zeros(shape: tuple, dtype, device, ctx: ShardingCtx, spec: PartitionSpec) -> torch.Tensor:
    """Zeros on ``device``; on a mesh a DTensor laid out by ``spec``, each
    rank allocating only its shard there."""
    if ctx.mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    placements = spec_placements(ctx.mesh, spec)
    local, _ = local_offset(shape, ctx.mesh, placements)
    return from_shards(torch.zeros(local, dtype=dtype, device=device), ctx.mesh, placements,
                       shape)


def _write_repeat(dst: torch.Tensor, r: int, src: torch.Tensor) -> None:
    """``dst[r, :, :n] = src`` for ``src`` of ``n`` positions along
    dimension 1.  A DTensor's position axis may be split over ranks: where
    ``src`` is shorter than the cache, each rank writes the positions of
    its own shard (``src`` brought to the cache's layout with its
    positions whole), as the decode writes its position."""
    n = src.shape[1]
    if not is_dtensor(dst):
        dst[r, :, :n] = src
        return
    if n == dst.shape[2]:
        dst[r].copy_(src)
        return
    from torch.distributed.tensor import Replicate

    view = dst[r]
    mesh = view.device_mesh
    local = src.redistribute(mesh, with_dim(view.placements, 1, Replicate())).to_local()
    shape, offset = local_offset(view.shape, mesh, view.placements)
    lo, hi = offset[1], min(offset[1] + shape[1], n)
    if lo < hi:
        view.to_local()[:, : hi - lo] = local[:, lo:hi]


def decode_step(
    params,
    cfg: ModelConfig,
    cache,
    tokens: torch.Tensor,  # [B, 1] (or [B, 1, K] audio)
    pos: int,  # host int position, the same for the whole batch
    ctx: ShardingCtx,
    extra: dict | None = None,
    *,
    use_kernels: bool = True,
):
    """-> (logits [B, 1, (K,) V], cache), the cache written in place (at
    ``pos`` for attention, the SSD state and conv window for SSD mixers).
    With ``use_kernels`` the attention core is the ``flash_decode`` kernel
    on the card (one launch per attention layer) and its plain version on
    the CPU; without, the plain version everywhere.  Vision decodes text
    tokens only: the patches were consumed at prefill."""
    with ctx.replicate_plain():
        return _decode_step(params, cfg, cache, tokens, pos, ctx, use_kernels)


def _decode_step(params, cfg: ModelConfig, cache, tokens, pos: int, ctx: ShardingCtx,
                 use_kernels: bool):
    if cfg.modality == "audio-codec":
        x = _embed_codebooks(params, cfg, tokens)
    else:
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

    Returns (last_logits [B, 1, (K,) V], cache with the prefix written and
    room up to max_len).  Each layer's k and v (or SSD conv window and
    state) go straight into the preallocated cache; logits are computed
    for the last position only."""
    with ctx.replicate_plain():
        return _prefill(params, cfg, batch, max_len, ctx)


def _prefill(params, cfg: ModelConfig, batch: dict, max_len: int, ctx: ShardingCtx):
    x, positions, _ = embed_inputs(params, cfg, batch, ctx)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max(max_len, s), ctx, device=x.device)
    for r in range(cfg.num_repeats):
        x = ctx.constrain(x, "batch", "seq", "embed")
        for tmpl, p, c in zip(cfg.pattern, params["blocks"], cache):
            x, _, layer = _apply_block_train(tmpl, _at(p, r), x, positions, cfg, ctx, True)
            for name, value in layer.items():
                _write_repeat(c[name], r, value)
            del layer
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return output_logits(params, cfg, x, ctx), cache
