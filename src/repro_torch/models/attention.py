"""GQA attention: chunked online-softmax train/prefill path + cached decode.

Port of ``repro.models.attention``.  Two cache layouts, as in the
reference: train/prefill lays q out ``[B, H, S, Dh]`` and streams keys and
values through a loop over key chunks with an online-softmax accumulator,
so the ``[S, S]`` score matrix never materialises; decode keeps the cache
``[B, S, Hkv, Dh]`` and attends one new token to its valid prefix.

The decode core goes through :func:`repro_torch.kernels.ops.decode_attention_batched`
(``use_kernels=True``, the default): the ``flash_decode`` kernel on the
card, with the attention logit softcap and the sliding window (gemma2's
layers), its plain version on the CPU.  On a mesh whose ``model`` axis
splits the cache's positions (``"seq_kv": "model"``, every production
mesh) each rank runs the kernel over its own positions
(``ops.decode_attention_partials``), the ranks gather their partial max,
sum and weighted sum, and each merges them in rank order
(``ops.decode_attention_merge``): split-K across ranks, where the
reference leaves GSPMD to reduce over the split axis.
``use_kernels=False`` takes the plain version on any device (under
DTensor on a mesh).  :func:`attention_decode` writes the new
token's k and v into the cache IN PLACE and returns the same dict (the
reference returns a new cache).

Supports: GQA/MQA, RoPE, qk-norm (qwen3), sliding window (gemma2 local
layers), attention logit softcap (gemma2), and the causal block-skipping
lever ``q_chunk`` (:func:`_attention_blockwise`: each query block visits
only the key chunks its mask can reach).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import flash_decode as flash_decode_lib
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, init_rms_scale, normal, rms_norm, softcap
from repro_torch.sharding.specs import (
    from_shards,
    gather_over,
    is_dtensor,
    local_offset,
    only_dims,
    split_axes,
    split_ways,
    to_shard,
    with_dim,
)

_MASK_VALUE = -1e30
# The train path processes queries in blocks whose float32 scores for one
# key chunk stay under this many bytes: each query row's arithmetic is
# unchanged, and a 32,768-token prefill at 40 heads fits beside a
# 14B-parameter model on one card.
SCORE_BLOCK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    window: int | None = None  # sliding window (None = global)
    attn_softcap: float | None = None
    norm_eps: float = 1e-6
    kv_chunk: int = 1024
    # When set, queries are processed in blocks of q_chunk and each block
    # only visits the key chunks its causal/window mask can reach.
    q_chunk: int | None = None

    @property
    def group(self) -> int:
        return self.num_heads // self.num_kv_heads


def init_attention(gen: torch.Generator, d_model: int, cfg: AttnConfig, dtype) -> dict:
    s_in = d_model ** -0.5
    s_out = (cfg.num_heads * cfg.head_dim) ** -0.5
    params = {
        "wq": normal(gen, (d_model, cfg.num_heads, cfg.head_dim), s_in, dtype),
        "wk": normal(gen, (d_model, cfg.num_kv_heads, cfg.head_dim), s_in, dtype),
        "wv": normal(gen, (d_model, cfg.num_kv_heads, cfg.head_dim), s_in, dtype),
        "wo": normal(gen, (cfg.num_heads, cfg.head_dim, d_model), s_out, dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = init_rms_scale(cfg.head_dim, gen.device)
        params["k_norm"] = init_rms_scale(cfg.head_dim, gen.device)
    return params


def _project_qkv(params, x, positions, cfg: AttnConfig, ctx):
    """x: [B, S, D] -> q [B, H, S, Dh], k/v [B, S, Hkv, Dh] (rope applied;
    qk-norm per head before RoPE)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = ctx.constrain(q.transpose(1, 2), "batch", "heads", None, None)  # [B, H, S, Dh]
    k = ctx.constrain(k, "batch", None, "kv_heads", None)
    v = ctx.constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


def _q_block(q: torch.Tensor, kv_chunk: int) -> int:
    """Query rows per block of ``q [B, H, S, Dh]``: the float32 scores
    [B, H, rows, kv_chunk] a device holds (a DTensor's local batch and
    heads) stay under SCORE_BLOCK_BYTES."""
    b, h = (q.to_local() if is_dtensor(q) else q).shape[:2]
    return max(1, min(q.shape[2], SCORE_BLOCK_BYTES // (4 * b * h * kv_chunk)))


def _key_chunks(k, v, positions, cfg: AttnConfig, kc: int) -> list:
    """Key chunks of ``kc`` positions in the order of the reference's scan,
    each expanded to full heads (head h uses KV head h // group) in float32:
    ``(k_r [B, kc, H, Dh], v_r, positions [B, kc])``.  On DTensors the KV
    heads are first made whole on every rank (the query heads a rank holds
    need KV heads other ranks hold, unless each rank holds whole groups)."""
    if is_dtensor(k) and cfg.group > 1:
        from torch.distributed.tensor import Replicate

        whole = with_dim(k.placements, 2, Replicate())
        k, v = k.redistribute(k.device_mesh, whole), v.redistribute(v.device_mesh, whole)
    chunks = []
    for c0 in range(0, k.shape[1], kc):
        sl = slice(c0, c0 + kc)
        k_r = torch.repeat_interleave(k[:, sl], cfg.group, dim=2).float()
        v_r = torch.repeat_interleave(v[:, sl], cfg.group, dim=2).float()
        chunks.append((k_r, v_r, positions[:, sl]))
    return chunks


def _attend(q_blk, qpos, chunks, cfg: AttnConfig, ctx, scale) -> torch.Tensor:
    """Online softmax of the float32 query block ``q_blk [B, H, r, Dh]`` (at
    ``qpos [B, r]``) over ``chunks``, one key chunk at a time: float32
    ``[B, H, r, Dh]``, the reference's scan step for step."""
    if is_dtensor(q_blk):
        return _attend_shards(q_blk, qpos, chunks, cfg, ctx, scale)
    b, h, r, dh = q_blk.shape
    acc = torch.zeros((b, h, r, dh), dtype=torch.float32, device=q_blk.device)
    m = torch.full((b, h, r, 1), _MASK_VALUE, dtype=torch.float32, device=q_blk.device)
    l = torch.zeros((b, h, r, 1), dtype=torch.float32, device=q_blk.device)
    for k_r, v_r, kp in chunks:
        scores = torch.einsum("bhsd,bchd->bhsc", q_blk, k_r) * scale
        scores = softcap(scores, cfg.attn_softcap)
        causal = kp[:, None, None, :] <= qpos[:, None, :, None]
        if cfg.window is not None:
            causal &= (qpos[:, None, :, None] - kp[:, None, None, :]) < cfg.window
        scores = ctx.constrain(
            scores.masked_fill_(~causal, _MASK_VALUE), "batch", "heads", None, None
        )
        # The running max only shifts the exponents (the result does not
        # depend on it), so no gradient flows through it, as in flash
        # attention; read off a detached alias, no autograd node keeps
        # ``scores``, which the next line overwrites.
        m_new = torch.maximum(m, scores.detach().amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = scores.sub_(m_new).exp_()  # exp(scores - m_new), in place
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhsc,bchd->bhsd", p, v_r)
        m = m_new
        del scores, p
    return acc / torch.clamp_min(l, 1e-30)


def _attend_shards(q_blk, qpos, chunks, cfg: AttnConfig, ctx, scale) -> torch.Tensor:
    """:func:`_attend` on DTensors, each rank on its own batch and heads
    shard: every key chunk is laid out like the queries (its heads split as
    the queries' are; where it was replicated, each rank keeps its slice
    and nothing moves), then the plain online softmax runs on the local
    tensors.  DTensor's own einsum would gather the scores of heads split
    unevenly over the ``model`` axis."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, layout = q_blk.device_mesh, tuple(q_blk.placements)
    assert all(p in (Shard(0), Shard(1), Replicate()) for p in layout), layout
    kv_layout = with_dim(layout, 1, Shard(2))  # [B, c, H, Dh]
    shape, offset = local_offset(q_blk.shape, mesh, layout)
    rows = slice(offset[0], offset[0] + shape[0])  # this rank's batch rows
    local = [(to_shard(k.redistribute(mesh, kv_layout)), to_shard(v.redistribute(mesh, kv_layout)),
              kp[rows]) for k, v, kp in chunks]
    out = _attend(to_shard(q_blk), qpos[rows], local, cfg, ctx, scale)
    return from_shards(out, mesh, layout, q_blk.shape)


def attention_train(
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    cfg: AttnConfig,
    ctx,
    *,
    kv_chunk: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Causal (optionally windowed) attention; returns output and (k, v)
    in cache layout so prefill shares this path."""
    s = x.shape[1]
    scale = cfg.head_dim ** -0.5
    kv_chunk = cfg.kv_chunk if kv_chunk is None else kv_chunk
    q, k, v = _project_qkv(params, x, positions, cfg, ctx)

    if cfg.q_chunk is not None and s > cfg.q_chunk:
        y = _attention_blockwise(q, k, v, positions, cfg, ctx, scale)
        return y_project(params, y, ctx, x.dtype), (k, v)

    kv_chunk = min(kv_chunk, s)
    assert s % kv_chunk == 0, f"seq {s} % kv_chunk {kv_chunk} != 0"
    qf = q.float()
    chunks = _key_chunks(k, v, positions, cfg, kv_chunk)
    rows = _q_block(qf, kv_chunk)
    out = _cat_rows([
        _attend(qf[:, :, q0:q0 + rows], positions[:, q0:q0 + rows], chunks, cfg, ctx, scale)
        for q0 in range(0, s, rows)])
    return y_project(params, out, ctx, x.dtype), (k, v)


def _cat_rows(blocks: list) -> torch.Tensor:
    """The query blocks' outputs ``[B, H, r, Dh]`` joined along the rows
    (one ``cat``, so DTensor blocks keep their layout; one block is
    returned as it is)."""
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=2)


def _attention_blockwise(q, k, v, positions, cfg: AttnConfig, ctx, scale) -> torch.Tensor:
    """Causal block-skipping flash attention (exact numerics).

    Queries are processed q_chunk at a time; block i only scans the key
    chunks its mask can reach: ``[lo_i, (i + 1) * qc)`` with ``lo_i = 0``
    for global attention or the window's start aligned down to a key chunk
    for sliding-window layers.  Assumes canonical positions (arange), which
    train/prefill use.  Returns float32 ``[B, H, S, Dh]``.
    """
    s = q.shape[2]
    qc = cfg.q_chunk
    kc = min(cfg.kv_chunk, qc)
    assert s % qc == 0 and qc % kc == 0, (s, qc, kc)
    chunks = _key_chunks(k, v, positions, cfg, kc)
    blocks = []
    for i in range(s // qc):
        qs = slice(i * qc, (i + 1) * qc)
        hi = (i + 1) * qc
        lo = 0
        if cfg.window is not None:
            lo = max(0, (i * qc - cfg.window) // kc * kc)
        blocks.append(_attend(q[:, :, qs].float(), positions[:, qs],
                              chunks[lo // kc: hi // kc], cfg, ctx, scale))
    return _cat_rows(blocks)


def y_project(params, out_f32, ctx, dtype):
    out = out_f32.to(dtype)
    if is_dtensor(out):
        y = _heads_contracted(out, params["wo"])
    else:
        y = torch.einsum("bhsd,hdo->bso", out, params["wo"])
    return ctx.constrain(y, "batch", "seq", "embed")


def _heads_contracted(out, wo) -> torch.Tensor:
    """``einsum("bhsd,hdo->bso", out, wo)`` on DTensors, each rank over its
    own heads: ``wo`` laid out with its heads split as ``out``'s are, the
    local contraction, and the ranks' partial sums left pending
    (``Partial``) over the axes that split the heads (and over those where
    ``out`` is itself a pending sum).  DTensor's own einsum would gather
    ``out`` where the heads split unevenly."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, layout = out.device_mesh, tuple(out.placements)
    assert all(p in (Shard(0), Shard(1), Replicate()) or p.is_partial() for p in layout), layout
    w = wo.redistribute(mesh, with_dim(only_dims(layout, (1,)), 1, Shard(0)))
    # each rank's gradient of w sums over its own batch rows (or its part of
    # a pending sum) only: pending over those axes
    w_grad = tuple(Partial() if p == Shard(0) or p.is_partial() else q
                   for p, q in zip(layout, w.placements))
    y = torch.einsum("bhsd,hdo->bso", to_shard(out), to_shard(w, w_grad))
    # the contraction is linear: a pending sum in ``out`` stays pending in y
    y_layout = with_dim(layout, 1, Partial())
    return from_shards(y, mesh, y_layout, (out.shape[0], out.shape[2], wo.shape[-1]))


def init_kv_cache(
    batch: int, max_len: int, cfg: AttnConfig, dtype, ctx, device: torch.device | str = "cpu"
) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    return {
        "k": ctx.constrain(k, "batch", "seq_kv", None, None),
        "v": ctx.constrain(v, "batch", "seq_kv", None, None),
    }


def _write_position(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos] = new[:, 0]`` in place.  On a DTensor whose position
    axis is split over ranks the rank holding ``pos`` writes it into its
    shard (``new`` brought to the cache's layout first)."""
    if not is_dtensor(cache):
        cache[:, pos : pos + 1] = new
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    new = new.redistribute(mesh, with_dim(cache.placements, 1, Replicate())).to_local()
    shape, offset = local_offset(cache.shape, mesh, cache.placements)
    at = pos - offset[1]
    if 0 <= at < shape[1]:
        cache.to_local()[:, at : at + 1] = new


def split_k_decode(
    q: torch.Tensor,  # [b, Hkv, G, Dh]: this rank's requests
    k: torch.Tensor,  # [b, S_r, Hkv, Dh]: its shard of the cache's positions
    v: torch.Tensor,
    *,
    offset: int,  # the global position of the shard's first row
    length: int,
    scale: float,
    softcap: float | None,
    window: int | None,
    gather: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:  # float32 [b, Hkv, G, Dh]
    """One rank's decode attention over a cache split by position
    (split-K across ranks): the kernel's partials over the global
    positions its shard holds (``ops.decode_attention_partials``),
    every rank's partials through ``gather`` (a plain tensor -> the
    ranks' tensors in rank order along a new leading axis), merged in rank
    order (``ops.decode_attention_merge``).  Every rank merges the same
    partials, so every rank holds the same bits."""
    parts = ops.decode_attention_partials(q, k, v, offset=offset, length=length, scale=scale,
                                          softcap=softcap, window=window)
    return ops.decode_attention_merge(*(gather(x) for x in parts))


def _decode_local(qg, k, v, length: int, scale: float, cfg: AttnConfig) -> torch.Tensor:
    """The ``flash_decode`` route on DTensors.  Each rank takes its batch
    shard of ``qg`` (the heads whole).  Where the cache's positions are
    whole on every rank (a mesh whose ``model`` axis is 1) the kernel runs
    on the local cache.  Where they are split, :func:`split_k_decode` runs
    on the rank's shard at its global offset, gathering over the mesh
    dimensions that split the positions (rank order, major first).  A
    cache split over heads, which ``cache_specs`` never lays out, raises."""
    mesh = k.device_mesh
    if split_ways(k, 2) > 1:
        raise ValueError(
            "flash_decode on a mesh needs the KV cache's heads whole on every rank "
            f"(placements {tuple(k.placements)} over mesh {tuple(mesh.shape)}; cache_specs "
            "never splits them); pass use_kernels=False for the plain decode under DTensor")
    batch = only_dims(k.placements, (0,))
    q_local = qg.redistribute(mesh, batch).to_local()
    opts = {"scale": scale, "softcap": cfg.attn_softcap, "window": cfg.window}
    if split_ways(k, 1) == 1:
        out = ops.decode_attention_batched(q_local, k.to_local(), v.to_local(), length=length,
                                           **opts)
        return from_shards(out, mesh, batch, qg.shape)
    _, offset = local_offset(k.shape, mesh, k.placements)
    axes = split_axes(k, 1)

    def gather(x):
        for name in reversed(axes):  # minor first, so the major axis ends up outermost
            x = gather_over(x, mesh, name)
        return x.flatten(0, len(axes) - 1)

    out = split_k_decode(q_local, k.to_local(), v.to_local(), offset=offset[1], length=length,
                         gather=gather, **opts)
    return from_shards(out, mesh, batch, qg.shape)


def attention_decode(
    params: dict,
    x: torch.Tensor,  # [B, 1, D] current token's activations
    cache: dict,  # {"k": [B, S, Hkv, Dh], "v": ...}, written in place at pos
    pos: int,  # current position (same for the whole batch), a host int
    cfg: AttnConfig,
    ctx,
    *,
    use_kernels: bool = True,
) -> tuple[torch.Tensor, dict]:
    b, one, d = x.shape
    hkv, dh, g = cfg.num_kv_heads, cfg.head_dim, cfg.group
    scale = dh ** -0.5
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)

    q, k_new, v_new = _project_qkv(params, x, positions, cfg, ctx)
    if is_dtensor(q):  # the query heads whole, to group them by KV head
        from torch.distributed.tensor import Replicate

        q = q.redistribute(q.device_mesh, with_dim(q.placements, 1, Replicate()))
    # q: [B, H, 1, Dh] -> grouped [B, Hkv, G, Dh]
    qg = q[:, :, 0, :].reshape(b, hkv, g, dh)

    k, v = cache["k"], cache["v"]
    _write_position(k, pos, k_new)
    _write_position(v, pos, v_new)

    if use_kernels and is_dtensor(k):
        out = _decode_local(qg, k, v, pos + 1, scale, cfg)
    elif use_kernels:
        out = ops.decode_attention_batched(qg, k, v, length=pos + 1, scale=scale,
                                           softcap=cfg.attn_softcap, window=cfg.window)
    else:
        out = flash_decode_lib.flash_decode_plain(
            qg, k, v, pos + 1, scale, softcap=cfg.attn_softcap, window=cfg.window
        )
    out = out.reshape(b, 1, cfg.num_heads, dh).transpose(1, 2)  # [B, H, 1, Dh]
    return y_project(params, out, ctx, x.dtype), cache


def attention_ref(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: AttnConfig,
    ctx,
) -> torch.Tensor:
    """Materialized-logits oracle (small shapes / tests only)."""
    q, k, v = _project_qkv(params, x, positions, cfg, ctx)
    k_r = torch.repeat_interleave(k, cfg.group, dim=2)  # [B, S, H, Dh]
    v_r = torch.repeat_interleave(v, cfg.group, dim=2)
    scores = torch.einsum("bhsd,bthd->bhst", q.float(), k_r.float()) * (cfg.head_dim ** -0.5)
    scores = softcap(scores, cfg.attn_softcap)
    causal = positions[:, None, None, :] <= positions[:, None, :, None]
    if cfg.window is not None:
        causal &= (positions[:, None, :, None] - positions[:, None, None, :]) < cfg.window
    scores = torch.where(causal, scores, _MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bhsd", p, v_r.float()).to(x.dtype)
    return torch.einsum("bhsd,hdo->bso", out, params["wo"])
