"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro.models.layers``.  Parameters are plain tensors in dicts,
as the reference's pytrees; ``init_*`` draw from an explicit
``torch.Generator`` on the target device, in float32, and cast to the
model's dtype (``jax.random`` gives other numbers from the same seed, so
the tests carry the reference's weights across with
:func:`repro_torch.convert.lm_params`).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.sharding.specs import from_shards, is_dtensor, local_offset, only_dims, to_shard


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) so zero-init means identity
    return (normed * (1.0 + scale.float())).to(dtype)


def init_rms_scale(dim: int, device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.zeros((dim,), dtype=torch.float32, device=device)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def normal(
    gen: torch.Generator, shape: tuple[int, ...], scale: float, dtype: torch.dtype
) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 on the generator's device, then
    cast to ``dtype`` (the reference's ``(normal(key, shape) * s).astype``)."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(
    head_dim: int, theta: float, device: torch.device | str = "cpu"
) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,  # [..., S, H, Dh]
    positions: torch.Tensor,  # [..., S]
    theta: float,
) -> torch.Tensor:
    """Rotate the two halves of each head (not interleaved pairs); angles
    are ``positions_f32 * freqs_f32`` in float32, as in the reference."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, Dh/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),  # nemotron squared-ReLU
}


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype, gated: bool = True
) -> dict:
    scale_in = d_model ** -0.5
    scale_out = d_ff ** -0.5
    p = {
        "w_up": normal(gen, (d_model, d_ff), scale_in, dtype),
        "w_down": normal(gen, (d_ff, d_model), scale_out, dtype),
    }
    if gated:
        p["w_gate"] = normal(gen, (d_model, d_ff), scale_in, dtype)
    return p


def mlp(params: dict, x: torch.Tensor, act: str, ctx) -> torch.Tensor:
    """MLP, gated (SwiGLU/GeGLU) when w_gate is present, plain otherwise.
    x: [B, S, D] -> [B, S, D]."""
    u = ctx.constrain(torch.einsum("bsd,df->bsf", x, params["w_up"]), "batch", "seq", "mlp")
    if "w_gate" in params:
        h = torch.einsum("bsd,df->bsf", x, params["w_gate"])
        h = ctx.constrain(h, "batch", "seq", "mlp")
        h = ACTS[act](h) * u
    else:
        h = ACTS[act](u)
    out = torch.einsum("bsf,fd->bsd", h, params["w_down"])
    return ctx.constrain(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype):
    return normal(gen, (vocab, d_model), d_model ** -0.5, dtype)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``table[ids]``.  On a DTensor table each rank reads the rows
    of its own shard (:func:`_lookup_shards`)."""
    if is_dtensor(table):
        return _lookup_shards(table, ids)
    return table[ids.long()]


def _lookup_shards(table, ids) -> torch.Tensor:
    """``table[ids]`` for a DTensor ``table [V, D]`` whose vocabulary may be
    split over ranks (``ids`` a DTensor split along its rows, or a plain
    tensor, replicated): each rank reads the ids that fall in its
    vocabulary shard from its own rows, zeros for the rest, and the pieces
    are left pending (``Partial``) over the axes that split the vocabulary,
    Megatron's vocabulary-parallel embedding.  DTensor's own indexing
    would gather the table, and its ``embedding`` rule's backward does not
    run on every torch release this port runs on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    split = only_dims(table.placements, (0,))
    if tuple(table.placements) != split:  # only the vocabulary stays split
        table = table.redistribute(mesh, split)
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    # the ids whole on the axes that split the vocabulary, as they were on the rest
    rows = tuple(Replicate() if t == Shard(0) else p
                 for t, p in zip(split, ids.placements))
    ids = ids.redistribute(mesh, rows)
    shape, offset = local_offset(table.shape, mesh, split)
    # the table's gradient on a rank sums its own ids only: pending over
    # the axes that split the ids
    grad = tuple(Partial() if t == Replicate() and p.is_shard() else t
                 for t, p in zip(split, rows))
    local = to_shard(table, grad)
    idx = ids.to_local().long() - offset[0]
    inside = (idx >= 0) & (idx < shape[0])
    out = local[torch.where(inside, idx, 0)]
    out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    layout = tuple(Partial() if t == Shard(0) else p for t, p in zip(split, rows))
    return from_shards(out, mesh, layout, tuple(ids.shape) + (table.shape[1],))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, ctx, scale: bool) -> torch.Tensor:
    x = lookup(table, tokens)  # [B, S, D]
    if scale:
        x = x * torch.tensor(table.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return ctx.constrain(x, "batch", "seq", "embed")


def lm_logits(
    x: torch.Tensor,  # [B, S, D]
    table: torch.Tensor,  # [V, D] (tied) or head [D, V]
    *,
    tied: bool,
    cap: float | None,
    ctx,
) -> torch.Tensor:
    if tied:
        logits = torch.einsum("bsd,vd->bsv", x, table)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, table)
    logits = ctx.constrain(logits, "batch", "seq", "vocab")
    return softcap(logits.float(), cap)
