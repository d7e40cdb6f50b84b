"""Top-k MoE with capacity-bounded sort dispatch.

Port of ``repro.models.moe``.  Routing (per token): softmax router in
float32, top-k experts, combine weights renormalized over the selected k
(OLMoE / Mixtral convention).  Dispatch is the reference's sort-based
fixed-capacity scheme:

  1. flatten the (token, k) assignment pairs and sort them by expert id
     (a stable sort, as the reference's ``argsort(stable=True)``),
  2. rank each pair within its expert's run; pairs ranked at or past the
     per-expert capacity C are dropped (GShard-style overflow),
  3. gather tokens into an ``[E, C, D]`` buffer -> per-expert GEMMs,
  4. combine the weighted expert outputs back to ``[T, D]``.

Where the reference scatters (``.at[slot].set(mode="drop")``, then
``.at[tok].add``), the port gathers, so nothing depends on the order of
atomic adds: slot ``(e, c)`` of the buffer reads the pair at sorted
position ``start_e + c`` when ``c`` is below expert e's count (else the
zero pad row, weight 0), and each token sums its k kept contributions in
its top-k order (a dropped pair is masked to 0).  Two runs on the card
repeat bit for bit.  The reference's scatter-add sums a token's terms in
slot order instead, so the two agree to rounding, not bit for bit.  In
a training step the gathers' backward is ``scatter_add_``, whose atomics
add in a varying order on the card, so MoE gradients do not repeat bit
for bit there.

Dispatch groups follow the mesh's batch axes, as in the reference
(``_num_groups``: one group per data shard, one without a mesh); the
group axis is written out as a batch dimension where the reference vmaps.
On a mesh the integer dispatch plan of each group is computed on the rank
that holds it (:func:`_per_group`), and the gathers, the expert GEMMs on
the expert shards and the combine run under DTensor.

Aux outputs: load-balance loss (Switch-style), router z-loss and the
fraction of pairs dropped.  The expert GEMMs are ``torch.einsum``, as the
reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import normal
from repro_torch.sharding.specs import axis_size, from_shards, is_dtensor, only_dims


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype) -> dict:
    """The router in float32 (as the reference), the experts in ``dtype``."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    return {
        "router": normal(gen, (d, e), s_in, torch.float32),
        "w_gate": normal(gen, (e, d, f), s_in, dtype),
        "w_up": normal(gen, (e, d, f), s_in, dtype),
        "w_down": normal(gen, (e, f, d), s_out, dtype),
    }


def capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cfg.top_k, min(c, tokens))


def _num_groups(ctx, b: int) -> int:
    """Dispatch groups = data-parallel shards (GShard-style), so routing,
    capacity and the token<->expert buffers stay shard-local: the size of
    the ``batch`` axes, halved until it divides ``b`` (1 without a mesh)."""
    if ctx is None or getattr(ctx, "mesh", None) is None:
        return 1
    g = axis_size(ctx.mesh, "batch")
    while g > 1 and b % g:
        g //= 2
    return max(1, g)


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """xt [..., T, D] -> float32 logits, probs [..., T, E] and the top-k
    (renormalized weights, expert ids) [..., T, k].  The router is float32;
    a training step's compute copy may hold it in bfloat16, which the
    reference's einsum promotes to float32, as here."""
    logits = torch.einsum("...td,de->...te", xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    return logits, probs, top_w, top_e


def _dispatch_plan(top_e: torch.Tensor, cap: int, e: int) -> tuple:
    """The integer side of the sort-based dispatch of each group's (token,
    expert) pairs ``top_e [G, Tg, k]``: ``order`` (pairs sorted by expert,
    stably), for each of the ``E * cap`` buffer slots its sorted position
    ``src``, whether it is ``filled`` and the token it reads ``buf_tok``
    (``Tg``: the zero pad row), and for each pair in token-major order the
    slot it reads back ``pick`` and whether it was ``kept``; ``keep`` is
    ``kept`` in sorted order.  Each group's plan is its own."""
    g, tg, k = top_e.shape
    n = tg * k
    dev = top_e.device
    flat_e = top_e.reshape(g, n)
    flat_t = torch.arange(tg, device=dev).repeat_interleave(k).expand(g, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(n, device=dev) - first
    keep = rank < cap  # [G, n], sorted order
    # Slot (e, c) reads sorted position start_e + c while c < count_e.
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    start = torch.searchsorted(se, experts, side="left")  # [G, E]
    count = torch.searchsorted(se, experts, side="right") - start
    c_idx = torch.arange(cap, device=dev)
    filled = c_idx[None, None, :] < count[:, :, None]  # [G, E, C]
    src = torch.clamp_max(start[:, :, None] + c_idx[None, None, :], n - 1).reshape(g, e * cap)
    filled = filled.reshape(g, e * cap)
    buf_tok = torch.where(filled, torch.gather(st, 1, src), tg)
    slot_sorted = se * cap + rank  # valid where keep
    inv = torch.empty_like(order).scatter_(1, order, torch.arange(n, device=dev).expand(g, n))
    slot = torch.gather(slot_sorted, 1, inv)  # [G, n], token-major (t, j) order
    kept = torch.gather(keep, 1, inv)
    return order, src, filled, buf_tok, torch.where(kept, slot, 0), kept, keep


def _per_group(fn, x: torch.Tensor, *args) -> tuple:
    """``fn(x, *args)`` for a function whose outputs are integer tensors
    with ``x``'s leading group axis and depend on each group alone.  On a
    DTensor it runs on each rank's local groups (``x`` first brought to a
    layout split along the group axis only) and the outputs come back as
    DTensors laid out the same way."""
    if not is_dtensor(x):
        return fn(x, *args)
    groups = only_dims(x.placements, (0,))
    x = x.redistribute(x.device_mesh, groups)
    return tuple(from_shards(o, x.device_mesh, groups, (x.shape[0],) + tuple(o.shape[1:]))
                 for o in fn(x.to_local(), *args))


def moe_ffn(
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    cfg: MoEConfig,
    ctx,
    num_groups: int | None = None,
) -> tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    g = _num_groups(ctx, b) if num_groups is None else num_groups
    tg = t // g  # tokens per group
    cap = capacity(tg, cfg)
    dev = x.device
    xg = x.reshape(g, tg, d)

    # ---- routing (per group) ----
    logits, probs, top_w, top_e = _route(xg, params["router"], k)  # [G, Tg, (E | k)]
    chosen = (top_e[..., None] == torch.arange(e, device=dev)).any(dim=2).float()  # [G, Tg, E]
    frac_tokens = chosen.mean(dim=1)  # [G, E]: share of tokens that picked each expert
    frac_probs = probs.mean(dim=1)
    lb_loss = e * torch.sum(frac_tokens * frac_probs, dim=-1)  # [G]
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1)

    # ---- sort-based dispatch (gathers only) ----
    order, src, filled, buf_tok, pick, kept, keep = _per_group(_dispatch_plan, top_e, cap, e)
    flat_w = top_w.reshape(g, tg * k)
    sw = torch.gather(flat_w, 1, order)
    buf_w = torch.where(filled, torch.gather(sw, 1, src), 0.0)

    xt_pad = torch.cat([xg, torch.zeros((g, 1, d), dtype=x.dtype, device=dev)], dim=1)
    dispatched = torch.gather(xt_pad, 1, buf_tok[..., None].expand(g, e * cap, d))
    dispatched = ctx.constrain(dispatched.reshape(g, e, cap, d), "batch", "experts", None, "embed")

    # ---- expert GEMMs ----
    h = torch.einsum("gecd,edf->gecf", dispatched, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", dispatched, params["w_up"])
    h = ctx.constrain(h, "batch", "experts", None, "expert_mlp")
    h = _act(h, cfg.act) * u
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"])
    out_buf = ctx.constrain(out_buf, "batch", "experts", None, "embed")

    # ---- combine: each token sums its k kept contributions in top-k order ----
    contrib = out_buf.reshape(g, e * cap, d) * buf_w[..., None].to(out_buf.dtype)
    picked = torch.gather(contrib, 1, pick[..., None].expand(g, tg * k, d))
    picked = torch.where(kept[..., None], picked, torch.zeros((), dtype=picked.dtype, device=dev))
    y = picked.reshape(g, tg, k, d).sum(dim=2)
    y = ctx.constrain(y.reshape(b, s, d), "batch", "seq", "embed")

    aux = {
        "lb_loss": torch.mean(lb_loss),
        "z_loss": torch.mean(z_loss),
        "overflow_frac": 1.0 - torch.mean(keep.float()),
    }
    return y.to(x.dtype), aux


def moe_ffn_dense_ref(params: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Oracle: compute every expert densely, combine by router weights.
    O(E x) compute — tests only.  Matches moe_ffn when no token overflows
    capacity."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    _, _, top_w, top_e = _route(xt, params["router"], cfg.top_k)
    h = torch.einsum("td,edf->etf", xt, params["w_gate"])
    u = torch.einsum("td,edf->etf", xt, params["w_up"])
    all_out = torch.einsum("etf,efd->etd", _act(h, cfg.act) * u, params["w_down"])  # [E, T, D]
    combine = torch.zeros((t, cfg.num_experts), dtype=torch.float32, device=x.device)
    combine = combine.scatter_add_(1, top_e, top_w)
    y = torch.einsum("te,etd->td", combine.to(all_out.dtype), all_out)
    return y.reshape(b, s, d).to(x.dtype)
