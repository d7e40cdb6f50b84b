"""Tree-structured global sum (paper §4.2, Figure 5).

Port of ``repro.dist.tree``.  Four views of the same reduction:

1. ``tree_schedule(q)`` — the explicit pairing schedule from Figure 5.
2. ``tree_order_sum`` — pairwise summation in schedule order.  Every path
   that sums per-worker partials goes through it, so the association
   order — part of the FD == serial contract — is the same everywhere.
3. ``simulate_tree_sum`` — runs the schedule message by message and
   meters the traffic.
4. ``psum_tree`` / ``collective_permute_tree`` — the device mappings over
   a ``torch.distributed`` process group, one process per worker: one
   all-reduce (NCCL's or gloo's own algorithm), or the recursive-doubling
   butterfly of paired sends and receives.  For a power-of-two q the
   butterfly leaves on every rank the bits of ``tree_order_sum`` of the q
   partials: round r of both adds the same pairs of 2^r-aligned group
   sums (stride 2^r), and a float add is commutative, so ``a + b`` on one
   rank and ``b + a`` on its peer round alike.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.meter import CommMeter


def tree_schedule(q: int) -> list[list[tuple[int, int]]]:
    """Rounds of (src -> dst) sends for a binary-tree reduce of q workers.

    Round r pairs workers at stride 2^r: src = k + 2^r sends to dst = k
    for k ≡ 0 (mod 2^(r+1)); worker 0 is the root.
    """
    rounds: list[list[tuple[int, int]]] = []
    stride = 1
    while stride < q:
        sends = []
        k = 0
        while k + stride < q:
            sends.append((k + stride, k))
            k += 2 * stride
        rounds.append(sends)
        stride *= 2
    return rounds


def broadcast_schedule(q: int) -> list[list[tuple[int, int]]]:
    """Reverse-order tree broadcast (root 0 to everyone)."""
    return [
        [(dst, src) for (src, dst) in rnd] for rnd in reversed(tree_schedule(q))
    ]


def tree_order_sum(parts: Sequence):
    """Pairwise sum of per-worker partials in Figure-5 schedule order.

    Works on anything supporting ``+`` (tensors included); never replace
    it with ``torch.stack(parts).sum(0)``, which associates differently.
    """
    acc = list(parts)
    for rnd in tree_schedule(len(acc)):
        for src, dst in rnd:
            acc[dst] = acc[dst] + acc[src]
    return acc[0]


def simulate_tree_sum(
    values: Sequence[torch.Tensor] | Sequence[float],
    meter: CommMeter | None = None,
    payload: int | None = None,
) -> torch.Tensor:
    """Run the Figure-5 reduce+broadcast over per-worker values.

    Returns the global sum (identical on every worker after broadcast).
    Meters 2*q*payload scalars like the paper's accounting.
    """
    q = len(values)
    acc = [torch.as_tensor(v) for v in values]
    if payload is None:
        payload = int(acc[0].numel())
    total = tree_order_sum(acc)
    for rnd in broadcast_schedule(q):
        for src, dst in rnd:
            acc[dst] = total
    if meter is not None:
        meter.tree_reduce_broadcast(q, payload)
    return total


# ---------------------------------------------------------------------------
# Device mappings (one process per worker, over a torch.distributed group)
# ---------------------------------------------------------------------------


def psum_tree(x: torch.Tensor, group=None, *, inplace: bool = False) -> torch.Tensor:
    """The deployable form: one sum all-reduce over ``group``, the
    backend's own reduce + broadcast, on a copy of ``x`` (on ``x`` itself
    with ``inplace=True``, for a buffer the caller owns).  The sum is left
    replicated on every rank; its association order is the backend's."""
    out = x if inplace else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def collective_permute_tree(
    x: torch.Tensor,
    group,
    axis_size: int,
    ranks: Sequence[int] | None = None,
) -> torch.Tensor:
    """Explicit log-depth all-reduce from paired send/receive rounds.

    A recursive-doubling butterfly: in round r worker i sends its partial
    sum to worker ``i ^ 2^r``, receives that worker's (one
    ``dist.batch_isend_irecv`` pair) and adds it; after log2(q) rounds
    every worker holds the global sum, bit for bit ``tree_order_sum`` of
    the q partials (module docstring).  Equivalent to reduce+broadcast in
    traffic (2q payloads in all) in half the rounds.  ``ranks[i]`` is the
    global rank of worker i (default: the group's ranks in order).
    Requires ``axis_size`` to be a power of two, as the reference does.
    """
    if axis_size & (axis_size - 1):
        raise ValueError(f"axis_size must be a power of two, got {axis_size}")
    if ranks is None:
        ranks = [dist.get_global_rank(group, i) for i in range(axis_size)]
    if len(ranks) != axis_size:
        raise ValueError(f"{len(ranks)} ranks for axis_size={axis_size}")
    me = ranks.index(dist.get_rank())
    out = x.clone(memory_format=torch.contiguous_format)
    stride = 1
    while stride < axis_size:
        peer = ranks[me ^ stride]
        got = torch.empty_like(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, peer, group),
            dist.P2POp(dist.irecv, got, peer, group),
        ])
        for req in reqs:
            req.wait()
        out = out + got
        stride *= 2
    return out
