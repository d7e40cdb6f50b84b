"""Tree-structured global sum (paper §4.2, Figure 5).

Port of ``repro.dist.tree`` (the schedule, the canonical summation order
and the executable spec; the device-collective mappings come with the
multi-device slice):

1. ``tree_schedule(q)`` — the explicit pairing schedule from Figure 5.
2. ``tree_order_sum`` — pairwise summation in schedule order.  Every path
   that sums per-worker partials goes through it, so the association
   order — part of the FD == serial contract — is the same everywhere.
3. ``simulate_tree_sum`` — runs the schedule message by message and
   meters the traffic.
"""

from __future__ import annotations

from typing import Sequence

import torch

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
