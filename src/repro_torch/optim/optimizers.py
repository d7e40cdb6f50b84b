"""Hand-rolled optimizers with the reference's functional interface.

Port of ``repro.optim.optimizers``: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, applied with
:func:`apply_updates`.  A state is a nest of float32 tensors that mirrors
the parameter tree (adamw's step count ``t`` a 0-dim int32 on the
parameters' device), so the reference's states carry across leaf for
leaf (:func:`repro_torch.convert.train_state`).  Nothing is updated in
place: ``update`` returns new tensors, as the reference's pure functions
do, so a caller may step twice from one state.  Inside, each update is a
few ``torch._foreach_*`` calls over the flat list of leaves, in the
reference's rounding order (AdamW is ``(m / bc1) / (sqrt(v / bc2) +
eps)``, plus ``weight_decay * p``, times ``-lr``; ``torch.optim.AdamW``
rounds in another order and is not used).

Trees are nests of dicts (leaves in sorted key order, as the reference's
pytrees flatten), lists, tuples and named tuples with tensor leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` in its flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            children = [build(v) for v in node]
            return type(node)(*children) if hasattr(node, "_fields") else type(node)(children)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params, updates):
    """``p + u`` (in ``p``'s dtype) for every leaf: new tensors."""
    p = tree_leaves(params)
    u = [ui.to(pi.dtype) for ui, pi in zip(tree_leaves(updates), p)]
    return tree_unflatten(params, torch._foreach_add(p, u))


def _f32(leaves: list) -> list:
    return [g.float() for g in leaves]


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        return tree_unflatten(grads, torch._foreach_mul(_f32(tree_leaves(grads)), -lr)), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_f32(params)}

    def update(grads, state, params):
        m = torch._foreach_mul(tree_leaves(state["m"]), beta)
        torch._foreach_add_(m, _f32(tree_leaves(grads)))
        m_tree = tree_unflatten(state["m"], m)
        return tree_unflatten(grads, torch._foreach_mul(m, -lr)), {"m": m_tree}

    return Optimizer(init, update)


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        device = tree_leaves(params)[0].device
        return {
            "m": _zeros_like_f32(params),
            "v": _zeros_like_f32(params),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(grads, state, params):
        t = state["t"] + 1
        g = _f32(tree_leaves(grads))
        m = torch._foreach_mul(tree_leaves(state["m"]), b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        g2 = torch._foreach_mul(g, g)
        del g
        torch._foreach_mul_(g2, 1 - b2)
        v = torch._foreach_mul(tree_leaves(state["v"]), b2)
        torch._foreach_add_(v, g2)
        del g2
        tf = t.float()
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(m, bc1)
        torch._foreach_div_(step, denom)
        del denom
        if weight_decay:
            torch._foreach_add_(step, torch._foreach_mul(_f32(tree_leaves(params)),
                                                         weight_decay))
        torch._foreach_mul_(step, -lr)
        state = {"m": tree_unflatten(state["m"], m), "v": tree_unflatten(state["v"], v),
                 "t": t}
        return tree_unflatten(grads, step), state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SVRG for deep models — the paper's optimizer generalized
# ---------------------------------------------------------------------------


class SVRGState(NamedTuple):
    anchor_params: Any  # w~_0
    anchor_grad: Any  # z = full (large-batch) gradient at the anchor
    inner: Any  # wrapped optimizer state


def svrg(base: Optimizer) -> Optimizer:
    """Variance-reduced wrapper: callers must compute, per step, BOTH the
    minibatch gradient at the current params and at the anchor params, and
    pass ``grads = (g_current, g_anchor)``.  The update applied is

        g_vr = g_current - g_anchor + z      (Algorithm 2 line 7)

    Refresh the anchor with :func:`svrg_refresh` every epoch (outer loop).
    No training entry point passes such a pair (as in the reference).
    """

    def init(params):
        return SVRGState(
            anchor_params=tree_map(lambda p: p, params),
            anchor_grad=_zeros_like_f32(params),
            inner=base.init(params),
        )

    def update(grads, state: SVRGState, params):
        g_cur, g_anc = grads
        g_vr = torch._foreach_sub(_f32(tree_leaves(g_cur)), _f32(tree_leaves(g_anc)))
        torch._foreach_add_(g_vr, tree_leaves(state.anchor_grad))
        updates, inner = base.update(tree_unflatten(g_cur, g_vr), state.inner, params)
        return updates, SVRGState(state.anchor_params, state.anchor_grad, inner)

    return Optimizer(init, update)


def svrg_refresh(state: SVRGState, params, full_grad) -> SVRGState:
    return SVRGState(
        anchor_params=tree_map(lambda p: p, params),
        anchor_grad=tree_map(lambda g: g.float(), full_grad),
        inner=state.inner,
    )


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adamw": adamw}
