"""Loss functions and regularizers on the margin (paper §2).

Port of ``repro.core.losses``: the objective is

    min_w  f(w) = (1/N) sum_i phi(w^T x_i, y_i) + g(w)

and every loss exposes ``value(s, y)`` and ``dvalue(s, y)`` elementwise on
the margin ``s = w^T x``.  The expressions keep the reference's operation
order.  ``torch.sigmoid`` / ``torch.logaddexp`` are not bit-identical to
``jax.nn.sigmoid`` / ``jnp.logaddexp``; the tests state the tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class MarginLoss:
    """A loss phi(s, y) defined on the margin s = w^T x."""

    name: str
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    dvalue: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    smoothness: float


def _logistic_value(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # log(1 + exp(-y s)) computed stably.
    z = -y * s
    return torch.logaddexp(torch.zeros_like(z), z)


def _logistic_dvalue(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # d/ds log(1+exp(-ys)) = -y * sigmoid(-y s)
    z = -y * s
    return -y * torch.sigmoid(z)


logistic = MarginLoss(
    name="logistic",
    value=_logistic_value,
    dvalue=_logistic_dvalue,
    smoothness=0.25,
)


def _squared_hinge_value(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    m = torch.clamp_min(1.0 - y * s, 0.0)
    return 0.5 * m * m


def _squared_hinge_dvalue(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    m = torch.clamp_min(1.0 - y * s, 0.0)
    return -y * m


squared_hinge = MarginLoss(
    name="squared_hinge",
    value=_squared_hinge_value,
    dvalue=_squared_hinge_dvalue,
    smoothness=1.0,
)


def _hinge_value(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - y * s, 0.0)


def _hinge_dvalue(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(y * s < 1.0, -y, torch.zeros_like(y))


hinge = MarginLoss(
    name="hinge",
    value=_hinge_value,
    dvalue=_hinge_dvalue,
    smoothness=float("inf"),
)


def _squared_value(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    r = s - y
    return 0.5 * r * r


def _squared_dvalue(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return s - y


squared = MarginLoss(
    name="squared",
    value=_squared_value,
    dvalue=_squared_dvalue,
    smoothness=1.0,
)


LOSSES = {l.name: l for l in (logistic, squared_hinge, hinge, squared)}


def soft_threshold(v: torch.Tensor, t: torch.Tensor | float) -> torch.Tensor:
    """prox of t*||.||_1: sign(v) * max(|v| - t, 0), elementwise — the
    expression the ``prox_update`` kernel (kernels/csrc/prox_update.cu)
    evaluates, in the same order."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """g(w) applied per feature block (paper eq. (3): g decomposes over blocks).

    ``l2`` / ``none`` are the smooth path (:meth:`smooth_grad` folds into
    the data gradient); ``l1`` / ``elastic_net`` go through the
    elementwise, block-local :meth:`prox`.  ``lam`` is the L2 strength for
    ``l2`` and the L1 strength for ``l1`` / ``elastic_net``; ``lam2`` is
    the elastic-net L2 strength.
    """

    name: str
    lam: float
    lam2: float = 0.0

    def value(self, w: torch.Tensor) -> torch.Tensor:
        if self.name == "l2":
            return 0.5 * self.lam * torch.sum(w * w)
        if self.name == "l1":
            return self.lam * torch.sum(torch.abs(w))
        if self.name == "elastic_net":
            return self.lam * torch.sum(torch.abs(w)) + 0.5 * self.lam2 * torch.sum(w * w)
        if self.name == "none":
            return torch.zeros((), dtype=w.dtype, device=w.device)
        raise ValueError(self.name)

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        """(Sub)gradient of g (diagnostics; optimizers use smooth_grad + prox)."""
        if self.name == "l2":
            return self.lam * w
        if self.name == "l1":
            return self.lam * torch.sign(w)
        if self.name == "elastic_net":
            return self.lam * torch.sign(w) + self.lam2 * w
        if self.name == "none":
            return torch.zeros_like(w)
        raise ValueError(self.name)

    @property
    def is_smooth(self) -> bool:
        return self.name in ("l2", "none")

    @property
    def smooth_lam(self) -> float:
        """L2 coefficient folded into the smooth gradient (0 unless 'l2')."""
        return float(self.lam) if self.name == "l2" else 0.0

    @property
    def prox_l1(self) -> float:
        """L1 strength handled by prox (0 for the smooth family)."""
        if self.name in ("l1", "elastic_net"):
            return float(self.lam)
        if self.name in ("l2", "none"):
            return 0.0
        raise ValueError(self.name)

    @property
    def prox_l2(self) -> float:
        """Elastic-net L2 strength handled by prox."""
        return float(self.lam2) if self.name == "elastic_net" else 0.0

    def smooth_grad(self, w: torch.Tensor) -> torch.Tensor:
        """Gradient of the smooth part of g only."""
        if self.name == "l2":
            return self.lam * w
        if self.name in ("l1", "elastic_net", "none"):
            return torch.zeros_like(w)
        raise ValueError(self.name)

    def prox(self, v: torch.Tensor, eta: torch.Tensor | float) -> torch.Tensor:
        """prox_{eta*g_nonsmooth}(v); identity for the smooth family.

        Pass ``eta`` as a float32 tensor to keep the reference's float32
        products ``eta * lam`` and ``1 + eta * lam2``.
        """
        if self.name in ("l2", "none"):
            return v
        if self.name == "l1":
            return soft_threshold(v, eta * self.lam)
        if self.name == "elastic_net":
            out = soft_threshold(v, eta * self.lam)
            return out / (1.0 + eta * self.lam2) if self.lam2 else out
        raise ValueError(self.name)


def l2(lam: float) -> Regularizer:
    return Regularizer("l2", lam)


def l1(lam: float) -> Regularizer:
    return Regularizer("l1", lam)


def elastic_net(lam1: float, lam2: float) -> Regularizer:
    return Regularizer("elastic_net", lam1, lam2)


def no_reg() -> Regularizer:
    return Regularizer("none", 0.0)
