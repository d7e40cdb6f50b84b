"""The one outer-loop harness every optimizer driver runs on.

Port of ``repro.core.driver`` (checkpoint/resume comes with a later
slice).  A driver supplies three hooks:

``snapshot(w) -> (z_data, s0)``
    The data part of the full gradient and the margins at ``w``, compute
    only.  Called once before the first epoch and once after every epoch:
    the post-epoch full gradient is both the next outer's snapshot and the
    same-iterate pair that ``evaluate`` reports from.

``epoch(t, rng, w, z_data, s0) -> w``
    One outer iteration's inner work: draw samples with
    :func:`draw_samples` / :func:`option_mask`, run the inner loop, and
    meter all of the outer's traffic through the backend.

``evaluate(w, z_data, s0) -> (objective, optimality_norm)``
    Defaults to :func:`make_same_iterate_eval`.  It returns Python floats,
    so it is the one place per outer iteration where the host waits for
    the device.

Recovery is epoch-abort-to-snapshot (:class:`RecoveryPolicy`): a
:class:`~repro_torch.dist.faults.FaultError` or a diverged objective
discards the epoch and reruns it from the snapshot the harness holds.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.dist.collectives import Collectives
from repro_torch.dist.faults import FaultError
from repro_torch.dist.meter import CommMeter


class DivergenceError(FaultError):
    """The post-epoch iterate is numerically broken (NaN/inf objective or
    exploding objective) — recovered like any other fault, plus eta
    backoff."""


@dataclasses.dataclass
class OuterRecord:
    outer: int
    objective: float
    grad_norm: float
    comm_scalars: int
    comm_rounds: int
    modeled_time_s: float
    wall_time_s: float


@dataclasses.dataclass
class RunResult:
    w: torch.Tensor
    history: list[OuterRecord]
    meter: CommMeter

    def objectives(self) -> np.ndarray:
        return np.array([h.objective for h in self.history])

    def final_objective(self) -> float:
        return self.history[-1].objective


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise.  With ``device=None`` and no CUDA device this raises — an
    entry point never carries on on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


# ---------------------------------------------------------------------------
# Same-iterate reporting (objective from cached margins, optimality residual)
# ---------------------------------------------------------------------------


def objective_from_margins(
    s: torch.Tensor,
    labels: torch.Tensor,
    w: torch.Tensor,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
) -> float:
    """Objective at ``w`` given the margins ``s = w^T x_i`` already in hand."""
    return float(torch.mean(loss.value(s, labels)) + reg.value(w))


def optimality_norm(
    z_data: torch.Tensor,
    w: torch.Tensor,
    reg: losses_lib.Regularizer,
    eta: float,
) -> float:
    """First-order optimality residual at ``w`` given ``z_data`` at the same w.

    Smooth g: ``||z_data + grad g(w)||``.  Nonsmooth g: the prox
    gradient-mapping norm ``||(w - prox_{eta*g}(w - eta * grad f(w))) / eta||``.
    """
    if reg.is_smooth:
        return float(torch.linalg.norm(z_data + reg.grad(w)))
    # eta stays a Python float, as in the reference's eager evaluation.
    v = reg.prox(w - eta * (z_data + reg.smooth_grad(w)), eta)
    return float(torch.linalg.norm((w - v) / eta))


def make_same_iterate_eval(
    labels: torch.Tensor,
    loss: losses_lib.MarginLoss,
    reg: losses_lib.Regularizer,
    eta: float,
) -> Callable:
    """The standard ``evaluate`` hook: objective from the snapshot margins,
    optimality residual from the snapshot gradient, both at the
    post-epoch iterate."""

    def evaluate(w, z_data, s0):
        obj = objective_from_margins(s0, labels, w, loss, reg)
        return obj, optimality_norm(z_data, w, reg, eta)

    return evaluate


# ---------------------------------------------------------------------------
# Sample / option-mask drawing (one rng-stream convention for all drivers)
# ---------------------------------------------------------------------------


def resolve_init_w(
    init_w: torch.Tensor | np.ndarray | None,
    dim: int,
    dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    """Zeros unless the caller warm-starts, always in the data's dtype and
    on the run's device."""
    if init_w is None:
        return torch.zeros((dim,), dtype=dtype, device=device)
    init_w = torch.as_tensor(init_w).to(dtype=dtype, device=device)
    if tuple(init_w.shape) != (dim,):
        raise ValueError(f"init_w has shape {tuple(init_w.shape)}, expected {(dim,)}")
    return init_w


def draw_samples(rng: np.random.Generator, n: int, m: int, u: int) -> np.ndarray:
    """M mini-batches of u uniform instance ids (the paper's sampling);
    the same draws as the reference for the same generator state."""
    return rng.integers(0, n, size=(m, u), dtype=np.int64).astype(np.int32)


def option_mask(rng: np.random.Generator, m: int, option: str) -> np.ndarray:
    """Step mask: Option I runs all M steps (and draws nothing from the
    rng); Option II stops at a uniform random step."""
    if option == "I":
        return np.ones(m, dtype=np.float32)
    stop = int(rng.integers(1, m + 1))
    return (np.arange(m) < stop).astype(np.float32)


# ---------------------------------------------------------------------------
# Failure semantics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Epoch-abort-to-snapshot recovery for the outer loop.

    On any :class:`~repro_torch.dist.faults.FaultError` raised during an
    epoch or by the divergence guard, the harness discards the failed
    epoch and reruns outer t from the snapshot (w, z, s0).
    ``on_abort(backend)`` meters what the abort costs; after
    ``max_epoch_retries`` failed attempts of one outer the fault
    propagates.
    """

    max_epoch_retries: int = 2
    eta_backoff: float = 0.5  # eta scale multiplier on divergence
    divergence_factor: float = 1e3  # obj > factor * |prev obj| => diverged
    on_abort: Callable | None = None

    def __post_init__(self) -> None:
        if self.max_epoch_retries < 0:
            raise ValueError("max_epoch_retries >= 0 required")
        if not 0.0 < self.eta_backoff <= 1.0:
            raise ValueError("eta_backoff must be in (0, 1]")
        if self.divergence_factor <= 1.0:
            raise ValueError("divergence_factor > 1 required")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def run_outer_loop(
    *,
    outer_iters: int,
    seed: int,
    init_w: torch.Tensor,
    snapshot: Callable,
    epoch: Callable,
    evaluate: Callable,
    backend: Collectives | None = None,
    recovery: RecoveryPolicy | None = None,
) -> RunResult:
    """Run ``outer_iters`` outer iterations with snapshot rotation.

    Per outer t: ``epoch`` consumes the current snapshot, ``snapshot``
    recomputes at the post-epoch iterate (next outer's snapshot and this
    record's diagnostic pair), ``evaluate`` reports.  ``backend=None`` is
    the serial path: zero scalars/rounds/modeled time on a fresh meter.
    """
    rng = np.random.default_rng(seed)
    w = init_w
    meter = backend.meter if backend is not None else CommMeter()
    history: list[OuterRecord] = []
    eta_scale = 1.0
    accepts_scale = "eta_scale" in inspect.signature(epoch).parameters
    t_start = time.perf_counter()
    z_data, s0 = snapshot(w)  # outer-0 snapshot
    prev_obj: float | None = None
    for t in range(outer_iters):
        attempts = 0
        while True:
            try:
                if accepts_scale:
                    w_new = epoch(t, rng, w, z_data, s0, eta_scale=eta_scale)
                else:
                    w_new = epoch(t, rng, w, z_data, s0)
                z_new, s0_new = snapshot(w_new)
                obj, gnorm = evaluate(w_new, z_new, s0_new)
                if recovery is not None:
                    floor = max(abs(prev_obj), 1.0) if prev_obj is not None \
                        else None
                    if not (np.isfinite(obj) and np.isfinite(gnorm)):
                        raise DivergenceError(
                            f"outer {t}: non-finite objective/optimality "
                            f"(obj={obj}, norm={gnorm})"
                        )
                    if floor is not None and \
                            obj > recovery.divergence_factor * floor:
                        raise DivergenceError(
                            f"outer {t}: objective exploded "
                            f"({obj:.3e} > {recovery.divergence_factor:g} * "
                            f"{floor:.3e})"
                        )
                break
            except FaultError as err:
                if recovery is None or attempts >= recovery.max_epoch_retries:
                    raise
                attempts += 1
                if isinstance(err, DivergenceError):
                    eta_scale *= recovery.eta_backoff
                if recovery.on_abort is not None and backend is not None:
                    recovery.on_abort(backend)
        w, z_data, s0 = w_new, z_new, s0_new
        prev_obj = obj
        history.append(
            OuterRecord(
                t,
                obj,
                gnorm,
                meter.total_scalars,
                meter.total_rounds,
                backend.modeled_time_s if backend is not None else 0.0,
                time.perf_counter() - t_start,
            )
        )
    return RunResult(w=w, history=history, meter=meter)
