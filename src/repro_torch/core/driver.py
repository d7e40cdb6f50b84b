"""The one outer-loop harness every optimizer driver runs on.

Port of ``repro.core.driver``.  A driver supplies three hooks:

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
:class:`~repro_torch.dist.faults.FaultError` (a worker crash or retries
exhausted, from :class:`~repro_torch.dist.faults.FaultyBackend`) or a
diverged objective discards the epoch and reruns it from the snapshot the
harness holds.  Checkpoint/resume (:class:`CheckpointPolicy`): every k
outers the harness persists (w, z, s0, outer index, eta scale, NumPy rng
state, meter counters and event log, modeled time, history) through
:mod:`repro_torch.checkpoint.ckpt`; a resumed run is bit for bit the
uninterrupted one.

While a profiler records, each outer iteration is an ``rt/outer`` span
holding its ``rt/epoch``, ``rt/snapshot`` and ``rt/evaluate``; the
outer-0 snapshot is an ``rt/snapshot`` before them
(:mod:`repro_torch.spans`).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import losses as losses_lib
from repro_torch.dist.collectives import Collectives
from repro_torch.dist.faults import FaultError
from repro_torch.dist.meter import CommMeter
from repro_torch.spans import span


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
    num_outputs: int = 1,
) -> torch.Tensor:
    """Zeros unless the caller warm-starts, always in the data's dtype and
    on the run's device.  ``num_outputs > 1`` is the multi-output shape
    ``w ∈ R^{d×k}``; 1 keeps the 1-D iterate."""
    shape = (dim,) if num_outputs == 1 else (dim, num_outputs)
    if init_w is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    init_w = torch.as_tensor(init_w).to(dtype=dtype, device=device)
    if tuple(init_w.shape) != shape:
        raise ValueError(f"init_w has shape {tuple(init_w.shape)}, expected {shape}")
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


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Persist outer-loop state every ``every`` outers (and at the end).

    One rolling checkpoint at ``<directory>/outer``: (w, z, s0) in the
    npz, everything else in the json sidecar's ``extra``.  ``resume=True``
    restores it before the first epoch when it exists (and starts fresh
    when it does not); the resumed run is bit for bit the uninterrupted
    one.  Restored tensors go to the device the run's snapshot lies on.
    """

    directory: str
    every: int = 1
    resume: bool = False

    def __post_init__(self) -> None:
        if not self.directory:
            raise ValueError("CheckpointPolicy.directory must be non-empty")
        if self.every < 1:
            raise ValueError("CheckpointPolicy.every >= 1 required")

    @property
    def path(self) -> str:
        return os.path.join(self.directory, "outer")

    def exists(self) -> bool:
        return os.path.exists(self.path + ".npz")


_CKPT_VERSION = 1


def _save_outer_state(
    policy: CheckpointPolicy,
    *,
    w,
    z_data,
    s0,
    outer_next: int,
    eta_scale: float,
    rng: np.random.Generator,
    meter: CommMeter,
    modeled_time_s: float,
    history: list[OuterRecord],
) -> None:
    ckpt.save(
        policy.path,
        {"w": w, "z": z_data, "s0": s0},
        extra={
            "version": _CKPT_VERSION,
            "outer_next": int(outer_next),
            "eta_scale": float(eta_scale),
            "rng_state": rng.bit_generator.state,
            "meter": meter.state_dict(),
            "modeled_time_s": float(modeled_time_s),
            "history": [dataclasses.asdict(h) for h in history],
        },
    )


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
    checkpoint: CheckpointPolicy | None = None,
) -> RunResult:
    """Run ``outer_iters`` outer iterations with snapshot rotation.

    Per outer t: ``epoch`` consumes the current snapshot, ``snapshot``
    recomputes at the post-epoch iterate (next outer's snapshot and this
    record's diagnostic pair), ``evaluate`` reports.  ``backend=None`` is
    the serial path: zero scalars/rounds/modeled time on a fresh meter.
    A backend with ``begin_outer`` (a ``FaultyBackend``) is told each
    outer before its epoch, which arms the plan's crashes.
    ``checkpoint`` arms persistence and resume (:class:`CheckpointPolicy`).
    """
    rng = np.random.default_rng(seed)
    w = init_w
    meter = backend.meter if backend is not None else CommMeter()
    history: list[OuterRecord] = []
    eta_scale = 1.0
    start_outer = 0
    accepts_scale = "eta_scale" in inspect.signature(epoch).parameters
    t_start = time.perf_counter()
    with span("rt/snapshot"):
        z_data, s0 = snapshot(w)  # outer-0 snapshot
    if checkpoint is not None and checkpoint.resume and checkpoint.exists():
        state = ckpt.restore(checkpoint.path, {"w": w, "z": z_data, "s0": s0})
        extra = ckpt.load_meta(checkpoint.path)["extra"]
        w, z_data, s0 = state["w"], state["z"], state["s0"]
        rng.bit_generator.state = extra["rng_state"]
        meter.load_state(extra["meter"])
        if backend is not None:
            # 0.0 + x == x bitwise, and modeled time accumulates left to
            # right, so re-charging the saved prefix then continuing is
            # exactly the uninterrupted sum.
            backend.charge_seconds(extra["modeled_time_s"])
        eta_scale = float(extra["eta_scale"])
        start_outer = int(extra["outer_next"])
        history = [OuterRecord(**h) for h in extra["history"]]
        if history:
            t_start = time.perf_counter() - history[-1].wall_time_s
    prev_obj: float | None = None
    for t in range(start_outer, outer_iters):
        with span("rt/outer"):
            attempts = 0
            while True:
                begin_outer = getattr(backend, "begin_outer", None)
                if begin_outer is not None:
                    begin_outer(t)
                try:
                    with span("rt/epoch"):
                        if accepts_scale:
                            w_new = epoch(t, rng, w, z_data, s0, eta_scale=eta_scale)
                        else:
                            w_new = epoch(t, rng, w, z_data, s0)
                    with span("rt/snapshot"):
                        z_new, s0_new = snapshot(w_new)
                    with span("rt/evaluate"):
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
            if checkpoint is not None and (
                (t + 1) % checkpoint.every == 0 or t == outer_iters - 1
            ):
                _save_outer_state(
                    checkpoint,
                    w=w,
                    z_data=z_data,
                    s0=s0,
                    outer_next=t + 1,
                    eta_scale=eta_scale,
                    rng=rng,
                    meter=meter,
                    modeled_time_s=(
                        backend.modeled_time_s if backend is not None else 0.0
                    ),
                    history=history,
                )
    return RunResult(w=w, history=history, meter=meter)
