"""Versioned weight snapshots and the batched sparse margin hot path.

Port of ``repro.serve.engine``.  Serving splits a linear model's
prediction into a frozen, versioned parameter snapshot that swaps
atomically (:class:`WeightSnapshot`) and a margin computation over padded
request batches (:class:`PredictionEngine`):

    s_i = sum_k w[idx[i, k]] * val[i, k]        (per output column)

On a CUDA device :func:`batched_margins` runs the margin kernel
(``ops.sparse_margins``: the one-block launch, the request's global ids
against the whole ``w``); on the CPU, and with ``use_kernels=False``,
the plain ``margins_rows``.  A ``[d, k]`` ``w`` takes one pass per
column, each bit for bit the scalar pass on that column.  The kernel
takes float32 only: a float64 ``w`` or values with ``use_kernels=True``
raise, they are never sent to the plain path.

The kernel sums entry k of a row on lane k mod 32 and a zero-valued pad
entry adds ``fmaf(w[0], 0, acc)``, so padding a request to its bucket
width leaves its margin's bits as they were (``chip_smoke.py`` holds
this on the card).  Snapshots clone ``w`` onto the serving device: the
kernel training path writes ``w``'s blocks in place, so an aliased
snapshot would change under the requests it serves.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.driver import resolve_device
from repro_torch.data.sparse import margins_rows
from repro_torch.kernels import ops

def batched_margins(
    indices,
    values,
    w,
    *,
    use_kernels: bool = True,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """The serving margin computation, as a NumPy array.

    ``indices`` / ``values`` are matching ``[n, width]`` arrays (global
    ids); ``w`` is ``[d]`` (returns ``[n]``) or ``[d, k]`` (returns
    ``[n, k]``, one pass per column).  The batch and ``w`` go to
    ``device`` (default ``cuda``; raises without one).  ``use_kernels``
    (default ``True``) runs the margin kernel on a CUDA device, float32
    only; the CPU and ``use_kernels=False`` take ``margins_rows``.
    """
    device = resolve_device(device)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int32))
    val = torch.as_tensor(values)
    if idx.dim() != 2 or idx.shape != val.shape:
        raise ValueError(
            f"need matching [n, width] arrays, got {tuple(idx.shape)} / "
            f"{tuple(val.shape)}"
        )
    w = torch.as_tensor(w)
    if w.dim() not in (1, 2):
        raise ValueError(f"w must be [d] or [d, k], got shape {tuple(w.shape)}")
    if use_kernels and (w.dtype != torch.float32 or val.dtype != torch.float32):
        raise TypeError(
            f"use_kernels=True scores float32 only, got w {w.dtype} and values "
            f"{val.dtype}; pass use_kernels=False to keep them"
        )
    if idx.shape[0] == 0:
        shape = (0,) if w.dim() == 1 else (0, int(w.shape[1]))
        return np.zeros(shape, dtype=val.numpy().dtype)
    idx = idx.to(device)
    val = val.to(device)
    w = w.to(device)
    column = ops.sparse_margins if use_kernels else margins_rows
    if w.dim() == 1:
        return column(idx, val, w).cpu().numpy()
    out = torch.stack(
        [column(idx, val, w[:, j].contiguous()) for j in range(w.shape[1])], dim=1
    )
    return out.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class WeightSnapshot:
    """A frozen model version: ``w`` is ``[d]`` (binary) or ``[d, k]``
    (one-vs-rest), ``version`` the monotone counter the engine orders
    publishes by.  Build it with :meth:`from_dense`, :meth:`from_blocks` or
    :meth:`from_estimator`, which copy ``w`` onto the serving device."""

    w: torch.Tensor
    version: int

    def __post_init__(self):
        if self.w.dim() not in (1, 2):
            raise ValueError(
                f"w must be [d] or [d, k], got shape {tuple(self.w.shape)}"
            )

    @property
    def dim(self) -> int:
        return int(self.w.shape[0])

    @property
    def num_outputs(self) -> int:
        return 1 if self.w.dim() == 1 else int(self.w.shape[1])

    @property
    def device(self) -> torch.device:
        return self.w.device

    @classmethod
    def from_dense(
        cls, w, version: int, *, device: torch.device | str | None = None
    ) -> "WeightSnapshot":
        """A copy of ``w`` on ``device`` (default ``cuda``)."""
        w = torch.as_tensor(w)
        return cls(w=w.to(resolve_device(device), copy=True), version=version)

    @classmethod
    def from_blocks(
        cls, blocks, version: int, *, device: torch.device | str | None = None
    ) -> "WeightSnapshot":
        """Assemble from per-worker feature blocks (``[d_l]`` or
        ``[d_l, k]`` in partition order); concatenation along the feature
        axis is lossless, so it serves bit for bit as the dense one."""
        blocks = [torch.as_tensor(b) for b in blocks]
        if not blocks:
            raise ValueError("from_blocks needs at least one block")
        ndims = {b.dim() for b in blocks}
        if ndims - {1, 2} or len(ndims) != 1:
            raise ValueError(
                f"blocks must all be [d_l] or all [d_l, k], got ndims {ndims}"
            )
        device = resolve_device(device)
        return cls(w=torch.cat([b.to(device) for b in blocks], dim=0), version=version)

    @classmethod
    def from_estimator(
        cls, clf, version: int, *, device: torch.device | str | None = None
    ) -> "WeightSnapshot":
        """From a fitted ``FDSVRGClassifier``: sklearn's ``coef_`` is
        ``[k, d]`` for one-vs-rest, the engine runs ``[d, k]``.  ``device``
        defaults to the estimator's (``cuda`` when that is ``None``)."""
        clf._check_fitted()
        coef = np.asarray(clf.coef_)
        return cls.from_dense(
            np.ascontiguousarray(coef.T) if coef.ndim == 2 else coef, version,
            device=clf.device if device is None else device,
        )


class PredictionEngine:
    """Batched sparse margins against an atomically swappable snapshot.

    It scores padded ``(indices, values)`` batches and leaves queueing,
    deadlines and snapshot pinning to the caller.  It owns the current
    snapshot (``publish`` swaps it under a lock; versions must strictly
    increase) and the shape meter ``compiled_shapes``: every distinct
    ``(rows, width, k, dtype, use_kernels)`` it has scored, the
    reference's count.  The batches go to the snapshot's device.
    """

    def __init__(self, snapshot: WeightSnapshot | None = None, *,
                 use_kernels: bool = True) -> None:
        self.use_kernels = use_kernels
        self._lock = threading.Lock()
        self._snapshot = snapshot
        self.compiled_shapes: set[tuple] = set()
        self.batches_served = 0
        self.rows_served = 0

    @classmethod
    def from_estimator(cls, clf, *, use_kernels: bool = True,
                       version: int = 0) -> "PredictionEngine":
        """An engine serving a fitted ``FDSVRGClassifier``'s ``coef_`` as
        ``version``, on the estimator's device."""
        return cls(WeightSnapshot.from_estimator(clf, version),
                   use_kernels=use_kernels)

    @property
    def snapshot(self) -> WeightSnapshot:
        snap = self._snapshot
        if snap is None:
            raise ValueError("no snapshot published yet")
        return snap

    @property
    def version(self) -> int:
        return self.snapshot.version

    def publish(self, snapshot: WeightSnapshot) -> WeightSnapshot:
        """Atomically install ``snapshot``; returns the one it replaced (or
        None).  Versions are monotone: serving never steps a model back."""
        with self._lock:
            prev = self._snapshot
            if prev is not None:
                if snapshot.version <= prev.version:
                    raise ValueError(
                        f"publish version {snapshot.version} is not newer "
                        f"than the current {prev.version}"
                    )
                if snapshot.dim != prev.dim:
                    raise ValueError(
                        f"snapshot dim {snapshot.dim} != engine dim "
                        f"{prev.dim}"
                    )
            self._snapshot = snapshot
            return prev

    def margins(self, indices, values, *,
                snapshot: WeightSnapshot | None = None) -> np.ndarray:
        """Margins for one padded batch: ``[n]`` for binary snapshots,
        ``[n, k]`` for multi-output.  ``snapshot`` overrides the current
        one (the serve loop passes the version a batch was pinned to)."""
        snap = self.snapshot if snapshot is None else snapshot
        values = np.asarray(values)
        n, width = values.shape if values.ndim == 2 else (0, 0)
        if n:
            self.compiled_shapes.add(
                (n, width, snap.num_outputs, str(values.dtype), self.use_kernels)
            )
        out = batched_margins(
            indices, values, snap.w, use_kernels=self.use_kernels, device=snap.device
        )
        self.batches_served += 1
        self.rows_served += n
        return out
