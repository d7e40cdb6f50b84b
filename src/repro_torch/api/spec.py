"""`ExperimentSpec` — the one declarative problem description every caller
hands to :func:`repro_torch.api.solve`.

Port of ``repro.api.spec``, with the same fields, defaults and validation
except where the port differs by design:

* ``use_kernels`` defaults to ``True``: on a CUDA device the run goes
  through the port's CUDA kernels, float32 only (float64 ``data`` with
  ``use_kernels=True`` is refused here, never sent to the plain path);
* ``device`` (new) is where the run lives, resolved by
  :func:`repro_torch.core.driver.resolve_device` inside ``solve``:
  ``None`` means ``cuda`` and raises without a card;
* ``init_w`` is a ``torch.Tensor`` or a NumPy array;
* ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` (one process
  per rank, every rank calling ``solve`` with its own spec), ``None``
  meaning one rank and no process group.

The spec's parts:

* **one regularizer** — a single :class:`repro_torch.core.losses.Regularizer`;
  the headline strength is ``spec.reg.lam``;
* **"paper" auto-defaults** — ``eta``, ``batch_size`` and ``inner_steps``
  default to the sentinel string ``"paper"``, resolved per method by the
  registry (the ``m = N/u`` rule, the per-method step sizes, the
  inner-step cap);
* **loud validation** — structural errors fail here; capability
  mismatches fail inside :func:`repro_torch.api.solve` against the
  registry's :class:`~repro_torch.api.registry.MethodInfo` record.

The spec is frozen: derive variants with :meth:`ExperimentSpec.replace`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.fdsvrg import _check_kernel_dtype
from repro_torch.data.sparse import PaddedCSR
from repro_torch.dist import ClusterModel

#: Sentinel for "resolve this per method from the registry's paper defaults".
PAPER = "paper"


@dataclasses.dataclass(frozen=True, eq=False)
class ExperimentSpec:
    """A complete, declarative description of one optimization run.

    Exactly one of ``dataset`` (a :mod:`repro_torch.data.datasets` key),
    ``data`` (an in-memory :class:`~repro_torch.data.sparse.PaddedCSR`),
    or ``source`` (a :class:`~repro_torch.data.pipeline.DataSource` or a
    LibSVM file path — the streaming out-of-core path) must be set.
    ``eq=False``: specs carry tensors (``data``, ``init_w``), so identity
    is the right equality.
    """

    method: str
    dataset: str | None = None
    data: PaddedCSR | None = None
    # Streaming ingestion (repro_torch.data.pipeline): a DataSource or a
    # LibSVM path; methods must advertise supports_streaming.
    source: Any | None = None
    # On-disk slab cache for source= runs (repro_torch.data.ingest_cache);
    # None disables caching.
    data_cache_dir: str | None = None
    # Host-memory bound for streamed parsing, in rows per chunk.
    ingest_chunk_rows: int = 65536
    loss: str = "logistic"
    reg: losses_lib.Regularizer = losses_lib.l2(1e-4)  # paper §5.3 default
    q: int | None = None  # workers; None -> dataset default (or 1 for raw data)
    eta: float | str = PAPER
    batch_size: int | str = PAPER
    inner_steps: int | str = PAPER
    outer_iters: int = 6
    option: str = "I"  # Algorithm 2 Option I/II
    seed: int = 0
    use_kernels: bool = True
    # None -> the dense inner step; "exact" -> bitwise-equivalent delayed
    # decay; "proba" -> unbiased probabilistic decay.
    lazy_updates: str | None = None
    cluster: ClusterModel | None = None  # None -> the backend's default
    init_w: torch.Tensor | np.ndarray | None = None  # warm start (None -> zeros)
    # Outer-loop checkpoint/resume (methods with supports_checkpoint).
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = False
    # Mesh-only knobs (validated against MethodInfo.needs_mesh):
    mesh: Any | None = None  # a DeviceMesh; None -> one rank, no process group
    tree_mode: str = "psum"  # "psum" | "butterfly"
    device: torch.device | str | None = None  # None -> cuda (raises without one)

    def __post_init__(self) -> None:
        given = sum(
            x is not None for x in (self.dataset, self.data, self.source)
        )
        if given != 1:
            raise ValueError(
                "exactly one of dataset= (a repro_torch.data.datasets key), "
                "data= (a PaddedCSR), or source= (a DataSource / LibSVM "
                "path) must be set"
            )
        if self.mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(self.mesh, DeviceMesh):
                raise TypeError(
                    "mesh must be a torch.distributed.device_mesh.DeviceMesh "
                    f"(got {type(self.mesh).__name__}); None runs one rank"
                )
        if self.ingest_chunk_rows < 1:
            raise ValueError(
                f"ingest_chunk_rows >= 1 required, got "
                f"{self.ingest_chunk_rows!r}"
            )
        if self.data_cache_dir is not None and self.source is None:
            raise ValueError(
                "data_cache_dir= only applies to source= runs (the "
                "in-memory paths have nothing to cache on disk)"
            )
        if self.option not in ("I", "II"):
            raise ValueError(f"option must be 'I' or 'II', got {self.option!r}")
        if not isinstance(self.reg, losses_lib.Regularizer):
            raise TypeError(
                f"reg must be a repro_torch.core.losses.Regularizer (got "
                f"{type(self.reg).__name__}); the spec takes ONE regularizer "
                "— there is no separate lam argument to mismatch it with"
            )
        if self.loss not in losses_lib.LOSSES:
            raise ValueError(
                f"unknown loss {self.loss!r}; known: "
                f"{sorted(losses_lib.LOSSES)}"
            )
        for field, value in (
            ("eta", self.eta), ("batch_size", self.batch_size),
            ("inner_steps", self.inner_steps),
        ):
            if isinstance(value, str):
                if value != PAPER:
                    raise ValueError(
                        f"{field} must be a number or the sentinel "
                        f"{PAPER!r}, got {value!r}"
                    )
            elif field == "eta":
                if value <= 0:
                    raise ValueError(f"eta > 0 required, got {value!r}")
            elif value < 1:
                raise ValueError(f"{field} >= 1 required, got {value!r}")
        if self.outer_iters < 1:
            raise ValueError(
                f"outer_iters >= 1 required, got {self.outer_iters!r}"
            )
        if self.q is not None and self.q < 1:
            raise ValueError("q >= 1 required")
        if self.lazy_updates not in (None, "exact", "proba"):
            raise ValueError(
                f"lazy_updates must be None, 'exact', or 'proba', got "
                f"{self.lazy_updates!r}"
            )
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every >= 1 required, got {self.checkpoint_every!r}"
            )
        if self.checkpoint_dir is None and self.resume:
            raise ValueError(
                "resume=True needs checkpoint_dir= (there is nothing to "
                "resume from without one)"
            )
        if self.data is not None:
            _check_kernel_dtype(self.data.values.dtype, self.use_kernels)

    def replace(self, **changes) -> "ExperimentSpec":
        """Derive a variant spec (sweeps: ``spec.replace(reg=...)``)."""
        return dataclasses.replace(self, **changes)
