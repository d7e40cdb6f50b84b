"""repro_torch.api — the public front door of the port.

Port of ``repro.api``: one declarative spec, one solver registry, one
estimator.

* :class:`~repro_torch.api.spec.ExperimentSpec` — a frozen description
  of one run (data, loss, ONE regularizer, method, schedule with
  ``"paper"`` auto-defaults, backend knobs, and the run's ``device``).
* :func:`~repro_torch.api.registry.solve` — runs a spec through its
  registered driver and returns the shared
  :class:`~repro_torch.core.driver.RunResult`;
  :func:`~repro_torch.api.registry.register_method` +
  :class:`~repro_torch.api.registry.MethodInfo` are the extension point.
* :class:`~repro_torch.api.estimator.FDSVRGClassifier` —
  scikit-learn-style ``fit`` / ``partial_fit`` (warm start) /
  ``predict`` / ``score``.
* :data:`~repro_torch.api.cache.BLOCK_CACHE` — the shared bounded
  BlockCSR cache ``solve`` builds its device layouts through.
* ``python -m repro_torch.api.cli`` — any registered method on any
  ``LinearConfig`` preset.

Everything defaults to ``device="cuda"`` (raising without a card) and
``use_kernels=True`` (the CUDA kernels, float32 only); pass
``device="cpu"`` for the plain PyTorch versions on the host.
"""

from repro_torch.api.cache import BLOCK_CACHE, BlockCache, block_data
from repro_torch.api.estimator import FDSVRGClassifier, as_padded_csr
from repro_torch.api.registry import (
    METHODS,
    PAPER_FD_BATCH,
    PAPER_MAX_INNER,
    MethodInfo,
    ResolvedRun,
    capability_matrix,
    method_info,
    register_method,
    solve,
)
from repro_torch.api.spec import PAPER, ExperimentSpec

__all__ = [
    "BLOCK_CACHE",
    "BlockCache",
    "ExperimentSpec",
    "FDSVRGClassifier",
    "METHODS",
    "MethodInfo",
    "PAPER",
    "PAPER_FD_BATCH",
    "PAPER_MAX_INNER",
    "ResolvedRun",
    "as_padded_csr",
    "block_data",
    "capability_matrix",
    "method_info",
    "register_method",
    "solve",
]
