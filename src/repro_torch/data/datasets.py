"""Paper-shaped data set presets (Table 1, full size and container scale).

Port of ``repro.data.datasets``.  The paper evaluates on four LibSVM sets:

    name      d            N           d/N
    news20    1,355,191    19,954      ~68
    url       3,231,961    2,396,130   ~1.3
    webspam   16,609,143   350,000     ~47
    kdd2010   29,890,095   19,264,097  ~1.6

``TABLE1_FULL`` carries the published sizes; ``TABLE1_SCALED`` keeps the
d-vs-N ratios and sparsity at 1/64–1/1024 scale for CPU tests.
"""

from __future__ import annotations

import dataclasses
import os

from repro_torch.data.sparse import PaddedCSR
from repro_torch.data.synthetic import make_sparse_classification


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int
    num_instances: int
    nnz_per_instance: int
    default_workers: int  # paper: 8 for news20, 16 for the rest


# Full-size specs from Table 1 (nnz per instance from LibSVM docs).
TABLE1_FULL = {
    "news20": DatasetSpec("news20", 1_355_191, 19_954, 455, 8),
    "url": DatasetSpec("url", 3_231_961, 2_396_130, 116, 16),
    "webspam": DatasetSpec("webspam", 16_609_143, 350_000, 3730, 16),
    "kdd2010": DatasetSpec("kdd2010", 29_890_095, 19_264_097, 29, 16),
    "avazu": DatasetSpec("avazu", 1_000_000, 40_428_967, 15, 16),
}

# Container-scale versions preserving d/N and sparsity character.
TABLE1_SCALED = {
    "news20": DatasetSpec("news20", 67_760, 998, 64, 8),
    "url": DatasetSpec("url", 50_500, 37_440, 24, 16),
    "webspam": DatasetSpec("webspam", 129_760, 2_734, 100, 16),
    "kdd2010": DatasetSpec("kdd2010", 116_758, 75_250, 12, 16),
    "avazu": DatasetSpec("avazu", 31_250, 1_263_405 // 32, 15, 16),
}

# One-host materialization budget for load(): the generator's float64
# scratch plus the padded int32/float32 arrays cost ~24 bytes per entry.
_BYTES_PER_ENTRY = 24
_DEFAULT_BUDGET_BYTES = 1 << 30  # 1 GiB


def materialize_bytes(spec: DatasetSpec) -> int:
    """Estimated one-host bytes to generate + hold ``spec`` padded."""
    return spec.num_instances * spec.nnz_per_instance * _BYTES_PER_ENTRY


def load(
    name: str,
    *,
    scaled: bool = True,
    seed: int = 0,
    max_bytes: int | None = None,
) -> PaddedCSR:
    """Materialize a preset as one in-memory :class:`PaddedCSR` (CPU tensors).

    Guarded: estimates above the budget (default 1 GiB; override with
    ``max_bytes`` or ``REPRO_MATERIALIZE_BUDGET_BYTES``) raise
    ``MemoryError`` instead of exhausting the host.  Full news20 (~0.22 GB)
    fits the default budget.
    """
    spec = (TABLE1_SCALED if scaled else TABLE1_FULL)[name]
    budget = max_bytes
    if budget is None:
        budget = int(
            os.environ.get(
                "REPRO_MATERIALIZE_BUDGET_BYTES", _DEFAULT_BUDGET_BYTES
            )
        )
    est = materialize_bytes(spec)
    if est > budget:
        raise MemoryError(
            f"materializing {name!r} (scaled={scaled}) needs ~{est / 1e9:.1f} GB"
            f" on one host (budget {budget / 1e9:.1f} GB); use the streaming"
            " path instead — repro_torch.data.pipeline.SyntheticSource"
            f".from_dataset({name!r}, scaled={scaled}) with"
            " stream_block_csr, or raise max_bytes /"
            " REPRO_MATERIALIZE_BUDGET_BYTES if you really have the RAM."
        )
    return make_sparse_classification(
        dim=spec.dim,
        num_instances=spec.num_instances,
        nnz_per_instance=spec.nnz_per_instance,
        seed=seed,
    )


def spec(name: str, *, scaled: bool = True) -> DatasetSpec:
    return (TABLE1_SCALED if scaled else TABLE1_FULL)[name]
