"""Sparse data layouts, the synthetic generator, the Table-1 presets, and
streaming LibSVM ingestion with its slab cache."""

from repro_torch.data.sparse import PaddedCSR
from repro_torch.data.block_csr import BlockCSR, local_margins, local_scatter
from repro_torch.data import datasets, synthetic
from repro_torch.data.libsvm import load_libsvm, scan_libsvm, write_libsvm
from repro_torch.data.pipeline import (
    ArraySource,
    DataSource,
    LibSVMSource,
    SyntheticSource,
    as_source,
    stream_block_csr,
)
from repro_torch.data.ingest_cache import get_or_build

__all__ = [
    "PaddedCSR",
    "BlockCSR",
    "local_margins",
    "local_scatter",
    "datasets",
    "synthetic",
    "load_libsvm",
    "scan_libsvm",
    "write_libsvm",
    "ArraySource",
    "DataSource",
    "LibSVMSource",
    "SyntheticSource",
    "as_source",
    "stream_block_csr",
    "get_or_build",
]
