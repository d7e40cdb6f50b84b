"""The shared, bounded BlockCSR cache service.

Port of ``repro.api.cache``.  Re-indexing a data set into the block-local
:class:`~repro_torch.data.block_csr.BlockCSR` layout is host-side NumPy
work that every FD caller repeats for the same ``(data, q)`` pair; this
cache does it once for all of them.  The port keys on ``(data, q,
device)`` and keeps the layout **already on the device**: a layout's
per-step row table (``BlockCSR.block_rows``) is cached on the object, and
``BlockCSR.to`` returns the object itself when it already lies on the
run's device, so a sweep that solves many times on one data set builds
that table once.

Scoping rules, as the reference's:

* **per-sweep scope** — a new data object evicts every entry built for
  other data sets; the identity check also guards against ``id()``
  recycling;
* **LRU bound** — at most :attr:`BlockCache.max_entries` entries for the
  current data set.

Streamed sources share the cache through :meth:`BlockCache.get_source`,
layered over the on-disk slab cache
(:mod:`repro_torch.data.ingest_cache`) when the caller passes
``cache_dir``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.core.driver import resolve_device
from repro_torch.core.partition import balanced
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.sparse import PaddedCSR


class BlockCache:
    """A bounded ``(data, q, device) -> BlockCSR`` cache with per-sweep scope."""

    def __init__(self, max_entries: int = 4) -> None:
        self.max_entries = int(max_entries)
        self._entries: OrderedDict[
            tuple[int, int, str], tuple[object, BlockCSR]
        ] = OrderedDict()

    def get(
        self, data: PaddedCSR, q: int, device: torch.device | str | None = None
    ) -> BlockCSR:
        """The BlockCSR of ``data`` at ``q`` blocks on ``device`` (default
        ``cuda``; raises without one), built at most once."""
        device = resolve_device(device)
        hit = self._lookup(data, q, device)
        if hit is not None:
            return hit
        block = BlockCSR.from_padded(data, balanced(data.dim, q)).to(device)
        self._insert(data, q, device, block)
        return block

    def get_source(
        self,
        source,
        q: int,
        device: torch.device | str | None = None,
        *,
        cache_dir: str | None = None,
        chunk_rows: int = 65536,
    ) -> BlockCSR:
        """The streamed BlockCSR of a DataSource at ``q`` blocks on
        ``device``: identity-keyed like :meth:`get`; a miss goes through
        :func:`repro_torch.data.ingest_cache.get_or_build` (with
        ``cache_dir``, a fresh process warm-loads slabs instead of
        parsing)."""
        from repro_torch.data.ingest_cache import get_or_build

        device = resolve_device(device)
        hit = self._lookup(source, q, device)
        if hit is not None:
            return hit
        partition = balanced(source.stats().dim, q)
        outcome = get_or_build(
            source, partition, cache_dir=cache_dir, chunk_rows=chunk_rows
        )
        block = outcome.data.to(device)
        self._insert(source, q, device, block)
        return block

    @staticmethod
    def _key(owner, q: int, device: torch.device) -> tuple[int, int, str]:
        return (id(owner), q, str(device))

    def _lookup(self, owner, q: int, device) -> BlockCSR | None:
        key = self._key(owner, q, device)
        hit = self._entries.get(key)
        if hit is not None and hit[0] is owner:
            self._entries.move_to_end(key)
            return hit[1]
        return None

    def _insert(self, owner, q: int, device, block: BlockCSR) -> None:
        # New owner object: the sweep moved on — drop other data sets'
        # entries (and any stale entry whose id() was recycled).
        for k in [k for k, v in self._entries.items() if v[0] is not owner]:
            del self._entries[k]
        self._entries[self._key(owner, q, device)] = (owner, block)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def values(self):
        """(data, BlockCSR) pairs, LRU order (oldest first) — tests."""
        return self._entries.values()


#: The process-wide cache :func:`repro_torch.api.solve` uses.
BLOCK_CACHE = BlockCache()


def block_data(
    data: PaddedCSR, q: int, device: torch.device | str | None = None
) -> BlockCSR:
    """Module-level convenience over :data:`BLOCK_CACHE`."""
    return BLOCK_CACHE.get(data, q, device)
