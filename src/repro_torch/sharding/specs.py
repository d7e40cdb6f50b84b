"""Logical-axis sharding context, single-device form.

Port of the part of ``repro.sharding.specs`` that the model code calls:
:meth:`ShardingCtx.constrain` (here the identity) and
:func:`unsharded_ctx`.  The mesh rules, ``param_specs`` and
``cache_specs`` come with the rest of the LM scaffolding (ROADMAP queue 1
item 11 step 9); the model code already names its logical axes, so they
slot in there.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """No mesh: every constraint is the identity."""

    mesh: None = None

    def constrain(self, x: torch.Tensor, *names: str | None) -> torch.Tensor:
        """The reference's ``with_sharding_constraint`` by logical names;
        the identity on one device (the names are checked against the rank)."""
        assert len(names) == x.dim(), (names, tuple(x.shape))
        return x


def unsharded_ctx() -> ShardingCtx:
    return ShardingCtx()
