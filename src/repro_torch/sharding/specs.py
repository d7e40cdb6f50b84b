"""Logical-axis sharding rules (the feature-distributed principle, applied).

Port of ``repro.sharding.specs``.  The paper's insight, partition the
parameters along *feature* dimensions so that what workers exchange is
activation reductions rather than parameter vectors, generalises to every
architecture as Megatron-style tensor parallelism over the ``model`` mesh
axis.  This module is the single source of truth for which logical axis of
which tensor carries that partition.

Tensors are annotated with logical axis names; :meth:`ShardingCtx.spec`
resolves them against the mesh (axes absent from the mesh resolve to
replication, so one model definition serves the (data, model), the
(pod, data, model) and the one-rank meshes unchanged).  A spec is the
reference's ``PartitionSpec`` as a tuple: one entry per tensor dimension,
``None``, a mesh-axis name, or a tuple of names, major first.

Where the reference hands a spec to GSPMD, the port lays tensors out as
``torch.distributed.tensor`` DTensors on a ``DeviceMesh``:
:meth:`ShardingCtx.placements` turns a spec into one placement per mesh
dimension (``Shard(i)`` / ``Replicate()``), :meth:`ShardingCtx.constrain`
redistributes a DTensor to it (the reference's
``with_sharding_constraint``), and :func:`distribute` lays a nest of
plain tensors out from a nest of specs (the reference's
``jit(in_shardings=...)``).  A tensor dimension split over two mesh axes
is split in mesh-dimension order, which is the reference's major-first
order for every rule here (:meth:`ShardingCtx.placements` refuses another
order).

Parameter masters and optimizer state are additionally sharded over the
data axes (ZeRO-1): see ``param_specs(zero1=True)`` in
:mod:`repro_torch.models.transformer`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import torch

# logical axis -> mesh axes (tuples mean "sharded over both, major first")
RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,               # sequence stays unsharded between layers (baseline);
    "seq_kv": "model",         # decode KV cache: sequence split-K over model
                               # (long_500k overrides to ("data","model"))
    "embed": None,             # d_model replicated (Megatron TP pattern)
    "heads": "model",          # q heads  — the feature partition in attention
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",            # FFN hidden — the feature partition in MLPs
    "experts": "model",        # expert parallelism
    "expert_mlp": None,
    "vocab": "model",          # LM head / embedding feature partition
    "ssm_inner": "model",      # SSD inner channels — feature partition for SSMs
    "ssm_heads": "model",      # SSD head axis
    "ssm_state": None,
    "conv_width": None,
    "codebooks": None,
    "patches": None,
    "zero1": ("pod", "data"),  # extra partition for master params/opt state
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor (the reference's
    ``PartitionSpec``); a leaf of a spec nest."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (the reference's
    ``mesh.shape``), read from ``mesh_dim_names`` and ``shape``."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, tuple(mesh.shape)))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Resolves logical axis names against a mesh; no-ops when mesh is None."""

    mesh: object | None = None  # torch.distributed.device_mesh.DeviceMesh
    rules: dict = dataclasses.field(default_factory=lambda: dict(RULES))
    # when False, constraints become identity (single-device smoke tests)
    enable: bool = True

    def _resolve_one(self, name: str | None):
        if name is None:
            return None
        mapped = self.rules.get(name, None)
        if mapped is None:
            return None
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        shape = mesh_axes(self.mesh)
        present = tuple(a for a in axes if a in shape)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, *names: str | None) -> PartitionSpec:
        if self.mesh is None:
            return P()
        return P(*(self._resolve_one(n) for n in names))

    def spec_div(self, shape: tuple[int, ...], *names: str | None) -> PartitionSpec:
        """Like spec(), but drops axes whose dimension doesn't divide the
        mesh-axis product.  Arrays crossing a step's boundary (parameters,
        state, inputs) keep even shards; activations under
        :meth:`constrain` may be uneven."""
        if self.mesh is None:
            return P()
        assert len(shape) == len(names), (shape, names)
        sizes = mesh_axes(self.mesh)
        out = []
        for dim, n in zip(shape, names):
            axes = self._resolve_one(n)
            if axes is None:
                out.append(None)
                continue
            ax = (axes,) if isinstance(axes, str) else axes
            size = 1
            for a in ax:
                size *= sizes[a]
            out.append(axes if dim % size == 0 else None)
        return P(*out)

    def placements(self, shape_or_rank, *names: str | None) -> tuple:
        """One DTensor placement per mesh dimension for a tensor named
        ``names``: :meth:`spec_div` when given a shape, :meth:`spec` when
        given a rank."""
        if isinstance(shape_or_rank, int):
            assert shape_or_rank == len(names), (shape_or_rank, names)
            spec = self.spec(*names)
        else:
            spec = self.spec_div(tuple(shape_or_rank), *names)
        return spec_placements(self.mesh, spec)

    def constrain(self, x: torch.Tensor, *names: str | None) -> torch.Tensor:
        """``with_sharding_constraint`` by logical names: a DTensor is
        redistributed to the names' placements; the identity without a
        mesh, when disabled, or on a plain tensor."""
        assert len(names) == x.dim(), (names, tuple(x.shape))
        if self.mesh is None or not self.enable or not is_dtensor(x):
            return x
        target = self.placements(x.dim(), *names)
        if tuple(x.placements) == target:
            return x
        return x.redistribute(x.device_mesh, target)


    def replicate_plain(self):
        """A context in which plain tensors (the positions, masks and
        constants the model code makes) enter DTensor ops as replicated
        (``implicit_replication``); it nests, and is a no-op without a
        mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        if DTensor._op_dispatcher._allow_implicit_replication:
            return contextlib.nullcontext()
        return implicit_replication()


def spec_placements(mesh, spec: Sequence) -> tuple:
    """A spec -> one placement per mesh dimension (``Shard(i)`` where
    tensor dimension i names that mesh axis, else ``Replicate()``).  A
    dimension over several axes must name them in mesh order (the
    reference's major first)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(dims)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        where = [dims.index(a) for a in ax]
        if where != sorted(where):
            raise ValueError(f"axes {ax} of dimension {i} are not in mesh order {dims}")
        for j in where:
            out[j] = Shard(i)
    return tuple(out)


def with_dim(placements: Sequence, dim: int, placement) -> tuple:
    """``placements`` with each split of tensor dimension ``dim``
    (``Shard(dim)``) replaced by ``placement``: ``Replicate()`` makes the
    dimension whole, ``Shard(j)`` moves its split to dimension ``j``,
    ``Partial(op)`` leaves a sum over it pending."""
    from torch.distributed.tensor import Shard

    return tuple(placement if p == Shard(dim) else p for p in placements)


def only_dims(placements: Sequence, dims) -> tuple:
    """``placements`` with the splits of the tensor dimensions ``dims``
    kept and every other entry made ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    return tuple(p if p.is_shard() and p.dim in dims else Replicate() for p in placements)


def split_ways(x, dim: int) -> int:
    """Over how many ranks dimension ``dim`` of the DTensor ``x`` is split."""
    from torch.distributed.tensor import Shard

    n = 1
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            n *= x.device_mesh.size(i)
    return n


def split_axes(x, dim: int) -> tuple[str, ...]:
    """The names of the mesh dimensions that split dimension ``dim`` of
    the DTensor ``x``, in mesh order (major first)."""
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(x.placements) if p == Shard(dim))


def gather_over(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """The plain tensor ``x`` of every rank along the mesh dimension
    ``name``, stacked in rank order (the ranks' coordinates along
    ``name``) along a new leading axis: ``[size of name, *x.shape]``, the
    same on each of those ranks (one all-gather; ``x`` has one shape and
    dtype on all of them)."""
    import torch.distributed as dist

    group = mesh.get_group(name)
    if dist.get_rank(group) != mesh.get_local_rank(name):
        raise ValueError(f"the group of mesh dimension {name!r} does not rank its members "
                         f"by their coordinate")
    n = mesh.size(mesh.mesh_dim_names.index(name))
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)  # gloo: flat only
    return out.view(n, *x.shape)


def local_offset(shape, mesh, placements: Sequence) -> tuple[tuple, tuple]:
    """This rank's piece of a tensor of global ``shape`` laid out by
    ``placements`` on ``mesh``: (its shape, its offset in each dimension),
    as DTensor slices it.  The port reads DTensor's slicing here only (a
    private helper of torch's)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, tuple(placements))
    return tuple(local), tuple(offset)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def to_shard(x: torch.Tensor, grad_placements: tuple | None = None) -> torch.Tensor:
    """This rank's shard of the DTensor ``x``, contiguous, for local
    computation (``DTensor.to_local``; its gradient comes back as a DTensor
    with ``grad_placements``, default ``x``'s).  The gradient of the shard
    is made contiguous too: DTensor reads a gradient's local layout off
    ``x``'s global strides, which are the contiguous ones here."""
    return _ContiguousGrad.apply(x.contiguous().to_local(grad_placements=grad_placements))


def from_shards(local: torch.Tensor, mesh, placements: tuple, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` whose shard on this rank is ``local``
    (made contiguous: DTensor reads a local tensor's layout off the global
    strides it is given, here the contiguous ones).  Differentiable, as
    ``DTensor.from_local``."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    strides, n = [], 1
    for d in reversed(shape):
        strides.append(n)
        n *= d
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements), run_check=False,
                              shape=shape, stride=tuple(reversed(strides)))


def spec_leaves(specs) -> list:
    """The specs of a spec nest, in the parameter tree's flatten order
    (dicts by sorted key, as ``optim.optimizers.tree_leaves``)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for v in specs for s in spec_leaves(v)]


def distribute(tree, specs, mesh):
    """Lay a nest of plain tensors out on ``mesh`` as DTensors, leaf by
    leaf (``distribute_tensor``: every rank passes the same full tensor
    and keeps its shard).  Leaves that already are DTensors are
    redistributed.  The reference's ``jit(in_shardings=...)``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

    leaves, sl = tree_leaves(tree), spec_leaves(specs)
    if len(leaves) != len(sl):
        raise ValueError(f"{len(leaves)} leaves against {len(sl)} specs")
    out = []
    for x, spec in zip(leaves, sl):
        target = spec_placements(mesh, spec)
        if not is_dtensor(x):
            x = distribute_tensor(x, mesh, target)
        elif tuple(x.placements) != target:
            x = x.redistribute(mesh, target)
        out.append(x)
    return tree_unflatten(tree, out)


def unsharded_ctx() -> ShardingCtx:
    return ShardingCtx(mesh=None)


def axis_size(mesh, logical: str) -> int:
    """Product of mesh-axis sizes behind a logical axis (1 without a mesh)."""
    if mesh is None:
        return 1
    mapped = RULES.get(logical)
    if mapped is None:
        return 1
    axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
    shape = mesh_axes(mesh)
    size = 1
    for a in axes:
        size *= shape.get(a, 1)
    return size
