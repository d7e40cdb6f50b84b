"""``ShardMapBackend`` — the deployable realization of the substrate, over
``torch.distributed``.

Port of ``repro.dist.shardmap``.  JAX drives every device of a mesh from
one program and maps the worker function over them with ``shard_map``;
PyTorch runs one process per rank, each executing the same worker code on
its own feature block (SPMD).  So the reference's ``shard_map`` method has
no counterpart here: the rank IS the mapped worker, and
:func:`repro_torch.dist.launch.spawn_ranks` (or any launcher that gives
each process its rank and the mesh) takes its place.  Inside a rank,
:meth:`ShardMapBackend.device_all_reduce` is the paper's Figure-5 tree over
the mesh's process group: one all-reduce (``tree_mode="psum"``, the
backend's own algorithm) or the explicit butterfly of paired sends and
receives (``"butterfly"``, :func:`~repro_torch.dist.tree.collective_permute_tree`,
bit for bit ``tree_order_sum`` for a power-of-two q).  Communication is
metered statically on the host with the §4.5 closed forms, against the
same :class:`~repro_torch.dist.meter.CommMeter` as every other backend.

Transport is explicit.  A gloo group moves host tensors, so with a CUDA
payload the backend copies it to the host, runs the collective there and
copies the result back, and counts each such collective in ``staged``.
NCCL runs one rank per device: a group whose ranks share a device is
refused at construction, before any collective (NCCL itself would fail
only at the first one).  Nothing here switches transport or device on
its own.

``interpret=True`` (or no mesh) is the device-free stand-in: ``all_reduce``
combines per-worker partials in canonical tree order on the host, and with
q = 1 ``device_all_reduce`` is the identity — one rank and no process
group, the counterpart of the reference's one-device default mesh.
"""

from __future__ import annotations

import itertools
import json
import socket
import time
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import MeteredBackend
from repro_torch.dist.meter import ClusterModel
from repro_torch.dist.tree import collective_permute_tree, psum_tree
from repro_torch.spans import span

TREE_MODES = ("psum", "butterfly")

# One key space per NCCL device check; every rank constructs its backends
# in the same order (SPMD), so the counters agree across ranks.
_DEVICE_CHECKS = itertools.count()


def _mesh_layout(mesh, feature_axes: Sequence[str]) -> tuple[int, object, list[int]]:
    """(q, the process group the collectives run over, the global rank of
    each worker in worker order).  Worker ids are linear over
    ``feature_axes`` in the given order, as the reference's
    ``device_worker_id``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            "mesh must be a torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__name__}"
        )
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(feature_axes)
    if len(set(axes)) != len(axes) or set(axes) != set(names):
        raise ValueError(
            f"feature_axes {axes} must name every dimension of the mesh "
            f"{names} once: each rank runs one feature block, so a mesh "
            "dimension that is not a feature axis (replicas) has no "
            "counterpart in the port"
        )
    ranks = mesh.mesh.permute([names.index(a) for a in axes]).reshape(-1).tolist()
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    elif sorted(ranks) == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        raise ValueError(
            f"a mesh of {mesh.ndim} dimensions must span every rank of the "
            "default process group: its collectives run over that group"
        )
    return len(ranks), group, ranks


def _transport(group, device: torch.device) -> str:
    """The backend that carries a tensor on ``device`` over ``group``
    (``dist.get_backend`` gives one name, or ``"cpu:gloo,cuda:nccl"``)."""
    spec = dist.get_backend(group)
    if ":" not in spec:
        return spec
    by_device = dict(part.split(":", 1) for part in spec.split(","))
    if device.type not in by_device:
        raise ValueError(f"process group {spec!r} has no backend for {device.type} tensors")
    return by_device[device.type]


def _device_identity() -> dict:
    """This rank's current CUDA device as NCCL tells devices apart."""
    index = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    return {"host": socket.gethostname(), "device": f"cuda:{index}",
            "name": props.name, "uuid": str(props.uuid)}


def _check_one_rank_per_device(ranks: Sequence[int]) -> None:
    """Refuse an NCCL group in which two ranks share a device.  The ranks
    trade their devices through the default store (no collective runs),
    so every rank raises the same error."""
    if len(ranks) < 2:
        return
    store = dist.distributed_c10d._get_default_store()
    key = f"repro_torch/shardmap/device_check/{next(_DEVICE_CHECKS)}"
    store.set(f"{key}/{dist.get_rank()}", json.dumps(_device_identity()))
    seen: dict[str, tuple[int, dict]] = {}
    for rank in ranks:
        who = json.loads(store.get(f"{key}/{rank}").decode())
        if who["uuid"] in seen:
            first = seen[who["uuid"]][0]
            raise ValueError(
                f"NCCL runs one rank per device, but ranks {first} and {rank} "
                f"share {who['device']} ({who['name']}, {who['uuid']}) on host "
                f"{who['host']}: give each rank its own device, or use a gloo group"
            )
        seen[who["uuid"]] = (rank, who)


class ShardMapBackend(MeteredBackend):
    """Collectives over a ``DeviceMesh``'s feature axes (or their
    interpretation).

    Exactly one of ``mesh`` / ``q`` must be given:

    * ``mesh`` + ``feature_axes`` — the real thing: ``q`` is the product of
      the named axis sizes, which must name every dimension of the mesh;
      ``device_all_reduce`` runs inside each rank's worker code.
    * ``q`` (with ``interpret=True``, or alone) — no process group:
      ``all_reduce`` runs the canonical tree-order reduction host-side,
      and at q = 1 ``device_all_reduce`` is the identity.

    ``staged`` counts the collectives whose CUDA payload went through host
    memory (a gloo group).  ``timed=True`` times every device collective
    into :attr:`collective_s` (two CUDA events each, which slows a step:
    off by default).
    """

    def __init__(
        self,
        mesh=None,
        feature_axes: Sequence[str] = ("model",),
        tree_mode: str = "psum",
        cluster: ClusterModel | None = None,
        q: int | None = None,
        interpret: bool = False,
        timed: bool = False,
    ) -> None:
        if tree_mode not in TREE_MODES:
            raise ValueError(f"tree_mode must be one of {TREE_MODES}, got {tree_mode!r}")
        if (mesh is None) == (q is None):
            raise ValueError("pass exactly one of mesh= or q=")
        self.group = None
        self.ranks: list[int] | None = None
        if mesh is not None:
            q, self.group, self.ranks = _mesh_layout(mesh, feature_axes)
            if _transport(self.group, torch.device("cuda")) == "nccl":
                _check_one_rank_per_device(self.ranks)
        super().__init__(q, cluster)
        self.mesh = mesh
        self.feature_axes = tuple(feature_axes)
        self.tree_mode = tree_mode
        self.interpret = bool(interpret or mesh is None)
        self.staged = 0
        self.timed = bool(timed)
        self._seconds = 0.0
        self._events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    # -- device path (inside each rank's worker code) ----------------------

    def _local(self, what: str) -> bool:
        """True when there is no group and q = 1 (the identity collective)."""
        if self.mesh is not None:
            return False
        if self.q == 1:
            return True
        raise ValueError(f"{what} requires a real mesh (or q = 1)")

    def _stage(self, x: torch.Tensor) -> bool:
        """True when ``x`` must go through host memory: a CUDA tensor over a
        gloo group.  Other pairings run as they are (a CPU tensor over NCCL
        raises in NCCL: nothing is moved behind the caller's back)."""
        return x.is_cuda and _transport(self.group, x.device) == "gloo"

    @property
    def collective_s(self) -> float:
        """Seconds spent in the device collectives, the same measure for
        every transport.  For a CUDA payload it is read from CUDA events on
        the rank's stream around each collective: from the moment the
        stream has finished the work queued before it (the payload is
        ready) to the moment the result is on the device, so it holds the
        staging copies, the rounds and the wait for the other ranks, and
        no compute of this rank.  For a CPU payload it is the host clock
        around the collective.  Reading it waits for the last collective
        to finish.  Only a backend built with ``timed=True`` keeps it."""
        if not self.timed:
            raise ValueError("collective_s needs a backend built with timed=True")
        if self._events:
            self._events[-1][1].synchronize()
            self._seconds += sum(a.elapsed_time(b) for a, b in self._events) / 1e3
            self._events.clear()
        return self._seconds

    def _timed(self, x: torch.Tensor, collective):
        """``collective()``, its time added to :attr:`collective_s` when
        the backend is timed."""
        if not self.timed:
            return collective()
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            y = collective()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((start, end))
            return y
        t0 = time.perf_counter()
        y = collective()
        self._seconds += time.perf_counter() - t0
        return y

    def device_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, replicated: one all-reduce
        (``psum``) or the butterfly; the identity with q = 1 and no mesh."""
        if self._local("device_all_reduce"):
            return x
        with span("rt/all_reduce"):
            return self._timed(x, lambda: self._all_reduce(x))

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        staged = self._stage(x)
        y = x.cpu() if staged else x
        if self.tree_mode == "psum":
            # The staged host copy is the caller's already: reduce it in place.
            y = psum_tree(y, self.group, inplace=staged)
        else:
            y = collective_permute_tree(y, self.group, self.q, self.ranks)
        if staged:
            y = y.to(x.device)
            self.staged += 1
        return y

    def device_all_gather(self, x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
        """Every worker's block of a feature-sharded vector, concatenated in
        worker order; worker i's block has ``sizes[i]`` entries (each is
        padded to the largest for the collective).  The identity with
        q = 1 and no mesh."""
        if self._local("device_all_gather"):
            return x
        with span("rt/all_gather"):
            return self._timed(x, lambda: self._all_gather(x, sizes))

    def _all_gather(self, x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
        staged = self._stage(x)
        buf = torch.zeros(max(sizes), dtype=x.dtype,
                          device=torch.device("cpu") if staged else x.device)
        buf[: x.shape[0]] = x
        parts = [torch.empty_like(buf) for _ in range(self.q)]
        dist.all_gather(parts, buf, group=self.group)
        by_rank = {dist.get_global_rank(self.group, i): p for i, p in enumerate(parts)}
        out = torch.cat([by_rank[r][:n] for r, n in zip(self.ranks, sizes, strict=True)])
        if staged:
            out = out.to(x.device)
            self.staged += 1
        return out

    def device_worker_id(self) -> int:
        """This rank's worker id: its linear index over the feature axes."""
        if self.mesh is None:
            raise ValueError("device_worker_id requires a real mesh")
        return self.ranks.index(dist.get_rank())

    # -- host path --------------------------------------------------------

    def all_reduce(self, parts: Sequence, payload: int | None = None):
        """Interpret-mode all-reduce of per-worker partials: the canonical
        tree order, the bits a deterministic device all-reduce leaves on
        every worker."""
        if not self.interpret:
            raise ValueError(
                "host all_reduce is only available with interpret=True; "
                "use device_all_reduce inside each rank's worker code"
            )
        return self._host_all_reduce(parts, payload)
