"""Start q ranks of one SPMD program on one host: :func:`spawn_ranks`,
or play them as threads of one process: :func:`play_ranks`.

The port's own launcher (the reference needs none: JAX drives every
device of a mesh from one process, while PyTorch runs one process per
rank).  Each rank joins a process group through a ``file://`` store in a
fresh directory (no TCP port to collide on), builds a ``DeviceMesh`` over
all ranks (1-D ``("model",)`` unless the caller names a shape and axes)
and calls ``fn(mesh, *args)``; rank 0's
return value comes back to the caller.  Ranks are started with the
``spawn`` method, so a caller that has already used CUDA can launch them.
On a CUDA device the kernel library is built in the caller first, so no
rank runs ``nvcc``.  Nothing here retries a rank or switches backend.
"""

from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable

import torch

from repro_torch.core.driver import resolve_device

RESULT = "result.pt"


def _rank_device(device: str, rank: int) -> torch.device:
    """``cuda`` spreads the ranks over the host's cards (rank r on card r
    modulo their count); ``cuda:k`` puts every rank on card k."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, q: int, fn: Callable, args: tuple, backend: str, device: str,
               workdir: str, timeout_s: float, mesh_shape: tuple | None = None,
               mesh_dim_names: tuple = ("model",)) -> None:
    """One rank: join the group, build the mesh, run ``fn``, keep rank 0's
    result; a failure leaves its traceback in ``rank<r>.err``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)  # the context, before the mesh looks at the device
        store = dist.FileStore(os.path.join(workdir, "store"), q)
        # A CUDA rank names its card, so the group binds to it (NCCL would
        # otherwise guess the card from the rank at its first barrier).
        bound = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(backend, store=store, rank=rank, world_size=q,
                                timeout=datetime.timedelta(seconds=timeout_s), **bound)
        try:
            mesh = DeviceMesh(dev.type, torch.arange(q).reshape(mesh_shape or (q,)).tolist(),
                              mesh_dim_names=mesh_dim_names)
            out = fn(mesh, *args)
            if rank == 0:
                torch.save(out, os.path.join(workdir, RESULT + ".tmp"))
                os.replace(os.path.join(workdir, RESULT + ".tmp"),
                           os.path.join(workdir, RESULT))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class RankError(RuntimeError):
    """One or more ranks failed or the ranks ran out of time; the message
    holds every failed rank's traceback."""


def spawn_ranks(
    q: int,
    fn: Callable,
    *args,
    backend: str = "gloo",
    device: torch.device | str | None = None,
    timeout_s: float = 300.0,
    workdir: str | None = None,
    mesh_shape: tuple[int, ...] | None = None,
    mesh_dim_names: tuple[str, ...] = ("model",),
):
    """Run ``fn(mesh, *args)`` on q spawned ranks and return rank 0's result.

    ``fn`` and ``args`` must pickle (a module-level function).  ``backend``
    is the process group's (``"gloo"`` or ``"nccl"``), ``device`` where the
    ranks run: ``cuda`` (the default; raises without a card) puts rank r
    on card r modulo the host's cards, ``cuda:k`` every rank on card k,
    ``cpu`` every rank on the CPU.  The store and the result go to
    ``workdir`` (default: a fresh temporary directory, removed after).
    NCCL ranks that would share a device raise ``ValueError`` before any
    rank starts.  The mesh is ``mesh_shape`` (default ``(q,)``, ranks in
    row-major order) with axes ``mesh_dim_names`` (default ``("model",)``).
    When a rank fails the others get a few seconds to fail too, then every
    rank left is killed and :class:`RankError` carries each failed rank's
    traceback; after ``timeout_s`` seconds every rank is killed and it
    raises too.
    """
    import torch.multiprocessing as mp

    if q < 1:
        raise ValueError(f"need q >= 1 ranks, got {q}")
    mesh_shape = (q,) if mesh_shape is None else tuple(mesh_shape)
    if math.prod(mesh_shape) != q or len(mesh_shape) != len(mesh_dim_names):
        raise ValueError(f"mesh {mesh_shape} with axes {mesh_dim_names} does not fit {q} ranks")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    device = str(resolve_device(device))
    if backend == "nccl":
        # A CUDA rank binds its group to its card at init, where NCCL
        # refuses a card that two ranks share: refuse before starting any.
        cards = [_rank_device(device, r) for r in range(q)]
        shared = next(((cards.index(c), r) for r, c in enumerate(cards)
                       if cards.index(c) != r), None)
        if shared is not None:
            raise ValueError(f"NCCL runs one rank per device, but ranks {shared[0]} and "
                             f"{shared[1]} would share {cards[shared[1]]}")
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.load_library()
    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="repro_torch_ranks_") if own_dir else workdir
    os.makedirs(workdir, exist_ok=True)
    ctx = None
    try:
        ctx = mp.start_processes(
            _rank_main, args=(q, fn, args, backend, device, workdir, float(timeout_s),
                              mesh_shape, tuple(mesh_dim_names)),
            nprocs=q, join=False, start_method="spawn",
        )
        procs = ctx.processes
        deadline = time.monotonic() + timeout_s
        failed_at = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + 5.0):
                break
            time.sleep(0.05)
        timed_out = any(p.is_alive() for p in procs) and failed_at is None
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(workdir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r} (exit code {p.exitcode}):\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if timed_out:
            raise RankError(f"{q} ranks did not finish within {timeout_s:g} s; killed"
                            + "".join("\n" + e for e in errors))
        if errors:
            raise RankError(f"{len(errors)} of {q} ranks failed:\n" + "\n".join(errors))
        return torch.load(os.path.join(workdir, RESULT), weights_only=False)
    finally:
        # torch.multiprocessing leaves a failed rank's pickled error behind.
        for path in getattr(ctx, "error_files", None) or ():
            if path and os.path.exists(path):
                os.remove(path)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def play_ranks(q: int, fn: Callable, timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, gather)`` for q ranks played in this process, a
    thread each, and return their results in rank order.

    ``gather(x)`` is an all-gather among them: every rank's plain tensor
    ``x`` stacked in rank order along a new leading axis, as
    ``specs.gather_over`` gives it across processes; each rank calls it the
    same number of times.  The ranks take turns (one runs between two
    gathers while the others wait), so the launch counters and the card's
    stream see one rank at a time.  This plays a mesh's collectives on one
    card, where NCCL refuses two ranks.  The first rank to raise stops the
    others, and its exception is raised here; after ``timeout_s`` seconds
    in one gather every rank stops and :class:`RankError` is raised.
    """
    import threading

    turn = threading.Lock()
    barrier = threading.Barrier(q, timeout=timeout_s)
    rows: dict[int, list] = {}
    results: list = [None] * q
    errors: list = [None] * q

    def rank_main(rank: int) -> None:
        calls = 0

        def gather(x: torch.Tensor) -> torch.Tensor:
            nonlocal calls
            row = rows.setdefault(calls, [None] * q)
            calls += 1
            row[rank] = x
            turn.release()
            try:
                barrier.wait()
            finally:
                turn.acquire()
            return torch.stack(row)

        with turn:
            try:
                results[rank] = fn(rank, gather)
            except BaseException as err:  # handed to the caller below
                errors[rank] = err
                barrier.abort()

    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True) for r in range(q)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if first:
        raise first[0]
    if any(errors):
        raise RankError(f"{q} played ranks: a gather did not complete within {timeout_s:g} s")
    return results
