"""Start q ranks of one SPMD program on one host: :func:`spawn_ranks`.

The port's own launcher (the reference needs none: JAX drives every
device of a mesh from one process, while PyTorch runs one process per
rank).  Each rank joins a process group through a ``file://`` store in a
fresh directory (no TCP port to collide on), builds the 1-D ``("model",)``
``DeviceMesh`` over all ranks and calls ``fn(mesh, *args)``; rank 0's
return value comes back to the caller.  Ranks are started with the
``spawn`` method, so a caller that has already used CUDA can launch them.
On a CUDA device the kernel library is built in the caller first, so no
rank runs ``nvcc``.  Nothing here retries a rank or switches backend.
"""

from __future__ import annotations

import datetime
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
               workdir: str, timeout_s: float) -> None:
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
        dist.init_process_group(backend, store=store, rank=rank, world_size=q,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = DeviceMesh(dev.type, list(range(q)), mesh_dim_names=("model",))
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
):
    """Run ``fn(mesh, *args)`` on q spawned ranks and return rank 0's result.

    ``fn`` and ``args`` must pickle (a module-level function).  ``backend``
    is the process group's (``"gloo"`` or ``"nccl"``), ``device`` where the
    ranks run: ``cuda`` (the default; raises without a card) puts rank r
    on card r modulo the host's cards, ``cuda:k`` every rank on card k,
    ``cpu`` every rank on the CPU.  The store and the result go to
    ``workdir`` (default: a fresh temporary directory, removed after).
    When a rank fails the others get a few seconds to fail too, then every
    rank left is killed and :class:`RankError` carries each failed rank's
    traceback; after ``timeout_s`` seconds every rank is killed and it
    raises too.
    """
    import torch.multiprocessing as mp

    if q < 1:
        raise ValueError(f"need q >= 1 ranks, got {q}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    device = str(resolve_device(device))
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.load_library()
    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="repro_torch_ranks_") if own_dir else workdir
    os.makedirs(workdir, exist_ok=True)
    ctx = None
    try:
        ctx = mp.start_processes(
            _rank_main, args=(q, fn, args, backend, device, workdir, float(timeout_s)),
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
