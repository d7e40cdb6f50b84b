"""One run of one cell: set-up, the timed window, the traced stretch, and
what the comparison and the metric readers need afterwards.

A cell drives ``repro_torch.api.solve(ExperimentSpec(...))``, the
program's front door, on data the benchmark draws from the run's seed:

1. set-up: CUDA, the kernel library (built on the first run of a
   checkout), the data on the card, the q-block layout in the front
   door's cache, and a warm-up ``solve`` of ``WARMUP_OUTERS`` outers from
   zeros, whose second outer sets the window's length;
2. the window: one ``solve`` of K whole outers that warm-starts from the
   warm-up's iterate, K chosen so that the call lasts about ``--seconds``
   (``--trace 1``: about the traffic's ``trace_seconds``, under the
   profiler), timed on the host up to ``torch.cuda.synchronize()``;
3. afterwards the outputs are set beside the plain reference, which
   replays the warm-up and the window's first ``COMPARED_OUTERS`` outers
   from the seeds: a fixed stretch, so that a program that runs more
   outers in the window is held to the same numbers, and the replay stays
   shorter than the window.

A sharded cell runs steps 1 and 2 on one rank a card (NCCL), started by
``repro_torch.dist.launch.spawn_ranks``; rank 0 times and traces, and the
parent process, which touches no card until the ranks have ended, runs
step 3.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from bench import datagen, roofline
from bench import trace as trace_lib

WARMUP_OUTERS = 2
COMPARED_OUTERS = 3  # the window's outers the reference follows
TRACE_TRIES = 3  # traced stretches taken while records are lost
RANK_TIMEOUT_S = 330.0


@dataclasses.dataclass
class Context:
    """What a metric reader reads.  ``window_s`` and ``samples`` are the
    measured call's (the traced stretch's with ``--trace 1``)."""

    setup_s: float
    window_s: float
    steps: int
    samples: int
    trace: trace_lib.Trace | None = None
    launches: dict | None = None
    lost_records: int = 0
    least_s: float | None = None

    def idle_share(self) -> float | None:
        if self.trace is None or not self.trace.kernels:
            return None
        return 1.0 - self.trace.busy_s() / self.window_s

    def mfu_percent(self) -> float | None:
        if self.least_s is None or self.trace is None or not self.trace.kernels:
            return None
        return 100.0 * self.least_s / self.window_s


@dataclasses.dataclass
class RunOut:
    """The program's side of a run, as plain data (it crosses processes)."""

    setup: dict
    data_seed: int
    outers: int
    warmup_seed: int
    window_seed: int
    compared: int  # the window's outers in ``objectives`` and ``grad_norms``
    objectives: list
    grad_norms: list
    change_norm: float  # |w| after the warm-up, which starts from zeros
    failed_outers: int  # the window's outers whose objective is not finite
    memory_peak_bytes: int
    fingerprint: tuple
    context: Context


def seeds(seed: int) -> tuple[int, int]:
    """The warm-up's and the window's sample-stream seeds."""
    s = int(seed) % 2**63
    return s, (s + 1) % 2**63


def inner_steps(cfg: dict, traffic: dict) -> int:
    """M = N / u, the paper's inner steps at a mini-batch of u."""
    return max(1, cfg["num_instances"] // traffic["batch_size"])


def sample_draws(seed: int, outers: int, n: int, m: int, u: int) -> list[np.ndarray]:
    """The sample ids of a solve: one ``default_rng(seed)``, an
    ``integers(0, n, (m, u))`` draw an outer (Option I draws nothing else)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, size=(m, u), dtype=np.int64) for _ in range(outers)]


def make_data(cfg: dict, seed: int, device) -> datagen.SparseSet:
    return datagen.make_sparse(
        dim=cfg["dim"], num_instances=cfg["num_instances"],
        nnz_per_instance=cfg["nnz_per_instance"], seed=seed, device=device,
        zipf_a=cfg["zipf_a"], label_noise=cfg["label_noise"],
        teacher_nnz_frac=cfg["teacher_nnz_frac"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spec(cfg, traffic, data, *, outers, seed, init_w, device, mesh=None):
    from repro_torch.api import ExperimentSpec
    from repro_torch.core import losses

    kw = dict(method=traffic["method"], data=data, loss=cfg["loss"],
              reg=losses.Regularizer(cfg["reg"], cfg["lam"]), eta=cfg["eta"],
              batch_size=traffic["batch_size"], inner_steps=inner_steps(cfg, traffic),
              outer_iters=outers, seed=seed, init_w=init_w, device=device,
              lazy_updates=traffic.get("lazy_updates"))
    if mesh is not None:
        kw.update(mesh=mesh, tree_mode=traffic["tree_mode"])
    else:
        kw["q"] = cfg["workers"]
    return ExperimentSpec(**kw)


def _outer_seconds(history) -> float:
    """The warm-up's last outer, past the first one's first launches."""
    return history[-1].wall_time_s - history[-2].wall_time_s


def window_outers(t_outer: float, seconds: float) -> int:
    return max(1, int(round(seconds / max(t_outer, 1e-9))))


def _drive(cfg, traffic, sset, data, device, *, seed, seconds, trace, t_start, mesh=None,
           agree=None, block=None):
    """Set-up, warm-up and the window on this process's card.  ``agree``
    makes a number the same on every rank (the largest); ``block`` is the
    rank's feature range for the work count (default: every feature)."""
    from repro_torch.api import BLOCK_CACHE, solve
    from repro_torch.kernels import ops

    agree = agree or (lambda x: x)
    setup = {}
    w_seed, x_seed = seeds(seed)
    t0 = time.perf_counter()
    if mesh is None:
        BLOCK_CACHE.get(data, cfg["workers"], device)
        _sync(device)
        setup["layout_s"] = time.perf_counter() - t0
    else:
        setup["layout_s"] = None  # each rank builds its block inside every solve
    t0 = time.perf_counter()
    warm = solve(_spec(cfg, traffic, data, outers=WARMUP_OUTERS, seed=w_seed, init_w=None,
                       device=device, mesh=mesh))
    _sync(device)
    setup["warmup_s"] = time.perf_counter() - t0
    t_outer = agree(_outer_seconds(warm.history))
    target = traffic["trace_seconds"] if trace else seconds
    outers = max(COMPARED_OUTERS if trace else 1, window_outers(t_outer, target))
    outers = int(agree(outers))
    w_warm = warm.w
    change = float(torch.linalg.vector_norm(w_warm.to(torch.float64)))
    spec = _spec(cfg, traffic, data, outers=outers, seed=x_seed, init_w=w_warm, device=device,
                 mesh=mesh)
    if mesh is not None:
        torch.distributed.barrier()
    _sync(device)
    setup_s = time.time() - t_start
    m, u = inner_steps(cfg, traffic), traffic["batch_size"]
    ctx = Context(setup_s=setup_s, window_s=0.0, steps=outers * m, samples=outers * m * u)
    if not trace:
        t0 = time.perf_counter()
        res = solve(spec)
        _sync(device)
        ctx.window_s = time.perf_counter() - t0
    else:
        for attempt in range(TRACE_TRIES):
            ops.reset_launch_counts()
            if mesh is None or torch.distributed.get_rank() == 0:
                res, tr = trace_lib.traced(lambda: solve(spec), lambda: _sync(device))
                launches = ops.launch_counts()
                lost = trace_lib.lost_records(tr.kernels, launches)
            else:
                res, tr, launches, lost = solve(spec), None, None, 0
                _sync(device)
            if agree(lost) == 0 or attempt == TRACE_TRIES - 1:
                break
        ctx.trace, ctx.launches, ctx.lost_records = tr, launches, lost
        if tr is not None:
            ctx.window_s = tr.wall_s
            lo, hi = block or (0, sset.dim)
            work = roofline.window_work(sset.indices, sset.values,
                                        sample_draws(x_seed, outers, sset.num_instances, m, u),
                                        lo, hi)
            ctx.least_s, setup["roofline_bound"] = work.least_seconds()
    walls = [0.0] + [h.wall_time_s for h in res.history]
    setup["window_outer_s"] = [float(q) for q in np.quantile(np.diff(walls), [0.1, 0.5, 0.9])]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    compared = min(COMPARED_OUTERS, outers)
    hist = list(warm.history) + list(res.history[:compared])
    return RunOut(setup=setup, data_seed=seed, outers=outers, warmup_seed=w_seed,
                  window_seed=x_seed, compared=compared,
                  objectives=[h.objective for h in hist], grad_norms=[h.grad_norm for h in hist],
                  change_norm=change,
                  failed_outers=sum(not math.isfinite(h.objective) for h in res.history),
                  memory_peak_bytes=int(agree(peak)),
                  fingerprint=sset.fingerprint(), context=ctx)


def run_one_card(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
                 t_start: float, device="cuda") -> RunOut:
    """A one-card cell: everything in this process."""
    from repro_torch.data.sparse import PaddedCSR
    from repro_torch.kernels import _build

    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        _sync(device)
    import_s = time.time() - t_start
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.load_library()
    library_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sset = make_data(cfg, seed, device)
    data = PaddedCSR(indices=sset.indices, values=sset.values, labels=sset.labels, dim=sset.dim)
    _sync(device)
    data_s = time.perf_counter() - t0
    out = _drive(cfg, traffic, sset, data, device, seed=seed, seconds=seconds, trace=trace,
                 t_start=t_start)
    out.setup = {"import_cuda_s": import_s, "library_s": library_s, "data_s": data_s,
                 **out.setup}
    return out


def rank_main(mesh, job: dict) -> RunOut | None:
    """One rank of a sharded cell (``spawn_ranks`` calls it with the mesh)."""
    import torch.distributed as dist

    from repro_torch.data.sparse import PaddedCSR

    if job.get("prepare") is not None:
        job["prepare"]()
    rank = dist.get_rank()
    device = torch.device(job["device"], rank) if job["device"] == "cuda" \
        else torch.device(job["device"])
    t_entered = time.time() - job["t_start"]
    cfg, traffic = job["cfg"], job["traffic"]

    def agree(x):
        t = torch.tensor([float(x)], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return type(x)(t.item())

    t0 = time.perf_counter()
    sset = make_data(cfg, job["seed"], device)
    data = PaddedCSR(indices=sset.indices, values=sset.values, labels=sset.labels, dim=sset.dim)
    _sync(device)
    data_s = time.perf_counter() - t0
    fp = sset.fingerprint()
    if agree(fp[0]) != fp[0] or agree(-fp[0]) != -fp[0] or agree(fp[1]) != fp[1]:
        raise RuntimeError(f"rank {rank} drew other data from the same seed: {fp}")
    lo, hi = partition_bounds(cfg["dim"], dist.get_world_size())[rank:rank + 2]
    out = _drive(cfg, traffic, sset, data, device, seed=job["seed"], seconds=job["seconds"],
                 trace=job["trace"], t_start=job["t_start"], mesh=mesh, agree=agree,
                 block=(lo, hi))
    out.setup = {"spawn_and_import_s": t_entered, "library_s": job["library_s"],
                 "data_s": data_s, **out.setup}
    return out if rank == 0 else None


def run_sharded(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
                t_start: float, ranks: int, device="cuda", backend="nccl",
                prepare=None) -> RunOut:
    """A sharded cell: ``ranks`` processes, one a card; rank 0's outputs."""
    from repro_torch.dist.launch import spawn_ranks
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    if device == "cuda":
        _build.load_library()  # once here, so that no rank builds
    library_s = time.perf_counter() - t0
    job = {"cfg": cfg, "traffic": traffic, "seed": seed, "seconds": seconds, "trace": trace,
           "t_start": t_start, "device": device, "library_s": library_s, "prepare": prepare}
    return spawn_ranks(ranks, rank_main, job, backend=backend, device=device,
                       timeout_s=RANK_TIMEOUT_S)


def partition_bounds(dim: int, q: int) -> tuple[int, ...]:
    """Balanced contiguous feature blocks (the first ``dim % q`` one wider)."""
    base, rem = divmod(dim, q)
    bounds = [0]
    for r in range(q):
        bounds.append(bounds[-1] + base + (1 if r < rem else 0))
    return tuple(bounds)
