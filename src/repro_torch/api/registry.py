"""The solver registry: one ``solve(spec) -> RunResult`` over the port's
optimizer drivers.

Port of ``repro.api.registry``.  Every driver registers here under a
method name with a :class:`MethodInfo` capability record; :func:`solve`
is the single front door that

* loads the data set (or takes the spec's in-memory one),
* resolves the ``"paper"`` auto-defaults per method (the per-method step
  sizes, the trajectory mini-batch, the inner-step rules FD: ``m = N/u``;
  DSVRG/Syn: ``m = N/q``; serial/PS: ``m = N``; BCD: ``m = q``, capped at
  :data:`PAPER_MAX_INNER`), exactly as the reference resolves them,
* validates the spec against the method's capabilities and fails loudly
  on mismatches,
* resolves the run's device (``spec.device``; ``None`` is ``cuda`` and
  raises without a card) and owns the BlockCSR layouts there (the shared
  bounded :data:`repro_torch.api.cache.BLOCK_CACHE`),
* dispatches to the registered driver, passing ``device`` and
  ``use_kernels``, and returns its
  :class:`~repro_torch.core.driver.RunResult`.

The ``kernels`` capability is the port's: ``True`` wherever the port has
a kernel route — the serial and FD drivers, ``fdsvrg_sharded``, the four
baselines, ``fd_saga`` and ``fd_bcd`` (the reference marks the last seven
``False``).  ``fdsvrg_sharded`` runs on ``spec.mesh`` (a ``DeviceMesh``;
every rank calls ``solve``), or on one rank with no process group.

====================  ====================================================
``serial``            Algorithm 2 (Johnson & Zhang), the proof reference
``fdsvrg``            Algorithm 1, metered simulation
``fdsvrg_sim``        Algorithm 1, explicit q-worker object simulation
``fdsvrg_sharded``    Algorithm 1, one rank per feature block of a mesh
``dsvrg``             DSVRG (Lee et al.), instance-sharded ring
``synsvrg``           SynSVRG on a parameter server (App. B)
``asysvrg``           AsySVRG on a parameter server (App. B)
``pslite_sgd``        PS-Lite asynchronous SGD (no variance reduction)
``fd_saga``           FD-SAGA update rule (replicated n-float table)
``fd_bcd``            Distributed block coordinate descent (L1 baseline)
====================  ====================================================
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch.api.cache import BLOCK_CACHE
from repro_torch.api.spec import PAPER, ExperimentSpec
from repro_torch.core import baselines
from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import CheckpointPolicy, RunResult, resolve_device
from repro_torch.core.fdsvrg import (
    SVRGConfig,
    fdsvrg_worker_simulation,
    run_fdsvrg,
    run_serial_svrg,
)
from repro_torch.core.fdsvrg_shardmap import FDSVRGShardedConfig, run_fdsvrg_sharded
from repro_torch.core.partition import balanced
from repro_torch.data import datasets
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.pipeline import as_source, is_source
from repro_torch.dist import ShardMapBackend, SimBackend
from repro_torch.optim.update_rules import BCDRule, SAGARule, make_context, run_with_rule

#: Cap on inner steps per outer for the scaled trajectories of the largest
#: sets (url/kdd) — subsampled epochs.
PAPER_MAX_INNER = 12_000

#: Scaled-trajectory mini-batch for the FD family (the paper's §4.4.1
#: mini-batch trick).
PAPER_FD_BATCH = 8


@dataclasses.dataclass(frozen=True)
class MethodInfo:
    """Capability record + paper operating point of one registered method."""

    name: str
    run: Callable  # (spec, data, resolved, device) -> RunResult
    backend: str  # backend family: "none" | "sim" | "shardmap"
    supports_kernels: bool
    supports_prox: bool = True
    supports_lazy: bool = False  # lazy O(nnz) delayed-decay inner steps
    supports_option_ii: bool = True
    needs_mesh: bool = False
    supports_checkpoint: bool = False  # outer-loop checkpoint/resume
    # Can run from streamed per-worker slabs alone (spec.source=...).
    supports_streaming: bool = False
    # Accepts a [N, k] label matrix (w ∈ R^{d×k}, one-vs-rest multiclass).
    supports_multi_output: bool = False
    # "paper" auto-default operating point:
    paper_eta: float = 1.0
    paper_batch: int = 1
    inner_rule: str = "n"  # "n" | "n_over_u" | "n_over_q" | "q"
    summary: str = ""


@dataclasses.dataclass(frozen=True)
class ResolvedRun:
    """Concrete numbers after ``"paper"`` resolution, handed to adapters."""

    eta: float
    batch_size: int
    inner_steps: int
    q: int


METHODS: dict[str, MethodInfo] = {}


def register_method(
    name: str,
    *,
    backend: str,
    supports_kernels: bool,
    supports_prox: bool = True,
    supports_lazy: bool = False,
    supports_option_ii: bool = True,
    needs_mesh: bool = False,
    supports_checkpoint: bool = False,
    supports_streaming: bool = False,
    supports_multi_output: bool = False,
    paper_eta: float,
    paper_batch: int = 1,
    inner_rule: str,
    summary: str = "",
) -> Callable:
    """Decorator registering a driver adapter under ``name``.

    The adapter receives ``(spec, data, resolved, device)`` — the
    validated spec, the loaded data set (or a DataSource), the resolved
    numeric parameters and the run's resolved device — and returns a
    ``RunResult``.
    """
    if inner_rule not in ("n", "n_over_u", "n_over_q", "q"):
        raise ValueError(f"unknown inner_rule {inner_rule!r}")

    def deco(fn: Callable) -> Callable:
        if name in METHODS:
            raise ValueError(f"method {name!r} is already registered")
        METHODS[name] = MethodInfo(
            name=name,
            run=fn,
            backend=backend,
            supports_kernels=supports_kernels,
            supports_prox=supports_prox,
            supports_lazy=supports_lazy,
            supports_option_ii=supports_option_ii,
            needs_mesh=needs_mesh,
            supports_checkpoint=supports_checkpoint,
            supports_streaming=supports_streaming,
            supports_multi_output=supports_multi_output,
            paper_eta=paper_eta,
            paper_batch=paper_batch,
            inner_rule=inner_rule,
            summary=summary
            or ((fn.__doc__ or "").strip().splitlines() or [""])[0],
        )
        return fn

    return deco


def method_info(name: str) -> MethodInfo:
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; registered methods: "
            f"{', '.join(sorted(METHODS))}"
        ) from None


def _capable(flag: str) -> str:
    return ", ".join(sorted(m for m, i in METHODS.items() if getattr(i, flag)))


def _validate(spec: ExperimentSpec, info: MethodInfo) -> None:
    """Capability checks — every mismatch is a loud error, never a
    silently ignored flag."""
    if spec.use_kernels and not info.supports_kernels:
        raise ValueError(
            f"method {info.name!r} does not support use_kernels=True "
            f"(kernel-path methods: {_capable('supports_kernels')}); pass "
            "use_kernels=False for its plain PyTorch path"
        )
    if spec.lazy_updates is not None and not info.supports_lazy:
        raise ValueError(
            f"method {info.name!r} does not support lazy_updates="
            f"{spec.lazy_updates!r} (lazy-capable methods: "
            f"{_capable('supports_lazy')}). The delayed-decay replay only "
            "exists for the BlockCSR inner scans; on any other driver the "
            "flag would be silently ignored."
        )
    if not spec.reg.is_smooth and not info.supports_prox:
        raise ValueError(
            f"method {info.name!r} does not support the proximal "
            f"regularizer family (got reg={spec.reg.name!r})"
        )
    if spec.option == "II" and not info.supports_option_ii:
        raise ValueError(
            f"method {info.name!r} ignores the Option I/II step mask; "
            "option='II' would not be honored — run Option I or use a "
            "driver that supports it"
        )
    if spec.mesh is not None and not info.needs_mesh:
        raise ValueError(
            f"method {info.name!r} does not run on a mesh; mesh= is only "
            "meaningful for the one-rank-per-block method (fdsvrg_sharded)"
        )
    if spec.tree_mode != "psum" and not info.needs_mesh:
        raise ValueError(
            f"method {info.name!r} does not consume tree_mode="
            f"{spec.tree_mode!r}; the collective topology is a mesh knob "
            "(fdsvrg_sharded) — it would not be honored here"
        )
    if spec.source is not None and not info.supports_streaming:
        raise ValueError(
            f"method {info.name!r} cannot run from a streamed source "
            f"(streaming methods: {_capable('supports_streaming')}). This "
            "driver needs the global matrix; load the data yourself "
            "(data=repro_torch.data.load_libsvm(...)) if that is what you "
            "want."
        )
    if spec.checkpoint_dir is not None and not info.supports_checkpoint:
        raise ValueError(
            f"method {info.name!r} does not support checkpoint/resume "
            f"(checkpointing methods: {_capable('supports_checkpoint')}). "
            "checkpoint_dir would be silently ignored; it fails here so a "
            "run that believes it is durable actually is."
        )
    labels = getattr(spec.data, "labels", None)
    if (
        labels is not None
        and labels.dim() == 2
        and labels.shape[1] > 1
        and not info.supports_multi_output
    ):
        raise ValueError(
            f"method {info.name!r} does not support multi-output labels "
            f"(got a [N, {labels.shape[1]}] label matrix; multi-output "
            f"methods: {_capable('supports_multi_output')})"
        )


def _resolve(
    spec: ExperimentSpec, info: MethodInfo, n: int, q: int
) -> ResolvedRun:
    """Turn ``"paper"`` sentinels into numbers with the per-method rules."""
    eta = info.paper_eta if spec.eta == PAPER else float(spec.eta)
    u = info.paper_batch if spec.batch_size == PAPER else int(spec.batch_size)
    if spec.inner_steps == PAPER:
        if info.inner_rule == "n_over_u":
            m = min(max(1, n // u), PAPER_MAX_INNER)
        elif info.inner_rule == "n_over_q":
            m = min(max(1, n // q), PAPER_MAX_INNER)
        elif info.inner_rule == "q":
            # One cycle over the feature blocks per outer (BCD).
            m = min(max(1, q), PAPER_MAX_INNER)
        else:  # "n"
            m = min(n, PAPER_MAX_INNER)
    else:
        m = int(spec.inner_steps)
    return ResolvedRun(eta=eta, batch_size=u, inner_steps=m, q=q)


@functools.lru_cache(maxsize=4)
def _load_dataset(name: str):
    """Memoized :func:`repro_torch.data.datasets.load`: dataset-name specs
    get the SAME data object across solve() calls, so the identity-keyed
    BlockCSR cache hits for sweeps built on ``spec.replace``."""
    return datasets.load(name)


def solve(spec: ExperimentSpec) -> RunResult:
    """Run ``spec`` through its registered driver; the ONE front door.

    Returns the driver's :class:`~repro_torch.core.driver.RunResult` —
    final iterate (on the run's device), per-outer history (objective,
    optimality residual, metered communication, modeled and wall-clock
    time), and the run's meter.
    """
    info = method_info(spec.method)
    _validate(spec, info)
    device = resolve_device(spec.device)
    if spec.source is not None:
        # The streaming path: the adapter turns the DataSource into
        # per-worker slabs (through the block/slab caches).
        data = as_source(spec.source)
        n = data.stats().num_instances
    else:
        data = (
            spec.data if spec.data is not None else _load_dataset(spec.dataset)
        )
        n = data.num_instances
    if info.needs_mesh:
        # The mesh's size IS the worker count; no mesh is one rank.
        q = 1 if spec.mesh is None else int(spec.mesh.size())
        if spec.q is not None and spec.q != q:
            raise ValueError(
                f"q={spec.q} disagrees with the mesh's {q} device(s); for "
                f"{info.name!r} the worker count IS the mesh size — pass a "
                "bigger mesh, not a bigger q"
            )
    elif spec.q is not None:
        q = spec.q
    elif spec.dataset is not None:
        q = datasets.spec(spec.dataset).default_workers
    else:
        q = 1
    resolved = _resolve(spec, info, n, q)
    return info.run(spec, data, resolved, device)


def capability_matrix() -> list[dict]:
    """Rows for the docs/CLI capability table, in registration order."""
    return [
        {
            "method": i.name,
            "backend": i.backend,
            "kernels": i.supports_kernels,
            "prox": i.supports_prox,
            "lazy": i.supports_lazy,
            "option_II": i.supports_option_ii,
            "mesh": i.needs_mesh,
            "checkpoint": i.supports_checkpoint,
            "streaming": i.supports_streaming,
            "multi_output": i.supports_multi_output,
            "paper_eta": i.paper_eta,
            "paper_batch": i.paper_batch,
            "inner_rule": i.inner_rule,
            "summary": i.summary,
        }
        for i in METHODS.values()
    ]


# ---------------------------------------------------------------------------
# Adapters: the drivers, registered
# ---------------------------------------------------------------------------


def _svrg_config(spec: ExperimentSpec, p: ResolvedRun) -> SVRGConfig:
    return SVRGConfig(
        eta=p.eta,
        inner_steps=p.inner_steps,
        outer_iters=spec.outer_iters,
        batch_size=p.batch_size,
        option=spec.option,
        seed=spec.seed,
    )


def _checkpoint_policy(spec: ExperimentSpec) -> CheckpointPolicy | None:
    if spec.checkpoint_dir is None:
        return None
    return CheckpointPolicy(
        directory=spec.checkpoint_dir,
        every=spec.checkpoint_every,
        resume=spec.resume,
    )


def _block(spec: ExperimentSpec, data, q: int, device):
    """The q-block layout of ``data`` on ``device``, through both cache
    layers for a source (in-process identity cache; on disk when the spec
    names one)."""
    if is_source(data):
        return BLOCK_CACHE.get_source(
            data, q, device, cache_dir=spec.data_cache_dir,
            chunk_rows=spec.ingest_chunk_rows,
        )
    return BLOCK_CACHE.get(data, q, device)


@register_method(
    "serial", backend="none", supports_kernels=True, supports_lazy=True,
    supports_checkpoint=True, supports_streaming=True,
    supports_multi_output=True,
    paper_eta=2.0, inner_rule="n",
    summary="Algorithm 2 (serial SVRG), the proof reference",
)
def _solve_serial(spec, data, p, device) -> RunResult:
    block = None
    if is_source(data):
        # Serial runs on the q=1 layout whatever spec.q says (q only
        # shapes the FD partitions).
        block, data = _block(spec, data, 1, device), None
    return run_serial_svrg(
        data, losses_lib.LOSSES[spec.loss], spec.reg, _svrg_config(spec, p),
        use_kernels=spec.use_kernels, lazy_updates=spec.lazy_updates,
        block_data=block, init_w=spec.init_w,
        checkpoint=_checkpoint_policy(spec), device=device,
    )


@register_method(
    "fdsvrg", backend="sim", supports_kernels=True, supports_lazy=True,
    supports_checkpoint=True, supports_streaming=True,
    supports_multi_output=True,
    paper_eta=2.0, paper_batch=PAPER_FD_BATCH, inner_rule="n_over_u",
    summary="Algorithm 1 (FD-SVRG), metered simulation",
)
def _solve_fdsvrg(spec, data, p, device) -> RunResult:
    block = _block(spec, data, p.q, device)
    return run_fdsvrg(
        None, block.partition, losses_lib.LOSSES[spec.loss], spec.reg,
        _svrg_config(spec, p), spec.cluster,
        use_kernels=spec.use_kernels, lazy_updates=spec.lazy_updates,
        block_data=block, init_w=spec.init_w,
        checkpoint=_checkpoint_policy(spec), device=device,
    )


@register_method(
    "fdsvrg_sim", backend="sim", supports_kernels=True, supports_lazy=True,
    supports_checkpoint=True, supports_streaming=True,
    paper_eta=2.0, paper_batch=PAPER_FD_BATCH, inner_rule="n_over_u",
    summary="Algorithm 1, explicit q-worker object-level simulation",
)
def _solve_fdsvrg_sim(spec, data, p, device) -> RunResult:
    block = _block(spec, data, p.q, device)
    return fdsvrg_worker_simulation(
        None, block.partition, losses_lib.LOSSES[spec.loss], spec.reg,
        _svrg_config(spec, p), SimBackend(p.q, spec.cluster),
        use_kernels=spec.use_kernels, lazy_updates=spec.lazy_updates,
        block_data=block, init_w=spec.init_w,
        checkpoint=_checkpoint_policy(spec), device=device,
    )


@register_method(
    "fdsvrg_sharded", backend="shardmap",
    # The port's ranks run the kernels through this front door (the
    # reference marks it False: its Pallas-inside-shard_map path is not
    # certified through solve).
    supports_kernels=True,
    supports_option_ii=False,  # the sharded inner scan has no step mask
    needs_mesh=True,
    paper_eta=2.0, paper_batch=PAPER_FD_BATCH, inner_rule="n_over_u",
    summary="Algorithm 1, deployable over the mesh's feature axes",
)
def _solve_fdsvrg_sharded(spec, data, p, device) -> RunResult:
    mesh = spec.mesh
    cfg = FDSVRGShardedConfig(
        dim=data.dim, num_instances=data.num_instances, nnz_max=data.nnz_max,
        eta=p.eta, inner_steps=p.inner_steps, batch_size=p.batch_size,
        loss_name=spec.loss, reg_name=spec.reg.name, lam=spec.reg.lam,
        lam2=spec.reg.lam2, tree_mode=spec.tree_mode, use_kernels=spec.use_kernels,
    )
    if mesh is None:
        backend = ShardMapBackend(q=1, tree_mode=spec.tree_mode, cluster=spec.cluster)
        axes, rank = ("model",), 0
    else:
        axes = tuple(mesh.mesh_dim_names)
        backend = ShardMapBackend(mesh=mesh, feature_axes=axes, tree_mode=spec.tree_mode,
                                  cluster=spec.cluster)
        rank = backend.device_worker_id()
    # Each rank builds its own block only, and not through BLOCK_CACHE:
    # no rank holds the other q - 1 blocks.
    block = BlockCSR.block_of(data, balanced(data.dim, p.q), rank)
    return run_fdsvrg_sharded(
        None, mesh, cfg, feature_axes=axes, outer_iters=spec.outer_iters,
        seed=spec.seed, backend=backend, init_w=spec.init_w, block=block,
        device=device,
    )


def _register_baseline(name, runner, *, paper_eta, inner_rule, supports_option_ii=True, summary):
    @register_method(
        name, backend="sim", supports_kernels=True,
        supports_option_ii=supports_option_ii,
        paper_eta=paper_eta, inner_rule=inner_rule, summary=summary,
    )
    def _solve_baseline(spec, data, p, device) -> RunResult:
        return runner(
            data, p.q, losses_lib.LOSSES[spec.loss], spec.reg,
            _svrg_config(spec, p), spec.cluster, init_w=spec.init_w,
            use_kernels=spec.use_kernels, device=device,
        )

    return _solve_baseline


_register_baseline(
    "dsvrg", baselines.run_dsvrg, paper_eta=1.0, inner_rule="n_over_q",
    summary="DSVRG (Lee et al.), instance-sharded ring",
)
_register_baseline(
    "synsvrg", baselines.run_syn_svrg, paper_eta=2.0, inner_rule="n_over_q",
    summary="SynSVRG on a parameter server (App. B, Alg 3/4)",
)
_register_baseline(
    "asysvrg", baselines.run_asy_svrg, paper_eta=0.5, inner_rule="n",
    supports_option_ii=False,  # the async scan draws no step mask
    summary="AsySVRG on a parameter server (App. B, Alg 5/6)",
)
_register_baseline(
    "pslite_sgd", baselines.run_pslite_sgd, paper_eta=0.3, inner_rule="n",
    supports_option_ii=False,
    summary="PS-Lite asynchronous SGD, no variance reduction",
)


# -- update-rule methods: a registration, not a new driver -------------------


def _run_rule(rule, spec, data, p, device) -> RunResult:
    ctx = make_context(
        BLOCK_CACHE.get(data, p.q, device), losses_lib.LOSSES[spec.loss],
        spec.reg, _svrg_config(spec, p), backend=SimBackend(p.q, spec.cluster),
    )
    return run_with_rule(rule, ctx, init_w=spec.init_w)


@register_method(
    "fd_saga", backend="sim", supports_kernels=True,
    supports_option_ii=False,  # SAGA has no Option I/II step mask
    paper_eta=1.0, paper_batch=PAPER_FD_BATCH, inner_rule="n_over_u",
    summary="FD-SAGA: feature-distributed SAGA, replicated n-float table",
)
def _solve_fd_saga(spec, data, p, device) -> RunResult:
    return _run_rule(SAGARule(use_kernels=spec.use_kernels), spec, data, p, device)


@register_method(
    "fd_bcd", backend="sim", supports_kernels=True,
    supports_option_ii=False,  # deterministic block cycling, no step mask
    paper_eta=1.0, inner_rule="q",
    summary="Distributed block coordinate descent (Mahajan et al.), L1 baseline",
)
def _solve_fd_bcd(spec, data, p, device) -> RunResult:
    return _run_rule(BCDRule(use_kernels=spec.use_kernels), spec, data, p, device)
