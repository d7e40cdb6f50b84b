"""Run any registered method on any LinearConfig from the command line.

    PYTHONPATH=src python -m repro_torch.api.cli --config fdsvrg-news20 --method fdsvrg
    PYTHONPATH=src python -m repro_torch.api.cli --list
    PYTHONPATH=src python -m repro_torch.api.cli --config fdsvrg-news20 \\
        --method dsvrg --quick --device cpu --no-use-kernels
    PYTHONPATH=src python -m repro_torch.api.cli --data path/to/train.libsvm \\
        --data-cache .ingest_cache --workers 8

Port of ``repro.api.cli``: one flag per spec knob; everything unset
resolves through the registry's ``"paper"`` defaults.  ``--quick`` is
the smoke shape: 2 outer iterations with the inner loop capped at 300
steps.  As everywhere in the port, the run goes to ``cuda`` through the
CUDA kernels unless ``--device`` / ``--no-use-kernels`` say otherwise.

``--data`` streams a LibSVM file through the out-of-core ingestion path;
combined with ``--config`` it keeps the preset's loss/reg/eta but swaps
the data in.  ``--data-cache`` persists the built slabs so re-runs skip
parsing.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.api.registry import (
    METHODS,
    PAPER_MAX_INNER,
    capability_matrix,
    method_info,
    solve,
)
from repro_torch.configs.fdsvrg_linear import CONFIGS
from repro_torch.core.driver import resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.api.cli",
        description="One front door: solve an ExperimentSpec with any "
        "registered method.",
    )
    p.add_argument("--config", choices=sorted(CONFIGS),
                   help="LinearConfig preset (repro_torch.configs.fdsvrg_linear)")
    p.add_argument("--data", default=None, metavar="PATH",
                   help="stream a LibSVM file instead of a preset's "
                   "synthetic data (out-of-core ingestion; streaming "
                   "methods only)")
    p.add_argument("--data-cache", default=None, metavar="DIR",
                   help="on-disk slab cache for --data (warm re-runs "
                   "skip parsing)")
    p.add_argument("--chunk-rows", type=int, default=None,
                   help="rows per parsed chunk for --data (bounds host "
                   "memory; default 65536)")
    p.add_argument("--method", default="fdsvrg",
                   help=f"registered method ({', '.join(sorted(METHODS))})")
    p.add_argument("--outer-iters", type=int, default=None)
    p.add_argument("--eta", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--inner-steps", type=int, default=None)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run the CUDA kernels on a CUDA device (float32); "
                   "--no-use-kernels runs the plain PyTorch path")
    p.add_argument("--device", default=None,
                   help="torch device of the run (default cuda; 'cpu' runs "
                   "the plain versions on the host)")
    p.add_argument("--lazy-updates", choices=("exact", "proba"), default=None,
                   help="O(nnz) delayed-decay inner steps (lazy-capable "
                   "methods only)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist a rolling outer-loop checkpoint here "
                   "(checkpoint-capable methods only)")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="outers between checkpoint writes (default 1)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint-dir when a checkpoint "
                   "exists (bit-identical to the uninterrupted run)")
    p.add_argument("--quick", action="store_true",
                   help="smoke shape: 2 outers, inner loop capped at 300")
    p.add_argument("--list", action="store_true",
                   help="print the method registry (capability matrix) and exit")
    return p


def _print_registry() -> None:
    """Render capability_matrix(): one source for this table and the docs."""
    rows = sorted(capability_matrix(), key=lambda r: r["method"])
    cols = list(rows[0])
    widths = {
        c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols[:-1]
    }
    print(" ".join([f"{c:<{widths[c]}}" for c in cols[:-1]] + [cols[-1]]))
    for r in rows:
        print(" ".join([f"{str(r[c]):<{widths[c]}}" for c in cols[:-1]]
                       + [str(r[cols[-1]])]))


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.list:
        _print_registry()
        return 0
    if args.config is None and args.data is None:
        print("error: --config or --data is required (or use --list)",
              file=sys.stderr)
        return 2
    try:
        info = method_info(args.method)  # fail fast on unknown methods
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    lc = CONFIGS[args.config] if args.config is not None else None

    overrides: dict = {"use_kernels": args.use_kernels, "device": device}
    if args.data is not None:
        overrides["dataset"] = None  # the source replaces any preset data
        overrides["source"] = args.data
        if args.data_cache is not None:
            overrides["data_cache_dir"] = args.data_cache
        if args.chunk_rows is not None:
            overrides["ingest_chunk_rows"] = args.chunk_rows
    elif args.data_cache is not None or args.chunk_rows is not None:
        print("error: --data-cache/--chunk-rows only apply with --data",
              file=sys.stderr)
        return 2
    if args.outer_iters is not None:
        overrides["outer_iters"] = args.outer_iters
    if args.eta is not None:
        overrides["eta"] = args.eta
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.inner_steps is not None:
        overrides["inner_steps"] = args.inner_steps
    if args.workers is not None:
        overrides["q"] = args.workers
    elif info.needs_mesh and lc is not None:
        # The worker count IS the mesh size; drop the config's paper
        # worker count so the default mesh (this one process: one rank)
        # decides — and say so: a q=1 run meters zero communication.
        overrides["q"] = None
        print(f"note: {args.method} runs at the mesh size (q=1 rank in this "
              f"process), not the preset's workers={lc.workers}; comm meters "
              "reflect that q")
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.lazy_updates is not None:
        overrides["lazy_updates"] = args.lazy_updates
    if args.checkpoint_dir is not None:
        overrides["checkpoint_dir"] = args.checkpoint_dir
    if args.checkpoint_every is not None:
        overrides["checkpoint_every"] = args.checkpoint_every
    if args.resume:
        overrides["resume"] = True
    if args.quick:
        overrides.setdefault("outer_iters", 2)
        overrides.setdefault("inner_steps", min(300, PAPER_MAX_INNER))

    if lc is not None:
        data_desc = (
            f"data={args.data}" if args.data else f"dataset={lc.dataset}"
        )
        print(f"config {lc.name}: {data_desc} method={args.method} "
              f"({info.summary}) device={device} use_kernels={args.use_kernels}")
        make_spec = lambda: lc.to_spec(method=args.method, **overrides)
    else:
        from repro_torch.api.spec import ExperimentSpec

        overrides.pop("dataset", None)
        print(f"data {args.data}: method={args.method} ({info.summary}) "
              f"device={device} use_kernels={args.use_kernels}")
        make_spec = lambda: ExperimentSpec(method=args.method, **overrides)
    try:
        result = solve(make_spec())
    except (TypeError, ValueError, NotImplementedError) as e:
        # spec/capability validation errors follow the CLI's one-line
        # error convention, same as a missing --config
        print(f"error: {e}", file=sys.stderr)
        return 2

    print(f"\n{'outer':>5} {'objective':>12} {'optimality':>12} "
          f"{'comm scalars':>13} {'modeled s':>10}")
    for h in result.history:
        print(f"{h.outer:>5} {h.objective:>12.6f} {h.grad_norm:>12.4e} "
              f"{h.comm_scalars:>13,} {h.modeled_time_s:>10.4f}")
    print(f"\nfinal objective {result.final_objective():.6f}; "
          f"{result.meter.total_scalars:,} scalars in "
          f"{result.meter.total_rounds:,} rounds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
