"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 30 --batch 8 --seq 256 [--reduced] [--optimizer adamw] \
        [--grad-accum 2] [--ckpt PATH] [--log-every 10]

Port of ``repro.launch.train``, with its flags and its printed lines
(``arch= params= steps=``, then ``step N loss= ce= gnorm= (s/step)`` at
the first step and every ``--log-every``).  It runs on ``cuda`` and
raises without a card; ``main(argv, device="cpu")`` (a keyword the
reference lacks) runs it on the CPU.  The initial state is
``train.loop.init_state`` from seed 0 (a ``torch.Generator``, so other
values than the reference's ``jax.random.key(0)``), the batches
``data.token_stream.batches`` from seed 0, byte for byte the
reference's.  ``--ckpt`` saves the final state through
``repro_torch.checkpoint.ckpt`` (``PATH.npz`` and ``PATH.json``).  The
host clock runs from before the first step, so the first line's s/step
includes the first step's one-off costs, as the reference's includes its
compile.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.driver import resolve_device
from repro_torch.data.token_stream import PipelineConfig, batches
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.sharding.specs import unsharded_ctx
from repro_torch.train.loop import TrainSettings, init_state, make_train_step


@dataclasses.dataclass
class TrainRun:
    """What one training run leaves, for a caller that checks or times it."""

    cfg: ModelConfig
    settings: TrainSettings
    state: dict  # after the last step
    metrics: list[dict]  # one dict of 0-dim device tensors per step
    first_step_s: float  # host seconds to the end of step 1 (synchronised)
    total_s: float  # host seconds over every step (synchronised at the end)


def run(argv=None, *, device: torch.device | str | None = None,
        cfg: ModelConfig | None = None) -> TrainRun:
    """Train as ``main`` does and return the run.  ``cfg``, where given,
    replaces the preset that ``--arch`` / ``--reduced`` name (a depth cut)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd", "momentum"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced_config(cfg)
    device = resolve_device(device)
    ctx = unsharded_ctx()
    opt = optimizers.OPTIMIZERS[args.optimizer](args.lr)
    settings = TrainSettings(grad_accum=args.grad_accum)
    state = init_state(cfg, 0, opt, tp=1, device=device)
    step = make_train_step(cfg, ctx, opt, settings)

    pcfg = PipelineConfig(args.batch, args.seq, grad_accum=args.grad_accum)
    it = batches(cfg, pcfg)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps}")

    history: list[dict] = []
    first_s = 0.0
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        state, metrics = step(state, batch)
        history.append(metrics)
        if (i + 1) % args.log_every == 0 or i == 0:
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            if i == 0:
                first_s = dt
            print(
                f"step {i+1:5d} loss={loss:.4f} "
                f"ce={float(metrics['ce']):.4f} "
                f"gnorm={float(metrics.get('grad_norm', 0.0)):.3f} "
                f"({dt/(i+1):.2f}s/step)",
                flush=True,
            )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total_s = time.perf_counter() - t0
    if args.ckpt:
        from repro_torch.checkpoint import ckpt

        ckpt.save(args.ckpt, state)
        print(f"saved checkpoint to {args.ckpt}.npz")
    return TrainRun(cfg, settings, state, history, first_s, total_s)


def main(argv=None, *, device: torch.device | str | None = None) -> float:
    """The reference's entry point: train, print, return the last loss."""
    return float(run(argv, device=device).metrics[-1]["loss"])


if __name__ == "__main__":
    main()
