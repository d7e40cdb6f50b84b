#!/usr/bin/env python3
"""Peak memory of one LM train step on the card over a sweep of batch sizes.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/train_memory.py [--batches 8,16,24,32,48] [--no-remat-at 16]

The configuration of ``chip_smoke.py``'s ``lm_train_4k``: smollm-360m at
full width and depth, train_4k's 4,096 positions, ``grad_accum`` 2,
bfloat16 compute, float32 masters, adamw; one step from
``train.loop.init_state(seed 0)`` at each batch size in a fresh process,
through ``chip_smoke._step_peak_gb`` (with the per-repeat remat of
``transformer.forward``): the peak ``max_memory_allocated`` after
``reset_peak_memory_stats``, the step's seconds (its first call), or the
out-of-memory error.  ``--no-remat-at`` repeats one batch size with the
remat wrapper replaced by the identity.  One JSON line per step and the
card's name and power limit.  The largest batch that fits with remat
after the smoke's earlier phases is ``LM_TRAIN_4K_BATCH``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, GRAD_ACCUM = "smollm-360m", 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="8,16,24,32,48")
    ap.add_argument("--no-remat-at", type=int, default=None)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.data.token_stream import PipelineConfig, batches
    from repro_torch.optim.optimizers import adamw
    from repro_torch.sharding.specs import unsharded_ctx
    from repro_torch.train.loop import TrainSettings, init_state, make_train_step

    if not torch.cuda.is_available():
        print("train_memory: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(card, flush=True)
    cfg, seq = get_config(ARCH), INPUT_SHAPES["train_4k"].seq_len
    opt = adamw(3e-3)
    state = init_state(cfg, 0, opt, tp=1)
    step = make_train_step(cfg, unsharded_ctx(), opt, TrainSettings(grad_accum=GRAD_ACCUM))
    runs = [(int(b), True) for b in args.batches.split(",")]
    if args.no_remat_at:
        runs.append((args.no_remat_at, False))
    for b, remat in runs:
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(batches(
            cfg, PipelineConfig(b, seq, seed=1, grad_accum=GRAD_ACCUM))).items()}
        row = {"arch": cfg.name, "batch": b, "seq": seq, "grad_accum": GRAD_ACCUM,
               "remat": remat, "state_gb": torch.cuda.memory_allocated() / 1e9}
        t0 = time.perf_counter()
        peak, oom = smoke._step_peak_gb(torch, step, state, batch, remat)
        row.update(fits=oom is None, peak_gb=peak, oom=oom, step_s=time.perf_counter() - t0)
        del batch
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
