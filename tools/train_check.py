#!/usr/bin/env python3
"""The LM training phases of ``chip_smoke.py`` (``lm_train_paths``) alone.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/train_check.py

It runs exactly the smoke's phases, with the smoke's settings (TF32 off):
``lm_train`` (``launch.train --arch smollm-360m --steps 30`` at full
width and depth, its repeatability, checkpoint resume, a profiled step
and peak memory with and without remat), ``lm_train_4k``,
``lm_train_moe``, ``lm_train_family`` and the CPU-against-card step.  No
kernel is built: none lies on the training path.  It prints the phases'
JSON lines and the card's name and power limit, and exits non-zero when
a check fails.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("train_check: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    try:
        times = smoke.lm_train_paths(torch, card)
    except smoke.SmokeFailure as err:
        print(f"train_check: FAILED: {err}", file=sys.stderr, flush=True)
        return 1
    smoke.emit({"phase": "lm_train_time", **times, "wall_s": time.perf_counter() - t0})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
