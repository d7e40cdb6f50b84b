#!/usr/bin/env python3
"""Inner steps per second of the FD-SVRG main path, dense and exact lazy.

Run from the root of a checkout, on a machine with a CUDA card, once per
tree to compare (each its own process, in turns):

    PYTHONPATH=src python tools/main_path_rate.py [--steps 2000] [--repeats 3]

It builds the kernels of the ``repro_torch`` on ``PYTHONPATH``, makes
full-width news20 at q = 8 from seed 0 (the ``fdsvrg-news20`` preset, as
``chip_smoke.py``'s main path), runs one warm-up outer, then ``--repeats``
times one outer of ``--steps`` inner steps with ``lazy_updates=None`` and
with ``"exact"``, in turns, each timed on the host clock up to a
``torch.cuda.synchronize()``.  It prints one JSON line: the tree it ran,
the card, each run's inner steps per second and the last objectives.
``--device cpu --scaled`` runs the scaled preset on the CPU, a quick check
of the script itself that measures nothing of the card.
"""

import argparse
import json
import os
import subprocess
import time

import torch

from repro_torch.configs.fdsvrg_linear import CONFIGS
from repro_torch.core import losses
from repro_torch.core.fdsvrg import SVRGConfig, run_fdsvrg
from repro_torch.core.partition import balanced
from repro_torch.data import datasets
from repro_torch.data.block_csr import BlockCSR


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scaled", action="store_true")
    args = parser.parse_args()
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("main_path_rate: needs a CUDA device (or --device cpu)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip() \
        if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    preset = CONFIGS["fdsvrg-news20"]
    data = datasets.load(preset.dataset, scaled=args.scaled, seed=0)
    part = balanced(data.dim, 8)
    bd = BlockCSR.from_padded(data, part).to(dev)
    loss, reg = losses.LOSSES[preset.loss], preset.regularizer()
    cfg = SVRGConfig(eta=preset.eta, inner_steps=args.steps, outer_iters=1,
                     batch_size=preset.batch_size, seed=0)
    for lazy in (None, "exact"):  # warm-up: the build and the first launches
        run_fdsvrg(None, part, loss, reg, cfg, block_data=bd, lazy_updates=lazy, device=dev)
    rates: dict[str, list[float]] = {"dense": [], "lazy_exact": []}
    objectives = {}
    for _ in range(args.repeats):
        for name, lazy in (("dense", None), ("lazy_exact", "exact")):
            sync()
            t0 = time.perf_counter()
            res = run_fdsvrg(None, part, loss, reg, cfg, block_data=bd, lazy_updates=lazy,
                             device=dev)
            sync()
            rates[name].append(args.steps / (time.perf_counter() - t0))
            objectives[name] = res.history[-1].objective
    import repro_torch

    print(json.dumps({"tree": os.path.relpath(os.path.dirname(repro_torch.__file__)),
                      "card": card, "steps": args.steps, "inner_steps_per_s": rates,
                      "objectives": objectives}), flush=True)


if __name__ == "__main__":
    main()
