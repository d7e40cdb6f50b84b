#!/usr/bin/env python3
"""Readings that a cell's limits are set from (not run by the benchmark).

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--stand-in-seeds 7,8,9] [--seconds 10]

For each of ``--seeds`` it runs the cell as the benchmark does (one card,
in this process, one seed after another) and prints the compared numbers
of the program against the reference: the lower readings.  For each of
``--stand-in-seeds`` it puts the plain reference in the program's place
at the cell's own size (the warm-up and the window's compared outers)
and prints the numbers of

* ``control``: the reference in bfloat16, the precision below the
  configuration's float32;
* ``half_batch``: the reference in float32 with each mini-batch's mean
  taken over its first half only;
* ``no_exchange`` (cells of more than one rank): the reference in float32
  with every rank's block stepping on its own partial margins.

A step that returns its state unchanged reads 1 on ``change_gap`` and
needs no run.  One JSON line a reading.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stand_ins(cell, seed: int, device) -> list[dict]:
    import torch

    from bench import cell as cell_lib
    from bench import compare, harness

    cfg, traffic = cell.config, cell.traffic
    ref_mod = harness.reference(cfg, cell.root)
    data = cell_lib.make_data(cfg, seed, device)
    w_seed, x_seed = cell_lib.seeds(seed)
    outers = cell_lib.COMPARED_OUTERS
    kw = dict(lam=cfg["lam"], eta=cfg["eta"], batch=traffic["batch_size"],
              inner_steps=cell_lib.inner_steps(cfg, traffic),
              warmup=(w_seed, cell_lib.WARMUP_OUTERS), window=(x_seed, outers))
    t0 = time.perf_counter()
    ref = ref_mod.replay(data, **kw)
    ref_s = time.perf_counter() - t0
    kinds = {"control": dict(dtype=torch.bfloat16),
             "half_batch": dict(dtype=torch.float32, half_batch=True)}
    ranks = traffic.get("ranks", 1)
    if ranks > 1:
        kinds["no_exchange"] = dict(dtype=torch.float32,
                                    blocks=cell_lib.partition_bounds(cfg["dim"], ranks))
    out = []
    for kind, opts in kinds.items():
        got = ref_mod.replay(data, **kw, **opts)
        out.append({"kind": kind, "seed": seed, "outers": outers, "reference_s": ref_s,
                    **compare.numbers(got, ref)})
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Readings for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--stand-in-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness

    harness.configure_caches()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        line, setup = harness.execute(cell, seed=seed, seconds=args.seconds, trace=False,
                                      t_start=time.time())
        print(json.dumps({"kind": "program", "seed": seed, "outers": setup["outers"],
                          "rate": line["metrics"], **{k: c["value"] for k, c in
                                                      line["checks"].items()}}), flush=True)
    for seed in [int(s) for s in args.stand_in_seeds.split(",") if s]:
        for reading in stand_ins(cell, seed, torch.device("cuda", 0)):
            print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
