#!/usr/bin/env python3
"""Find which op makes the plain AsySVRG route drift on the card at eta = 0.25.

Run from the root of a checkout, on a machine with a CUDA card:

    PYTHONPATH=src python tools/async_bisect.py [--eta 0.25] [--steps 2000] [--outers 2]

At full-width news20 (the generator's data from seed 0; q = 8 workers,
l2 lam = 1e-4, the q = 1 layout) it runs ``run_asy_svrg`` with
``use_kernels=False`` on the CPU (the yardstick: the reference's CPU run
agrees with it within 4e-6) and twice on the card (do two card runs
agree with each other?), the kernel route once, and then the card's
plain route with some of its ops swapped for their CPU results:

* ``snapshot`` — the full gradient's z and s0 (the plain snapshot's
  ``index_add_`` over every row and its ``torch.sum`` margins);
* ``scatter`` — a step's ``x = zeros.index_add_(0, idx, val)`` (float
  atomics on the card over the ~80 copies of id 12,539 a row stores);
* ``sum`` — a step's margin ``torch.sum(w_stale[idx] * val)``;
* ``dvalue`` — the loss derivative at the step's margin and at s0.

Each swap alone, all four, and all but one.  The other ops of a step are
elementwise (one IEEE rounding each, the same on both devices).  Prints
one JSON line per run (objectives, max |w - w_cpu|, whether w equals the
CPU's bit for bit) and writes them to ``chiprun_out/async_bisect.json``.
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs.fdsvrg_linear import CONFIGS
from repro_torch.core import baselines, losses
from repro_torch.core.fdsvrg import SVRGConfig, _full_grad_blocks
from repro_torch.data import datasets

Q = 8
SWAPS = ("snapshot", "scatter", "sum", "dvalue")


def plain_epoch_with_swaps(swaps, bd_cpu):
    """``baselines._async_epoch``'s plain route, op for op, with the named
    ops computed on the CPU and their results moved to the card."""

    def epoch(bd, w0, z_data, s0, samples, delays, eta, loss, reg, delay_buf,
              variance_reduced, use_kernels):
        assert variance_reduced and not use_kernels
        device = w0.device
        eta_t = torch.full((), float(np.float32(eta)), dtype=w0.dtype, device=device)
        ring = [w0] * delay_buf
        idx_cpu, val_cpu, y_cpu = bd_cpu.indices[0], bd_cpu.values[0], bd_cpu.labels
        s0_cpu = s0.cpu()

        def dl(s, y, s_cpu=None, y_host=None):
            if "dvalue" in swaps:
                return loss.dvalue(s.cpu() if s_cpu is None else s_cpu, y_host).to(device)
            return loss.dvalue(s, y)

        for m in range(samples.shape[0]):
            i = int(samples[m])
            w_now = ring[m % delay_buf]
            w_stale = ring[(m - int(delays[m])) % delay_buf]
            idx, val, y = bd.indices[0][i], bd.values[0][i], bd.labels[i]
            prod = w_stale[idx] * val
            s_m = torch.sum(prod.cpu()).to(device) if "sum" in swaps else torch.sum(prod)
            if "scatter" in swaps:
                x_host = torch.zeros(w0.shape[0]).index_add_(0, idx_cpu[i], val_cpu[i])
                touched = torch.unique(idx_cpu[i])
                x = torch.zeros_like(w0)
                x[touched.to(device)] = x_host[touched].to(device)
            else:
                x = torch.zeros_like(w0).index_add_(0, idx, val)
            coef = dl(s_m, y, y_host=y_cpu[i]) - dl(s0[i], y, s_cpu=s0_cpu[i], y_host=y_cpu[i])
            g = coef * x + z_data
            g = g + reg.smooth_grad(w_stale)
            ring[(m + 1) % delay_buf] = reg.prox(w_now - eta_t * g, eta_t)
        return ring[samples.shape[0] % delay_buf]

    return epoch


def snapshot_on_cpu(bd_cpu):
    def full_grad(bd, w, loss, use_kernels):
        z, s0 = _full_grad_blocks(bd_cpu, w.cpu(), loss, use_kernels)
        return z.to(w.device), s0.to(w.device)

    return full_grad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--eta", type=float, default=0.25)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--outers", type=int, default=2)
    args = ap.parse_args()
    preset = CONFIGS["fdsvrg-news20"]
    data = datasets.load(preset.dataset, scaled=False, seed=0)
    loss, reg = losses.logistic, losses.l2(preset.lam)
    cfg = SVRGConfig(eta=args.eta, inner_steps=args.steps, outer_iters=args.outers, seed=0)
    bd_cpu = baselines._layout(data, False, torch.device("cpu"))
    out_lines = []

    def emit(label, res, t0):
        w = res.w.cpu()
        line = {"run": label, "eta": args.eta, "inner_steps": args.steps,
                "outers": args.outers, "objectives": res.objectives().tolist(),
                "wall_s": time.perf_counter() - t0}
        if out_lines:
            w_cpu = out_lines[0]["_w"]
            line["w_max_abs_diff_vs_cpu"] = float(torch.max(torch.abs(w - w_cpu)))
            line["w_bitwise_cpu"] = bool(torch.equal(w, w_cpu))
            line["objective_rel_vs_cpu"] = float(np.max(
                np.abs(res.objectives() - out_lines[0]["objectives"])
                / np.abs(out_lines[0]["objectives"])))
        print(json.dumps(line), flush=True)
        out_lines.append({**line, "_w": w})

    def run(label, device, use_kernels=False, swaps=None):
        orig_epoch, orig_fg = baselines._async_epoch, baselines._full_grad_blocks
        if swaps is not None:
            baselines._async_epoch = plain_epoch_with_swaps(swaps, bd_cpu)
            if "snapshot" in swaps:
                baselines._full_grad_blocks = snapshot_on_cpu(bd_cpu)
        try:
            t0 = time.perf_counter()
            res = baselines.run_asy_svrg(data, Q, loss, reg, cfg, use_kernels=use_kernels,
                                         device=device)
            if device != "cpu":
                torch.cuda.synchronize()
            emit(label, res, t0)
        finally:
            baselines._async_epoch, baselines._full_grad_blocks = orig_epoch, orig_fg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    run("cpu plain", "cpu")
    run("card plain", "cuda")
    run("card plain again", "cuda")
    run("card kernel route", "cuda", use_kernels=True)
    run("card plain, no swap (the copied loop)", "cuda", swaps=())
    for op in SWAPS:
        run(f"card plain, swap {op}", "cuda", swaps=(op,))
    run("card plain, swap all", "cuda", swaps=SWAPS)
    for op in SWAPS:
        run(f"card plain, swap all but {op}", "cuda",
            swaps=tuple(s for s in SWAPS if s != op))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "async_bisect.json"), "w") as f:
        json.dump({"card": card, "runs": [{k: v for k, v in ln.items() if k != "_w"}
                                          for ln in out_lines]}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
