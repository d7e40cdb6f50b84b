#!/usr/bin/env python3
"""Time one inner step's margins and exact-lazy catch-up at full-width news20, q = 8.

Run from the root of a checkout, on a machine with a CUDA card:

    PYTHONPATH=src python tools/step_timing.py

It builds the kernels and prints what ``nvcc -Xptxas -v`` says of the
margins and catch-up kernels.  Then, on the news20 generator's data from
seed 0, it prints one JSON line per shape: ``ops.step_margins`` at u = 1,
8, 64 and ``ops.snapshot_margins`` (the L2 overwritten before each call),
each one launch for the 8 blocks, whether its margins equal 8 one-block
launches plus ``tree_order_sum`` bit for bit, and its device time; then
``ops.lazy_step_catchup`` at u = 1, 8, 64 from the state an epoch of 500
steps leaves (as ``chip_smoke.py`` builds it) and at u = 1 from stamps of
19,954 sampled rows (m = N), at l2 (lam = 1e-4), each with its chain
bound (the longest replay times 4 dependent float operations of 4
cycles at the card's top SM clock).  Device times are kernel time from a
``torch.profiler`` (CUPTI) trace, the mean of 50 calls (5 for the
snapshot).  It is the quick look at the two kernels; ``chip_smoke.py``
checks them against the CPU and times them beside the path before.
"""

import json
import subprocess

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.fdsvrg_linear import CONFIGS
from repro_torch.core import losses
from repro_torch.core.driver import draw_samples
from repro_torch.core.fdsvrg import _full_grad_blocks
from repro_torch.core.partition import balanced
from repro_torch.data import datasets
from repro_torch.data.block_csr import BlockCSR
from repro_torch.dist.tree import tree_order_sum
from repro_torch.kernels import _build, ops
from repro_torch.kernels import sparse_margin as margin_mod

LAM = 1e-4  # the news20 preset's l2 strength
CHAIN_CYCLES = 4 * 4  # a replayed step: 4 dependent float operations of 4 cycles


def ptxas_report() -> str:
    lines = []
    for name in ("sparse_margin.cu", "lazy_update.cu"):
        out = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(_build.CSRC / name), "-o", "/dev/null"], capture_output=True, text=True,
            check=True)
        lines += [ln for ln in out.stderr.splitlines() if "Used" in ln or "spill" in ln]
    return "\n".join(lines)


def device_ms(fn, iters, before=None) -> float:
    """Mean kernel time per call of ``fn`` from a profiler trace (``before``
    runs before each call and is not counted: copies only)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy"))
    return us / iters / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("step_timing: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    clock_hz = float(card.split(",")[2].split()[0]) * 1e6
    _build.load_library()
    print(ptxas_report(), flush=True)
    cfg = CONFIGS["fdsvrg-news20"]
    data = datasets.load(cfg.dataset, scaled=False, seed=0)
    bd = BlockCSR.from_padded(data, balanced(data.dim, 8)).to(dev)
    n, q = data.num_instances, bd.num_blocks
    bounds = list(bd.partition.bounds)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0.0, 0.1, size=data.dim).astype(np.float32)).to(dev)
    w_parts = [w[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    l2_src = torch.zeros(64 * 2**20 // 4, device=dev)
    l2_dst = torch.empty_like(l2_src)

    def flush():
        l2_dst.copy_(l2_src)

    for u in (1, 8, 64, None):
        ids = None if u is None else torch.from_numpy(
            rng.integers(0, n, size=u).astype(np.int64)).to(dev)
        rows = [(i, v) if ids is None else (i[ids], v[ids]) for i, v in zip(bd.indices, bd.values)]
        want = tree_order_sum([margin_mod.sparse_margin(i, v, w_l)
                               for (i, v), w_l in zip(rows, w_parts)])
        if ids is None:
            def fn():
                return ops.snapshot_margins(bd, w)
        else:
            buf = ops.step_rows(bd, u)

            def fn(ids=ids, buf=buf):
                return ops.step_margins(bd, ids, w, out=buf).s
        bitwise = bool(torch.equal(fn(), want))
        print(json.dumps({
            "kernel": "sparse_margin", "shape": "snapshot R=N" if u is None else f"step u={u}",
            "blocks": q, "bitwise_vs_8_launches": bitwise, "l2": "cold" if u is None else "warm",
            "kernel_ms": device_ms(fn, 5 if u is None else 50, flush if u is None else None),
            "card": card}), flush=True)

    loss = losses.LOSSES[cfg.loss]
    z = _full_grad_blocks(bd, torch.zeros(data.dim, device=dev), loss, True)[0]
    eta = float(np.float32(cfg.eta))

    def state(steps, seed):
        """w and the stamps after ``steps`` u = 1 step catch-ups, and the
        next step's rows (8 sampled rows)."""
        samples = torch.from_numpy(draw_samples(np.random.default_rng(seed), n, steps + 1, 8)
                                   .astype(np.int64)).to(dev)
        w_s, last = w.clone(), torch.zeros(data.dim, dtype=torch.int32, device=dev)
        if steps <= 500:
            for m in range(steps):
                ops.lazy_step_catchup(bd, samples[m, :1], w_s, last, z, eta, m, steps, lam=LAM)
        else:  # the stamps alone, as chip_smoke.py's epoch_stamps builds them
            g = torch.cat([bd.indices[l][samples[:steps, 0]].long() + bounds[l]
                           for l in range(q)], 1)
            stamps = torch.arange(1, steps + 1, device=dev, dtype=torch.int32)
            last.scatter_reduce_(0, g.reshape(-1), stamps.repeat_interleave(g.shape[1]), "amax")
        return w_s, last, samples[steps]

    for steps, us in ((500, (1, 8, 64)), (n, (1,))):
        w_s, last, nxt = state(steps, 1)
        for u in us:
            ids = nxt[:u] if u <= 8 else torch.from_numpy(
                rng.integers(0, n, size=u).astype(np.int64)).to(dev)
            g = torch.cat([bd.indices[l][ids].long() + bounds[l] for l in range(q)], 1)
            k = torch.clamp_min(steps - last[torch.unique(g)], 0)
            a = (w_s.clone(), last.clone())

            def restore(a=a):
                a[0].copy_(w_s)
                a[1].copy_(last)

            chain = int(k.max())
            ms = device_ms(lambda: ops.lazy_step_catchup(bd, ids, *a, z, eta, steps, steps,
                                                         lam=LAM), 50, restore)
            bound = chain * CHAIN_CYCLES / clock_hz * 1e3
            print(json.dumps({
                "kernel": "lazy_catchup", "shape": f"step m={steps}, u={u}", "blocks": q,
                "longest_replay": chain, "chain_bound_ms": bound, "kernel_ms": ms,
                "kernel_over_chain_bound": ms / bound, "card": card}), flush=True)


if __name__ == "__main__":
    main()
