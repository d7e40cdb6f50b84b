#!/usr/bin/env python3
"""Time the snapshot scatter (``block_scatter``) alone at full-width news20, q = 8.

Run from the root of a checkout, on a machine with a CUDA card:

    PYTHONPATH=src python tools/scatter_timing.py [--heavy-min 256 1024 4096]

It builds the kernels and prints what ``nvcc -Xptxas -v`` says of
``block_scatter.cu``.  Then, at the main path's first snapshot (w = 0,
the news20 generator's data from seed 0), for each ``--heavy-min``
(the indexes are built with it; the default is ``block_scatter.HEAVY_MIN``)
it prints one JSON line: whether ``z`` equals the CPU's per-block ``index_add_`` bit for bit,
the mean time of one snapshot launch and of block 0's launch alone from
CUDA events (10 calls, the 50 MB L2 overwritten before each and the
overwrite's own time taken off), and block 0's chain time inside each
(``%globaltimer`` at the start and end of its heavy fold).  It is the
quick look at one kernel's settings; ``chip_smoke.py`` measures every
kernel with the profiler.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.configs.fdsvrg_linear import CONFIGS
from repro_torch.core import losses
from repro_torch.core.fdsvrg import _divide
from repro_torch.core.partition import balanced
from repro_torch.data import datasets
from repro_torch.data.block_csr import BlockCSR, local_scatter
from repro_torch.kernels import _build
from repro_torch.kernels import block_scatter as scatter_mod

ITERS = 10


def ptxas_report() -> str:
    src = _build.CSRC / "block_scatter.cu"
    out = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
         "/dev/null"], capture_output=True, text=True, check=True)
    return out.stderr


def cold_ms(fn, flush) -> float:
    """Mean ms of ``fn`` over ITERS calls, each after ``flush``, minus the
    flush's own mean time."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(body):
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS

    fn()
    return timed(lambda: (flush(), fn())) - timed(flush)


def chain_ms(values, coeffs, index, flush) -> float:
    """The first (longest) heavy fold's own time, mean of ITERS launches."""
    timing = torch.zeros(2 * index.heavy.numel(), dtype=torch.int64, device="cuda")
    spans = []
    for _ in range(ITERS):
        flush()
        scatter_mod.block_scatter(values, coeffs, index, timing)
        torch.cuda.synchronize()
        spans.append(float(timing[1] - timing[0]) / 1e6)
    return sum(spans) / len(spans)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--heavy-min", type=int, nargs="+", default=[scatter_mod.HEAVY_MIN])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scatter_timing: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.load_library()
    print(ptxas_report(), flush=True)
    cfg = CONFIGS["fdsvrg-news20"]
    data = datasets.load(cfg.dataset, scaled=False, seed=0)
    bd_cpu = BlockCSR.from_padded(data, balanced(data.dim, 8))
    bd = bd_cpu.to("cuda")
    n = data.num_instances
    loss = losses.LOSSES[cfg.loss]
    coeffs = _divide(loss.dvalue(torch.zeros(n, device="cuda"), bd.labels), n)
    coeffs_cpu = coeffs.cpu()
    want = torch.cat([local_scatter(bd_cpu.indices[l], bd_cpu.values[l], coeffs_cpu,
                                    bd.block_dims[l]) for l in range(8)]).numpy().view(np.int32)
    l2_src = torch.zeros(64 * 2**20 // 4, device="cuda")
    l2_dst = torch.empty_like(l2_src)

    def flush():
        l2_dst.copy_(l2_src)

    for heavy_min in args.heavy_min:
        snap = scatter_mod.snapshot_index(bd.indices, bd.values, bd.block_dims, heavy_min)
        one = scatter_mod.scatter_index(bd.indices[0], bd.values[0], bd.block_dims[0], heavy_min)
        z = scatter_mod.block_scatter(bd.values, coeffs, snap)
        torch.cuda.synchronize()
        print(json.dumps({
            "heavy_min": heavy_min, "heavy_ids": int(snap.heavy.numel()),
            "bitwise_vs_cpu": bool(np.array_equal(z.cpu().numpy().view(np.int32), want)),
            "snapshot_ms": cold_ms(lambda: scatter_mod.block_scatter(bd.values, coeffs, snap),
                                   flush),
            "block0_chain_ms_in_snapshot": chain_ms(bd.values, coeffs, snap, flush),
            "block0_alone_ms": cold_ms(
                lambda: scatter_mod.block_scatter(bd.values[0], coeffs, one), flush),
            "block0_chain_ms_alone": chain_ms(bd.values[0], coeffs, one, flush),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
