#!/usr/bin/env python3
"""Time the port's ``flash_decode`` kernel alone at qwen3-14b's decode shapes.

Run from the root of a checkout, on a machine with a CUDA card:

    PYTHONPATH=src python tools/flash_decode_timing.py

It builds the kernels, then for each shape (B requests, ``length`` valid
positions of an S-position bfloat16 cache, 8 KV heads of 5 query heads,
Dh 128) holds the kernel against its plain version (``|d| <= 2e-5 *
max|v|``) and prints one line: the worst error, the mean time of 20
back-to-back calls from CUDA events (warm L2, launch overhead included),
the split geometry and the bytes bound at 3.35 TB/s.  It is the quick
look at one kernel; ``chip_smoke.py`` measures every kernel with the
profiler and a cold L2.
"""

import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as fd

SHAPES = ((1, 32_768, 32_784), (4, 528, 528), (1, 524_288, 524_288))  # B, length, S
HKV, GROUP, DH = 8, 5, 128
PEAK_BYTES_PER_S = 3.35e12


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.time()
    _build.build()
    _build.load_library()
    print("build_s", time.time() - t0)
    dev = torch.device("cuda")
    scale = DH ** -0.5
    for b, length, s in SHAPES:
        g = torch.Generator(dev).manual_seed(0)
        q = torch.randn((b, HKV, GROUP, DH), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, s, HKV, DH), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, s, HKV, DH), generator=g, device=dev).to(torch.bfloat16)
        got = fd.flash_decode(q, k, v, length, scale)
        want = fd.flash_decode_plain(q, k, v, length, scale)
        err = float((got - want).abs().max())
        tol = 2e-5 * float(v[:, :length].float().abs().max())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            fd.flash_decode(q, k, v, length, scale)
        start.record()
        for _ in range(20):
            fd.flash_decode(q, k, v, length, scale)
        end.record()
        end.synchronize()
        print(dict(b=b, length=length, err=err, tol=tol, ok=err <= tol,
                   ms=start.elapsed_time(end) / 20,
                   splits=fd.num_splits(b * HKV, length,
                                        torch.cuda.get_device_properties(dev).multi_processor_count),
                   bound_ms=2 * b * length * HKV * DH * 2 / PEAK_BYTES_PER_S * 1e3), flush=True)


if __name__ == "__main__":
    main()
