#!/usr/bin/env python3
"""Time the port's ``flash_decode`` kernel alone at qwen3-14b's decode shapes.

Run from the root of a checkout, on a machine with a CUDA card:

    PYTHONPATH=src python tools/flash_decode_timing.py [--waves 2 4 8]

It builds the kernels and prints what ``nvcc -Xptxas -v`` says of
``flash_decode.cu`` (registers, spills, shared memory per instantiation).
Then for each shape (B requests, ``length`` valid positions of an
S-position bfloat16 cache, 8 KV heads of 5 query heads, Dh 128) and each
``--waves`` setting of the split geometry (``flash_decode.WAVES``) it holds
the kernel against its plain version (``|d| <= 2e-5 * max|v|``) and prints
one line: the worst error, the mean time of 20 calls from CUDA events with
the 50 MB L2 overwritten before each (cold, as a decode step finds the
cache; the copy's own time measured alone and taken off), the split
geometry and the bytes bound at 3.35 TB/s.  Each line also times the
same work on a head-major copy of the cache (``[B * Hkv, S, 1, Dh]``, each
KV head's rows contiguous, the layout SDPA reads in ``chip_smoke.py``) and
SDPA on it, which separates the cache's layout from the kernel.  It is the
quick look at one kernel; ``chip_smoke.py`` measures every kernel with the
profiler.
"""

import argparse
import subprocess
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_decode as fd

SHAPES = ((1, 32_768, 32_784), (4, 32_768, 32_784), (4, 528, 544), (1, 524_288, 524_288))
HKV, GROUP, DH = 8, 5, 128
PEAK_BYTES_PER_S = 3.35e12
ITERS = 20


def ptxas_report() -> str:
    """``nvcc -Xptxas -v`` on flash_decode.cu: one line per kernel."""
    src = _build.CSRC / "flash_decode.cu"
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

    def both():
        flush()
        fn()

    for _ in range(3):
        both()
    return timed(both) - timed(flush)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--waves", type=int, nargs="+", default=[fd.WAVES])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.time()
    _build.build()
    _build.load_library()
    print("build_s", time.time() - t0)
    print(ptxas_report(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    l2_src = torch.zeros(64 * 2**20 // 4, device=dev)
    l2_dst = torch.empty_like(l2_src)
    scale = DH ** -0.5
    for b, length, s in SHAPES:
        g = torch.Generator(dev).manual_seed(0)
        q = torch.randn((b, HKV, GROUP, DH), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, s, HKV, DH), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, s, HKV, DH), generator=g, device=dev).to(torch.bfloat16)
        want = fd.flash_decode_plain(q, k, v, length, scale)
        tol = 2e-5 * float(v[:, :length].float().abs().max())
        for waves in args.waves:
            fd.WAVES = waves
            got = fd.flash_decode(q, k, v, length, scale)
            err = float((got - want).abs().max())
            same = torch.equal(got, fd.flash_decode(q, k, v, length, scale))
            ms = cold_ms(lambda: fd.flash_decode(q, k, v, length, scale),
                         lambda: l2_dst.copy_(l2_src))
            # The same work with each KV head's rows contiguous.
            qh = q.reshape(b * HKV, 1, GROUP, DH)
            kh, vh = (t.transpose(1, 2).reshape(b * HKV, s, 1, DH).contiguous() for t in (k, v))
            head_major_ms = cold_ms(lambda: fd.flash_decode(qh, kh, vh, length, scale),
                                    lambda: l2_dst.copy_(l2_src))
            qs = q.reshape(b, HKV * GROUP, 1, DH)
            ks, vs = (t[:, :length].transpose(1, 2).contiguous() for t in (k, v))
            sdpa_ms = cold_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, scale=scale, enable_gqa=True), lambda: l2_dst.copy_(l2_src))
            print(dict(b=b, length=length, waves=waves, err=err, tol=tol, ok=err <= tol,
                       deterministic=same, ms=ms, head_major_ms=head_major_ms, sdpa_ms=sdpa_ms,
                       splits=fd.num_splits(b * HKV, length, sms),
                       bound_ms=2 * b * length * HKV * DH * 2 / PEAK_BYTES_PER_S * 1e3),
                  flush=True)
            del kh, vh, ks, vs
        del q, k, v


if __name__ == "__main__":
    main()
