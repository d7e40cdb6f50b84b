#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
FD-SVRG main path (full-width news20, q = 8; a step's and the snapshot's
margins, one launch for all 8 blocks, bit for bit against 8 one-block
launches plus ``tree_order_sum`` at u = 1, 8 and 64 and R = N; the
snapshot scatter, one launch for all 8 blocks, bit for bit against the
CPU's ``index_add_`` in every block; the step's exact-lazy catch-up, one
launch for all 8 blocks, bit for bit against the CPU's plain version at
u = 1, 8 and 64, and timed at m = N = 19,954 beside its chain bound; a
step's loss coefficients at u = 1, 8 and 64 and the snapshot's, one
launch each, bit for bit against the PyTorch chain they replace; the
epoch-end flush, one launch over all 1,355,191 features, bit for bit
against 8 one-block launches and the CPU; the
touched-pass kernels bit for bit against their plain
versions on the CPU at u = 1, 8 and 64, the lazy ones also on a block
of kdd2010's width), drives that main
path through ``run_fdsvrg(use_kernels=True)`` with exact meter and
launch-count checks (one margins and one coefficient launch a step and a
snapshot, one catch-up launch a step, one flush an epoch; no torch gather
of the sampled rows, their labels or their snapshot margins), holds two
short kernel-path runs bitwise equal and
one against the plain path, runs the serial path, and scores the trained
``w`` through the margin kernel.
Then the lazy paths: ``run_fdsvrg(lazy_updates="exact")`` and
``"proba"`` and ``run_serial_svrg(lazy_updates="exact")`` with exact
meter and launch counts, the exact-lazy run held bitwise against the
dense main path, one exact-lazy epoch held bitwise against the dense
epoch on the kernel path, and a profile of the lazy epoch.
Then the other solvers at full-width news20: the paper's baselines
(``baseline_paths``: DSVRG at M = N/q = 2,494, SynSVRG at M = 500 with
u = q, AsySVRG and PS-Lite at M = 2,000, on the q = 1 layout) and the
rest of the update-rule family (``rule_paths``: FD-SAGA at M = 2,000,
FD-BCD at M = 2q block steps, multi-output SVRG with k = 4 on the plain
path at M = 500), 2 outers each, every line with its cut: exact meters
(the §4.5 closed forms) and launch counts, two kernel-path runs bitwise
equal with no ``index_add_`` (counted by a TorchFunctionMode), the plain
twin within a stated tolerance (for multi-output, the k scalar
kernel-path runs), falling objectives (finite for PS-Lite), steps/s and
one profiled outer's idle share.
Then the dense-layout step: block 0 densified into a [169,399 x 19,954]
matrix, the composed step of ``tests/test_kernels.py:159`` (margins
through ``margins_dense``, ``loss_and_grad``, ``svrg_dense_update``) run
K steps beside its BlockCSR twin (``sparse_margins``, ``loss_and_grad``,
``fused_block_update``) with exact launch counts (each step's column read
in place, then once more with a contiguous copy for the comparison), and
the four dense-step kernels held against their plain versions at full
width and at one step's shapes.
Then LM serving (qwen3-14b at full width, 14.8e9 parameters in bfloat16,
random weights from seed 0): the ``flash_decode`` kernel held against
its plain version and timed beside one SDPA call, at qwen3-14b's decode
shapes (up to 524,288 positions) and the reference test's; then
``repro_torch.launch.serve`` at batch 4 over a 512-token prompt
(``lm_serve``) and at batch 1 over a 32,768-token prompt
(``lm_decode_long``), 16 greedy tokens each, with exact launch counts
(one ``flash_decode`` per layer and step), a plain twin of the decode
(``use_kernels=False``, fed the kernel run's tokens) within a stated
tolerance, and a profile of one long decode step; then the batch-4 run
again in float32 at 4 layers (``lm_serve_f32``), whose twin separates the
kernel's error from bfloat16's.
Each phase prints one JSON line; the last line is the result object
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without printing it, as does a machine without a CUDA device or a
directory without the rest of the repository.  It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores.  bound_ms is computed against them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# Cycles of one dependent float32 add: the snapshot scatter's chain bound.
FADD_CYCLES = 4
# Dependent float operations of one replayed step (g = 0) before the prox:
# v = w - eta * ((0 + z) + lam * w) is fmul, fadd, fmul, fsub, each
# FADD_CYCLES; the catch-up's chain bound counts these only (a prox adds more).
REPLAY_CHAIN_OPS = 4

# Main-path run: the fdsvrg-news20 preset at full width, depth cut to a
# few steps (the paper's M is N = 19,954 inner steps per outer).
Q = 8
OUTERS = 2
INNER_STEPS = 2000
PLAIN_CHECK_STEPS = 500
PROFILE_STEPS = 500
LAZY_CHECK_STEPS = 500  # the lazy kernels are checked at the state these leave
LAUNCH_COUNT_STEPS = 200  # steps of one epoch profiled for its launches per step
LAZY_VS_DENSE_STEPS = 1000
DENSE_STEPS = 200  # K inner steps of the dense-layout step and its BlockCSR twin
KDD2010_N, KDD2010_D = 19_264_097, 29_890_095  # TABLE1_FULL["kdd2010"]: N and d
PROBA_ETA = 0.05  # the reference's news20 proba run (tests/test_lazy_updates.py)
SEED = 0

# Stated tolerances.
MARGIN_RTOL = 1e-6  # |kernel - plain| <= 1e-6 * sum_k |w[idx] * val| per row
# Kernel path vs plain path on the card: the margin kernel sums in another
# order than the plain gather-sum, and the plain path's index_add_ adds
# repeated ids with atomics in an order that changes from run to run, so
# the two trajectories drift apart by rounding; w is held relative to its
# scale.  Two kernel-path runs, and the exact-lazy run against the dense
# one, are held bitwise: every kernel on that path sums in a fixed order.
RUN_RTOL, RUN_W_RTOL = 1e-5, 1e-3
# Lazy kernels vs plain: catch-up and flush replay k steps per feature,
# |kernel - plain| <= 1e-6 * (k + 1) * (|w| + |plain| + eta * |z|); touch
# and proba, |d| <= 1e-6 * (|w| + |plain| + eta * (|g| + c * (|z| +
# lam * |w|) + c * lam1)) + 1e-7 at a touched feature (c = 1 for touch);
# the plain versions add duplicate ids with index_add_'s atomics.  The
# counters `last` must match exactly.  prox_update vs plain is held to the
# touched pass's bound too, with c = 1 (|g| the sum of the feature's
# |contributions|): its plain version adds repeated ids, up to 640 copies
# of one id at u = 8, with index_add_'s atomics in an order that changes
# from run to run, and the kernel adds them in flat order.
LAZY_RTOL, LAZY_ATOL = 1e-6, 1e-7
# The dense-layout kernels vs plain.  fd_matvec: |d| <= 1e-5 * sum_k |w_k *
# D_kn| per column (slices vs cuBLAS's order).  logistic_grad: within 4 ulp
# of max(|plain|, 1) (expf / logf vs PyTorch's exp / log; log(1 + tiny)
# makes one ulp of the sum absolute).  svrg_update: bitwise.  fused_update:
# bitwise against the prox_update kernel at lam1 = lam2 = 0, and against
# its plain version within the touched pass's bound, LAZY_ATOL + LAZY_RTOL
# * (|w| + |plain| + eta * (|g| + |z| + lam * |w|)) with |g| the sum of the
# feature's |contributions| (index_add_ adds the rows' repeated ids, up to
# 640 copies of one id at u = 8, with atomics in another order).
MATVEC_RTOL = 1e-5
LOSS_ULPS = 4
# dense_step: the dense and sparse snapshot margins, |d| <= 1e-5 *
# sum_k |w[idx] * val| per row (a column of D sums a row's repeated ids
# before the product); loss_and_grad vs the port's logaddexp / sigmoid
# loss, rtol = atol = 1e-5 (the reference's own test); after K steps the
# two layouts' w within 1e-4 * max|w| (each step rounds the update's terms
# in another order).
DENSE_MARGIN_RTOL = 1e-5
LOSS_RTOL = 1e-5
DENSE_STEP_W_RTOL = 1e-4
# flash_decode vs plain: |d| <= 2e-5 * max|v[:length]| (the output is a
# convex combination of v's rows; the Dh products of a score and the up
# to 524,288 weighted rows are summed in other orders, expf against
# PyTorch's exp).  The serving paths' plain twin (use_kernels=False, the
# same weights and cache, fed the kernel run's tokens): each step's logits
# within 0.05 * max|logits| (bfloat16 activations: a one-ulp difference in
# the attention output's bfloat16 rounding travels through 40 layers).
FLASH_RTOL = 2e-5
LM_LOGIT_RTOL = 0.05
# Float operations per replayed or touched feature, for bound_ms: the
# dense step 5 (+4 with a prox, +1 with elastic net); the proba step 6
# (+6 with a prox, +4 with elastic net).


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def host_ms(torch, fn, iters: int) -> float:
    """Mean time per call when called back to back, from CUDA events: what
    a Python loop of such calls pays, launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, prof) -> tuple[dict[str, float], dict[str, int]]:
    """Device time (us) and launches of each kernel name in a profile,
    memory copies left out (the L2 flush is a device-to-device copy)."""
    from torch.autograd import DeviceType

    us: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy"):
            us[e.name] = us.get(e.name, 0.0) + e.device_time_total
            calls[e.name] = calls.get(e.name, 0) + 1
    return us, calls


# The port's kernels in an FD-SVRG profile, by the name the trace gives
# them (first match wins), and the launch counter of each.
PORT_KERNELS = (("block_scatter_kernel", "block_scatter"), ("margins_kernel", "sparse_margin"),
                ("coef_kernel", "logistic_grad"), ("range_kernel", "prox_update"),
                ("entries_kernel<(anonymous namespace)::ProbaUpdate", "lazy_proba_update"),
                ("entries_kernel", "lazy_touch_update"), ("lazy_catchup_kernel", "lazy_catchup"),
                ("lazy_flush_kernel", "lazy_flush"))


def lost_records(us: dict[str, float], calls: dict[str, int],
                 launches: dict[str, int]) -> tuple[float, dict[str, list[int]]]:
    """Each launched port counter's records in a trace beside its launches,
    and an estimate of the device time (us) of the launches the trace lost:
    each counter's mean per record, over the names it launches, times the
    launches it lacks.  The estimate is reported apart and never added to
    the trace's device time; a counter with launches and no record gets
    none, and its phase traces again, then fails."""
    per_counter: dict[str, list[float]] = {}
    for name in us:
        counter = next((c for key, c in PORT_KERNELS if key in name), None)
        if counter is not None:
            acc = per_counter.setdefault(counter, [0.0, 0])
            acc[0] += us[name]
            acc[1] += calls[name]
    records = {c: [int(per_counter.get(c, [0.0, 0])[1]), launches[c]]
               for c in dict.fromkeys(c for _, c in PORT_KERNELS) if launches.get(c, 0) > 0}
    missing_us = sum(max(launches[c] - n, 0) * t / n for c, (t, n) in per_counter.items()
                     if c in records)
    return missing_us, records


def traced_outer(torch, run, ops, tries: int = 3):
    """``run()`` (one outer) under the profiler, from launch counts of 0:
    its wall seconds, device us and records by kernel name, the estimate of
    the lost records' us and each launched counter's records beside its
    launches.  Traces again, up to ``tries`` times, while a launched
    counter has no record; fails after that."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        us, calls = device_kernels(torch, prof)
        lost_us, records = lost_records(us, calls, ops.launch_counts())
        if all(kept > 0 for kept, _ in records.values()):
            break
    require(all(kept > 0 for kept, _ in records.values()),
            f"the trace kept no record of a launched kernel in {tries} tries: {records}")
    return wall_s, us, calls, lost_us, records


def device_ms(torch, fn, iters: int, before=None, kernels_seen=None) -> float:
    """Mean device time per call: the kernels ``fn`` launches, summed from
    a torch.profiler (CUPTI) trace after warm-up.  ``before`` runs before
    each call and is not counted (it may only copy memory): a copy that
    overwrites the 50 MB L2 makes the cache cold, as the snapshot finds
    it; a copy of saved state restores what an in-place kernel wrote.
    ``kernels_seen``, a list, gets the kernel records the trace holds per
    call: below the launches per call when records were lost."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # A trace can come back without a single kernel record (seen once in a
    # few hundred traces on an H100 80GB HBM3 at 700 W): trace again, up to
    # three times, before failing.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        us, calls = device_kernels(torch, prof)
        if sum(us.values()) > 0.0:
            break
    require(sum(us.values()) > 0.0, "the profiler recorded no device time")
    if kernels_seen is not None:
        kernels_seen.append(sum(calls.values()) / iters)
    # The trace can miss a few records (7 of 10 four-millisecond fd_matvec
    # launches were kept on an H100 80GB HBM3 at 700 W): each kernel name
    # counts its mean time per record, times its launches per call.
    return sum(us[k] / calls[k] * max(1, round(calls[k] / iters)) for k in us) / 1e3


def first_difference(torch, got, want, w, z) -> dict | None:
    """Where a kernel and its plain version first disagree, with inputs."""
    where = torch.nonzero(got != want).flatten()
    if where.numel() == 0:
        return None
    j = int(where[0])
    return {"index": j, "kernel": float(got[j]), "plain": float(want[j]),
            "w": float(w[j]), "z": float(z[j])}


def expected_launches(ops, **nonzero: int) -> dict[str, int]:
    """The launch counts a path must leave: 0 for every kernel the port
    counts, but for the path's nonzero closed forms."""
    want = dict.fromkeys(ops.launch_counts(), 0)
    require(set(nonzero) <= set(want), f"unknown kernels {set(nonzero) - set(want)}")
    want.update(nonzero)
    return want


def call_counter(torch):
    """A TorchFunctionMode that counts, while it is on, the torch gathers of
    sampled rows (a 2-D tensor indexed by a tensor), of the rows' labels and
    snapshot margins (a 1-D tensor indexed by a 1-D tensor), and the
    ``index_add_`` calls (on the card, the float atomics in an order that
    changes from run to run, which the port's kernels replace)."""
    from torch.overrides import TorchFunctionMode

    index_add = (torch.Tensor.index_add_, torch.Tensor.index_add, torch.index_add)

    class Counter(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.count = 0
            self.count_1d = 0
            self.index_adds = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__ and isinstance(args[1], torch.Tensor):
                if args[0].dim() == 2:
                    self.count += 1
                elif args[0].dim() == 1 and args[1].dim() == 1:
                    self.count_1d += 1
            elif func in index_add:
                self.index_adds += 1
            return func(*args, **(kwargs or {}))

    return Counter()


def ulp(torch, x):
    """The float32 spacing above ``|x|``."""
    a = torch.abs(x.float())
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def cpu_args(args: tuple) -> tuple:
    """The arguments with every tensor copied to the CPU (in-place plain
    versions write the copies)."""
    return tuple(a.cpu().clone() if hasattr(a, "cpu") else a for a in args)


def bitwise_vs_cpu(got, want_cpu) -> bool:
    """The kernel's output equals the CPU plain version's bit for bit: the
    CPU's index_add_ adds in flat order, as the kernel does, where the
    card's plain version adds repeated ids with atomics."""
    import torch

    return torch.equal(got.cpu().view(torch.int32), want_cpu.view(torch.int32))


def step_flops(lam1: float, lam2: float, proba: bool = False) -> float:
    if proba:
        return 6.0 + (6.0 if lam1 or lam2 else 0.0) + (4.0 if lam2 else 0.0)
    return 5.0 + (4.0 if lam1 or lam2 else 0.0) + (1.0 if lam2 else 0.0)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# The other solvers' paths, at full-width news20 and OUTERS outers each: the
# paper's baselines on the q = 1 layout of the data, and the rest of the
# update-rule family on the q = Q layout.  Depth is cut to these inner
# steps per outer (the paper's M in brackets); DSVRG runs the paper's M,
# N // Q (a machine's shard).
SYN_STEPS = 500  # SynSVRG, u = q (N / q)
ASYNC_STEPS = 2000  # AsySVRG and PS-Lite (N)
# The async pair's step size (the reference's baseline tests' 0.1): at the
# preset's 0.25, gradients up to q - 1 updates stale made AsySVRG's first
# outer rise (0.6931 -> 0.7817) and its kernel and plain twins drift
# 1.2e-3 apart on an H100 (PERF.md, Findings).
ASYNC_ETA = 0.1
SAGA_STEPS = 2000  # FD-SAGA (N / u)
BCD_STEPS = 2 * Q  # FD-BCD: two cycles over the q blocks (q)
MULTI_STEPS, MULTI_K = 500, 4  # multi-output SVRG, the plain path (N / u)


def solver_paths(torch, ops, data, bd8, loss, reg, eta: float, obj_init: float) -> dict:
    """Drive the baselines (``baseline_paths``) and FD-SAGA, FD-BCD and
    multi-output SVRG (``rule_paths``) through their entry points, each
    line with its cut, its exact meter and launch counts, two kernel-path
    runs bitwise equal (the second under ``call_counter``: no
    ``index_add_``), the plain twin within RUN_RTOL / RUN_W_RTOL, steps/s
    and one profiled outer's idle share.  Multi-output runs the plain path
    only (the reference's rule); its twin is the k scalar kernel-path runs,
    one a column.  Returns each path's launch counts."""
    import dataclasses

    import numpy as np

    from repro_torch.core import baselines
    from repro_torch.core.fdsvrg import SVRGConfig
    from repro_torch.dist import COSTS, SimBackend
    from repro_torch.optim import update_rules as rules

    n, d, nnz = data.num_instances, data.dim, data.nnz_max
    snaps = OUTERS + 1
    launches: dict[str, dict[str, int]] = {}

    def config(steps, outers, step_size=eta):
        return SVRGConfig(eta=step_size, inner_steps=steps, outer_iters=outers, seed=SEED)

    def timed(make_run, use_kernels, outers):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = make_run(use_kernels, outers)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, ops.launch_counts()

    def profiled(make_run, use_kernels, steps):
        window_s, by_kernel, calls, lost_us, records = traced_outer(
            torch, lambda: make_run(use_kernels, 1), ops)
        busy_s = sum(by_kernel.values()) / 1e6
        return {"profiled_outer_wall_s": window_s, "device_busy_s": busy_s,
                "device_idle_share": 1.0 - busy_s / window_s,
                "lost_records_ms": lost_us / 1e3,
                "device_kernels_per_step_incl_snapshots": sum(calls.values()) / steps,
                "top_kernels_us_calls": [[k[:90], v, calls.get(k, 0)] for k, v in
                                         sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]]}

    def check(phase, method, make_run, steps, want, per_outer, init, falls, cut, step_size=eta):
        res, wall, counts = timed(make_run, True, OUTERS)
        with call_counter(torch) as guard:
            again = make_run(True, OUTERS)
        with call_counter(torch) as plain_guard:
            plain = make_run(False, OUTERS)
        objs, po = res.objectives(), plain.objectives()
        bitwise = bool(torch.equal(res.w, again.w)) and objs.tolist() == again.objectives().tolist()
        obj_rel = float(np.max(np.abs(objs - po) / np.abs(po)))
        w_err = float(torch.max(torch.abs(res.w - plain.w)))
        w_scale = float(torch.max(torch.abs(plain.w)))
        want_counts = expected_launches(ops, **want)
        comm = [h.comm_scalars for h in res.history]
        want_comm = [init + per_outer * (t + 1) for t in range(OUTERS)]
        line = {"phase": phase, "method": method, "d": d, "N": n, "q": Q, "eta": step_size,
                "reg": reg.name, "lam": reg.lam, "outers": OUTERS, "inner_steps": steps,
                "cut": cut, "objective_init": obj_init, "objectives": objs.tolist(),
                "grad_norms": [h.grad_norm for h in res.history], "comm_scalars": comm,
                "expected_comm_scalars": want_comm, "launches": counts,
                "expected_launches": want_counts, "kernel_runs_bitwise": bitwise,
                "index_adds_kernel_path": guard.index_adds,
                "index_adds_plain_path": plain_guard.index_adds,
                "objective_plain": po.tolist(), "objective_rel_err": obj_rel,
                "w_max_abs_err": w_err, "w_max_abs": w_scale,
                "tolerance": f"two kernel runs bitwise; vs plain objective rtol {RUN_RTOL:g}, "
                             f"max|dw| <= {RUN_W_RTOL:g} * max|w|",
                "wall_s": wall, "inner_steps_per_s": OUTERS * steps / wall,
                **profiled(make_run, True, steps)}
        emit(line)
        require(all(math.isfinite(o) for o in objs), f"{method}: non-finite objective {objs}")
        require(not falls or (objs[0] < obj_init and objs[1] < objs[0]),
                f"{method}: objective does not fall: {obj_init} -> {objs.tolist()}")
        require(comm == want_comm and res.meter.total_scalars == want_comm[-1],
                f"{method}: meter {comm} != {want_comm}")
        require(counts == want_counts, f"{method}: launches {counts} != {want_counts}")
        require(bitwise, f"{method}: two kernel-path runs differ")
        require(guard.index_adds == 0, f"{method}: {guard.index_adds} index_add_ on the kernel path")
        require(obj_rel <= RUN_RTOL and w_err <= RUN_W_RTOL * w_scale,
                f"{method}: kernel path vs plain: objective rel {obj_rel}, w {w_err} of {w_scale}")
        launches[method] = counts

    # The baselines: q = 1 layout of the rows (455 wide), u = 1 unless said.
    base_steps = {"dsvrg": n // Q, "synsvrg": SYN_STEPS,
                  "asysvrg": ASYNC_STEPS, "pslite_sgd": ASYNC_STEPS}
    runners = {"dsvrg": baselines.run_dsvrg, "synsvrg": baselines.run_syn_svrg,
               "asysvrg": baselines.run_asy_svrg, "pslite_sgd": baselines.run_pslite_sgd}
    for method, steps in base_steps.items():
        step_size = eta if method in ("dsvrg", "synsvrg") else ASYNC_ETA

        def make_run(use_kernels, outers, method=method, steps=steps, step_size=step_size):
            return runners[method](data, Q, loss, reg, config(steps, outers, step_size),
                                   use_kernels=use_kernels)

        coef = 0 if method == "pslite_sgd" else OUTERS * steps
        per_outer = COSTS.outer_cost(method, n=n, d=d, nnz=nnz, q=Q, inner_steps=steps)[1]
        paper_m = {"dsvrg": f"N/q = {n // Q}", "synsvrg": f"N/q = {n // Q}"}.get(method,
                                                                                 f"N = {n}")
        check("baseline_paths", method, make_run, steps,
              dict(sparse_margin=snaps + OUTERS * steps, logistic_grad=snaps + coef,
                   block_scatter=snaps, prox_update=OUTERS * steps),
              per_outer, 0, method != "pslite_sgd",
              f"M = {steps} inner steps per outer (the paper's M = {paper_m}); "
              f"{OUTERS} outers; the wall includes building the q = 1 layout", step_size)

    # FD-SAGA and FD-BCD on the q = Q layout.
    for method, steps in (("fd_saga", SAGA_STEPS), ("fd_bcd", BCD_STEPS)):
        def make_run(use_kernels, outers, method=method, steps=steps):
            ctx = rules.make_context(bd8, loss, reg, config(steps, outers),
                                     backend=SimBackend(Q))
            return rules.run_with_rule(rules.RULES[method](use_kernels=use_kernels), ctx)

        per_outer = COSTS.outer_cost(method, n=n, d=d, nnz=nnz, q=Q, inner_steps=steps)[1]
        init = COSTS.init_cost(method, n=n, nnz=nnz, q=Q)[1]
        if method == "fd_saga":
            want = dict(sparse_margin=snaps + OUTERS * steps, logistic_grad=snaps,
                        block_scatter=snaps, prox_update=Q * OUTERS * steps,
                        fused_update=Q * OUTERS * steps)
            cut = f"M = {steps} inner steps per outer (the paper's M = N = {n}); {OUTERS} outers"
        else:
            want = dict(sparse_margin=snaps + OUTERS * steps,
                        logistic_grad=snaps + OUTERS * steps,
                        block_scatter=snaps + OUTERS * steps)
            cut = f"M = {steps} block steps per outer (2 cycles; the paper's M = q); {OUTERS} outers"
        check("rule_paths", method, make_run, steps, want, per_outer, init, True, cut)

    # Multi-output SVRG, k = MULTI_K: column 0 the real labels, the others
    # +-1 from a seed; its twin is the k scalar kernel-path runs.
    y = np.random.default_rng(SEED + 11).choice([-1.0, 1.0], size=(n, MULTI_K))
    y[:, 0] = bd8.labels.cpu().numpy()
    y = torch.from_numpy(y.astype(np.float32)).to(bd8.device)
    wide = dataclasses.replace(bd8, labels=y)

    def multi_run(use_kernels, outers):
        return rules.run_with_rule(rules.SVRGRule(use_kernels=False), rules.make_context(
            wide, loss, reg, config(MULTI_STEPS, outers), backend=SimBackend(Q)))

    res, wall, counts = timed(multi_run, False, OUTERS)
    cols = [rules.run_with_rule(rules.SVRGRule(), rules.make_context(
        dataclasses.replace(bd8, labels=y[:, j].contiguous()), loss, reg,
        config(MULTI_STEPS, OUTERS), backend=SimBackend(Q))) for j in range(MULTI_K)]
    objs = res.objectives()
    col_mean = np.mean([c.objectives() for c in cols], axis=0)
    obj_rel = float(np.max(np.abs(objs - col_mean) / np.abs(col_mean)))
    w_err = max(float(torch.max(torch.abs(res.w[:, j] - c.w))) for j, c in enumerate(cols))
    w_scale = max(float(torch.max(torch.abs(c.w))) for c in cols)
    per_outer = (COSTS.fd_fullgrad(n=n, nnz=nnz, q=Q, k=MULTI_K).scalars
                 + MULTI_STEPS * COSTS.fd_inner_step(nnz=nnz, q=Q, u=1, k=MULTI_K).scalars)
    comm = [h.comm_scalars for h in res.history]
    want_comm = [per_outer * (t + 1) for t in range(OUTERS)]
    want_counts = expected_launches(ops)
    emit({"phase": "rule_paths", "method": "svrg_multi_output", "k": MULTI_K, "d": d, "N": n,
          "q": Q, "eta": eta, "reg": reg.name, "lam": reg.lam, "outers": OUTERS,
          "inner_steps": MULTI_STEPS,
          "cut": f"M = {MULTI_STEPS} inner steps per outer (the paper's M = N = {n}); "
                 f"{OUTERS} outers; k = {MULTI_K} outputs",
          "objective_init": obj_init, "objectives": objs.tolist(),
          "objective_mean_of_scalar_runs": col_mean.tolist(), "objective_rel_err": obj_rel,
          "w_max_abs_err": w_err, "w_max_abs": w_scale,
          "tolerance": f"the plain path (index_add_ on the card) vs k scalar kernel-path "
                       f"runs: objective rtol {RUN_RTOL:g}, max|dw| <= {RUN_W_RTOL:g} * max|w|",
          "comm_scalars": comm, "expected_comm_scalars": want_comm, "launches": counts,
          "expected_launches": want_counts, "wall_s": wall,
          "inner_steps_per_s": OUTERS * MULTI_STEPS / wall,
          **profiled(multi_run, False, MULTI_STEPS)})
    require(all(math.isfinite(o) for o in objs) and objs[0] < obj_init and objs[1] < objs[0],
            f"multi-output: objective does not fall: {obj_init} -> {objs.tolist()}")
    require(comm == want_comm and res.meter.total_scalars == want_comm[-1],
            f"multi-output: meter {comm} != {want_comm}")
    require(counts == want_counts, f"multi-output: launches {counts} (the plain path)")
    require(obj_rel <= RUN_RTOL and w_err <= RUN_W_RTOL * w_scale,
            f"multi-output vs scalar runs: objective rel {obj_rel}, w {w_err} of {w_scale}")
    return launches


def run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: torch.cuda.is_available() is false")
    src = os.path.join(ROOT, "src")
    require(
        os.path.isdir(os.path.join(src, "repro_torch")),
        f"{src}/repro_torch not found: run chip_smoke.py from a checkout",
    )
    sys.path.insert(0, src)
    import numpy as np

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.configs.fdsvrg_linear import CONFIGS
    from repro_torch.core import losses
    from repro_torch.core.driver import objective_from_margins
    from repro_torch.core.driver import draw_samples
    from repro_torch.core.fdsvrg import (
        SVRGConfig,
        _full_grad_blocks,
        _inner_epoch,
        _lazy_inner_epoch,
        run_fdsvrg,
        run_serial_svrg,
    )
    from repro_torch.core.partition import balanced
    from repro_torch.data import datasets
    from repro_torch.data.block_csr import BlockCSR, local_scatter
    from repro_torch.dist.tree import tree_order_sum
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import block_scatter as scatter_mod
    from repro_torch.kernels import fd_matvec as matvec_mod
    from repro_torch.kernels import flash_decode as decode_mod
    from repro_torch.kernels import fused_update as fused_mod
    from repro_torch.kernels import lazy_update as lazy_mod
    from repro_torch.kernels import logistic_grad as logistic_mod
    from repro_torch.kernels import prox_update as prox_mod
    from repro_torch.kernels import sparse_margin as margin_mod
    from repro_torch.kernels import svrg_update as svrg_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.sharding.specs import unsharded_ctx
    from repro_torch.train.serve import make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    card = card_line()
    print(card, flush=True)
    name, power_limit = (s.strip() for s in card.split(",", 1))
    emit({"phase": "card", "name": name, "power_limit": power_limit,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. The build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, ROOT),
          "sources": [os.path.relpath(s, ROOT) for s in _build.sources()]})

    # Data: full-width news20 from the port's generator, q = 8 and q = 1.
    cfg_preset = CONFIGS["fdsvrg-news20"]
    spec = datasets.spec(cfg_preset.dataset, scaled=False)
    t0 = time.perf_counter()
    data = datasets.load(cfg_preset.dataset, scaled=False, seed=SEED)
    part8 = balanced(data.dim, Q)
    bd8_cpu = BlockCSR.from_padded(data, part8)
    bd8 = bd8_cpu.to(dev)
    bd1 = BlockCSR.from_padded(data, balanced(data.dim, 1)).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "data", "dataset": spec.name, "d": data.dim,
          "N": data.num_instances, "nnz_per_row": data.nnz_max, "q": Q,
          "block_dims": list(bd8.block_dims), "nnz_budgets_q8": list(bd8.nnz_budgets),
          "nnz_budget_q1": bd1.nnz_budgets[0], "setup_s": time.perf_counter() - t0})
    n = data.num_instances
    rng = np.random.default_rng(SEED)
    l2_src = torch.zeros(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    l2_dst = torch.empty_like(l2_src)

    def flush():
        l2_dst.copy_(l2_src)

    # 3. Kernel vs plain on the card, at main-path shapes.
    idx0, val0 = bd8.indices[0], bd8.values[0]
    d0 = bd8.block_dims[0]
    w0 = torch.from_numpy(rng.normal(0.0, 0.1, size=d0).astype(np.float32)).to(dev)
    sampled = torch.from_numpy(rng.integers(0, n, size=8).astype(np.int64)).to(dev)
    margin_rows = {}
    for label, (idx, val) in {
        "snapshot R=N": (idx0, val0),
        "inner step R=u=1": (idx0[sampled[:1]], val0[sampled[:1]]),
    }.items():
        got = margin_mod.sparse_margin(idx, val, w0)
        want = margin_mod.sparse_margin_plain(idx, val, w0)
        scale = torch.sum(torch.abs(w0[idx] * val), dim=-1)
        err = torch.abs(got - want)
        torch.cuda.synchronize()
        ratio = float(torch.max(err / torch.clamp_min(scale, 1e-30)))
        require(bool(torch.all(err <= MARGIN_RTOL * scale)),
                f"sparse_margin {label}: kernel vs plain error ratio {ratio}")
        rows, width = idx.shape
        csr = torch.sparse_csr_tensor(
            torch.arange(0, rows * width + 1, width, dtype=torch.int64, device=dev),
            idx.reshape(-1).to(torch.int64), val.reshape(-1), size=(rows, d0),
        )
        lib_out = torch.mv(csr, w0)
        require(bool(torch.all(torch.abs(lib_out - want) <= 1e-5 * scale + 1e-6)),
                f"sparse_margin {label}: library yardstick disagrees")
        cold = flush if rows > 1 else None
        iters = 50 if rows > 1 else 200
        distinct = int(torch.unique(idx).numel())
        b_ms, b_by = bound_ms(rows * width * 8 + distinct * 4 + rows * 4, 2.0 * rows * width)
        row = {
            "phase": "kernel_check", "kernel": "sparse_margin", "shape": label,
            "rows": rows, "nnz_l": width, "d_block": d0,
            "max_abs_err": float(torch.max(err)), "max_err_over_sum_abs": ratio,
            "tolerance": f"|d| <= {MARGIN_RTOL:g} * sum|w[idx]*val| per row",
            "bitwise": bool(torch.equal(got, want)),
            "l2": "cold" if cold else "warm",
            "kernel_ms": device_ms(torch, lambda: margin_mod.sparse_margin(idx, val, w0), iters, cold),
            "plain_ms": device_ms(torch, lambda: margin_mod.sparse_margin_plain(idx, val, w0), iters, cold),
            "library_ms": device_ms(torch, lambda: torch.mv(csr, w0), iters, cold),
            "host_ms": host_ms(torch, lambda: margin_mod.sparse_margin(idx, val, w0), iters),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        margin_rows[label] = row

    # The margins over all 8 blocks in one launch, at a step's u sampled rows
    # (ops.step_margins: u = 1, 8, 64) and at the snapshot's N rows
    # (ops.snapshot_margins): s and the partials bitwise 8 one-block launches
    # plus tree_order_sum, the step's gathered rows equal to the torch
    # gathers, s within MARGIN_RTOL of the plain version.  Timed beside the
    # path before (the 8 one-block launches with their 16 gathers and 7
    # adds), the plain version, one CSR torch.mv over the rows' global ids
    # (built outside the timed call) and the launch's floor, one launch over
    # one row of one entry: two dependent global rounds and the fixed cost.
    bounds8 = [0]
    for d_l in bd8.block_dims:
        bounds8.append(bounds8[-1] + d_l)
    rng_m = np.random.default_rng(SEED + 6)
    w_all = torch.from_numpy(rng_m.normal(0.0, 0.1, size=data.dim).astype(np.float32)).to(dev)
    w_parts = [w_all[a:b] for a, b in zip(bounds8[:-1], bounds8[1:])]
    ids64_m = torch.from_numpy(rng_m.integers(0, n, size=64).astype(np.int64)).to(dev)
    one_idx, one_val = idx0[:1, :1].contiguous(), val0[:1, :1].contiguous()
    margin_floor_ms = device_ms(torch, lambda: margin_mod.sparse_margin(one_idx, one_val, w0), 200)
    multi_margin_rows = {}
    for label, ids in (("step u=1", sampled[:1]), ("step u=8", sampled[:8]),
                       ("step u=64", ids64_m), ("snapshot R=N", None)):
        n_rows = n if ids is None else ids.numel()
        rows_l = [(bd8.indices[l], bd8.values[l]) if ids is None else
                  (bd8.indices[l][ids], bd8.values[l][ids]) for l in range(Q)]
        singles = [margin_mod.sparse_margin(i, v, w_l) for (i, v), w_l in zip(rows_l, w_parts)]
        want_s = tree_order_sum(singles)
        buf = None if ids is None else ops.step_rows(bd8, n_rows)
        if ids is None:
            def fn():
                return ops.snapshot_margins(bd8, w_all)
        else:
            def fn(ids=ids, buf=buf):
                return ops.step_margins(bd8, ids, w_all, out=buf).s
        ops.reset_launch_counts()
        if ids is None:
            got_s, got_rows, got_parts = ops.snapshot_margins(bd8, w_all), None, None
        else:
            got_s, got_rows, got_parts = ops.step_margins(bd8, ids, w_all, partials=True)
        one_launch = ops.launch_counts()["sparse_margin"] == 1
        again = fn()
        bit_s = bool(torch.equal(got_s, want_s)) and bool(torch.equal(again, got_s))
        bit_parts = got_parts is None or bool(torch.equal(got_parts, torch.stack(singles)))
        rows_equal = got_rows is None or all(
            bool(torch.equal(a, c)) and bool(torch.equal(b, e))
            for (a, b), (c, e) in zip(got_rows, rows_l))
        plain_s = margin_mod.margins_plain(bd8.indices, bd8.values, w_parts, ids)[0]
        scale = sum(torch.sum(torch.abs(w_l[i] * v), -1) for (i, v), w_l in zip(rows_l, w_parts))
        err = torch.abs(got_s - plain_s)
        ratio = float(torch.max(err / torch.clamp_min(MARGIN_RTOL * scale, 1e-30)))
        gidx = torch.cat([i.long() + b for (i, _), b in zip(rows_l, bounds8)], 1)
        gval = torch.cat([v for _, v in rows_l], 1)
        width = gidx.shape[1]
        csr = torch.sparse_csr_tensor(
            torch.arange(0, n_rows * width + 1, width, dtype=torch.int64, device=dev),
            gidx.reshape(-1), gval.reshape(-1), size=(n_rows, data.dim))
        require(bool(torch.all(torch.abs(torch.mv(csr, w_all) - plain_s) <= 1e-5 * scale + 1e-6)),
                f"margins {label}: library yardstick disagrees")

        def per_block(ids=ids):
            if ids is None:
                parts = [margin_mod.sparse_margin(i, v, w_l)
                         for i, v, w_l in zip(bd8.indices, bd8.values, w_parts)]
            else:
                parts = [margin_mod.sparse_margin(bd8.indices[l][ids], bd8.values[l][ids],
                                                  w_parts[l]) for l in range(Q)]
            return tree_order_sum(parts)

        entries = n_rows * width
        distinct = int(torch.unique(gidx).numel())
        # The rows' entries (id and value) read once, w at each distinct id,
        # s written; a step also reads its ids and writes its gathered rows.
        nbytes = entries * 8 + distinct * 4 + n_rows * 4 + (0 if ids is None else
                                                           n_rows * 8 + entries * 8)
        b_ms, b_by = bound_ms(nbytes, 2.0 * entries)
        cold = flush if ids is None else None
        iters = 50 if ids is None else 200
        row = {"phase": "kernel_check", "kernel": "sparse_margin",
               "entry": "ops.snapshot_margins" if ids is None else "ops.step_margins",
               "shape": f"{label}, 8 blocks", "rows": n_rows, "blocks": Q,
               "entries": entries, "launches_per_call": 1 if one_launch else None,
               "bitwise_s_vs_8_launches_and_tree_sum": bit_s,
               "bitwise_partials": bit_parts, "rows_equal_torch_gathers": rows_equal,
               "max_abs_err": float(torch.max(err)), "max_err_over_tol": ratio,
               "tolerance": f"s bitwise 8 one-block launches + tree_order_sum; vs plain "
                            f"|d| <= {MARGIN_RTOL:g} * sum_l sum_k |w[idx]*val| per row",
               "l2": "cold" if cold else "warm",
               "kernel_ms": device_ms(torch, fn, iters, cold),
               "per_block_ms": device_ms(torch, per_block, iters, cold),
               "plain_ms": device_ms(torch, lambda ids=ids: margin_mod.margins_plain(
                   bd8.indices, bd8.values, w_parts, ids)[0], iters, cold),
               "library_ms": device_ms(torch, lambda csr=csr: torch.mv(csr, w_all), iters, cold),
               "host_ms": host_ms(torch, fn, iters),
               "per_block_host_ms": host_ms(torch, per_block, iters),
               "one_block_host_ms": margin_rows["inner step R=u=1"]["host_ms"],
               "bound_ms": b_ms, "bound_by": b_by, "floor_ms": margin_floor_ms,
               "floor": "one launch over one row of one entry"}
        emit(row)
        require(one_launch and bit_s and bit_parts and rows_equal and ratio <= 1.0,
                f"margins {label}: {row}")
        multi_margin_rows[label] = row
        del csr, gidx, gval, buf

    # A step's loss coefficients (ops.step_coef at u = 1, 8, 64) and the
    # snapshot's (ops.snapshot_coef, R = N), from the margins at w_all: one
    # launch each, bit for bit against the chain of PyTorch ops the path ran
    # before (two gathers, the two derivatives, a subtraction, a true
    # division), which is the plain version; timed beside it (device and
    # host), with the one-launch floor above; finite at margins of +-100.
    loss = losses.LOSSES[cfg_preset.loss]
    s0_coef = ops.snapshot_margins(bd8, w_all)
    coef_rows = {}
    for label, ids in (("step u=1", sampled[:1]), ("step u=8", sampled[:8]),
                       ("step u=64", ids64_m), ("snapshot R=N", None)):
        if ids is None:
            u_t = None

            def fn():
                return ops.snapshot_coef(bd8, s0_coef, loss)

            def plain():
                return logistic_mod.snapshot_coef_plain(s0_coef, bd8.labels, n, loss.dvalue)
        else:
            s_step = ops.step_margins(bd8, ids, w_all).s
            u_t = torch.full((), float(ids.numel()), device=dev)

            def fn(ids=ids, s_step=s_step, u_t=u_t):
                return ops.step_coef(bd8, ids, s_step, s0_coef, u_t, loss)

            def plain(ids=ids, s_step=s_step, u_t=u_t):
                return logistic_mod.step_coef_plain(s_step, ids, bd8.labels, s0_coef, u_t,
                                                    loss.dvalue)
        ops.reset_launch_counts()
        got = fn()
        one_launch = ops.launch_counts()["logistic_grad"] == 1
        want = plain()
        bits = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        rows_c = n if ids is None else ids.numel()
        # The step reads its ids, margins, the rows' labels and s0 and
        # writes coef; the snapshot reads s0 and the labels and writes the
        # coefficients.  Two derivatives of 5 operations, a subtraction and
        # a division a step's row (one derivative and a division a
        # snapshot's), expf counted as one.
        nbytes = rows_c * 12 if ids is None else rows_c * 24 + 4  # + the 0-dim u
        b_ms, b_by = bound_ms(nbytes, rows_c * (6.0 if ids is None else 12.0))
        row = {"phase": "kernel_check", "kernel": "logistic_grad",
               "entry": "ops.snapshot_coef" if ids is None else "ops.step_coef",
               "shape": f"{label} coefficients", "rows": rows_c,
               "launches_per_call": 1 if one_launch else None, "bitwise_vs_chain": bits,
               "n_differ": int(torch.count_nonzero(got != want)),
               "max_abs_err": float(torch.max(torch.abs(got - want))),
               "tolerance": "bitwise the PyTorch chain (the plain version) on the card",
               "l2": "warm",
               "kernel_ms": device_ms(torch, fn, 200),
               "plain_ms": device_ms(torch, plain, 200),
               "host_ms": host_ms(torch, fn, 200), "plain_host_ms": host_ms(torch, plain, 200),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "floor_ms": margin_floor_ms, "floor": "one launch over one row of one entry"}
        emit(row)
        require(one_launch and bits, f"coefficients {label}: {row}")
        coef_rows[label] = row
    # Extreme margins: the coefficients stay finite and equal the chain.
    s_ext = torch.tensor([100.0, -100.0, 1e4, -1e4] * 16, device=dev)
    ids_ext = ids64_m
    ext = ops.step_coef(bd8, ids_ext, s_ext, torch.full((n,), -100.0, device=dev),
                        torch.full((), 64.0, device=dev), loss)
    ext_want = logistic_mod.step_coef_plain(s_ext, ids_ext, bd8.labels,
                                            torch.full((n,), -100.0, device=dev),
                                            torch.full((), 64.0, device=dev), loss.dvalue)
    require(bool(torch.all(torch.isfinite(ext))) and torch.equal(ext, ext_want),
            f"coefficients at margins of +-100, +-1e4: {ext.tolist()} vs {ext_want.tolist()}")
    emit({"phase": "coef_extremes", "margins": [100.0, -100.0, 1e4, -1e4], "finite": True,
          "bitwise_vs_chain": True})

    # The snapshot scatter at the main path's first snapshot (w = 0): one
    # launch for all 8 blocks, whose z, block by block, equals the CPU's
    # flat-order index_add_ (local_scatter) of the same rows and
    # coefficients bit for bit; then each block alone (the q = 1 case of
    # the same kernel), bitwise again.
    ops.reset_launch_counts()
    z_first, s_first = _full_grad_blocks(bd8, torch.zeros(data.dim, device=dev), loss, True)
    require(ops.launch_counts()["block_scatter"] == 1,
            f"the snapshot launched block_scatter {ops.launch_counts()['block_scatter']} times")
    coeffs_first = ops.snapshot_coef(bd8, s_first, loss)
    coeffs_cpu = coeffs_first.cpu()
    sm_clock_hz = float(card_line("clocks.max.sm").split()[0]) * 1e6
    snap_index = bd8.snapshot_index()

    def chain_ms(values, index, times=3):
        """The longest heavy fold's own time inside a launch (%globaltimer
        at its start and end), the mean of ``times`` cold launches."""
        timing = torch.zeros(2 * index.heavy.numel(), dtype=torch.int64, device=dev)
        spans = []
        for _ in range(times):
            flush()
            scatter_mod.block_scatter(values, coeffs_first, index, timing)
            torch.cuda.synchronize()
            spans.append(float(timing[1] - timing[0]) / 1e6)
        return sum(spans) / len(spans)

    scatter_rows = []
    lo = 0
    for l in range(Q):
        d_l = bd8.block_dims[l]
        idx_l, val_l = bd8.block(l)
        index = scatter_mod.scatter_index(idx_l, val_l, d_l)
        want = local_scatter(bd8_cpu.indices[l], bd8_cpu.values[l], coeffs_cpu, d_l)
        got = z_first[lo:lo + d_l].cpu()
        lo += d_l
        again = scatter_mod.block_scatter(val_l, coeffs_first, index)
        bitwise = bool(np.array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32)))
        repeat = bool(torch.equal(again, z_first[lo - d_l:lo]))
        terms = int(index.perm.numel())
        chain = int(torch.max(index.starts[1:] - index.starts[:-1]))
        flat_idx = idx_l.reshape(-1)
        flat_val = (val_l * coeffs_first[:, None]).reshape(-1)
        # perm and the values once a term, coeffs, starts (int64) and z.
        b_ms, b_by = bound_ms(8 * terms + 4 * n + 12 * d_l + 4 * int(index.heavy.numel()),
                              2.0 * terms)
        row = {"phase": "kernel_check", "kernel": "block_scatter", "block": l, "d_block": d_l,
               "nnz_l": int(idx_l.shape[1]), "terms": terms,
               "heavy_ids": int(index.heavy.numel()), "longest_chain": chain,
               "bitwise_vs_cpu_index_add": bitwise, "bitwise_repeat": repeat,
               "max_abs_err": float(torch.max(torch.abs(got - want))),
               "tolerance": "bitwise vs the CPU's flat-order index_add_", "l2": "cold",
               "kernel_ms": device_ms(torch, lambda: scatter_mod.block_scatter(
                   val_l, coeffs_first, index), 5, flush),
               "plain_ms": device_ms(torch, lambda: scatter_mod.block_scatter_plain(
                   idx_l, val_l, coeffs_first, d_l), 5, flush),
               "library_ms": device_ms(torch, lambda: torch.zeros(d_l, device=dev).index_add_(
                   0, flat_idx, flat_val), 5, flush),
               "host_ms": host_ms(torch, lambda: scatter_mod.block_scatter(
                   val_l, coeffs_first, index), 20),
               "bound_ms": b_ms, "bound_by": b_by,
               "chain_bound_ms": chain * FADD_CYCLES / sm_clock_hz * 1e3}
        if l == 0:
            row["chain_ms_alone"] = chain_ms(val_l, index)
        emit(row)
        require(bitwise and repeat, f"block_scatter block {l}: {row}")
        scatter_rows.append(row)
    # One snapshot: the single launch, timed itself, beside the 8 index_add_
    # calls it replaces (one call each, in turn) and the plain version.
    snap_again = scatter_mod.block_scatter(bd8.values, coeffs_first, snap_index)
    snap_repeat = bool(torch.equal(snap_again, z_first))
    flat_pairs = [(bd8.indices[l].reshape(-1), (bd8.values[l] * coeffs_first[:, None]).reshape(-1),
                   bd8.block_dims[l]) for l in range(Q)]

    def index_adds():
        for flat_i, flat_v, d_l in flat_pairs:
            torch.zeros(d_l, device=dev).index_add_(0, flat_i, flat_v)

    def plain_snapshot():
        return torch.cat([scatter_mod.block_scatter_plain(*bd8.block(l), coeffs_first,
                                                          bd8.block_dims[l]) for l in range(Q)])

    snap_terms = int(snap_index.perm.numel())
    b_ms, b_by = bound_ms(8 * snap_terms + 4 * n + 12 * data.dim + 4 * int(
        snap_index.heavy.numel()), 2.0 * snap_terms)
    snapshot = {
        "phase": "scatter_snapshot", "blocks": Q, "launches_per_snapshot": 1,
        "terms": snap_terms, "heavy_ids": int(snap_index.heavy.numel()),
        "bitwise_repeat": snap_repeat, "l2": "cold",
        "kernel_ms": device_ms(torch, lambda: scatter_mod.block_scatter(
            bd8.values, coeffs_first, snap_index), 5, flush),
        "index_add_ms": device_ms(torch, index_adds, 5, flush),
        "index_add_ms_sum_of_blocks": sum(r["library_ms"] for r in scatter_rows),
        "plain_ms": device_ms(torch, plain_snapshot, 5, flush),
        "host_ms": host_ms(torch, lambda: scatter_mod.block_scatter(
            bd8.values, coeffs_first, snap_index), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "chain_bound_ms": max(r["chain_bound_ms"] for r in scatter_rows),
        "chain_bound_ms_sum_of_blocks": sum(r["chain_bound_ms"] for r in scatter_rows),
        "block0_chain_ms_in_launch": chain_ms(bd8.values, snap_index),
        "block0_chain_ms_alone": scatter_rows[0]["chain_ms_alone"],
        "block0_launch_ms_alone": scatter_rows[0]["kernel_ms"],
        "heavy_min": snap_index.heavy_min,
        "sm_clock_max_mhz": sm_clock_hz / 1e6, "fadd_cycles": FADD_CYCLES,
        "note": "one snapshot = one launch over the 8 blocks; the chain bound is the longest "
                "id run of dependent adds over all blocks; a block's chain time is read from "
                "%globaltimer in its heavy fold"}
    emit(snapshot)
    require(snap_repeat, "block_scatter: a repeat of the snapshot launch differs")
    require(snapshot["kernel_ms"] < snapshot["index_add_ms"],
            f"one snapshot launch ({snapshot['kernel_ms']} ms) is not faster than the 8 "
            f"index_add_ calls ({snapshot['index_add_ms']} ms)")
    del z_first, s_first, snap_again, flat_pairs

    prox_rows = {}
    eta = float(np.float32(cfg_preset.eta))
    settings = {
        "l2": (1e-4, 0.0, 0.0),
        "l1": (0.0, 1e-5, 0.0),
        "elastic_net": (0.0, 1e-5, 1e-4),
        "none": (0.0, 0.0, 0.0),
    }
    z0 = torch.from_numpy(rng.normal(0.0, 1e-3, size=d0).astype(np.float32)).to(dev)
    # u = 64 (10,304 entries at block 0, past one staged window of the
    # touched pass) from a generator of its own, so the u = 1 and 8 draws
    # stay as they were.
    rng64 = np.random.default_rng(SEED + 4)
    sampled64 = torch.from_numpy(rng64.integers(0, n, size=64).astype(np.int64)).to(dev)
    coef64 = torch.from_numpy(rng64.normal(0.0, 0.5, size=64).astype(np.float32)).to(dev)
    for u in (1, 8, 64):
        idx = idx0[sampled64] if u == 64 else idx0[sampled[:u]]
        val = val0[sampled64] if u == 64 else val0[sampled[:u]]
        coef = coef64 if u == 64 else torch.from_numpy(
            rng.normal(0.0, 0.5, size=u).astype(np.float32)).to(dev)
        g_abs = torch.zeros(d0, device=dev).index_add_(
            0, idx.reshape(-1).long(), torch.abs(val * coef[:, None]).reshape(-1))
        for reg_name, (lam, lam1, lam2) in settings.items():
            args = (w0, idx, val, coef, z0, eta, lam, lam1, lam2)
            got = prox_mod.prox_update(*args)
            want = prox_mod.prox_update_plain(*args)
            cpu_bits = bitwise_vs_cpu(got, prox_mod.prox_update_plain(*cpu_args(args)))
            err = torch.abs(got - want)
            tol = LAZY_ATOL + LAZY_RTOL * (torch.abs(w0) + torch.abs(want) + eta * (
                g_abs + torch.abs(z0) + lam * torch.abs(w0) + lam1))
            ok = bool(torch.all(err <= tol))
            torch.cuda.synchronize()
            require(ok, f"prox_update u={u} {reg_name}: max error {float(err.max())}, "
                        f"{float(torch.max(err / tol))} of its tolerance")
            require(cpu_bits, f"prox_update u={u} {reg_name}: not bitwise the CPU plain version")
            entries = idx.numel()
            flops = (5.0 + (4.0 if lam1 or lam2 else 0.0) + (1.0 if lam2 else 0.0)) * d0 \
                + 2.0 * entries
            b_ms, b_by = bound_ms(3 * d0 * 4 + entries * 8 + u * 4, flops)
            row = {
                "phase": "kernel_check", "kernel": "prox_update", "u": u, "reg": reg_name,
                "d_block": d0, "nnz_l": idx.shape[1],
                "max_abs_err": float(err.max()),
                "max_err_over_tol": float(torch.max(err / tol)),
                "bitwise": bool(torch.equal(got, want)),
                "bitwise_vs_cpu_plain": cpu_bits,
                "n_differ": int(torch.count_nonzero(got != want)),
                # index_add_ adds repeated ids with atomics, in an order that
                # can change from run to run; the kernel adds in flat order.
                "max_id_repeats": int(torch.unique(idx[val != 0], return_counts=True)[1].max()),
                "first_differ": first_difference(torch, got, want, w0, z0),
                "tolerance": f"|d| <= {LAZY_ATOL:g} + {LAZY_RTOL:g} * (|w| + |plain| + eta * "
                             f"(|g| + |z| + lam * |w| + lam1))",
                "l2": "warm",
                "kernel_ms": device_ms(torch, lambda: prox_mod.prox_update(*args), 200),
                "plain_ms": device_ms(torch, lambda: prox_mod.prox_update_plain(*args), 200),
                "host_ms": host_ms(torch, lambda: prox_mod.prox_update(*args), 200),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            }
            emit(row)
            prox_rows[(u, reg_name)] = row

    # 3b. The lazy kernels vs plain, at the state an exact-lazy epoch of
    # LAZY_CHECK_STEPS steps leaves: the step catch-up (one launch for all 8
    # blocks) replays and stamps every sampled row in turn, and its `last`
    # must equal the stamps reckoned from the samples (last[j] = 1 + the last
    # step that touched j).  Block 0's part of that state (its w from w0, as
    # the one-block replays left it before) feeds the one-block rows; then
    # step m = LAZY_CHECK_STEPS with fresh rows.
    reg = cfg_preset.regularizer()
    u = cfg_preset.batch_size
    z_all = _full_grad_blocks(bd8, torch.zeros(data.dim, device=dev), loss, True)[0]
    z_real = z_all[:d0]
    m_ck = LAZY_CHECK_STEPS
    ck_ids = torch.from_numpy(
        draw_samples(np.random.default_rng(SEED + 1), n, m_ck + 1, 8).astype(np.int64)
    ).to(dev)
    rng_c = np.random.default_rng(SEED + 7)
    w_state = torch.cat([w0, torch.from_numpy(
        rng_c.normal(0.0, 0.1, size=data.dim - d0).astype(np.float32)).to(dev)])
    last_state = torch.zeros(data.dim, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for m in range(m_ck):
        ops.lazy_step_catchup(bd8, ck_ids[m, :1], w_state, last_state, z_all, eta, m, m_ck,
                              lam=settings["l2"][0])
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0

    def global_ids(ids):
        """[len(ids), 701]: the sampled rows' ids in all 8 blocks, global."""
        return torch.cat([bd8.indices[l][ids].long() + bounds8[l] for l in range(Q)], 1)

    def epoch_stamps(ids):
        """last after a step catch-up at every step m of ids (one row a step)."""
        g = global_ids(ids)
        stamps = torch.arange(1, ids.numel() + 1, device=dev, dtype=torch.int32)
        return torch.zeros(data.dim, dtype=torch.int32, device=dev).scatter_reduce_(
            0, g.reshape(-1), stamps.repeat_interleave(g.shape[1]), "amax")

    require(torch.equal(last_state, epoch_stamps(ck_ids[:m_ck, 0])),
            "lazy_catchup: last != the epoch's stamps")
    w_ck, last_ck = w_state[:d0].clone(), last_state[:d0].clone()
    emit({"phase": "lazy_check_state", "steps": m_ck, "blocks": Q, "catchup_loop_s": epoch_s,
          "features_touched": int(torch.count_nonzero(last_state)),
          "features_touched_block0": int(torch.count_nonzero(last_ck)),
          "last_equals_stamps": True})
    lazy_rows = {}

    def lazy_check(kernel, u_ck, reg_name, case, got, want, last_ok, tol, w_in, time_it,
                   cpu_bits=None, extra=None):
        err = torch.abs(got - want)
        ok = bool(torch.all(err <= tol)) and cpu_bits is not False
        row = {"phase": "kernel_check", "kernel": kernel, "u": u_ck, "reg": reg_name,
               "case": case, "d_block": d0, "nnz_l": idx0.shape[1],
               "max_abs_err": float(err.max()),
               "max_err_over_tol": float(torch.max(err / torch.clamp_min(tol, 1e-30))),
               "bitwise": bool(torch.equal(got, want)),
               "n_differ": int(torch.count_nonzero(got != want)),
               "first_differ": first_difference(torch, got, want, w_in, z_real),
               "last_exact": last_ok}
        if cpu_bits is not None:
            row["bitwise_vs_cpu_plain"] = cpu_bits
        row.update(extra or {})
        if time_it is not None:
            row.update(time_it())
        emit(row)
        require(ok and last_ok, f"{kernel} u={u_ck} {reg_name} {case}: {row}")
        lazy_rows[(kernel, u_ck, reg_name, case)] = row

    def timings(fn, plain_fn, restore, plain_iters, nbytes, flops):
        b_ms, b_by = bound_ms(nbytes, flops)
        return {"kernel_ms": device_ms(torch, fn, 200, restore),
                "plain_ms": device_ms(torch, plain_fn, plain_iters, restore),
                "host_ms": host_ms(torch, fn, 200), "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by}

    def chain_bound_ms(k_max):
        """The longest replay's dependent chain: k_max steps of
        REPLAY_CHAIN_OPS float operations, FADD_CYCLES each."""
        return k_max * REPLAY_CHAIN_OPS * FADD_CYCLES / sm_clock_hz * 1e3

    def replay_steps(last, m, stop):
        k = torch.clamp_min(min(stop, m) - last, 0)
        return k + ((m - last) > k).to(k.dtype)

    for u_ck in (1, 8, 64):
        ids = sampled64 if u_ck == 64 else ck_ids[m_ck, :u_ck]
        idx, val = idx0[ids], val0[ids]
        coef = coef64 if u_ck == 64 else torch.from_numpy(
            rng.normal(0.0, 0.5, size=u_ck).astype(np.float32)).to(dev)
        corr = lazy_mod.step_corrections(bd8.nnz_col_block(0), n, u_ck)
        flat = idx.reshape(-1).long()
        distinct = torch.unique(flat)
        entries = flat.numel()
        g_abs = torch.zeros(d0, device=dev).index_add_(0, flat, torch.abs(val * coef[:, None]).reshape(-1))
        for reg_name, (lam, lam1, lam2) in settings.items():
            for case in ("unmasked", "masked"):
                timed = reg_name == reg.name and case == "unmasked"
                # catch-up: unmasked eta; "masked" = an Option II tail (stop < m).
                stop = m_ck if case == "unmasked" else 3 * m_ck // 4
                # The one-block catch-up (the q = 1 case of the step launch).
                a = (w_ck.clone(), last_ck.clone())
                b = (w_ck.clone(), last_ck.clone())
                lazy_mod.lazy_catchup(*a, z_real, idx, eta, m_ck, stop, lam, lam1, lam2)
                lazy_mod.lazy_catchup_plain(*b, z_real, idx, eta, m_ck, stop, lam, lam1, lam2)
                k = replay_steps(last_ck, m_ck, stop)
                tol = LAZY_RTOL * (k + 1) * (torch.abs(w_ck) + torch.abs(b[0])
                                             + eta * torch.abs(z_real))
                steps = float(k[distinct].sum())
                chain = int(k[distinct].max())

                def restore(a=a):
                    a[0].copy_(w_ck)
                    a[1].copy_(last_ck)

                lazy_check("lazy_catchup", u_ck, reg_name, case, a[0], b[0],
                           bool(torch.equal(a[1], b[1])), tol, w_ck,
                           (lambda: timings(
                               lambda: lazy_mod.lazy_catchup(*a, z_real, idx, eta, m_ck, stop, lam, lam1, lam2),
                               lambda: lazy_mod.lazy_catchup_plain(*a, z_real, idx, eta, m_ck, stop, lam, lam1, lam2),
                               restore, 3, entries * 4 + distinct.numel() * 20,
                               steps * step_flops(lam1, lam2))
                            | {"replayed_steps": steps})
                           if timed else None,
                           extra={"longest_replay": chain, "chain_bound_ms": chain_bound_ms(chain)})
                # touch and proba: masked = eta * mask = 0.
                eta_m = eta if case == "unmasked" else 0.0
                for kernel, c in (("lazy_touch_update", None), ("lazy_proba_update", corr)):
                    a, b = w_ck.clone(), w_ck.clone()
                    extra = () if c is None else (c,)
                    kfn = getattr(lazy_mod, kernel)
                    pfn = getattr(lazy_mod, kernel + "_plain")
                    kfn(a, idx, val, coef, z_real, *extra, eta_m, lam, lam1, lam2)
                    pfn(b, idx, val, coef, z_real, *extra, eta_m, lam, lam1, lam2)
                    cpu_bits = bitwise_vs_cpu(a, pfn(*cpu_args(
                        (w_ck, idx, val, coef, z_real, *extra, eta_m, lam, lam1, lam2))))
                    cc = torch.ones_like(w_ck) if c is None else c
                    tol = LAZY_ATOL + LAZY_RTOL * (
                        torch.abs(w_ck) + torch.abs(b) + eta_m * (
                            g_abs + cc * (torch.abs(z_real) + lam * torch.abs(w_ck)) + cc * lam1))

                    def restore(a=a):
                        a.copy_(w_ck)

                    nbytes = entries * 8 + u_ck * 4 + distinct.numel() * (12 if c is None else 16)
                    flops = 2.0 * entries + distinct.numel() * step_flops(lam1, lam2, c is not None)
                    lazy_check(kernel, u_ck, reg_name, case, a, b, True, tol, w_ck,
                               (lambda: timings(
                                   lambda: kfn(a, idx, val, coef, z_real, *extra, eta_m, lam, lam1, lam2),
                                   lambda: pfn(a, idx, val, coef, z_real, *extra, eta_m, lam, lam1, lam2),
                                   restore, 50, nbytes, flops))
                               if timed else None, cpu_bits)
                if u_ck == 1:
                    # flush: the whole block; "masked" = an Option II tail.
                    a, b = w_ck.clone(), w_ck.clone()
                    lazy_mod.lazy_flush(a, last_ck, z_real, eta, m_ck, stop, lam, lam1, lam2)
                    lazy_mod.lazy_flush_plain(b, last_ck, z_real, eta, m_ck, stop, lam, lam1, lam2)
                    k = replay_steps(last_ck, m_ck, stop)
                    tol = LAZY_RTOL * (k + 1) * (torch.abs(w_ck) + torch.abs(b) + eta * torch.abs(z_real))
                    steps = float(k.sum())

                    def restore(a=a):
                        a.copy_(w_ck)

                    lazy_check("lazy_flush", 1, reg_name, case, a, b, True, tol, w_ck,
                               (lambda: timings(
                                   lambda: lazy_mod.lazy_flush(a, last_ck, z_real, eta, m_ck, stop, lam, lam1, lam2),
                                   lambda: lazy_mod.lazy_flush_plain(a, last_ck, z_real, eta, m_ck, stop, lam, lam1, lam2),
                                   restore, 3, d0 * 16, steps * step_flops(lam1, lam2))
                                | {"replayed_steps": steps})
                               if timed else None)

    # 3b'. The step catch-up: one launch for a step's rows in all 8 blocks
    # (ops.lazy_step_catchup), from the state above at step m_ck, for the
    # four regularizers, unmasked and with an Option II tail; w and last
    # bitwise the CPU's plain version (lazy_catchup_plain block after block).
    # Timed at the path's regularizer, unmasked, beside the path before (8
    # one-block launches with their 8 row gathers) and the card's plain
    # version.  Then a step at m = N = 19,954 (the paper's M), its stamps
    # built from 19,954 sampled rows as above: replays of up to 19,954 steps.
    z_all_cpu = z_all.cpu()
    step_ck_rows = {}

    def step_catchup_row(label, u_ck, reg_name, case, ids, w_in, last_in, m_at, stop, timed,
                         time_plain=True):
        lam, lam1, lam2 = settings[reg_name]
        a = (w_in.clone(), last_in.clone())
        ops.reset_launch_counts()
        ops.lazy_step_catchup(bd8, ids, *a, z_all, eta, m_at, stop, lam=lam, lam1=lam1,
                              lam2=lam2)
        one_launch = ops.launch_counts()["lazy_catchup"] == 1
        cpu = (w_in.cpu(), last_in.cpu())
        ops.lazy_step_catchup(bd8_cpu, ids.cpu(), *cpu, z_all_cpu, eta, m_at, stop, lam=lam,
                              lam1=lam1, lam2=lam2)
        bits = bitwise_vs_cpu(a[0], cpu[0]) and bool(torch.equal(a[1].cpu(), cpu[1]))
        g = global_ids(ids).reshape(-1)
        distinct = torch.unique(g)
        k = replay_steps(last_in, m_at, stop)[distinct]
        chain = int(k.max())
        row = {"phase": "kernel_check", "kernel": "lazy_catchup", "entry": "ops.lazy_step_catchup",
               "u": u_ck, "reg": reg_name, "case": case, "shape": label, "blocks": Q, "m": m_at,
               "stop": stop, "entries": g.numel(), "distinct_ids": distinct.numel(),
               "ctas": sum(-(-u_ck * w // 256) for w in bd8.nnz_budgets),
               "launches_per_call": 1 if one_launch else None,
               "bitwise_vs_cpu_plain": bits,
               "n_differ": int(torch.count_nonzero(a[0].cpu() != cpu[0])),
               "max_abs_err": float(torch.max(torch.abs(a[0].cpu() - cpu[0]))),
               "tolerance": "w and last bitwise the CPU plain version",
               "replayed_steps": float(k.sum()), "longest_replay": chain,
               "chain_bound_ms": chain_bound_ms(chain),
               "replay_chain_ops": REPLAY_CHAIN_OPS, "fadd_cycles": FADD_CYCLES,
               "sm_clock_max_mhz": sm_clock_hz / 1e6}
        if timed:
            def restore(a=a):
                a[0].copy_(w_in)
                a[1].copy_(last_in)

            def per_block(a=a):
                for l in range(Q):
                    lo, hi = bounds8[l], bounds8[l + 1]
                    lazy_mod.lazy_catchup(a[0][lo:hi], a[1][lo:hi], z_all[lo:hi],
                                          bd8.indices[l][ids], eta, m_at, stop, lam, lam1, lam2)

            b_ms, b_by = bound_ms(g.numel() * 4 + ids.numel() * 8 + distinct.numel() * 20,
                                  float(k.sum()) * step_flops(lam1, lam2))
            row.update({
                "l2": "warm",
                "kernel_ms": device_ms(torch, lambda: ops.lazy_step_catchup(
                    bd8, ids, *a, z_all, eta, m_at, stop, lam=lam, lam1=lam1, lam2=lam2),
                    50, restore),
                "per_block_ms": device_ms(torch, per_block, 50, restore),
                # The plain loop launches ~8 kernels a replayed step and block.
                "plain_ms": device_ms(torch, lambda: lazy_mod.catchup_plain(
                    bd8.indices, bounds8, ids, *a, z_all, eta, m_at, stop, lam, lam1, lam2),
                    3, restore) if time_plain else None,
                "host_ms": host_ms(torch, lambda: ops.lazy_step_catchup(
                    bd8, ids, *a, z_all, eta, m_at, stop, lam=lam, lam1=lam1, lam2=lam2), 200),
                "per_block_host_ms": host_ms(torch, per_block, 50),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
            row["kernel_over_chain_bound"] = row["kernel_ms"] / row["chain_bound_ms"]
        emit(row)
        require(one_launch and bits, f"lazy_catchup step {label} u={u_ck} {reg_name} {case}: {row}")
        step_ck_rows[(label, u_ck, reg_name, case)] = row
        return row

    for u_ck in (1, 8, 64):
        ids = sampled64 if u_ck == 64 else ck_ids[m_ck, :u_ck]
        for reg_name in settings:
            for case in ("unmasked", "masked"):
                step_catchup_row(f"step m={m_ck}, 8 blocks", u_ck, reg_name, case, ids, w_state,
                                 last_state, m_ck, m_ck if case == "unmasked" else 3 * m_ck // 4,
                                 reg_name == reg.name and case == "unmasked")
    m_full = n  # the paper's M = N inner steps per outer
    full_ids = torch.from_numpy(
        draw_samples(np.random.default_rng(SEED + 8), n, m_full + 1, 1).astype(np.int64)[:, 0]
    ).to(dev)
    last_full = epoch_stamps(full_ids[:m_full])
    step_catchup_row(f"step m={m_full}, 8 blocks", 1, reg.name, "unmasked",
                     full_ids[m_full:], w_state, last_full, m_full, m_full, True,
                     time_plain=False)
    del last_full

    # 3b''. The epoch-end flush over the whole width (ops.lazy_block_flush
    # over the 8 blocks' features: one launch) at the state the catch-up
    # epoch above left, four regularizers, unmasked and with an Option II
    # tail: bitwise the 8 one-block launches and the CPU's plain flush.
    # Timed at the path's regularizer, unmasked, beside the 8 one-block
    # launches and the card's plain version.  Three bounds: bytes
    # (16 B a feature), the operations at 67 TFLOP/s, and issue: the
    # replayed ops are rounded __f*_rn that never fuse, one issue slot
    # each (step_flops less the hoisted 0 + z) on SMs x 128 lanes at the
    # max SM clock.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    last_state_cpu = last_state.cpu()
    flush_rows = {}
    for reg_name, (lam, lam1, lam2) in settings.items():
        for case in ("unmasked", "masked"):
            stop = m_ck if case == "unmasked" else 3 * m_ck // 4
            tail = (eta, m_ck, stop, lam, lam1, lam2)
            whole = w_state.clone()
            ops.reset_launch_counts()
            ops.lazy_block_flush(whole, last_state, z_all, eta, m_ck, stop, lam=lam, lam1=lam1,
                                 lam2=lam2)
            one_launch = ops.launch_counts()["lazy_flush"] == 1
            blocks = w_state.clone()
            for lo, hi in zip(bounds8[:-1], bounds8[1:]):
                lazy_mod.lazy_flush(blocks[lo:hi], last_state[lo:hi], z_all[lo:hi], *tail)
            cpu = w_state.cpu()
            lazy_mod.lazy_flush_plain(cpu, last_state_cpu, z_all_cpu, *tail)
            bits_blocks = bool(torch.equal(whole.view(torch.int32), blocks.view(torch.int32)))
            bits_cpu = bitwise_vs_cpu(whole, cpu)
            k = replay_steps(last_state, m_ck, stop)
            steps = float(k.sum())
            row = {"phase": "kernel_check", "kernel": "lazy_flush", "entry": "ops.lazy_block_flush",
                   "reg": reg_name, "case": case, "shape": f"whole width, 8 blocks, after a "
                                                          f"{m_ck}-step epoch",
                   "d": data.dim, "stop": stop, "replayed_steps": steps,
                   "launches_per_call": 1 if one_launch else None,
                   "bitwise_vs_8_launches": bits_blocks, "bitwise_vs_cpu_plain": bits_cpu,
                   "max_abs_err": float(torch.max(torch.abs(whole.cpu() - cpu))),
                   "tolerance": "bitwise: 8 one-block launches, the CPU plain version"}
            if reg_name == reg.name and case == "unmasked":
                t = w_state.clone()

                def restore(t=t):
                    t.copy_(w_state)

                def per_block(t=t, tail=tail):
                    for lo, hi in zip(bounds8[:-1], bounds8[1:]):
                        lazy_mod.lazy_flush(t[lo:hi], last_state[lo:hi], z_all[lo:hi], *tail)

                b_ms, b_by = bound_ms(16 * data.dim, steps * step_flops(lam1, lam2))
                issue_ops = step_flops(lam1, lam2) - 1.0
                issue_ms = steps * issue_ops / (sms * 128 * sm_clock_hz) * 1e3
                row.update({
                    "l2": "warm",
                    "kernel_ms": device_ms(torch, lambda t=t, tail=tail: lazy_mod.lazy_flush(
                        t, last_state, z_all, *tail), 20, restore),
                    "per_block_ms": device_ms(torch, per_block, 20, restore),
                    "plain_ms": device_ms(torch, lambda t=t, tail=tail: lazy_mod.lazy_flush_plain(
                        t, last_state, z_all, *tail), 3, restore),
                    "host_ms": host_ms(torch, lambda t=t, tail=tail: ops.lazy_block_flush(
                        t, last_state, z_all, tail[0], tail[1], tail[2], lam=lam, lam1=lam1,
                        lam2=lam2), 20),
                    "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                    "bytes_bound_ms": 16 * data.dim / PEAK_BYTES_PER_S * 1e3,
                    "flop_bound_ms": steps * step_flops(lam1, lam2) / PEAK_F32_FLOP_PER_S * 1e3,
                    "issue_bound_ms": issue_ms, "issue_ops_per_step": issue_ops,
                    "sms": sms, "sm_clock_max_mhz": sm_clock_hz / 1e6,
                    "bounded_by_of_three": max(
                        (("bytes", 16 * data.dim / PEAK_BYTES_PER_S * 1e3),
                         ("operations", steps * step_flops(lam1, lam2) / PEAK_F32_FLOP_PER_S * 1e3),
                         ("issue", issue_ms)), key=lambda kv: kv[1])[0]})
                row["kernel_over_issue_bound"] = row["kernel_ms"] / issue_ms
            emit(row)
            require(one_launch and bits_blocks and bits_cpu,
                    f"lazy_flush whole width {reg_name} {case}: {row}")
            flush_rows[(reg_name, case)] = row
    del last_state_cpu

    # 3c. The lazy touched pass on the widest block a preset gives,
    # kdd2010's d at q = 1 (29,890,095 features, 176x news20's block 0):
    # its grid is sized to the entries, so a step should cost what it
    # costs on block 0.  Rows of news20's width and shape (80 copies of one
    # id a row, trailing padding), their ids spread over the whole block;
    # bitwise against the CPU plain version, timed beside block 0's row.
    rng_wide = np.random.default_rng(SEED + 5)
    d_wide = KDD2010_D
    w_wide = torch.from_numpy(rng_wide.normal(0.0, 0.1, size=d_wide).astype(np.float32)).to(dev)
    z_wide = torch.from_numpy(rng_wide.normal(0.0, 1e-3, size=d_wide).astype(np.float32)).to(dev)
    corr_wide = torch.from_numpy(rng_wide.uniform(1.0, 20.0, size=d_wide).astype(np.float32)).to(dev)
    width = idx0.shape[1]
    for u_w in (8, 64):
        idx_np = rng_wide.integers(0, d_wide, size=(u_w, width)).astype(np.int32)
        val_np = rng_wide.normal(size=(u_w, width)).astype(np.float32)
        idx_np[:, 5:85] = int(rng_wide.integers(0, d_wide))
        idx_np[:, width - 20:], val_np[:, width - 20:] = 0, 0.0
        idx_w, val_w = torch.from_numpy(idx_np).to(dev), torch.from_numpy(val_np).to(dev)
        coef_w = torch.from_numpy(rng_wide.normal(0.0, 0.5, size=u_w).astype(np.float32)).to(dev)
        distinct = int(torch.unique(idx_w).numel())
        lam, lam1, lam2 = settings[reg.name]
        for kernel, c in (("lazy_touch_update", None), ("lazy_proba_update", corr_wide)):
            extra = () if c is None else (c,)
            kfn = getattr(lazy_mod, kernel)
            pfn = getattr(lazy_mod, kernel + "_plain")
            a = w_wide.clone()
            kfn(a, idx_w, val_w, coef_w, z_wide, *extra, eta, lam, lam1, lam2)
            cpu_bits = bitwise_vs_cpu(a, pfn(*cpu_args(
                (w_wide, idx_w, val_w, coef_w, z_wide, *extra, eta, lam, lam1, lam2))))

            def restore(a=a):
                a.copy_(w_wide)

            b_ms, b_by = bound_ms(
                idx_w.numel() * 8 + u_w * 4 + distinct * (12 if c is None else 16),
                2.0 * idx_w.numel() + distinct * step_flops(lam1, lam2, c is not None))
            row = {"phase": "kernel_check", "kernel": kernel, "u": u_w, "reg": reg.name,
                   "case": "kdd2010 width", "d_block": d_wide, "nnz_l": width,
                   "grid_blocks": -(-idx_w.numel() // 256), "distinct_ids": distinct,
                   "bitwise_vs_cpu_plain": cpu_bits, "l2": "warm",
                   "kernel_ms": device_ms(torch, lambda: kfn(
                       a, idx_w, val_w, coef_w, z_wide, *extra, eta, lam, lam1, lam2), 200, restore),
                   "block0_kernel_ms": lazy_rows[(kernel, u_w, reg.name, "unmasked")]["kernel_ms"],
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            require(cpu_bits, f"{kernel} at kdd2010 width u={u_w}: {row}")
    del w_wide, z_wide, corr_wide

    # 4. The main path: run_fdsvrg at q = 8 through both kernels.
    cfg = SVRGConfig(eta=cfg_preset.eta, inner_steps=INNER_STEPS, outer_iters=OUTERS,
                     batch_size=u, seed=SEED)
    obj_init = objective_from_margins(
        torch.zeros(n, device=dev), bd8.labels, torch.zeros(data.dim, device=dev), loss, reg
    )
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_fdsvrg(None, part8, loss, reg, cfg, block_data=bd8, use_kernels=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_outer = 2 * Q * n + INNER_STEPS * 2 * Q * u
    expected_counts = expected_launches(
        ops, sparse_margin=(OUTERS + 1) + INNER_STEPS * OUTERS,
        logistic_grad=(OUTERS + 1) + INNER_STEPS * OUTERS,
        block_scatter=OUTERS + 1, prox_update=Q * INNER_STEPS * OUTERS)
    objs = [h.objective for h in res.history]
    emit({"phase": "main_path", "entry": "run_fdsvrg", "config": cfg_preset.name,
          "d": data.dim, "N": n, "q": Q, "u": u, "eta": cfg.eta, "reg": reg.name,
          "lam": reg.lam, "outers": OUTERS, "inner_steps": INNER_STEPS,
          "cut": f"M = {INNER_STEPS} inner steps per outer (the paper's M = N = {n}); "
                 f"{OUTERS} outers",
          "objective_init": obj_init, "objectives": objs,
          "grad_norms": [h.grad_norm for h in res.history],
          "comm_scalars": [h.comm_scalars for h in res.history],
          "expected_scalars_per_outer": per_outer, "launches": counts,
          "expected_launches": expected_counts, "wall_s": wall,
          "inner_steps_per_s": OUTERS * INNER_STEPS / wall})
    require(all(math.isfinite(o) for o in objs), f"non-finite objective {objs}")
    require(objs[0] < obj_init and objs[1] < objs[0],
            f"objective does not fall: {obj_init} -> {objs}")
    require([h.comm_scalars for h in res.history]
            == [per_outer * (t + 1) for t in range(OUTERS)]
            and res.meter.total_scalars == OUTERS * per_outer,
            f"meter {res.meter.total_scalars} != {OUTERS} * {per_outer}")
    require(counts == expected_counts, f"launches {counts} != {expected_counts}")

    # Where the main path's time goes: one short outer under the profiler.
    from torch.profiler import ProfilerActivity, profile

    window = SVRGConfig(eta=cfg_preset.eta, inner_steps=PROFILE_STEPS, outer_iters=1,
                        batch_size=u, seed=SEED)
    run_fdsvrg(None, part8, loss, reg, window, block_data=bd8)  # warm-up
    torch.cuda.synchronize()
    window_s, by_kernel, main_calls, main_lost_us, main_records = traced_outer(
        torch, lambda: run_fdsvrg(None, part8, loss, reg, window, block_data=bd8), ops)
    busy_s = sum(by_kernel.values()) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]

    # Launches per inner step, dense and exact lazy: one epoch of
    # LAUNCH_COUNT_STEPS steps from the first snapshot, profiled alone (the
    # lazy epoch's flush adds 1 launch), and the torch gathers and
    # index_add_ calls each epoch makes (call_counter); none on the kernel
    # path.
    z_p, s0_p = _full_grad_blocks(bd8, torch.zeros(data.dim, device=dev), loss, True)
    lc_samples = draw_samples(np.random.default_rng(SEED + 9), n, LAUNCH_COUNT_STEPS, u)
    lc_mask = np.ones(LAUNCH_COUNT_STEPS, dtype=np.float32)
    w_zero = torch.zeros(data.dim, device=dev)
    per_step, gathers, gathers_1d, index_adds = {}, {}, {}, {}
    for mode in ("dense", "lazy", "dense plain"):
        def epoch(kernels=mode != "dense plain", lazy=mode == "lazy"):
            if lazy:
                return _lazy_inner_epoch(bd8, w_zero, z_p, s0_p, lc_samples, cfg.eta, lc_mask,
                                         None, loss, reg, kernels, "exact")
            return _inner_epoch(bd8, w_zero, z_p, s0_p, lc_samples, cfg.eta, lc_mask, loss, reg,
                                kernels)

        epoch()
        torch.cuda.synchronize()
        with call_counter(torch) as mode_counter:
            epoch()
        gathers[mode] = mode_counter.count
        gathers_1d[mode] = mode_counter.count_1d
        index_adds[mode] = mode_counter.index_adds
        if mode != "dense plain":
            with profile(activities=[ProfilerActivity.CUDA]) as lc_prof:
                epoch()
                torch.cuda.synchronize()
            per_step[mode] = sum(device_kernels(torch, lc_prof)[1].values()) / LAUNCH_COUNT_STEPS
    emit({"phase": "main_path_profile", "inner_steps": PROFILE_STEPS, "outers": 1,
          "note": "one outer = 2 snapshots + the inner steps; profiler running (CUDA activity); "
                  "device_busy_s is the trace's; lost_records_ms estimates the launches it "
                  "lost, at their kernel's mean, and is not in it",
          "wall_s": window_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / window_s,
          "lost_records_ms": main_lost_us / 1e3, "port_records_and_launches": main_records,
          "device_kernels": sum(main_calls.values()),
          "device_kernels_per_step_of_an_epoch": per_step,
          "row_gathers_per_epoch": gathers,
          "label_and_s0_gathers_per_step": {k: v / LAUNCH_COUNT_STEPS
                                            for k, v in gathers_1d.items()},
          "index_adds_per_epoch": index_adds,
          "epoch_steps": LAUNCH_COUNT_STEPS,
          "top_kernels_us_calls": [[k[:90], v, main_calls.get(k, 0)] for k, v in top]})
    require(gathers["dense"] == 0 and gathers["lazy"] == 0
            and gathers["dense plain"] == Q * LAUNCH_COUNT_STEPS * 2,
            f"torch gathers of the sampled rows: {gathers}")
    require(gathers_1d["dense"] == 0 and gathers_1d["lazy"] == 0
            and gathers_1d["dense plain"] == 2 * LAUNCH_COUNT_STEPS,
            f"torch gathers of the rows' labels and snapshot margins: {gathers_1d}")
    require(index_adds["dense"] == 0 and index_adds["lazy"] == 0
            and index_adds["dense plain"] == Q * LAUNCH_COUNT_STEPS,
            f"index_add_ calls of an epoch: {index_adds}")
    # 1 margins + 1 coefficient + Q prox_update launches a dense step; the
    # lazy step adds the catch-up (and the epoch its flush and a fill).
    require(per_step["dense"] <= Q + 3 and per_step["lazy"] <= Q + 4,
            f"device kernels per step: {per_step}")

    # 5. Two short kernel-path runs, bitwise equal; one against the plain path.
    short = SVRGConfig(eta=cfg_preset.eta, inner_steps=PLAIN_CHECK_STEPS, outer_iters=1,
                       batch_size=u, seed=SEED)
    k_run = run_fdsvrg(None, part8, loss, reg, short, block_data=bd8, use_kernels=True)
    k_again = run_fdsvrg(None, part8, loss, reg, short, block_data=bd8, use_kernels=True)
    runs_bitwise = bool(torch.equal(k_run.w, k_again.w)) and \
        k_run.objectives().tolist() == k_again.objectives().tolist()
    p_run = run_fdsvrg(None, part8, loss, reg, short, block_data=bd8, use_kernels=False)
    ko, po = k_run.objectives(), p_run.objectives()
    w_err = float(torch.max(torch.abs(k_run.w - p_run.w)))
    w_scale = float(torch.max(torch.abs(p_run.w)))
    obj_rel = float(np.max(np.abs(ko - po) / np.abs(po)))
    emit({"phase": "plain_path_check", "inner_steps": PLAIN_CHECK_STEPS, "outers": 1,
          "kernel_runs_bitwise": runs_bitwise,
          "objective_kernels": ko.tolist(), "objective_plain": po.tolist(),
          "objective_rel_err": obj_rel, "w_max_abs_err": w_err, "w_max_abs": w_scale,
          "tolerance": f"two kernel runs bitwise; vs plain objective rtol {RUN_RTOL:g}, "
                       f"max|dw| <= {RUN_W_RTOL:g} * max|w|"})
    require(runs_bitwise, "two kernel-path runs differ")
    require(obj_rel <= RUN_RTOL and w_err <= RUN_W_RTOL * w_scale,
            f"kernel path vs plain path: objective rel {obj_rel}, w {w_err} of {w_scale}")

    # 6. The serial path (q = 1, row width 455).
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ser = run_serial_svrg(None, loss, reg, short, block_data=bd1, use_kernels=True)
    torch.cuda.synchronize()
    ser_counts = ops.launch_counts()
    ser_expected = expected_launches(ops, sparse_margin=2 + PLAIN_CHECK_STEPS,
                                     logistic_grad=2 + PLAIN_CHECK_STEPS,
                                     block_scatter=2, prox_update=PLAIN_CHECK_STEPS)
    emit({"phase": "serial_path", "entry": "run_serial_svrg", "nnz_l": bd1.nnz_budgets[0],
          "inner_steps": PLAIN_CHECK_STEPS, "objectives": ser.objectives().tolist(),
          "launches": ser_counts, "expected_launches": ser_expected,
          "wall_s": time.perf_counter() - t0})
    require(ser.objectives()[0] < obj_init, "serial objective does not fall")
    require(ser_counts == ser_expected, f"serial launches {ser_counts} != {ser_expected}")

    # 7. Serving check: score the trained w through the margin kernel.
    ops.reset_launch_counts()
    scores = ops.sparse_margins(bd1.indices[0], bd1.values[0], res.w)
    serve_counts = ops.launch_counts()
    plain_scores = margin_mod.sparse_margin_plain(bd1.indices[0], bd1.values[0], res.w)
    acc = float(torch.mean((torch.sign(scores) == bd1.labels).float()))
    acc_plain = float(torch.mean((torch.sign(plain_scores) == bd1.labels).float()))
    emit({"phase": "serving", "rows": n, "train_accuracy": acc,
          "train_accuracy_plain": acc_plain, "launches": serve_counts})
    require(serve_counts == expected_launches(ops, sparse_margin=1),
            f"serving launches {serve_counts}")
    require(acc > 0.5 and abs(acc - acc_plain) <= 1.0 / n + 1e-12,
            f"serving accuracy {acc} (plain {acc_plain})")

    # 8. The exact lazy path: run_fdsvrg(lazy_updates="exact") at the main
    # path's configuration.  Laziness changes no communication: the meter
    # is the dense closed form.  Against the dense main path (same samples,
    # each exact-lazy epoch bit for bit the dense one, snapshots through the
    # same kernels) w and the objectives are equal bit for bit.
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lazy_res = run_fdsvrg(None, part8, loss, reg, cfg, block_data=bd8, lazy_updates="exact")
    torch.cuda.synchronize()
    lazy_wall = time.perf_counter() - t0
    lazy_counts = ops.launch_counts()
    lazy_expected = expected_launches(
        ops, sparse_margin=(OUTERS + 1) + INNER_STEPS * OUTERS,
        logistic_grad=(OUTERS + 1) + INNER_STEPS * OUTERS,
        block_scatter=OUTERS + 1, lazy_catchup=INNER_STEPS * OUTERS,
        lazy_touch_update=Q * INNER_STEPS * OUTERS,
        lazy_flush=OUTERS)
    lazy_objs = [h.objective for h in lazy_res.history]
    lazy_rel = float(np.max(np.abs(np.array(lazy_objs) - np.array(objs)) / np.abs(objs)))
    lazy_w_bitwise = bool(torch.equal(lazy_res.w, res.w))
    emit({"phase": "lazy_exact_path", "entry": "run_fdsvrg(lazy_updates='exact')",
          "q": Q, "u": u, "eta": cfg.eta, "reg": reg.name, "outers": OUTERS,
          "inner_steps": INNER_STEPS, "objectives": lazy_objs, "objectives_dense": objs,
          "objective_rel_vs_dense": lazy_rel, "bitwise_objectives_vs_dense": lazy_objs == objs,
          "bitwise_w_vs_dense": lazy_w_bitwise,
          "w_max_abs_diff_vs_dense": float(torch.max(torch.abs(lazy_res.w - res.w))),
          "comm_scalars": [h.comm_scalars for h in lazy_res.history],
          "expected_scalars_per_outer": per_outer, "launches": lazy_counts,
          "expected_launches": lazy_expected, "wall_s": lazy_wall,
          "inner_steps_per_s": OUTERS * INNER_STEPS / lazy_wall,
          "inner_steps_per_s_dense": OUTERS * INNER_STEPS / wall})
    require(all(math.isfinite(o) for o in lazy_objs), f"non-finite lazy objective {lazy_objs}")
    require(lazy_objs[0] < obj_init and lazy_objs[1] < lazy_objs[0],
            f"lazy objective does not fall: {obj_init} -> {lazy_objs}")
    require([h.comm_scalars for h in lazy_res.history]
            == [per_outer * (t + 1) for t in range(OUTERS)]
            and lazy_res.meter.total_scalars == OUTERS * per_outer,
            f"lazy meter {lazy_res.meter.total_scalars} != {OUTERS} * {per_outer}")
    require(lazy_counts == lazy_expected, f"lazy launches {lazy_counts} != {lazy_expected}")
    require(lazy_objs == objs and lazy_w_bitwise,
            f"lazy vs dense: objective rel {lazy_rel}, w bitwise {lazy_w_bitwise}")

    # 9. The gate: one exact-lazy epoch equals the dense epoch bit for bit
    # on the kernel path, from one snapshot (z, s0) fed to both, Option II
    # (a masked tail of a quarter of the steps).
    w_start = res.w
    z_s, s0_s = _full_grad_blocks(bd8, w_start, loss, True)
    lvd_samples = draw_samples(np.random.default_rng(SEED + 2), n, LAZY_VS_DENSE_STEPS, u)
    lvd_stop = 3 * LAZY_VS_DENSE_STEPS // 4
    lvd_mask = (np.arange(LAZY_VS_DENSE_STEPS) < lvd_stop).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_dense = _inner_epoch(bd8, w_start, z_s, s0_s, lvd_samples, cfg.eta, lvd_mask, loss, reg,
                           True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    w_lazy = _lazy_inner_epoch(bd8, w_start, z_s, s0_s, lvd_samples, cfg.eta, lvd_mask, None,
                               loss, reg, True, "exact")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = bool(torch.equal(w_lazy, w_dense))
    emit({"phase": "lazy_vs_dense", "inner_steps": LAZY_VS_DENSE_STEPS, "option": "II",
          "active_steps": lvd_stop, "bitwise": same,
          "n_differ": int(torch.count_nonzero(w_lazy != w_dense)),
          "first_differ": first_difference(torch, w_lazy, w_dense, w_start, z_s),
          "moved_features": int(torch.count_nonzero(w_lazy != w_start)),
          "dense_s": t1 - t0, "lazy_s": t2 - t1})
    require(same, "exact-lazy epoch != dense epoch on the kernel path")

    # 10. The probabilistic lazy path, one outer at the reference's proba eta.
    proba_cfg = SVRGConfig(eta=PROBA_ETA, inner_steps=INNER_STEPS, outer_iters=1,
                           batch_size=u, seed=SEED)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    proba_res = run_fdsvrg(None, part8, loss, reg, proba_cfg, block_data=bd8,
                           lazy_updates="proba")
    torch.cuda.synchronize()
    proba_wall = time.perf_counter() - t0
    proba_counts = ops.launch_counts()
    proba_expected = expected_launches(ops, sparse_margin=2 + INNER_STEPS,
                                       logistic_grad=2 + INNER_STEPS,
                                       block_scatter=2, lazy_proba_update=Q * INNER_STEPS)
    dense_proba_eta = run_fdsvrg(None, part8, loss, reg, proba_cfg, block_data=bd8)
    proba_obj = proba_res.history[0].objective
    emit({"phase": "lazy_proba_path", "entry": "run_fdsvrg(lazy_updates='proba')",
          "eta": PROBA_ETA, "inner_steps": INNER_STEPS, "outers": 1,
          "objective_init": obj_init, "objective": proba_obj,
          "objective_dense_same_eta": dense_proba_eta.history[0].objective,
          "comm_scalars": proba_res.meter.total_scalars, "launches": proba_counts,
          "expected_launches": proba_expected, "wall_s": proba_wall,
          "inner_steps_per_s": INNER_STEPS / proba_wall})
    require(math.isfinite(proba_obj) and proba_obj < obj_init,
            f"proba objective {proba_obj} not below {obj_init}")
    require(proba_res.meter.total_scalars == per_outer,
            f"proba meter {proba_res.meter.total_scalars} != {per_outer}")
    require(proba_counts == proba_expected, f"proba launches {proba_counts} != {proba_expected}")

    # 11. The serial lazy path (q = 1, row width 455).
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lser = run_serial_svrg(None, loss, reg, short, block_data=bd1, lazy_updates="exact")
    torch.cuda.synchronize()
    lser_counts = ops.launch_counts()
    lser_expected = expected_launches(
        ops, sparse_margin=2 + PLAIN_CHECK_STEPS, logistic_grad=2 + PLAIN_CHECK_STEPS,
        block_scatter=2, lazy_catchup=PLAIN_CHECK_STEPS,
        lazy_touch_update=PLAIN_CHECK_STEPS, lazy_flush=1)
    lser_rel = float(np.max(np.abs(lser.objectives() - ser.objectives())
                            / np.abs(ser.objectives())))
    emit({"phase": "lazy_serial_path", "entry": "run_serial_svrg(lazy_updates='exact')",
          "nnz_l": bd1.nnz_budgets[0], "inner_steps": PLAIN_CHECK_STEPS,
          "objectives": lser.objectives().tolist(), "objectives_dense": ser.objectives().tolist(),
          "objective_rel_vs_dense": lser_rel, "launches": lser_counts,
          "expected_launches": lser_expected, "wall_s": time.perf_counter() - t0})
    require(lser.objectives()[0] < obj_init, "serial lazy objective does not fall")
    require(lser_counts == lser_expected, f"serial lazy launches {lser_counts} != {lser_expected}")
    require(lser_rel <= RUN_RTOL, f"serial lazy vs dense objective rel {lser_rel}")

    # 12. Where the lazy path's time goes, and dense vs lazy steps/s on one
    # host (runs in turn: dense, lazy, lazy, dense; each one outer of
    # PROFILE_STEPS steps plus its two snapshots, no profiler).
    run_fdsvrg(None, part8, loss, reg, window, block_data=bd8, lazy_updates="exact")  # warm-up
    torch.cuda.synchronize()
    lazy_window_s, lazy_by_kernel, lazy_calls, lazy_lost_us, lazy_records = traced_outer(
        torch, lambda: run_fdsvrg(None, part8, loss, reg, window, block_data=bd8,
                                  lazy_updates="exact"), ops)
    lazy_busy_s = sum(lazy_by_kernel.values()) / 1e6
    walls: dict[str, list[float]] = {"dense": [], "lazy": []}
    for mode in ("dense", "lazy", "lazy", "dense"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fdsvrg(None, part8, loss, reg, window, block_data=bd8,
                   lazy_updates="exact" if mode == "lazy" else None)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
    emit({"phase": "lazy_profile", "inner_steps": PROFILE_STEPS, "outers": 1,
          "note": "one outer = 2 snapshots + the inner steps; profiler running (CUDA activity); "
                  "lost_records_ms is not in device_busy_s",
          "wall_s": lazy_window_s, "device_busy_s": lazy_busy_s,
          "device_idle_share": 1.0 - lazy_busy_s / lazy_window_s,
          "lost_records_ms": lazy_lost_us / 1e3, "port_records_and_launches": lazy_records,
          "top_kernels_us_calls": [[k[:90], v, lazy_calls.get(k, 0)] for k, v in
                                   sorted(lazy_by_kernel.items(), key=lambda kv: -kv[1])[:10]],
          "walls_s": walls,
          "inner_steps_per_s": {k: PROFILE_STEPS / (sum(v) / len(v)) for k, v in walls.items()}})

    # 12a-b. The baselines and the rest of the update-rule family.
    solver_launches = solver_paths(torch, ops, data, bd8, loss, reg, cfg_preset.eta, obj_init)

    # 13. The dense-layout step: the composed step of tests/test_kernels.py:159
    # at full width.  Block 0 densified: D[id, row] holds the row's values at
    # that local id, its repeated ids coalesced on the host first (flat
    # order, np.add.at), so the device scatter has no duplicates and D is
    # deterministic.  Then a snapshot held across layouts, and K inner steps
    # from the same w and z in the dense layout (margins_dense on column i,
    # loss_and_grad, svrg_dense_update) and in BlockCSR (sparse_margins on
    # row i, loss_and_grad, fused_block_update).
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 is on: the plain products would not be float32")
    t0 = time.perf_counter()
    flat_ids = idx0.cpu().numpy().astype(np.int64)
    keys = (flat_ids * n + np.arange(n, dtype=np.int64)[:, None]).reshape(-1)
    uniq, inverse = np.unique(keys, return_inverse=True)
    sums = np.zeros(uniq.shape, dtype=np.float32)
    np.add.at(sums, inverse.reshape(-1), val0.cpu().numpy().reshape(-1))
    entry_keys = torch.from_numpy(uniq).to(dev)
    entry_vals = torch.from_numpy(sums).to(dev)
    entry_ids, entry_rows = entry_keys // n, entry_keys % n
    D = torch.zeros((d0, n), dtype=torch.float32, device=dev)
    D.view(-1)[entry_keys] = entry_vals
    torch.cuda.synchronize()
    densify_s = time.perf_counter() - t0
    w_blk = res.w[:d0].contiguous()
    labels = bd8.labels
    lam, eta_d = reg.lam, cfg.eta
    step_rows = draw_samples(np.random.default_rng(SEED + 3), n, DENSE_STEPS, 1)[:, 0].tolist()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    s0 = ops.margins_dense(w_blk, D)
    s0_sparse = ops.sparse_margins(idx0, val0, w_blk)
    loss0, dl0 = ops.loss_and_grad(s0, labels)
    z_d = D @ (dl0 / n)  # plain, as the reference computes it outside any kernel

    def dense_steps(copy_column: bool):
        """The K paired steps from w_blk; each step's column of D is read in
        place (or, for the comparison, copied to a contiguous column first)."""
        w_d, w_s = w_blk, w_blk
        for i in step_rows:
            col = D[:, i:i + 1].contiguous() if copy_column else D[:, i:i + 1]
            _, dl_i = ops.loss_and_grad(ops.margins_dense(w_d, col), labels[i:i + 1])
            g_d = (dl_i[0] - dl0[i]) * col[:, 0]
            w_d = ops.svrg_dense_update(w_d, g_d, z_d, eta=eta_d, lam=lam)
            ri, rv = idx0[i:i + 1], val0[i:i + 1]
            _, dl_r = ops.loss_and_grad(ops.sparse_margins(ri, rv, w_s), labels[i:i + 1])
            w_s = ops.fused_block_update(w_s, ri, rv, dl_r - dl0[i:i + 1], z_d, eta_d, lam=lam)
        return w_d, w_s

    w_dense, w_sparse = dense_steps(False)
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    dense_counts = ops.launch_counts()
    # Paired steps/s with the column read in place and with its copy, in
    # turns (copy, in place, in place, copy), after the counted run.
    step_walls: dict[str, list[float]] = {"in_place": [], "copied": []}
    for copy_column in (True, False, False, True):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        w_again, _ = dense_steps(copy_column)
        torch.cuda.synchronize()
        step_walls["copied" if copy_column else "in_place"].append(time.perf_counter() - t1)
        require(torch.equal(w_again, w_dense), "dense_step: a repeat of the K steps differs")
    dense_expected = expected_launches(
        ops, fd_matvec=1 + DENSE_STEPS, logistic_grad=1 + 2 * DENSE_STEPS,
        svrg_update=DENSE_STEPS, fused_update=DENSE_STEPS, sparse_margin=1 + DENSE_STEPS)
    margin_scale = torch.sum(torch.abs(w_blk[idx0] * val0), dim=-1)
    margin_err = torch.abs(s0 - s0_sparse)
    margin_ratio = float(torch.max(margin_err / torch.clamp_min(DENSE_MARGIN_RTOL * margin_scale,
                                                                1e-30)))
    loss_ref, dloss_ref = loss.value(s0, labels), loss.dvalue(s0, labels)
    loss_err = max(float(torch.max(torch.abs(a - b) / (LOSS_RTOL + LOSS_RTOL * torch.abs(b))))
                   for a, b in ((loss0, loss_ref), (dl0, dloss_ref)))
    w_gap = float(torch.max(torch.abs(w_dense - w_sparse)))
    w_scale = float(torch.max(torch.abs(w_sparse)))
    w_moved = float(torch.max(torch.abs(w_dense - w_blk)))
    emit({"phase": "dense_step", "entry": "ops.margins_dense / loss_and_grad / "
          "svrg_dense_update vs ops.sparse_margins / loss_and_grad / fused_block_update",
          "block": 0, "d_block": d0, "N": n, "D_elements": d0 * n, "lam": lam, "eta": eta_d,
          "steps": DENSE_STEPS, "stored_entries": int(keys.size),
          "distinct_entries": int(uniq.size), "densify_s": densify_s,
          "snapshot_margin_max_abs_err": float(margin_err.max()),
          "snapshot_margin_err_over_tol": margin_ratio,
          "loss_err_over_tol": loss_err, "w_max_abs_gap": w_gap, "w_max_abs": w_scale,
          "w_max_abs_moved": w_moved,
          "tolerance": f"margins |d| <= {DENSE_MARGIN_RTOL:g} * sum|w[idx]*val|; loss rtol = "
                       f"atol = {LOSS_RTOL:g}; w |d| <= {DENSE_STEP_W_RTOL:g} * max|w|",
          "launches": dense_counts, "expected_launches": dense_expected,
          "wall_s": dense_wall, "steps_per_s_both_twins": DENSE_STEPS / dense_wall,
          "steps_per_s_both_twins_in_turns": {
              k: [DENSE_STEPS / t for t in v] for k, v in step_walls.items()}})
    require(bool(torch.all(torch.isfinite(w_dense))) and w_moved > 0.0,
            "dense_step: w not finite or not moved")
    require(margin_ratio <= 1.0, f"dense_step: snapshot margins {margin_ratio} of tolerance")
    require(loss_err <= 1.0, f"dense_step: loss_and_grad vs the logistic loss {loss_err}")
    require(w_gap <= DENSE_STEP_W_RTOL * w_scale, f"dense_step: w gap {w_gap} of {w_scale}")
    require(dense_counts == dense_expected, f"dense_step launches {dense_counts} != {dense_expected}")

    # 14. The dense-layout kernels vs plain, at the shapes the step gives
    # them and at kdd2010's N and d.
    dense_rows = {}

    def dense_check(kernel, shape, got, want, tol, fn, plain_fn, library_fn, iters, nbytes,
                    flops, exact=False, **extra):
        err = torch.abs(got - want)
        ratio = 0.0 if exact else float(torch.max(err / torch.clamp_min(tol, 1e-30)))
        ok = bool(torch.equal(got, want)) if exact else bool(torch.all(err <= tol))
        b_ms, b_by = bound_ms(nbytes, flops)
        row = {"phase": "kernel_check", "kernel": kernel, "shape": shape,
               "max_abs_err": float(err.max()), "max_err_over_tol": ratio,
               "bitwise": bool(torch.equal(got, want)), **extra,
               "kernel_ms": device_ms(torch, fn, iters),
               "plain_ms": device_ms(torch, plain_fn, iters),
               "library_ms": None if library_fn is None else device_ms(torch, library_fn, iters),
               "host_ms": host_ms(torch, fn, iters), "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        require(ok, f"{kernel} {shape}: {row}")
        dense_rows[(kernel, shape)] = row

    def matvec_check(shape, w, data, scale, library, iters):
        got = matvec_mod.fd_matvec(w, data)
        require(torch.equal(got, matvec_mod.fd_matvec(w, data)), f"fd_matvec {shape}: not deterministic")
        rows_d, cols = data.shape
        # A second clock beside the profiler's: CUDA events around calls back
        # to back, the kernel and the library call in turns (k, l, l, k), and
        # the kernel records the profiler keeps per call.
        turns: dict[str, list[float]] = {"kernel": [], "library": []}
        for which in ("kernel", "library", "library", "kernel") if library else ("kernel",):
            fn = (lambda: matvec_mod.fd_matvec(w, data)) if which == "kernel" else \
                (lambda: torch.mv(data.t(), w))
            turns[which].append(host_ms(torch, fn, iters))
        seen: list[float] = []
        device_ms(torch, lambda: matvec_mod.fd_matvec(w, data), iters, kernels_seen=seen)
        nbytes = data.element_size() * (rows_d * cols + rows_d) + 4 * cols
        dense_check("fd_matvec", shape, got, matvec_mod.fd_matvec_plain(w, data),
                    MATVEC_RTOL * scale,
                    lambda: matvec_mod.fd_matvec(w, data),
                    lambda: matvec_mod.fd_matvec_plain(w, data),
                    (lambda: torch.mv(data.t(), w)) if library else None,
                    iters, nbytes, 2.0 * rows_d * cols, dtype=str(data.dtype).split(".")[1],
                    row_stride=data.stride(0), event_ms_in_turns=turns,
                    profiled_kernels_per_call=seen[0],
                    geometry=dict(zip(("vec", "tx", "slice_rows"), matvec_mod.geometry(
                        rows_d, cols, data.stride(0), data.data_ptr(), data.element_size(), sms))),
                    tolerance=f"|d| <= {MATVEC_RTOL:g} * sum_k |w_k * D_kn|")

    # sum_k |w_k * D_kn| from the coalesced entries (D's nonzeros), so no
    # |D| of block size is allocated.
    col_scale = torch.zeros(n, device=dev).index_add_(
        0, entry_rows, torch.abs(w_blk[entry_ids] * entry_vals))
    matvec_check(f"block 0 f32 [{d0} x {n}]", w_blk, D, col_scale, True, 10)
    i0 = step_rows[0]
    col0 = D[:, i0:i0 + 1]  # read in place, row stride N, as the dense step does
    matvec_check(f"step f32 [{d0} x 1]", w_blk, col0, col_scale[i0:i0 + 1], True, 200)
    D_bf16 = D.to(torch.bfloat16)
    del D, col0, z_d
    torch.cuda.empty_cache()
    w_bf16 = w_blk.to(torch.bfloat16)
    col_scale_bf16 = torch.zeros(n, device=dev).index_add_(
        0, entry_rows, torch.abs(w_bf16[entry_ids].float() * entry_vals.to(torch.bfloat16).float()))
    matvec_check(f"block 0 bf16 [{d0} x {n}]", w_bf16, D_bf16, col_scale_bf16, False, 10)
    del D_bf16
    torch.cuda.empty_cache()

    big = torch.from_numpy(rng.normal(0.0, 3.0, size=KDD2010_N).astype(np.float32)).to(dev)
    big_y = torch.from_numpy(np.where(rng.random(KDD2010_N) < 0.5, -1.0, 1.0)
                             .astype(np.float32)).to(dev)
    # The step shape N = 1 is the first dense step's: the margin of column i0
    # at w_blk (that step's w) and its label.  It is 2K of the path's 1 + 2K
    # launches.
    both_dtypes = (torch.float32, torch.bfloat16)
    for label, s_in, y_in, dtypes in (("snapshot N", s0, labels, both_dtypes),
                                      ("kdd2010 N", big, big_y, both_dtypes),
                                      ("step N", s0[i0:i0 + 1], labels[i0:i0 + 1],
                                       (torch.float32,))):
        for dtype in dtypes:
            s_t, y_t = s_in.to(dtype), y_in.to(dtype)
            got = logistic_mod.logistic_grad(s_t, y_t)
            want = logistic_mod.logistic_grad_plain(s_t, y_t)
            tol = [LOSS_ULPS * ulp(torch, torch.clamp_min(torch.abs(v), 1.0)) for v in want]
            both = (torch.cat(got), torch.cat(want), torch.cat(tol))
            size = s_t.numel()
            dense_check("logistic_grad", f"{label} = {size} {str(dtype).split('.')[1]}", *both,
                        lambda: logistic_mod.logistic_grad(s_t, y_t),
                        lambda: logistic_mod.logistic_grad_plain(s_t, y_t), None,
                        200 if size < 10**6 else 20, size * (2 * s_t.element_size() + 8),
                        10.0 * size,
                        tolerance=f"|d| <= {LOSS_ULPS} ulp of max(|plain|, 1), both outputs")
    del big, big_y

    for size in (d0, KDD2010_D):
        vecs = [torch.from_numpy(rng.normal(0.0, 0.1, size=size).astype(np.float32)).to(dev)
                for _ in range(3)]
        for lam_c in (1e-4, 0.0):
            got = svrg_mod.svrg_update(*vecs, eta_d, lam_c)
            dense_check("svrg_update", f"d = {size}, lam = {lam_c:g}", got,
                        svrg_mod.svrg_update_plain(*vecs, eta_d, lam_c), None,
                        lambda: svrg_mod.svrg_update(*vecs, eta_d, lam_c),
                        lambda: svrg_mod.svrg_update_plain(*vecs, eta_d, lam_c), None,
                        200 if size < 10**6 else 20, 16 * size, 5.0 * size, exact=True,
                        tolerance="bitwise")
    del vecs

    for u_ck in (1, 8, 64):
        if u_ck == 64:
            idx, val, coef = idx0[sampled64], val0[sampled64], coef64
        else:
            idx, val = idx0[sampled[:u_ck]], val0[sampled[:u_ck]]
            coef = torch.from_numpy(rng.normal(0.0, 0.5, size=u_ck).astype(np.float32)).to(dev)
        g_abs = torch.zeros(d0, device=dev).index_add_(
            0, idx.reshape(-1).long(), torch.abs(val * coef[:, None]).reshape(-1))
        # lam = 1e-4 is l2's smooth strength, lam = 0 that of l1, elastic_net
        # and none (the kernel has no prox stages).
        for lam_c in (1e-4, 0.0):
            for case, eta_c in (("unmasked", eta), ("masked", 0.0)):
                args = (w0, idx, val, coef, z0, eta_c, lam_c)
                got = fused_mod.fused_update(*args)
                same_prox = bool(torch.equal(got, prox_mod.prox_update(*args, 0.0, 0.0)))
                require(same_prox, f"fused_update u={u_ck} lam={lam_c} {case}: != prox_update")
                want = fused_mod.fused_update_plain(*args)
                cpu_bits = bitwise_vs_cpu(got, fused_mod.fused_update_plain(*cpu_args(args)))
                require(cpu_bits, f"fused_update u={u_ck} lam={lam_c} {case}: not bitwise "
                                  f"the CPU plain version")
                entries = idx.numel()
                dense_check("fused_update", f"block 0, u = {u_ck}, lam = {lam_c:g}, {case}", got,
                            want, LAZY_ATOL + LAZY_RTOL * (
                                torch.abs(w0) + torch.abs(want) + eta_c * (
                                    g_abs + torch.abs(z0) + lam_c * torch.abs(w0))),
                            lambda: fused_mod.fused_update(*args),
                            lambda: fused_mod.fused_update_plain(*args), None, 200,
                            12 * d0 + 8 * entries + 4 * u_ck, 5.0 * d0 + 2.0 * entries,
                            equals_prox_update_kernel=same_prox,
                            bitwise_vs_cpu_plain=cpu_bits,
                            n_differ=int(torch.count_nonzero(got != want)),
                            tolerance=f"bitwise vs prox_update(lam1 = lam2 = 0); vs plain "
                                      f"|d| <= {LAZY_ATOL:g} + {LAZY_RTOL:g} * (|w| + |plain| "
                                      f"+ eta * (|g| + |z| + lam * |w|))")

    # 15. LM serving (qwen3-14b at full width): first flash_decode against
    # its plain version, then the serving entry point's two shapes, each with a
    # plain twin.  The FD-SVRG phases' large tensors are gone; release the
    # cache so the 29.5 GB of weights and the prefill find room.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "lm_settings", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    decode_rows = {}

    def decode_check(label, q, k, v, length, iters):
        """q [B, Hkv, G, Dh], k/v [B, S, Hkv, Dh] on the card."""
        b_, hkv_, g_, dh_ = q.shape
        scale = dh_ ** -0.5
        got = decode_mod.flash_decode(q, k, v, length, scale)
        require(torch.equal(got, decode_mod.flash_decode(q, k, v, length, scale)),
                f"flash_decode {label}: not deterministic")
        want = decode_mod.flash_decode_plain(q, k, v, length, scale)
        vmax = float(torch.max(torch.abs(v[:, :length].float())))
        err = float(torch.max(torch.abs(got - want)))
        tol = FLASH_RTOL * vmax
        # The yardstick: one SDPA call over the valid prefix (k, v moved to
        # [B, Hkv, L, Dh] outside the timed call).
        qs = q.reshape(b_, hkv_ * g_, 1, dh_)
        ks = k[:, :length].transpose(1, 2).contiguous()
        vs = v[:, :length].transpose(1, 2).contiguous()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, scale=scale,
                                                                    enable_gqa=True)

        lib_err = float(torch.max(torch.abs(library().float().reshape(got.shape) - want)))
        elt = q.element_size()
        b_ms, b_by = bound_ms(2 * b_ * length * hkv_ * dh_ * elt + b_ * hkv_ * g_ * dh_ * (elt + 4),
                              4.0 * b_ * hkv_ * g_ * length * dh_)
        row = {"phase": "kernel_check", "kernel": "flash_decode", "shape": label,
               "B": b_, "Hkv": hkv_, "group": g_, "Dh": dh_, "S": k.shape[1], "length": length,
               "dtype": str(q.dtype).split(".")[1],
               "splits": list(decode_mod.num_splits(b_ * hkv_, length, sms)),
               "max_abs_err": err, "max_err_over_tol": err / tol,
               "tolerance": f"|d| <= {FLASH_RTOL:g} * max|v[:length]|",
               "library_max_abs_err": lib_err, "l2": "cold",
               "kernel_ms": device_ms(torch, lambda: decode_mod.flash_decode(q, k, v, length, scale),
                                      iters, flush),
               "plain_ms": device_ms(torch, lambda: decode_mod.flash_decode_plain(
                   q, k, v, length, scale), max(3, iters // 10), flush),
               "library_ms": device_ms(torch, library, iters, flush),
               "host_ms": host_ms(torch, lambda: decode_mod.flash_decode(q, k, v, length, scale),
                                  iters),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        require(err <= tol, f"flash_decode {label}: {row}")
        decode_rows[label] = row
        del ks, vs

    gen_d = torch.Generator(dev)
    gen_d.manual_seed(SEED)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen_d, device=dev).to(dtype)

    qwen = get_config("qwen3-14b")
    q_hkv, q_group, q_dh = qwen.num_kv_heads, qwen.num_heads // qwen.num_kv_heads, qwen.head_dim
    for b_, length in ((1, 1), (1, 700), (1, 32_768), (4, 1), (4, 528), (4, 700), (4, 32_768),
                       (1, 524_288)):
        s_ = length if length == 524_288 else length + 16
        q = randn((b_, q_hkv, q_group, q_dh), torch.bfloat16)
        k, v = (randn((b_, s_, q_hkv, q_dh), torch.bfloat16) for _ in range(2))
        decode_check(f"qwen3-14b B = {b_}, length = {length}", q, k, v, length,
                     20 if length > 100_000 else 100)
        del q, k, v
    # The reference test's shapes (tests/test_kernels.py:113-120), one
    # request through ops.decode_attention's B = 1 form.
    for h_, hkv_, dh_, s_, length in ((8, 8, 64, 1024, 1024), (8, 2, 64, 1024, 700),
                                      (16, 4, 128, 2048, 1), (4, 1, 32, 300, 257)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = randn((h_, dh_), dtype), randn((s_, hkv_, dh_), dtype), \
                randn((s_, hkv_, dh_), dtype)
            ops.reset_launch_counts()
            got = ops.decode_attention(q, k, v, length=length)
            require(ops.launch_counts()["flash_decode"] == 1 and got.shape == (h_, dh_),
                    "ops.decode_attention: one launch, [H, Dh] out")
            decode_check(f"H = {h_}, Hkv = {hkv_}, Dh = {dh_}, S = {s_}, length = {length}, "
                         f"{str(dtype).split('.')[1]}", q.reshape(1, hkv_, h_ // hkv_, dh_),
                         k[None], v[None], length, 100)
    torch.cuda.empty_cache()

    def lm_phase(phase, argv, profile_step):
        """Drive repro_torch.launch.serve at full width with exact launch
        counts, then a plain twin fed the kernel run's tokens."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = serve_mod.run(argv)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        cfg_lm = r.cfg
        b_, gen = r.tokens.shape
        want_counts = expected_launches(ops, flash_decode=gen * cfg_lm.num_layers)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finite = all(bool(torch.all(torch.isfinite(lg))) for lg in r.logits)
        ctx_lm = unsharded_ctx()
        plain_step = make_serve_step(cfg_lm, ctx_lm, use_kernels=False)
        # The twin reuses the cache in place: at step i it rewrites position
        # pos0 + i with its own k/v before reading it, and the kernel run's
        # later rows lie past the valid prefix, so it sees what a fresh plain
        # run fed the same tokens would.
        worst, agree = 0.0, 0
        for i in range(gen):
            nxt, lg, _ = plain_step(r.params, r.cache, r.inputs[:, i:i + 1], r.pos0 + i)
            lg = lg[:, 0]
            worst = max(worst, float(torch.max(torch.abs(lg - r.logits[i])))
                        / float(torch.max(torch.abs(lg))))
            agree += int(torch.sum(nxt[:, 0].cpu() == torch.from_numpy(r.tokens[:, i])))
        row = {"phase": phase, "entry": "repro_torch.launch.serve.run", "argv": argv,
               "arch": cfg_lm.name, "d_model": cfg_lm.d_model, "layers": cfg_lm.num_layers,
               "vocab": cfg_lm.vocab_size, "dtype": cfg_lm.dtype,
               "params": cfg_lm.param_count(), "batch": b_, "prompt_len": r.prompt.shape[1],
               "gen": gen, "prefill_s": r.prefill_s, "decode_s": r.decode_s,
               "decode_ms_per_token": r.decode_s / gen * 1e3, "wall_s": wall,
               "peak_memory_gb": peak_gb, "launches": counts, "expected_launches": want_counts,
               "tokens_first_request": r.tokens[0].tolist(), "logits_finite": finite,
               "twin_max_logit_err_over_max_logit": worst,
               "twin_tolerance": f"max|d logits| <= {LM_LOGIT_RTOL:g} * max|logits| per step",
               "twin_argmax_agreement": agree / (b_ * gen)}
        if profile_step:
            from torch.profiler import ProfilerActivity, profile

            step = make_serve_step(cfg_lm, ctx_lm)
            pos = r.pos0 + gen - 1  # re-decodes the last step, rewriting its cache row
            tok = r.inputs[:, -1:]
            step(r.params, r.cache, tok, pos)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(r.params, r.cache, tok, pos)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t0
            by_kernel, calls = device_kernels(torch, prof)
            busy_s = sum(by_kernel.values()) / 1e6
            fd_us = sum(v for k_, v in by_kernel.items() if "flash_decode" in k_)
            fd_launches = ops.launch_counts()["flash_decode"]
            b_ms, _ = bound_ms(2 * b_ * (pos + 1) * cfg_lm.num_kv_heads * cfg_lm.head_dim * 2, 0.0)
            row.update({
                "profile_pos": pos, "profile_step_wall_ms": step_s * 1e3,
                "profile_device_busy_ms": busy_s * 1e3,
                "profile_device_idle_share": 1.0 - busy_s / step_s,
                "flash_decode_launches_in_step": fd_launches,
                "device_kernels_in_step": sum(calls.values()),
                "flash_decode_device_ms_per_launch": fd_us / 1e3 / max(fd_launches, 1),
                "flash_decode_bound_ms": b_ms,
                "top_kernels_us_calls": [[k_[:90], v, calls.get(k_, 0)] for k_, v in
                                         sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]]})
        emit(row)
        require(r.tokens.shape == (b_, gen) and r.tokens.min() >= 0
                and r.tokens.max() < cfg_lm.vocab_size, f"{phase}: tokens {r.tokens}")
        require(finite, f"{phase}: non-finite logits")
        require(counts == want_counts, f"{phase}: launches {counts} != {want_counts}")
        require(worst <= LM_LOGIT_RTOL, f"{phase}: kernel vs plain twin logits {worst}")
        if profile_step:
            require(row["flash_decode_launches_in_step"] == cfg_lm.num_layers,
                    f"{phase}: profiled step launched {row['flash_decode_launches_in_step']}")
        return counts

    lm_phase("lm_serve", ["--arch", "qwen3-14b", "--batch", "4", "--prompt-len", "512",
                          "--gen", "16"], False)
    long_counts = lm_phase("lm_decode_long", ["--arch", "qwen3-14b", "--batch", "1",
                                              "--prompt-len", str(INPUT_SHAPES["decode_32k"].seq_len),
                                              "--gen", "16"], True)
    # The batch-4 run in float32 at 4 layers (11.5 GB of weights): the twin's
    # gap there is the kernel's own, without bfloat16's rounding.
    lm_phase("lm_serve_f32", ["--arch", "qwen3-14b", "--batch", "4", "--prompt-len", "512",
                              "--gen", "16", "--layers", "4", "--dtype", "float32"], False)
    torch.cuda.empty_cache()

    # 16. The kernels line.  Launches: sparse_margin, logistic_grad,
    # block_scatter and prox_update from the dense main path (sparse_margin's,
    # logistic_grad's and lazy_catchup's times at one step over all 8
    # blocks, lazy_flush's at one epoch's flush, their launches on the path), the
    # exact-lazy kernels from the lazy_exact_path
    # run, lazy_proba_update from the lazy_proba_path run, the dense-layout
    # kernels from the dense_step run, flash_decode from lm_decode_long.
    # Times at the main path's shapes (block 0, u = 1, its regularizer,
    # unmasked), the dense step's (block 0's full f32 matrix, one step's
    # N = 1, d_block) and one long decode step's (B = 1, 32,768 positions).
    margin_step = multi_margin_rows[f"step u={u}"]
    snap8 = multi_margin_rows["snapshot R=N"]
    ck_step = step_ck_rows[(f"step m={m_ck}, 8 blocks", u, reg.name, "unmasked")]
    step = prox_rows[(u, reg.name)]
    fd_label = f"qwen3-14b B = 1, length = {INPUT_SHAPES['decode_32k'].seq_len}"
    fd_row = decode_rows[fd_label]
    coef_step = coef_rows[f"step u={u}"]
    flush_row = flush_rows[(reg.name, "unmasked")]

    def by_path(kernel):
        """The kernel's launches on each solver path that launched it."""
        return {m: c[kernel] for m, c in solver_launches.items() if c[kernel]}

    def lazy_entry(name, line, launches, shape):
        row = lazy_rows[(name, u, reg.name, "unmasked")]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/lazy_update.cu",
                "replaces": f"src/repro/kernels/lazy_update.py:{line}",
                "launches": launches, "max_abs_err": row["max_abs_err"],
                "ms": row["kernel_ms"], "host_ms": row["host_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None, "shape": shape}

    def dense_entry(name, line, shape):
        row = dense_rows[(name, shape)]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": f"src/repro/kernels/{name}.py:{line}",
                "launches": dense_counts[name], "launches_by_path": by_path(name),
                "max_abs_err": row["max_abs_err"],
                "ms": row["kernel_ms"], "host_ms": row["host_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": shape}
    emit({"kernels": [
        {"name": "sparse_margin", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_margin.cu",
         "replaces": "src/repro/kernels/sparse_margin.py:56",
         "launches": counts["sparse_margin"],
         "launches_by_path": by_path("sparse_margin"),
         "max_abs_err": max(multi_margin_rows[k]["max_abs_err"] for k in multi_margin_rows),
         "ms": margin_step["kernel_ms"], "host_ms": margin_step["host_ms"],
         "plain_ms": margin_step["plain_ms"], "bound_ms": margin_step["bound_ms"],
         "bound_by": margin_step["bound_by"], "library_ms": margin_step["library_ms"],
         "floor_ms": margin_step["floor_ms"], "per_block_ms": margin_step["per_block_ms"],
         "snapshot_ms": snap8["kernel_ms"], "snapshot_bound_ms": snap8["bound_ms"],
         "snapshot_library_ms": snap8["library_ms"],
         "shape": f"one inner step over 8 blocks, u={u} (the snapshot: R={n})"},
        {"name": "block_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_scatter.cu",
         "replaces": "src/repro/data/block_csr.py:271",
         "tpu_kernel": False,
         "note": "the port's own kernel: the reference's snapshot scatter is a plain "
                 ".at[].add (no pallas_call); one launch for all 8 blocks; library_ms is "
                 "the 8 index_add_ calls",
         "launches": counts["block_scatter"],
         "launches_by_path": by_path("block_scatter"),
         "max_abs_err": max(r["max_abs_err"] for r in scatter_rows),
         "ms": snapshot["kernel_ms"], "host_ms": snapshot["host_ms"],
         "plain_ms": snapshot["plain_ms"], "bound_ms": snapshot["bound_ms"],
         "bound_by": snapshot["bound_by"], "chain_bound_ms": snapshot["chain_bound_ms"],
         "library_ms": snapshot["index_add_ms"],
         "shape": f"one snapshot: 8 blocks, d={data.dim}, R={n}, {snap_terms} terms"},
        {"name": "prox_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/prox_update.cu",
         "replaces": "src/repro/kernels/prox_update.py:84",
         "launches": counts["prox_update"],
         "launches_by_path": by_path("prox_update"), "max_abs_err": step["max_abs_err"],
         "ms": step["kernel_ms"], "host_ms": step["host_ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
         "library_ms": None, "shape": f"inner step block 0: d_l={d0}, u={u}, {reg.name}"},
        {"name": "lazy_catchup", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lazy_update.cu",
         "replaces": "src/repro/kernels/lazy_update.py:125",
         "launches": lazy_counts["lazy_catchup"],
         "max_abs_err": max(r["max_abs_err"] for r in step_ck_rows.values()),
         "ms": ck_step["kernel_ms"], "host_ms": ck_step["host_ms"],
         "plain_ms": ck_step["plain_ms"], "bound_ms": ck_step["bound_ms"],
         "bound_by": ck_step["bound_by"], "chain_bound_ms": ck_step["chain_bound_ms"],
         "per_block_ms": ck_step["per_block_ms"], "library_ms": None,
         "shape": f"one step over 8 blocks, u={u}, m={m_ck} after a {m_ck}-step epoch, "
                  f"{reg.name} (bitwise the CPU)"},
        lazy_entry("lazy_touch_update", 177, lazy_counts["lazy_touch_update"],
                   f"block 0: d_l={d0}, u={u}, {reg.name}"),
        {"name": "lazy_flush", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lazy_update.cu",
         "replaces": "src/repro/kernels/lazy_update.py:224",
         "launches": lazy_counts["lazy_flush"],
         "max_abs_err": max(r["max_abs_err"] for r in flush_rows.values()),
         "ms": flush_row["kernel_ms"], "host_ms": flush_row["host_ms"],
         "plain_ms": flush_row["plain_ms"], "bound_ms": flush_row["bound_ms"],
         "bound_by": flush_row["bound_by"], "issue_bound_ms": flush_row["issue_bound_ms"],
         "per_block_ms": flush_row["per_block_ms"], "library_ms": None,
         "block0_ms": lazy_rows[("lazy_flush", u, reg.name, "unmasked")]["kernel_ms"],
         "shape": f"one epoch's flush over all 8 blocks, d={data.dim}, after a {m_ck}-step "
                  f"epoch, {reg.name} (bitwise 8 one-block launches and the CPU)"},
        lazy_entry("lazy_proba_update", 266, proba_counts["lazy_proba_update"],
                   f"block 0: d_l={d0}, u={u}, {reg.name}"),
        dense_entry("fused_update", 73, f"block 0, u = {u}, lam = {reg.lam:g}, unmasked"),
        dense_entry("fd_matvec", 61, f"block 0 f32 [{d0} x {n}]"),
        {"name": "logistic_grad", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/logistic_grad.cu",
         "replaces": "src/repro/kernels/logistic_grad.py:46",
         "launches": counts["logistic_grad"],
         "launches_by_path": by_path("logistic_grad"),
         "max_abs_err": max(r["max_abs_err"] for r in coef_rows.values()),
         "ms": coef_step["kernel_ms"], "host_ms": coef_step["host_ms"],
         "plain_ms": coef_step["plain_ms"], "plain_host_ms": coef_step["plain_host_ms"],
         "bound_ms": coef_step["bound_ms"], "bound_by": coef_step["bound_by"],
         "floor_ms": coef_step["floor_ms"], "library_ms": None,
         "snapshot_ms": coef_rows["snapshot R=N"]["kernel_ms"],
         "snapshot_bound_ms": coef_rows["snapshot R=N"]["bound_ms"],
         "dense_step_launches": dense_counts["logistic_grad"],
         "dense_step_ms": dense_rows[("logistic_grad", "step N = 1 float32")]["kernel_ms"],
         "shape": f"one step's coefficients, u={u} (the snapshot's: R={n}); bitwise the "
                  f"PyTorch chain"},
        dense_entry("svrg_update", 49, f"d = {d0}, lam = {reg.lam:g}"),
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:97",
         "launches": long_counts["flash_decode"], "max_abs_err": fd_row["max_abs_err"],
         "ms": fd_row["kernel_ms"], "host_ms": fd_row["host_ms"], "plain_ms": fd_row["plain_ms"],
         "bound_ms": fd_row["bound_ms"], "bound_by": fd_row["bound_by"],
         "library_ms": fd_row["library_ms"], "shape": fd_label + " (Hkv 8, group 5, Dh 128, bf16)"},
    ]})
    print(card, flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
