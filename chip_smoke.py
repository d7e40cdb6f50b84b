#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
FD-SVRG main path (full-width news20, q = 8), drives that main path
through ``run_fdsvrg(use_kernels=True)`` with exact meter and
launch-count checks, compares a short run with the plain path, runs the
serial path, and scores the trained ``w`` through the margin kernel.
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

# Main-path run: the fdsvrg-news20 preset at full width, depth cut to a
# few steps (the paper's M is N = 19,954 inner steps per outer).
Q = 8
OUTERS = 2
INNER_STEPS = 2000
PLAIN_CHECK_STEPS = 500
PROFILE_STEPS = 500
SEED = 0

# Stated tolerances.
MARGIN_RTOL = 1e-6  # |kernel - plain| <= 1e-6 * sum_k |w[idx] * val| per row
PROX_ATOL, PROX_RTOL = 1e-7, 1e-6  # |kernel - plain| <= atol + rtol * |plain|
# Kernel path vs plain path on the card: the two sum margins in different
# orders and the snapshot's index_add_ adds with atomics, so the two
# trajectories drift apart by rounding; w is held relative to its scale.
RUN_RTOL, RUN_W_RTOL = 1e-5, 1e-3


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def device_kernel_us(torch, prof) -> dict[str, float]:
    """Device time (us) of each kernel name in a profile, memory copies
    left out (the L2 flush is a device-to-device copy)."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy"):
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total
    return out


def device_ms(torch, fn, iters: int, flush=None) -> float:
    """Mean device time per call: the kernels ``fn`` launches, summed from
    a torch.profiler (CUPTI) trace after warm-up.  With ``flush`` (a copy
    that overwrites the 50 MB L2) before each call, the cache is cold, as
    the snapshot finds it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    total = sum(device_kernel_us(torch, prof).values())
    require(total > 0.0, "the profiler recorded no device time")
    return total / iters / 1e3


def first_difference(torch, got, want, w, z) -> dict | None:
    """Where a kernel and its plain version first disagree, with inputs."""
    where = torch.nonzero(got != want).flatten()
    if where.numel() == 0:
        return None
    j = int(where[0])
    return {"index": j, "kernel": float(got[j]), "plain": float(want[j]),
            "w": float(w[j]), "z": float(z[j])}


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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

    from repro_torch.configs.fdsvrg_linear import CONFIGS
    from repro_torch.core import losses
    from repro_torch.core.driver import objective_from_margins
    from repro_torch.core.fdsvrg import SVRGConfig, run_fdsvrg, run_serial_svrg
    from repro_torch.core.partition import balanced
    from repro_torch.data import datasets
    from repro_torch.data.block_csr import BlockCSR
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import prox_update as prox_mod
    from repro_torch.kernels import sparse_margin as margin_mod

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
    bd8 = BlockCSR.from_padded(data, part8).to(dev)
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

    prox_rows = {}
    eta = float(np.float32(cfg_preset.eta))
    settings = {
        "l2": (1e-4, 0.0, 0.0),
        "l1": (0.0, 1e-5, 0.0),
        "elastic_net": (0.0, 1e-5, 1e-4),
        "none": (0.0, 0.0, 0.0),
    }
    z0 = torch.from_numpy(rng.normal(0.0, 1e-3, size=d0).astype(np.float32)).to(dev)
    for u in (1, 8):
        idx, val = idx0[sampled[:u]], val0[sampled[:u]]
        coef = torch.from_numpy(rng.normal(0.0, 0.5, size=u).astype(np.float32)).to(dev)
        for reg_name, (lam, lam1, lam2) in settings.items():
            args = (w0, idx, val, coef, z0, eta, lam, lam1, lam2)
            got = prox_mod.prox_update(*args)
            want = prox_mod.prox_update_plain(*args)
            err = torch.abs(got - want)
            ok = bool(torch.all(err <= PROX_ATOL + PROX_RTOL * torch.abs(want)))
            torch.cuda.synchronize()
            require(ok, f"prox_update u={u} {reg_name}: max error {float(err.max())}")
            entries = idx.numel()
            flops = (5.0 + (4.0 if lam1 or lam2 else 0.0) + (1.0 if lam2 else 0.0)) * d0 \
                + 2.0 * entries
            b_ms, b_by = bound_ms(3 * d0 * 4 + entries * 8 + u * 4, flops)
            row = {
                "phase": "kernel_check", "kernel": "prox_update", "u": u, "reg": reg_name,
                "d_block": d0, "nnz_l": idx.shape[1],
                "max_abs_err": float(err.max()), "bitwise": bool(torch.equal(got, want)),
                "n_differ": int(torch.count_nonzero(got != want)),
                # index_add_ adds repeated ids with atomics, in an order that
                # can change from run to run; the kernel adds in flat order.
                "max_id_repeats": int(torch.unique(idx[val != 0], return_counts=True)[1].max()),
                "first_differ": first_difference(torch, got, want, w0, z0),
                "tolerance": f"|d| <= {PROX_ATOL:g} + {PROX_RTOL:g} * |plain|",
                "l2": "warm",
                "kernel_ms": device_ms(torch, lambda: prox_mod.prox_update(*args), 200),
                "plain_ms": device_ms(torch, lambda: prox_mod.prox_update_plain(*args), 200),
                "host_ms": host_ms(torch, lambda: prox_mod.prox_update(*args), 200),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            }
            emit(row)
            prox_rows[(u, reg_name)] = row

    # 4. The main path: run_fdsvrg at q = 8 through both kernels.
    loss = losses.LOSSES[cfg_preset.loss]
    reg = cfg_preset.regularizer()
    u = cfg_preset.batch_size
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
    expected_counts = {
        "sparse_margin": Q * (OUTERS + 1) + Q * INNER_STEPS * OUTERS,
        "prox_update": Q * INNER_STEPS * OUTERS,
    }
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_fdsvrg(None, part8, loss, reg, window, block_data=bd8)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    by_kernel = device_kernel_us(torch, prof)
    busy_s = sum(by_kernel.values()) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "main_path_profile", "inner_steps": PROFILE_STEPS, "outers": 1,
          "note": "one outer = 2 snapshots + the inner steps; profiler running (CUDA activity)",
          "wall_s": window_s, "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / window_s,
          "top_kernels_us": [[k[:90], v] for k, v in top]})

    # 5. A short run against the plain path on the card.
    short = SVRGConfig(eta=cfg_preset.eta, inner_steps=PLAIN_CHECK_STEPS, outer_iters=1,
                       batch_size=u, seed=SEED)
    k_run = run_fdsvrg(None, part8, loss, reg, short, block_data=bd8, use_kernels=True)
    p_run = run_fdsvrg(None, part8, loss, reg, short, block_data=bd8, use_kernels=False)
    ko, po = k_run.objectives(), p_run.objectives()
    w_err = float(torch.max(torch.abs(k_run.w - p_run.w)))
    w_scale = float(torch.max(torch.abs(p_run.w)))
    obj_rel = float(np.max(np.abs(ko - po) / np.abs(po)))
    emit({"phase": "plain_path_check", "inner_steps": PLAIN_CHECK_STEPS, "outers": 1,
          "objective_kernels": ko.tolist(), "objective_plain": po.tolist(),
          "objective_rel_err": obj_rel, "w_max_abs_err": w_err, "w_max_abs": w_scale,
          "tolerance": f"objective rtol {RUN_RTOL:g}, max|dw| <= {RUN_W_RTOL:g} * max|w|"})
    require(obj_rel <= RUN_RTOL and w_err <= RUN_W_RTOL * w_scale,
            f"kernel path vs plain path: objective rel {obj_rel}, w {w_err} of {w_scale}")

    # 6. The serial path (q = 1, row width 455).
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ser = run_serial_svrg(None, loss, reg, short, block_data=bd1, use_kernels=True)
    torch.cuda.synchronize()
    ser_counts = ops.launch_counts()
    ser_expected = {"sparse_margin": 2 + PLAIN_CHECK_STEPS, "prox_update": PLAIN_CHECK_STEPS}
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
    require(serve_counts == {"sparse_margin": 1, "prox_update": 0}, "serving launches")
    require(acc > 0.5 and abs(acc - acc_plain) <= 1.0 / n + 1e-12,
            f"serving accuracy {acc} (plain {acc_plain})")

    # 8. The kernels line (main-path launches; times at main-path shapes).
    snap = margin_rows["snapshot R=N"]
    step = prox_rows[(u, reg.name)]
    emit({"kernels": [
        {"name": "sparse_margin", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_margin.cu",
         "replaces": "src/repro/kernels/sparse_margin.py:56",
         "launches": counts["sparse_margin"], "max_abs_err": snap["max_abs_err"],
         "ms": snap["kernel_ms"], "host_ms": snap["host_ms"], "plain_ms": snap["plain_ms"],
         "bound_ms": snap["bound_ms"], "bound_by": snap["bound_by"],
         "library_ms": snap["library_ms"], "shape": f"snapshot block 0: R={n}, nnz_l={snap['nnz_l']}"},
        {"name": "prox_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/prox_update.cu",
         "replaces": "src/repro/kernels/prox_update.py:84",
         "launches": counts["prox_update"], "max_abs_err": step["max_abs_err"],
         "ms": step["kernel_ms"], "host_ms": step["host_ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
         "library_ms": None, "shape": f"inner step block 0: d_l={d0}, u={u}, {reg.name}"},
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
