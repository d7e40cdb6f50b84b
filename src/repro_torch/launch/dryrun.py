"""Multi-pod dry-run: trace every (arch x input-shape x mesh) combination
against the production meshes with shape-only tensors, and record per-device
FLOPs, bytes, collectives and peak memory for the roofline tables.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
step with XLA against 256 or 512 forced host devices and reads XLA's
analyses; nothing of that exists for PyTorch, so each piece has a stand-in:

* devices: a fake process group of 256 / 512 ranks in one process
  (:mod:`repro_torch.launch.mesh`); this process is rank 0 and traces what
  rank 0 does, every rank doing the same work in an SPMD step;
* state and inputs: ``meta`` tensors (shapes and dtypes, no storage) laid
  out as DTensors by the mesh rules (``state_specs``, ``param_specs``,
  ``cache_specs``, the batch split along the batch axes), so the tool runs
  here and on a card's host alike and never touches a card (the FD-SVRG
  outer's rank-local block is small, and is host zeros);
* the step: the port's own ``make_train_step`` / ``prefill`` /
  ``make_serve_step``, run eagerly on those DTensors.  No kernel runs on a
  shape-only tensor, so the steps take their plain versions
  (``use_kernels=False`` for decode), as the reference's dry-run lowers its
  ``jnp`` path; every result says ``"kernels": false``;
* per-device FLOPs: counted on each rank's LOCAL shapes
  (:class:`repro_torch.launch.roofline.DeviceCount`; a count at the DTensor
  level would see global shapes);
* per-device bytes: the sum of each local op's input and output bytes, an
  eager, unfused count, so above XLA's;
* memory analysis: ``torch.distributed._tools.mem_tracker.MemTracker``'s
  peak by category on the rank, on the device that holds its shards;
* collectives: every collective the rank issues, at its output bytes by
  kind, and the implicit ones (DTensor's redistributes to run an op) by
  the port's code that caused them.

Depth: the LM combos are traced at 1 and 2 repeats of the pattern and the
counts, collectives and peak memory extrapolated linearly to the full
depth (``_ROOFLINE_DEPTHS``; an eager trace's counts are exactly linear in
depth), with the real grad-accumulation.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--multi-pod | --both-meshes]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fdsvrg
Results land in results/torch_dryrun/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch.inputs import (
    decode_token_specs,
    prefill_batch_specs,
    train_batch_specs,
)
from repro_torch.launch.mesh import chips, fake_world, make_production_mesh, make_test_mesh
from repro_torch.models import transformer
from repro_torch.optim.optimizers import adamw, tree_leaves, tree_map
from repro_torch.sharding.specs import ShardingCtx, distribute, spec_placements
from repro_torch.train.loop import TrainSettings, init_state, make_train_step, state_specs
from repro_torch.train.serve import make_serve_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "torch_dryrun")

# per-arch gradient-accumulation (microbatching) for train_4k at global
# batch 256, the reference's; each result reports the per-card peak this
# gives against the H100's 80 GB
GRAD_ACCUM = {
    "qwen3-14b": 8, "jamba-v0.1-52b": 8, "gemma2-9b": 8,
    "minitron-4b": 4, "paligemma-3b": 4, "musicgen-large": 4,
    "mamba2-2.7b": 4, "olmoe-1b-7b": 4,
    "smollm-360m": 2, "granite-moe-1b-a400m": 2,
}

# pure full-attention archs skip long_500k
LONG_CONTEXT_ARCHS = {a for a, c in ARCHS.items() if c.supports_long_context}

# depth pair of the linear extrapolation (counts are exactly linear in depth)
_ROOFLINE_DEPTHS = (1, 2)


def _rules_overrides(shape: InputShape) -> dict:
    if shape.name == "long_500k":
        # batch=1: retire the batch axes, spread the KV cache over data+model
        return {"batch": None, "seq_kv": ("data", "model")}
    return {}


def _batch_shardings(cfg, mesh, ctx: ShardingCtx, batch_specs: dict, grad_accum: int) -> dict:
    """Each input's placements: split along the batch axes (after the
    microbatch axis when ``grad_accum`` > 1), the rest replicated."""
    lead = (None,) if grad_accum > 1 else ()

    def names_for(key: str, rank: int):
        body = {
            "tokens": ("batch", None, None),
            "labels": ("batch", None, None),
            "patch_embeds": ("batch", None, None),
        }[key]
        return lead + body[: rank - len(lead)]

    return {k: spec_placements(mesh, ctx.spec(*names_for(k, v.dim())))
            for k, v in batch_specs.items()}


def _meta(tree):
    """A nest's shapes and dtypes as ``meta`` tensors."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _abstract(make):
    """``make()``'s nest as ``meta`` tensors: built under
    ``FakeTensorMode``, so nothing of model size is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = make()
    return _meta(tree)


def _lay_out_batch(batch: dict, placements: dict, mesh) -> dict:
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(v, mesh, placements[k]) for k, v in batch.items()}


def _trace_combo(cfg: ModelConfig, shape: InputShape, mesh, ctx: ShardingCtx,
                 grad_accum: int) -> dict:
    """Build the right step for one combo on shape-only DTensors and run it
    once under the counters: rank 0's counts and memory peak."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    if shape.kind == "train":
        opt = adamw(3e-4)
        state = _abstract(lambda: init_state(cfg, 0, opt, tp, device="cpu"))
        inputs = distribute(state, state_specs(state, cfg, ctx), mesh)
        batch = train_batch_specs(cfg, shape, grad_accum)
        batch = _lay_out_batch(batch, _batch_shardings(cfg, mesh, ctx, batch, grad_accum),
                               mesh)
        step = make_train_step(cfg, ctx, opt, TrainSettings(grad_accum=grad_accum))

        def run():
            return step(inputs, batch)
    else:
        params = _abstract(lambda: transformer.init_params(cfg, 0, "cpu", tp))
        inputs = distribute(params, transformer.param_specs(params, cfg, ctx, zero1=False),
                            mesh)
        if shape.kind == "prefill":
            batch = prefill_batch_specs(cfg, shape)
            batch = _lay_out_batch(batch, _batch_shardings(cfg, mesh, ctx, batch, 1), mesh)

            def run():
                return transformer.prefill(inputs, cfg, batch, shape.seq_len, ctx)
        else:
            # laid out by cache_specs, each rank's shard on meta
            cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len, ctx,
                                           device="meta")
            tok = decode_token_specs(cfg, shape)
            names = ("batch",) + (None,) * (tok.dim() - 1)
            tok = _lay_out_batch({"t": tok}, {"t": spec_placements(mesh, ctx.spec(*names))},
                                 mesh)["t"]
            serve_step = make_serve_step(cfg, ctx, use_kernels=False)

            def run():
                return serve_step(inputs, cache, tok, shape.seq_len - 1)

    count = roofline_lib.DeviceCount()
    mem = MemTracker()
    mem.track_external(*tree_leaves(inputs))
    t0 = time.time()
    with mem, count:
        run()
    return {"count": count.as_dict(), "peak_bytes": _peak(mem),
            "trace_s": round(time.time() - t0, 2)}


def _peak(mem) -> dict:
    """MemTracker's peak snapshot of the rank: ``{device: {category:
    bytes}}`` (``meta`` holds the shape-only shards)."""
    snap = mem.get_tracker_snapshot("peak")
    return {str(dev): {str(cat).split(".")[-1]: int(v) for cat, v in cats.items()}
            for dev, cats in snap.items()}


def _depth_cfg(cfg: ModelConfig, repeats: int) -> ModelConfig:
    return dataclasses.replace(cfg, name=f"{cfg.name}@r{repeats}",
                               num_layers=repeats * len(cfg.pattern))


def _extrapolate(at: dict, r_full: int) -> dict:
    """Linear extrapolation of two traces (at ``_ROOFLINE_DEPTHS``) to
    ``r_full`` repeats: every count, every collective kind and the peak.
    Raises where the peaks are not physical: each depth's above 0, the
    deeper one's no lower, the extrapolated one above 0 (a tracker that
    charges one trace's one-off work to the other gives such peaks)."""
    r1, r2 = _ROOFLINE_DEPTHS

    def line(a, b):
        return a + (r_full - r1) * (b - a) / (r2 - r1)

    c1, c2 = at[r1]["count"], at[r2]["count"]
    out = {k: line(c1[k], c2[k]) for k in ("flops", "bytes", "ops")}
    for part in ("collectives", "implicit"):
        keys = sorted(set(c1[part]) | set(c2[part]))
        out[part] = {k: line(c1[part].get(k, 0), c2[part].get(k, 0)) for k in keys}
    p1, p2 = _peak_total(at[r1]["peak_bytes"]), _peak_total(at[r2]["peak_bytes"])
    out["peak_bytes"] = line(p1, p2)
    if not 0 < p1 <= p2 or out["peak_bytes"] <= 0:
        raise ValueError(f"unphysical peak: {p1:.0f} B at {r1} repeats, {p2:.0f} B at {r2}, "
                         f"{out['peak_bytes']:.0f} B extrapolated to {r_full}")
    return out


def _peak_total(peak: dict, device: str = "meta") -> float:
    """The peak on the device that holds the rank's shards (``meta`` for
    the shape-only traces); the host tensors DTensor makes for itself
    (sharding propagation's) are not the rank's memory."""
    return float(peak.get(device, {}).get("Total", 0))


def _mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def dryrun_one(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One (arch x shape x mesh) combination, traced at 1 and 2 repeats of
    its pattern and extrapolated to its full depth."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    ctx = transformer.make_ctx(mesh, cfg, overrides=_rules_overrides(shape))
    ga = GRAD_ACCUM[arch] if shape.kind == "train" else 1
    return _roofline_result(cfg, shape, mesh, ctx, ga, arch=arch, shape_tag=shape_name)


def _roofline_result(cfg: ModelConfig, shape: InputShape, mesh, ctx, ga: int, *,
                     arch: str, shape_tag: str) -> dict:
    t0 = time.time()
    # a first trace fills DTensor's sharding caches, whose one-off work the
    # memory tracker would charge to the first depth traced
    _trace_combo(_depth_cfg(cfg, _ROOFLINE_DEPTHS[0]), shape, mesh, ctx, ga)
    at = {r: _trace_combo(_depth_cfg(cfg, r), shape, mesh, ctx, ga) for r in _ROOFLINE_DEPTHS}
    full = _extrapolate(at, cfg.num_repeats)
    nchips = chips(mesh)
    rf = roofline_lib.Roofline(
        flops_total=full["flops"] * nchips,
        hbm_bytes_total=full["bytes"] * nchips,
        collective_bytes_per_chip=sum(full["collectives"].values()),
        chips=nchips,
        dtype=cfg.dtype,
    )
    mf = roofline_lib.model_flops(cfg, shape)
    hbm = roofline_lib.H100.hbm_bytes
    return {
        "arch": arch,
        "shape": shape_tag,
        "mesh": _mesh_tag(mesh),
        "chips": nchips,
        "kernels": False,
        "depth": f"extrapolated from {list(_ROOFLINE_DEPTHS)} repeats to {cfg.num_repeats}",
        "trace_s": round(time.time() - t0, 2),
        "flops_per_device": full["flops"],
        "bytes_per_device": full["bytes"],
        "collectives": full["collectives"],
        "implicit_redistributes": full["implicit"],
        "peak_bytes_per_device": full["peak_bytes"],
        "peak_vs_h100_hbm": full["peak_bytes"] / hbm,
        "memory_by_depth": {str(r): at[r]["peak_bytes"] for r in at},
        "counts_by_depth": {str(r): at[r]["count"] for r in at},
        "roofline": rf.as_dict(),
        "model_flops": mf,
        "useful_flops_ratio": mf / rf.flops_total if rf.flops_total else None,
        "grad_accum": ga if shape.kind == "train" else None,
        "ok": True,
    }


def dryrun_fdsvrg(multi_pod: bool = False, *, mesh=None, num_instances: int = 65_536,
                  inner_steps: int = 256, batch_size: int = 64,
                  tree_mode: str = "psum") -> dict:
    """The paper's own workload at kdd2010 scale: one FD-SVRG outer
    iteration (``make_outer_iteration``, the plain path) with ``w``
    feature-sharded over every rank of ``mesh`` (default the production
    mesh), traced as rank 0."""
    from repro_torch.core.fdsvrg_shardmap import FDSVRGShardedConfig, make_outer_iteration
    from repro_torch.core.partition import FeaturePartition
    from repro_torch.data.block_csr import BlockCSR, aot_nnz_budget
    from torch.distributed._tools.mem_tracker import MemTracker

    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    q = chips(mesh)
    d = 29_890_095  # kdd2010 dimensionality
    d_pad = ((d + q - 1) // q) * q
    n, nnz, m, u = num_instances, 32, inner_steps, batch_size  # instance window per outer
    cfg = FDSVRGShardedConfig(
        dim=d_pad, num_instances=n, nnz_max=nnz, eta=0.1,
        inner_steps=m, batch_size=u, tree_mode=tree_mode, use_kernels=False,
    )
    step = make_outer_iteration(mesh, cfg, feature_axes=tuple(mesh.mesh_dim_names))
    bnnz = aot_nnz_budget(nnz, q)  # block-local rows, nnz/q + skew slack
    d_l = d_pad // q
    # A rank's block is small (kdd2010 over 256 ranks: 116,760 features,
    # N x bnnz ids), so it is real host zeros: the butterfly's paired
    # sends have no shape-only form.
    block = BlockCSR(
        partition=FeaturePartition(dim=d_l, bounds=(0, d_l)),
        indices=(torch.zeros((n, bnnz), dtype=torch.int32),),
        values=(torch.zeros((n, bnnz), dtype=torch.float32),),
        labels=torch.ones((n,), dtype=torch.float32),
        dim=d_l,
        nnz_max=nnz,
    )
    w = torch.zeros((d_l,), dtype=torch.float32)
    samples = np.zeros((m, u), dtype=np.int32)
    count = roofline_lib.DeviceCount()
    mem = MemTracker()
    mem.track_external(w, block.indices[0], block.values[0], block.labels)
    t0 = time.time()
    with mem, count:
        step(w, block, samples)
    rf = roofline_lib.from_trace(count, q, dtype="float32")
    return {
        "arch": "fdsvrg-kdd2010",
        "shape": f"outer(N={n},M={m},u={u})",
        "tree_mode": tree_mode,
        "mesh": _mesh_tag(mesh),
        "chips": q,
        "kernels": False,
        "trace_s": round(time.time() - t0, 2),
        "flops_per_device": count.flops,
        "bytes_per_device": count.bytes,
        "collectives": dict(count.collectives),
        "implicit_redistributes": dict(count.implicit),
        "peak_bytes_per_device": _peak_total(_peak(mem), "cpu"),
        "memory": _peak(mem),
        "roofline": rf.as_dict(),
        "ok": True,
    }


def dryrun_smoke() -> dict:
    """ONE reduced arch x mesh combo, fast enough for CI: smollm-360m at
    CPU-smoke scale on a fake 2x4 mesh."""
    from repro_torch.configs import reduced_config

    arch = "smollm-360m"
    mesh = make_test_mesh(2, 4)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), ssm_chunk=16)
    shape = InputShape("train_64", 64, 8, "train")
    ctx = transformer.make_ctx(mesh, cfg, overrides=_rules_overrides(shape))
    res = _roofline_result(cfg, shape, mesh, ctx, 1, arch=f"{arch}-reduced",
                           shape_tag="train(seq=64,batch=8)")
    return res


def combos():
    for arch in sorted(ARCHS):
        for shape_name in INPUT_SHAPES:
            if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            yield arch, shape_name


def _summary(res: dict) -> str:
    rl = res["roofline"]
    coll = {k: int(v) for k, v in sorted(res["collectives"].items())}
    return (f"flops/dev={res['flops_per_device']:.4e} bytes/dev={res['bytes_per_device']:.4e} "
            f"collectives={coll} peak/dev={res['peak_bytes_per_device'] / 2**30:.3f}GiB "
            f"compute={rl['compute_s']:.6f}s memory={rl['memory_s']:.6f}s "
            f"collective={rl['collective_s']:.6f}s dominant={rl['dominant']} "
            f"trace={res['trace_s']}s")


def _failure(arch, shape_name, mesh_tag, e: Exception) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "ok": False,
            "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fdsvrg", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="one reduced arch x mesh combo on a fake 2x4 mesh")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    out_dir = args.out_dir or os.path.abspath(RESULTS_DIR)
    os.makedirs(out_dir, exist_ok=True)

    if args.smoke:
        fake_world(8)
        path = os.path.join(out_dir, "smoke__train_64__2x4.json")
        try:
            res = dryrun_smoke()
            print(f"[OK] smoke: {_summary(res)}", flush=True)
            failures = 0
        except Exception as e:
            res = _failure("smollm-360m-reduced", "train(seq=64,batch=8)", "2x4", e)
            print(f"[FAIL] smoke: {res['error'][:300]}", flush=True)
            failures = 1
        with open(path, "w") as f:
            json.dump(res, f, indent=2, default=str)
        print(f"done; {failures} failures", flush=True)
        return failures

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    fake_world(512 if any(meshes) else 256)
    if args.fdsvrg:
        jobs = [("fdsvrg", None)]
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape)]
    elif args.arch:
        jobs = [(a, s) for a, s in combos() if a == args.arch]
    else:
        jobs = list(combos())

    failures = 0
    for arch, shape_name in jobs:
        for mp in meshes:
            mesh_tag = "2x16x16" if mp else "16x16"
            tag = f"{arch}__{shape_name or 'paper'}__{mesh_tag}"
            path = os.path.join(out_dir, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[SKIP] {tag}: already done", flush=True)
                        continue
            try:
                res = dryrun_fdsvrg(mp) if arch == "fdsvrg" else dryrun_one(arch, shape_name, mp)
                print(f"[OK] {tag}: {_summary(res)}", flush=True)
            except Exception as e:
                failures += 1
                res = _failure(arch, shape_name, mesh_tag, e)
                print(f"[FAIL] {tag}: {res['error'][:300]}", flush=True)
            with open(path, "w") as f:
                json.dump(res, f, indent=2, default=str)
    print(f"done; {failures} failures", flush=True)
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
