"""The port's launch tools: the dry-run, its roofline terms and what they
call, held against the reference where it has a counterpart, on the CPU.

* ``data.block_csr.aot_nnz_budget`` equals the reference's on a grid.
* ``Roofline.dominant`` and ``H100Model.roofline_terms`` (the counterpart
  of ``tests/test_dryrun_small.py``'s roofline test), and the H100 model's
  published numbers.
* In one subprocess with a fake process group of 8 ranks, then one of 256
  (process groups are global to a process): the collective counter on a known program (an
  all-gather, an all-reduce and a reduce-scatter of known shapes on a fake
  2 x 4 mesh, each counted once at its output bytes); the per-rank FLOPs of
  ``[256 * 64, 5120] @ [5120, 17408]`` split over a fake 16 x 16 mesh
  (1.14e10 on rank 0, not the global 2.92e12); the small dry-run of
  reduced smollm-360m, granite-moe-1b-a400m and jamba-v0.1-52b x train,
  prefill and decode on the fake 2 x 4 mesh (FLOPs above 0, the sharded
  models communicate, a memory report); ``dryrun_fdsvrg`` on the 2 x 4
  mesh; ``main(["--smoke"])`` writing its result.
* In a subprocess with 8 host devices: the reference's ``_cost_tuple`` of
  reduced smollm-360m's train step (seq 64, batch 8, 2 x 4, every scan
  unrolled as its roofline compiles are), against the port's per-device
  count of the same step: FLOPs per device within ``FLOPS_BAND`` of the
  reference's (measured 1.333, bytes 1.360: the port counts an eager,
  unfused step, one FLOP per element of each pointwise op, which XLA
  counts otherwise after fusing).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.data.block_csr import aot_nnz_budget as r_aot_nnz_budget
from repro.dist.meter import TpuV5eModel
from repro_torch.data.block_csr import aot_nnz_budget
from repro_torch.dist.meter import H100Model
from repro_torch.launch import roofline as t_roofline

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FLOPS_BAND = (1.2, 1.5)  # port / reference FLOPs per device, smollm train (2 x 4)


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu", **extra)


@pytest.mark.parametrize("q", [1, 2, 3, 8, 16, 256, 512])
def test_aot_nnz_budget_matches_reference(q):
    for nnz in (1, 7, 8, 32, 33, 100, 1000, 4096):
        assert aot_nnz_budget(nnz, q) == r_aot_nnz_budget(nnz, q), (nnz, q)


def test_roofline_dominant_term():
    r = t_roofline.Roofline(flops_total=1e18, hbm_bytes_total=1e12,
                            collective_bytes_per_chip=1e9, chips=256)
    assert r.dominant == "compute"
    r2 = t_roofline.Roofline(flops_total=1e12, hbm_bytes_total=1e15,
                             collective_bytes_per_chip=1e9, chips=256)
    assert r2.dominant == "memory"
    r3 = t_roofline.Roofline(flops_total=1e12, hbm_bytes_total=1e9,
                             collective_bytes_per_chip=1e13, chips=256)
    assert r3.dominant == "collective"
    assert set(r.as_dict()) >= {"compute_s", "memory_s", "collective_s", "dominant", "chips"}


def test_h100_model_terms():
    h = H100Model()
    # NVIDIA's published H100 SXM numbers, dense
    assert (h.peak_flops_bf16, h.peak_flops_f32, h.hbm_Bps) == (989e12, 67e12, 3.35e12)
    assert h.link_Bps(8) == 450e9 and h.link_Bps(256) == 50e9
    t = h.roofline_terms(flops=989e12 * 8, hbm_bytes=3.35e12 * 8, collective_bytes=0.0, chips=8)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(1.0)
    t = h.roofline_terms(flops=1.0, hbm_bytes=1.0, collective_bytes=50e9 * 256, chips=256)
    assert t["dominant"] == "collective" and t["collective_s"] == pytest.approx(1.0)
    f32 = h.roofline_terms(flops=67e12, hbm_bytes=0.0, collective_bytes=0.0, chips=1,
                           dtype="float32")
    assert f32["compute_s"] == pytest.approx(1.0)
    # the same keys as the reference's TPU model
    ref = TpuV5eModel().roofline_terms(flops=1.0, hbm_bytes=1.0, collective_bytes=1.0, chips=1)
    assert set(t) == set(ref)


@pytest.mark.parametrize("peaks, ok", [
    ((100, 150), True),  # 100 + 3 * 50 at 4 repeats
    ((100, 100), True),
    ((0, 50), False),  # depth 1's peak not above 0
    ((-100, 50), False),
    ((150, 100), False),  # the deeper trace's peak lower
    ((100, -6000), False),  # a negative extrapolated peak
])
def test_extrapolated_peak_must_be_physical(peaks, ok):
    from repro_torch.launch import dryrun

    count = {"flops": 1.0, "bytes": 1.0, "ops": 1, "collectives": {}, "implicit": {}}
    at = {r: {"count": count, "peak_bytes": {"meta": {"Total": p}}}
          for r, p in zip(dryrun._ROOFLINE_DEPTHS, peaks)}
    if ok:
        assert dryrun._extrapolate(at, 4)["peak_bytes"] == peaks[0] + 3 * (peaks[1] - peaks[0])
    else:
        with pytest.raises(ValueError, match="unphysical peak"):
            dryrun._extrapolate(at, 4)


_PORT =textwrap.dedent("""
    import dataclasses, json, sys, tempfile
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import chips, fake_world, make_production_mesh, make_test_mesh
    from repro_torch.launch.roofline import DeviceCount
    from repro_torch.models import transformer

    fake_world(8)
    out = {}
    small = make_test_mesh(2, 4)
    c = DeviceCount()
    x = distribute_tensor(torch.empty(64, 128, device="meta"), small, (Shard(0), Shard(1)))
    p = DTensor.from_local(torch.empty(64, 128, device="meta"), small, (Partial(), Replicate()))
    with c:
        x.redistribute(small, (Replicate(), Shard(1)))            # all-gather over data
        p.redistribute(small, (Replicate(), Replicate()))         # all-reduce over data
        p.redistribute(small, (Shard(0), Replicate()))            # reduce-scatter over data
    out["counter"] = c.as_dict()

    shapes = {"train": InputShape("t", 64, 8, "train"), "prefill": InputShape("p", 64, 4, "prefill"),
              "decode": InputShape("d", 64, 8, "decode")}
    combos = {}
    for arch in ("smollm-360m", "granite-moe-1b-a400m", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(reduced_config(get_config(arch)), ssm_chunk=16)
        for kind, shape in shapes.items():
            ctx = transformer.make_ctx(small, cfg, overrides=dryrun._rules_overrides(shape))
            r = dryrun._trace_combo(cfg, shape, small, ctx, 2 if kind == "train" else 1)
            combos[f"{arch} {kind}"] = r
    out["combos"] = combos
    out["fdsvrg"] = dryrun.dryrun_fdsvrg(mesh=small, num_instances=512, inner_steps=4)
    with tempfile.TemporaryDirectory() as d:
        out["smoke_rc"] = dryrun.main(["--smoke", "--out-dir", d])
        with open(d + "/smoke__train_64__2x4.json") as f:
            out["smoke"] = json.load(f)

    # a world of 256 for the production mesh
    torch.distributed.destroy_process_group()
    big = make_production_mesh()
    c = DeviceCount()
    a = distribute_tensor(torch.empty(256 * 64, 5120, device="meta"), big, (Shard(0), Replicate()))
    w = distribute_tensor(torch.empty(5120, 17408, device="meta"), big, (Replicate(), Shard(1)))
    with c:
        a @ w
    out["matmul_flops"] = c.flops
    out["chips"] = [chips(small), chips(big)]
    print("PORT-JSON " + json.dumps(out, default=str))
""")

_REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    from repro.configs import get_config, reduced_config
    from repro.configs.base import InputShape
    from repro.dist.compat import make_mesh
    from repro.launch.dryrun import _cost_tuple, _lower_combo, _rules_overrides
    from repro.models import transformer
    from repro.models.unroll import unrolled

    mesh = make_mesh((2, 4), ("data", "model"))
    cfg = dataclasses.replace(reduced_config(get_config("smollm-360m")), ssm_chunk=16)
    shape = InputShape("train_64", 64, 8, "train")
    ctx = transformer.make_ctx(mesh, cfg, overrides=_rules_overrides(shape))
    with unrolled():
        flops, nbytes, coll = _cost_tuple(_lower_combo(cfg, shape, mesh, ctx, 1).compile())
    print("REF-JSON " + json.dumps({"flops": flops, "bytes": nbytes, "collective": coll}))
""")


def _json_after(tag: str, text: str) -> dict:
    line = next(ln for ln in text.splitlines() if ln.startswith(tag))
    return json.loads(line[len(tag):])


@pytest.fixture(scope="module")
def traced():
    """The port's subprocess (fake process group) and the reference's (8
    host devices), run side by side."""
    procs = {tag: subprocess.Popen([sys.executable, "-c", code], env=_env(),
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for tag, code in (("PORT-JSON ", _PORT), ("REF-JSON ", _REF))}
    out = {}
    try:
        for tag, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            out[tag.split("-")[0].lower()] = _json_after(tag, stdout)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def test_collective_counter_counts_each_once_at_its_output_bytes(traced):
    c = traced["port"]["counter"]
    # all-gather over data of a [32, 32] shard -> [64, 32]; the all-reduce's
    # output is the [64, 128] tensor; the reduce-scatter's output [32, 128]
    assert c["collectives"] == {"all-gather": 64 * 32 * 4, "all-reduce": 64 * 128 * 4,
                                "reduce-scatter": 32 * 128 * 4}
    assert c["flops"] == 0


def test_flops_are_counted_per_rank(traced):
    assert traced["port"]["chips"] == [8, 256]
    assert traced["port"]["matmul_flops"] == 2 * (256 * 64 // 16) * 5120 * (17408 // 16)
    assert traced["port"]["matmul_flops"] == pytest.approx(1.14e10, rel=1e-3)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_small_mesh_dryrun(traced, arch, kind):
    r = traced["port"]["combos"][f"{arch} {kind}"]
    assert r["count"]["flops"] > 0 and r["count"]["bytes"] > 0
    # sharded models communicate
    assert sum(r["count"]["collectives"].values()) > 0, r["count"]["collectives"]
    # a memory report: the rank's peak by category on the shape-only device
    assert r["peak_bytes"]["meta"]["Total"] > 0


def test_dryrun_fdsvrg_at_a_small_world(traced):
    r = traced["port"]["fdsvrg"]
    assert r["ok"] and r["chips"] == 8 and r["mesh"] == "2x4" and not r["kernels"]
    # one all-reduce of the N margins a snapshot, of u scalars a step, and
    # of the residual's squares
    assert r["collectives"] == {"all-reduce": 4 * (512 + 4 * 64 + 1)}
    assert r["flops_per_device"] > 0 and r["peak_bytes_per_device"] > 0


def test_smoke_writes_its_result(traced):
    assert traced["port"]["smoke_rc"] == 0
    s = traced["port"]["smoke"]
    assert s["ok"] and s["mesh"] == "2x4" and s["chips"] == 8 and s["kernels"] is False
    assert s["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert s["flops_per_device"] > 0 and s["peak_bytes_per_device"] > 0


def test_flops_per_device_against_the_references_cost_analysis(traced):
    port = traced["port"]["smoke"]["flops_per_device"]
    ref = traced["ref"]["flops"]
    ratio = port / ref
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], (port, ref, ratio)
