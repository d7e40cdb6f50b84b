"""Named hypothesis experiments over the dry-run (the §Perf pairs).

Port of ``repro.launch.perf``:

    PYTHONPATH=src python -m repro_torch.launch.perf --pair jamba_train
    PYTHONPATH=src python -m repro_torch.launch.perf --pair qwen3_prefill
    PYTHONPATH=src python -m repro_torch.launch.perf --pair gemma2_long
    PYTHONPATH=src python -m repro_torch.launch.perf --pair fdsvrg

Each experiment is a config delta applied to a baseline preset, traced
and analysed exactly as ``repro_torch.launch.dryrun`` does (a fake process
group of 256 ranks, the 16 x 16 mesh, shape-only DTensors, the plain
versions of the kernels), with the roofline terms against the NVIDIA
H100 (:class:`repro_torch.dist.meter.H100Model`); results go to
``results/torch_perf/<pair>.json`` with the before and after terms.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch import configs as configs_pkg
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

RESULTS = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "torch_perf")
)


def _run_variant(base_arch: str, shape: str, label: str, **overrides) -> dict:
    cfg = get_config(base_arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    tmp = f"__perf_{label}"
    cfg = dataclasses.replace(cfg, name=tmp)
    configs_pkg.ARCHS[tmp] = cfg
    dryrun.GRAD_ACCUM[tmp] = dryrun.GRAD_ACCUM[base_arch]
    try:
        res = dryrun.dryrun_one(tmp, shape, False)
    finally:
        configs_pkg.ARCHS.pop(tmp, None)
        dryrun.GRAD_ACCUM.pop(tmp, None)
    res["label"] = label
    res["overrides"] = {k: str(v) for k, v in overrides.items()}
    return res


def _print_row(res: dict):
    rl = res["roofline"]
    mem = res["peak_bytes_per_device"] / 2**30
    print(
        f"  {res['label']:<28} compute={rl['compute_s']:.4f}s "
        f"memory={rl['memory_s']:.4f}s collective={rl['collective_s']:.4f}s "
        f"dominant={rl['dominant']:<10} useful={res.get('useful_flops_ratio') or 0:.3f} "
        f"peak={mem:.1f}GiB",
        flush=True,
    )


def pair_jamba_train() -> list[dict]:
    """jamba-v0.1-52b x train_4k: the SSD intra-chunk quadratic term (chunk
    256 against d_state 16) wastes ~L/(2N) of the mixer's FLOPs and its
    L^2 decay matrices carry the memory term."""
    out = [_run_variant("jamba-v0.1-52b", "train_4k", "baseline")]
    _print_row(out[-1])
    # H1a: chunk ~ 4*d_state balances intra (L) vs inter (N) work
    for chunk in (64, 32):
        out.append(_run_variant("jamba-v0.1-52b", "train_4k",
                                f"ssm_chunk={chunk}", ssm_chunk=chunk))
        _print_row(out[-1])
    # H1b: bf16 SSD operands (the port rounds them and saves no bytes)
    out.append(_run_variant("jamba-v0.1-52b", "train_4k",
                            "chunk=32+bf16-ssd",
                            ssm_chunk=32, ssm_compute_dtype="bfloat16"))
    _print_row(out[-1])
    return out


def pair_qwen3_prefill() -> list[dict]:
    """qwen3-14b x prefill_32k: the single-scan flash path scores every
    (q, k) chunk pair; causal block-skipping halves score FLOPs."""
    out = [_run_variant("qwen3-14b", "prefill_32k", "baseline")]
    _print_row(out[-1])
    for qc in (4096, 2048):
        out.append(_run_variant("qwen3-14b", "prefill_32k",
                                f"q_chunk={qc}", attn_q_chunk=qc))
        _print_row(out[-1])
    return out


def pair_gemma2_long() -> list[dict]:
    """gemma2-9b x long_500k: the decode step over 524,288 positions."""
    out = [_run_variant("gemma2-9b", "long_500k", "baseline")]
    _print_row(out[-1])
    return out


def pair_fdsvrg() -> list[dict]:
    """The paper's own workload: the collective term of one outer
    iteration at kdd2010's width, by tree and batch size."""
    out = []
    for label, tree_mode, u in (
        ("baseline-psum-u64", "psum", 64),
        ("butterfly-u64", "butterfly", 64),
        ("psum-u512", "psum", 512),
        ("psum-u8", "psum", 8),
    ):
        res = dryrun.dryrun_fdsvrg(False, batch_size=u, tree_mode=tree_mode)
        res.update(label=label, batch=u)
        out.append(res)
        coll = res["collectives"]
        print(f"  {label:<28} coll_bytes={sum(coll.values()):>12,} "
              f"kinds={ {k: v for k, v in sorted(coll.items())} }", flush=True)
    return out


PAIRS = {
    "jamba_train": pair_jamba_train,
    "qwen3_prefill": pair_qwen3_prefill,
    "gemma2_long": pair_gemma2_long,
    "fdsvrg": pair_fdsvrg,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True, choices=sorted(PAIRS))
    ap.add_argument("--out-dir", default=RESULTS)
    args = ap.parse_args(argv)
    dryrun.fake_world(256)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    print(f"== perf pair: {args.pair} ==", flush=True)
    results = PAIRS[args.pair]()
    path = os.path.join(args.out_dir, f"{args.pair}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(f"done in {time.time() - t0:.0f}s -> {path}")


if __name__ == "__main__":
    main()
