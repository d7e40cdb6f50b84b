#!/usr/bin/env python3
"""The mesh rules on the card: ``chip_smoke.py``'s ``mesh_rules`` phase
alone, or smollm-360m's train step and decode on a 2 data x 2 model mesh of
four cards.

Run from the root of a checkout, on a machine with CUDA cards:

    python3 tools/mesh_check.py              # the smoke's phase, one card
    python3 tools/mesh_check.py --cards 4    # a (2, 2) NCCL mesh, a rank a card
    python3 tools/mesh_check.py --cards 4 --dtype float32   # a float32 compute copy

With one card it builds the port's kernels and runs ``chip_smoke.mesh_rules``
exactly as the smoke does: one NCCL rank on a (data=1, model=1) mesh, three
train steps of smollm-360m at full width and depth against the same steps
without a mesh, then a greedy decode whose tokens and ``flash_decode``
launches must equal the no-mesh decode's.  With four cards it starts four
NCCL ranks (``spawn_ranks``, rank r on card r) on a (2, 2) ``(data, model)``
mesh and runs ``chip_smoke._mesh_rank`` on each: the three steps alone on
its card (the one-card reference), then its part of the mesh's steps,
checking that its masters, ``m`` and ``v`` are its ``state_specs`` slice
and reporting its peak memory in both runs; then
a greedy decode at ``chip_smoke.MESH_DECODE`` on its card alone and on the
mesh through ``make_serve_step(cfg, make_ctx(mesh, cfg))`` with its
defaults, the cache's positions split over ``model``, so the kernel's
split-K route (each rank's partials, gathered over ``model`` by NCCL,
merged in rank order), fed the one-card run's tokens.  It prints one JSON
line for the steps and one for the decode, the card's name and power
limit, and exits non-zero when a check fails.

The four-card bounds depend on the compute copy's dtype (``BOUNDS``).  In
bfloat16 they are the smoke's ``MESH_*`` bounds, and each step's decode
logits within ``chip_smoke.LM_LOGIT_RTOL`` of max|logits| of the one-card
decode (the LM twins' bound).  With ``--dtype float32`` they are those of
the CPU mesh test (``tests/test_torch_train_mesh.py``: metrics 1e-5, all
but 1e-3 of a leaf's masters within 2e-5) and the decode's tokens equal, so
a fault of the multi-rank layout shows there apart from bfloat16's
rounding.  Each rank's launches equal their closed form
(:func:`decode_launches`) in both.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The compute dtype -> (every metric, relative; the share of each leaf's
# masters allowed past the absolute bound; that bound).  Any master within
# chip_smoke.MESH_MASTER_ANY in both: adamw moves a weight whose gradient
# is near 0 by ~lr either way, so a sign flip costs 2 lr a step.  bfloat16's
# were set from a CPU rehearsal at reduced width on a 2 x 2 gloo mesh, 3
# steps (metrics 1.03e-3, masters 3.7e-3, share past 1e-4 0.94 %); four
# H100s at full width read 3.07e-3, 5.55e-3 and 9.6 %, past the share's
# bound.  float32's are the CPU mesh test's.
BOUNDS = {"bfloat16": (5e-3, 0.05, 1e-4), "float32": (1e-5, 1e-3, 2e-5)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=1, choices=(1, 4))
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(BOUNDS),
                        help="the compute copy's dtype on four cards")
    args = parser.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as smoke
    from repro_torch.dist.launch import spawn_ranks
    from repro_torch.kernels import _build

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        print(f"mesh_check: needs {args.cards} CUDA card(s)", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(card, flush=True)
    _build.build()
    _build.load_library()
    try:
        if args.cards == 1:
            smoke.mesh_rules(torch, card)
        else:
            t0 = time.perf_counter()
            ranks = spawn_ranks(4, _all_ranks,
                                {"arch": smoke.MESH_ARCH, "lr": smoke.TRAIN_LR,
                                 "dtype": args.dtype},
                                backend="nccl", device="cuda", timeout_s=smoke.MESH_LIMIT_S,
                                mesh_shape=(2, 2), mesh_dim_names=("data", "model"))
            failed = (_train_line(smoke, torch, ranks, args.dtype, card)
                      + _decode_line(smoke, torch, ranks, args.dtype, card))
            print(json.dumps({"phase": "mesh_four_cards_time",
                              "wall_s": time.perf_counter() - t0}), flush=True)
            smoke.require(not failed, "mesh_check: " + "; ".join(failed))
    except smoke.SmokeFailure as err:
        print(f"mesh_check: FAILED: {err}", file=sys.stderr, flush=True)
        return 1
    print(card, flush=True)
    return 0


def _train_line(smoke, torch, ranks: list, dtype: str, card: str) -> list:
    """Print the (2, 2) mesh's train steps against one card's; the failed
    bounds."""
    metric_rtol, loose_share, atol = BOUNDS[dtype]
    runs = ranks[0]["train"]
    cmp = smoke._mesh_compare(torch, runs, atol)
    line = {"phase": "mesh_four_cards", "arch": smoke.MESH_ARCH, "dtype": dtype,
            "mesh": ranks[0]["mesh"], "backend": "nccl",
            "steps": smoke.MESH_TRAIN_STEPS, "batch": smoke.MESH_TRAIN_SHAPE[0],
            "seq": smoke.MESH_TRAIN_SHAPE[1], **cmp,
            "tolerance": {"metric_rtol": metric_rtol, "master_any": smoke.MESH_MASTER_ANY,
                          "master_atol": atol, "loose_share": loose_share},
            "metrics": {tag: {k: [m[k] for m in r["metrics"]] for k in r["metrics"][0]}
                        for tag, r in runs.items()},
            "s_per_step": {tag: r["step_s"] for tag, r in runs.items()},
            "leaves_checked": [r["train"]["mesh"]["leaves_checked"] for r in ranks],
            "peak_gb_one_card": [r["train"]["no_mesh"]["peak_gb"] for r in ranks],
            "peak_gb_per_card_on_mesh": [r["train"]["mesh"]["peak_gb"] for r in ranks],
            "card": card}
    print(json.dumps(line), flush=True)
    ok = (cmp["metric_rel_max"] <= metric_rtol and cmp["master_abs_max"] <= smoke.MESH_MASTER_ANY
          and cmp["master_loose_share_max"] <= loose_share)
    return [] if ok else [f"the (2, 2) mesh's steps against one card: {cmp}"]


def _decode_line(smoke, torch, ranks: list, dtype: str, card: str) -> list:
    """Print the (2, 2) mesh's decode against one card's; the failed
    checks."""
    from repro_torch.configs import get_config

    dec = ranks[0]["decode"]
    cmp = smoke._decode_compare(torch, dec)
    want = decode_launches(smoke, get_config(smoke.MESH_ARCH), (2, 2), smoke.MESH_DECODE)
    got = [{k: r["decode"]["mesh"][k] for k in ("flash_decode", "flash_decode_merge")}
           for r in ranks]
    line = {"phase": "mesh_four_cards_decode", "arch": smoke.MESH_ARCH, "dtype": dtype,
            "mesh": ranks[0]["mesh"], "backend": "nccl",
            "entry": "make_serve_step(cfg, make_ctx(mesh, cfg)) with its defaults",
            "batch": smoke.MESH_DECODE[0], "prompt": smoke.MESH_DECODE[1],
            "tokens": smoke.MESH_DECODE[2], **cmp,
            "tolerance": "tokens equal" if dtype == "float32" else
                         f"logits within {smoke.LM_LOGIT_RTOL:g} * max|logits|",
            "launches_by_rank": got, "want_launches_by_rank": want,
            "ms_per_token_by_rank": [{tag: r["decode"][tag]["ms_per_token"]
                                      for tag in ("no_mesh", "mesh")} for r in ranks],
            "prefill_s": {tag: d["prefill_s"] for tag, d in dec.items()}, "card": card}
    print(json.dumps(line), flush=True)
    failed = [] if got == want else [f"decode launches {got}, want {want}"]
    if dtype == "float32" and not cmp["tokens_equal"]:
        failed.append(f"the mesh's decode tokens differ: {cmp}")
    if dtype != "float32" and cmp["logits_rel_max"] > smoke.LM_LOGIT_RTOL:
        failed.append(f"the mesh's decode logits: {cmp}")
    return failed


def _all_ranks(mesh, s: dict) -> list:
    """``chip_smoke._mesh_rank`` on every rank; rank 0 returns each rank's
    result (the masters, tokens and logits only from rank 0)."""
    import torch.distributed as dist

    import chip_smoke as smoke

    mine = smoke._mesh_rank(mesh, s)
    every = [None] * dist.get_world_size()
    summary = {key: {tag: {k: v for k, v in r.items() if k not in ("params", "logits", "tokens")}
                     for tag, r in mine[key].items()}
               for key in ("train", "decode")}
    dist.all_gather_object(every, {"mesh": mine["mesh"], **summary})
    every[0] = mine
    return every


def decode_launches(smoke, cfg, mesh_shape: tuple, decode_shape: tuple) -> list[dict]:
    """The closed form of a mesh decode's launches on each rank (row-major
    over a (data, model) mesh): one ``flash_decode`` partials launch a
    token and attention layer whose window meets the rank's shard of the
    cache's positions (``model`` splits them), one merge a token and
    attention layer; on an unsplit cache one ``flash_decode`` and no
    merge."""
    _, prompt, gen = decode_shape
    model = mesh_shape[1]
    bounds = smoke.shard_bounds(prompt + gen, model)
    windows = [(t.mixer, cfg.sliding_window) for t in cfg.pattern
               if t.mixer in ("global", "local")] * cfg.num_repeats
    out = []
    for rank in range(mesh_shape[0] * model):
        lo, hi = bounds[rank % model], bounds[rank % model + 1]
        live = 0
        for i in range(gen):
            length = prompt + i
            for mixer, window in windows:
                start = max(0, length - window) if mixer == "local" and window else 0
                live += max(lo, start) < min(hi, length)
        out.append({"flash_decode": live,
                    "flash_decode_merge": gen * len(windows) if model > 1 else 0})
    return out


if __name__ == "__main__":
    sys.exit(main())
