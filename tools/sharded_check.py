#!/usr/bin/env python3
"""The multi-device driver's phase of ``chip_smoke.py`` (``sharded_path``)
alone, with the main-path run it is held against.

Run from the root of a checkout, on a machine with one or more CUDA cards:

    python3 tools/sharded_check.py [--parts gloo,nccl,nccl_cards]

It builds the port's kernels, makes full-width news20 at q = 8 from seed 0
(the ``fdsvrg-news20`` preset, as ``chip_smoke.py``'s main path), then
runs ``chip_smoke.sharded_path`` on the main path's configuration
(``INNER_STEPS``, ``OUTERS``), which the phase cuts to ``SHARDED_STEPS``
inner steps: ``run_fdsvrg(q=8, use_kernels=True)``, 8 gloo ranks on card 0
held bitwise against it, one NCCL rank, and, on a host with two cards or
more, one NCCL rank a card.  It runs exactly the smoke's phase.
``--parts`` runs only the named ones (``nccl_cards`` alone on a host of
several cards checks the NCCL path across cards).  It prints the phase's
JSON lines, the card's name and power limit, and exits non-zero when a
check fails.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parts", default="gloo,nccl,nccl_cards")
    args = parser.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as smoke
    from repro_torch.configs.fdsvrg_linear import CONFIGS
    from repro_torch.core import losses
    from repro_torch.core.fdsvrg import SVRGConfig
    from repro_torch.core.partition import balanced
    from repro_torch.data import datasets
    from repro_torch.data.block_csr import BlockCSR
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        print("sharded_check: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    preset = CONFIGS["fdsvrg-news20"]
    data = datasets.load(preset.dataset, scaled=False, seed=smoke.SEED)
    part8 = balanced(data.dim, smoke.Q)
    bd8_cpu = BlockCSR.from_padded(data, part8)
    dev = torch.device("cuda")
    bd8, bd1 = bd8_cpu.to(dev), BlockCSR.from_padded(data, balanced(data.dim, 1)).to(dev)
    loss, reg = losses.LOSSES[preset.loss], preset.regularizer()
    cfg = SVRGConfig(eta=preset.eta, inner_steps=smoke.INNER_STEPS, outer_iters=smoke.OUTERS,
                     batch_size=preset.batch_size, seed=smoke.SEED)
    torch.cuda.synchronize()
    smoke.emit({"phase": "sharded_check_setup", "setup_s": time.perf_counter() - t0})
    workdir = tempfile.mkdtemp(prefix="sharded_check_")
    try:
        launches = smoke.sharded_path(torch, ops, data, bd8_cpu, bd8, bd1, cfg, loss, reg,
                                      workdir, parts=tuple(args.parts.split(",")))
    except smoke.SmokeFailure as err:
        print(f"sharded_check: FAILED: {err}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    smoke.emit({"sharded_launches_summed_over_ranks": launches})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
