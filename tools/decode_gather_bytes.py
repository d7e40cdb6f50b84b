#!/usr/bin/env python3
"""Bytes one decode step's attention core moves across the ranks that split
the KV cache's positions, per card and token, on both decode routes, from
the shapes alone.

    PYTHONPATH=src python tools/decode_gather_bytes.py

for every preset with attention, at the ``decode_32k`` input shape on the
16 x 16 ``(data, model)`` mesh the dry-run traces.  The cache ``[B, S,
Hkv, Dh]`` is split by position over the ``model`` axis (R ranks) and by
request over ``data``, so a card holds ``b = B / data`` requests.  Per
attention layer and token, on each card:

* the kernel route (split-K, ``use_kernels=True``) all-gathers every
  rank's partial max, sum and weighted sum: ``R * b * Hkv * G * (Dh + 2)``
  float32 values out;
* the plain route (``use_kernels=False``, the reference's arithmetic under
  DTensor) all-reduces the max and the sum over the position shards, ``2 *
  b * Hkv * G`` float32 values out, and leaves the weighted sum pending
  (``Partial``) into the output projection's reduction of ``b * D``
  values: the dry-run lists exactly those two all-reduces as its implicit
  redistributes (``flash_decode_plain``'s ``sub`` and ``clamp_min``).

Counted as the dry-run counts a collective (its output bytes), times the
model's attention layers.  No card and no trace: arithmetic only.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

DATA, MODEL = 16, 16  # the production mesh


def gather_bytes(cfg, batch: int) -> dict:
    """Per card and token: the kernel route's all-gather and the plain
    route's all-reduces, output bytes over all attention layers."""
    layers = cfg.num_repeats * sum(t.mixer in ("global", "local") for t in cfg.pattern)
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // hkv
    b = -(-batch // DATA)
    kernel = MODEL * b * hkv * g * (dh + 2) * 4
    plain = 2 * b * hkv * g * 4
    return {"layers": layers, "per_layer_kernel": kernel, "per_layer_plain": plain,
            "kernel": layers * kernel, "plain": layers * plain}


def main() -> int:
    from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config

    shape = INPUT_SHAPES["decode_32k"]
    print(f"B {shape.global_batch}, S {shape.seq_len}, mesh (data {DATA}, model {MODEL}); "
          "the attention core's collective output bytes a card and token (a layer in brackets)")
    for arch in ARCHS:
        cfg = get_config(arch)
        if not cfg.num_heads:
            continue  # attention-free
        r = gather_bytes(cfg, shape.global_batch)
        print(f"{arch}: {r['layers']} attention layers; kernel route all-gather "
              f"{r['kernel']:,} ({r['per_layer_kernel']:,}); plain route all-reduces "
              f"{r['plain']:,} ({r['per_layer_plain']:,})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
