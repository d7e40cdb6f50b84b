"""LM token pipeline: deterministic synthetic streams per architecture.

Port of ``repro.data.token_stream`` (host NumPy, copied, not imported):
a Zipf unigram mixture with copy motifs, so the models have something
learnable, batched exactly as :mod:`repro_torch.launch.inputs` promises.
Every batch is byte for byte the reference's for the same config and
seed: ``tokens`` and ``labels`` int32 ``[B, S]`` (``[B, S, K]`` for the
audio codebooks); for vision ``tokens [B, S - P]``, float32
``patch_embeds [B, P, frontend_dim]`` and ``labels [B, S]`` with zeros
over the P patches.  With ``grad_accum`` A > 1 every array is reshaped
to ``[A, B / A, ...]``.  The arrays stay NumPy; the caller moves them.

``repro_torch.data.pipeline`` keeps the reference's deprecation shim for
the old names.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    batch_size: int
    seq_len: int
    seed: int = 0
    grad_accum: int = 1


def _token_stream(rng, n, vocab, zipf_a=1.2):
    """Zipf-ish unigram stream with injected copy motifs (learnable)."""
    u = rng.random(n)
    raw = np.minimum(u ** (-1.0 / (zipf_a - 1.0)) - 1.0, float(vocab))
    toks = np.clip(np.floor(raw).astype(np.int64), 0, vocab - 1)
    # repeat motifs: every 64 tokens, copy the previous 8
    for start in range(64, n - 8, 64):
        toks[start : start + 8] = toks[start - 8 : start]
    return toks.astype(np.int32)


def batches(cfg: ModelConfig, pcfg: PipelineConfig) -> Iterator[dict]:
    """Yields {"tokens": ..., "labels": ..., (modality extras)} forever."""
    rng = np.random.default_rng(pcfg.seed)
    v = cfg.vocab_size
    b, s = pcfg.batch_size, pcfg.seq_len

    while True:
        if cfg.modality == "audio-codec":
            k = cfg.num_codebooks
            toks = np.stack(
                [_token_stream(rng, b * s, v).reshape(b, s) for _ in range(k)],
                axis=-1,
            )
            batch = {"tokens": toks, "labels": toks.copy()}
        elif cfg.modality == "vision":
            p = cfg.num_patches
            text = _token_stream(rng, b * (s - p), v).reshape(b, s - p)
            patches = rng.normal(0, 1, size=(b, p, cfg.frontend_dim)).astype(np.float32)
            labels = np.concatenate([np.zeros((b, p), np.int32), text], axis=1)
            batch = {"tokens": text, "patch_embeds": patches, "labels": labels}
        else:
            toks = _token_stream(rng, b * s, v).reshape(b, s)
            batch = {"tokens": toks, "labels": toks.copy()}

        if pcfg.grad_accum > 1:
            a = pcfg.grad_accum
            batch = {
                k2: v2.reshape((a, v2.shape[0] // a) + v2.shape[1:])
                for k2, v2 in batch.items()
            }
        yield batch
