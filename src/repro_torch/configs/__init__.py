"""Config registry: ``get_config(arch_id)`` / ``--arch <id>``.

Port of ``repro.configs``: ``ARCHS`` holds the reference's ten LM
presets, in its order; ``LINEAR`` holds the paper's
linear-classification presets (:mod:`repro_torch.configs.fdsvrg_linear`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    fdsvrg_linear,
    gemma2_9b,
    granite_moe_1b_a400m,
    jamba_v0_1_52b,
    mamba2_2_7b,
    minitron_4b,
    musicgen_large,
    olmoe_1b_7b,
    paligemma_3b,
    qwen3_14b,
    smollm_360m,
)
from repro_torch.configs.base import INPUT_SHAPES, InputShape, LayerTemplate, ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        paligemma_3b.CONFIG,
        smollm_360m.CONFIG,
        qwen3_14b.CONFIG,
        olmoe_1b_7b.CONFIG,
        musicgen_large.CONFIG,
        jamba_v0_1_52b.CONFIG,
        minitron_4b.CONFIG,
        mamba2_2_7b.CONFIG,
        gemma2_9b.CONFIG,
        granite_moe_1b_a400m.CONFIG,
    ]
}

LINEAR = dict(fdsvrg_linear.CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def reduced_config(cfg: ModelConfig, tp: int = 1) -> ModelConfig:
    """CPU-smoke-test variant: 1 pattern repeat (>=2 layers), d_model<=512,
    <=4 experts, tiny vocab — same family, same code paths."""
    d_model = min(cfg.d_model, 256)
    num_layers = len(cfg.pattern) if len(cfg.pattern) >= 2 else 2
    heads = 0
    kv = 0
    head_dim = 0
    if cfg.num_heads:
        heads = min(cfg.num_heads, 4)
        kv = max(1, min(cfg.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        head_dim = 32
    experts = min(cfg.num_experts, 4) if cfg.num_experts else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        num_experts=experts,
        capacity_factor=float(experts) if experts else cfg.capacity_factor,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=8,
        sliding_window=8 if cfg.sliding_window else None,
        frontend_dim=64 if cfg.frontend_dim else 0,
        num_patches=4 if cfg.num_patches else 0,
        dtype="float32",
    )


__all__ = [
    "ARCHS",
    "INPUT_SHAPES",
    "LINEAR",
    "InputShape",
    "LayerTemplate",
    "ModelConfig",
    "get_config",
    "reduced_config",
]
