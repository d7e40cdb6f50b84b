"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726].

Language backbone only (gemma-2B geometry); the SigLIP vision tower is a
stub frontend per the assignment carve-out: ``input_specs`` supplies
precomputed patch embeddings [B, 256, 1152] and the model owns the
projector into d_model.

Port of ``repro.configs.paligemma_3b``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    source="arXiv:2407.07726",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257_216,
    num_heads=8,
    num_kv_heads=1,  # MQA
    head_dim=256,
    pattern=(LayerTemplate("global", "dense"),),
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    modality="vision",
    frontend_dim=1152,  # SigLIP-So400m width
    num_patches=256,
)
