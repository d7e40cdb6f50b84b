"""gemma2-9b [dense] — local+global alternating attention, logit softcaps,
sandwich norms [arXiv:2408.00118].

Port of ``repro.configs.gemma2_9b``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    source="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256_000,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    pattern=(
        LayerTemplate("local", "dense"),
        LayerTemplate("global", "dense"),
    ),
    post_norm=True,
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    # local layers have a native 4096 window; global layers decode a full
    # (sequence-sharded) cache linearly per token -> long_500k runs.
    supports_long_context=True,
)
