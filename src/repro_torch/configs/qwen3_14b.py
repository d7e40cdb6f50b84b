"""qwen3-14b [dense] — qk-norm, GQA [hf:Qwen/Qwen3-8B family, 14B geometry].

Port of ``repro.configs.qwen3_14b``, the same numbers."""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab_size=151_936,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    pattern=(LayerTemplate("global", "dense"),),
    act="silu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
)
