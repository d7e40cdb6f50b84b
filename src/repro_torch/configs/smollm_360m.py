"""smollm-360m [dense] — llama-architecture small model
[hf:HuggingFaceTB/SmolLM-135M family, 360M geometry].

Port of ``repro.configs.smollm_360m``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32,
    d_model=960,
    d_ff=2560,
    vocab_size=49_152,
    num_heads=15,
    num_kv_heads=5,  # GQA 3:1
    head_dim=64,
    pattern=(LayerTemplate("global", "dense"),),
    act="silu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
