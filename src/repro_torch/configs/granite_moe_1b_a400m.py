"""granite-moe-1b-a400m [moe] — 32 experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

Port of ``repro.configs.granite_moe_1b_a400m``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    d_ff=512,  # expert hidden
    vocab_size=49_155,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    pattern=(LayerTemplate("global", "moe"),),
    num_experts=32,
    top_k=8,
    moe_d_ff=512,
    act="silu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
