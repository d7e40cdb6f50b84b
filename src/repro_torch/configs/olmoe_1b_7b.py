"""olmoe-1b-7b [moe] — 64 experts, top-8 [arXiv:2409.02060].

Port of ``repro.configs.olmoe_1b_7b``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    source="arXiv:2409.02060",
    num_layers=16,
    d_model=2048,
    d_ff=1024,  # (expert hidden; no dense FFN layers in this arch)
    vocab_size=50_304,
    num_heads=16,
    num_kv_heads=16,  # MHA
    head_dim=128,
    pattern=(LayerTemplate("global", "moe"),),
    num_experts=64,
    top_k=8,
    moe_d_ff=1024,
    act="silu",
    tie_embeddings=False,
    rope_theta=10_000.0,
)
