"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679].

Port of ``repro.configs.minitron_4b``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=3072,
    d_ff=9216,
    vocab_size=256_000,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    pattern=(LayerTemplate("global", "dense"),),
    act="relu2",  # nemotron squared-ReLU
    mlp_gated=False,  # nemotron plain 2-matrix MLP
    tie_embeddings=False,
    rope_theta=10_000.0,
)
