"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].

Port of ``repro.configs.mamba2_2_7b``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    d_ff=0,  # the mamba block subsumes the FFN
    vocab_size=50_280,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    pattern=(LayerTemplate("ssm", "none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    act="silu",
    tie_embeddings=True,
    supports_long_context=True,  # O(1) state; 500k decode is native
)
