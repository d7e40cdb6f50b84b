"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887].

Jamba block structure (period 8): attention at in-block offset 4, Mamba
elsewhere; MoE replaces the dense FFN every other layer (offsets 1,3,5,7).
The paper's mixer is Mamba-1; we implement it with the SSD (Mamba-2)
formulation — same state-space recurrence class, TPU-native chunked scan —
with Jamba's d_state=16 (recorded as a hardware adaptation in DESIGN.md).

Port of ``repro.configs.jamba_v0_1_52b``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig


def _template(i: int) -> LayerTemplate:
    mixer = "global" if i == 4 else "ssm"
    ffn = "moe" if i % 2 == 1 else "dense"
    return LayerTemplate(mixer, ffn)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65_536,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    pattern=tuple(_template(i) for i in range(8)),
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    act="silu",
    tie_embeddings=False,
    rope_theta=10_000.0,  # jamba uses no rope on its single attn layer; kept for uniformity
    supports_long_context=True,  # 4 attention layers carry the KV; mamba is O(1)
)
