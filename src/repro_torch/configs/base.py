"""ModelConfig: one schema covering all six architecture families.

Port of ``repro.configs.base``, copied as data: the port imports nothing
of the reference, and its tests hold the two schemas field for field.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerTemplate:
    """One position in the repeating layer pattern."""

    mixer: str  # "global" | "local" | "ssm"
    ffn: str  # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation bracket from the assignment
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # attention
    num_heads: int = 0  # 0 => attention-free
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 => d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    attn_softcap: float | None = None
    attn_kv_chunk: int = 1024
    attn_q_chunk: int | None = None  # §Perf lever: causal block-skipping
    # pattern: template list repeated num_layers/len(pattern) times
    pattern: tuple[LayerTemplate, ...] = (LayerTemplate("global", "dense"),)
    # output
    logit_softcap: float | None = None
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    post_norm: bool = False  # gemma2 sandwich norms
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (olmoe/granite: the listed d_ff)
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_compute_dtype: str = "float32"  # §Perf lever: "bfloat16" halves SSD HBM traffic
    # multimodal frontends (stub embeddings per the carve-out)
    modality: str | None = None  # "vision" | "audio-codec"
    frontend_dim: int = 0  # SigLIP width for paligemma
    num_patches: int = 0
    num_codebooks: int = 0
    mlp_gated: bool = True  # False: plain 2-matrix MLP (nemotron)
    # numerics / misc
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    shard_heads: bool = True  # False when q-heads don't divide the TP axis
    # capability flags used by the dry-run matrix
    supports_long_context: bool = False  # sub-quadratic decode at 500k

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not a multiple of "
                f"pattern length {len(self.pattern)}"
            )
        if self.num_heads:
            if self.num_heads % max(self.num_kv_heads, 1) != 0:
                raise ValueError(f"{self.name}: heads % kv_heads != 0")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def num_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def has_attention(self) -> bool:
        return any(t.mixer in ("global", "local") for t in self.pattern)

    @property
    def has_moe(self) -> bool:
        return any(t.ffn == "moe" for t in self.pattern)

    @property
    def has_ssm(self) -> bool:
        return any(t.mixer == "ssm" for t in self.pattern)

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND roofline math)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for tmpl in self.pattern:
            n_rep = self.num_repeats
            if tmpl.mixer in ("global", "local"):
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
                    self.num_heads * hd * d
                )
                total += attn * n_rep
            elif tmpl.mixer == "ssm":
                di = self.ssm_expand * d
                n = self.ssm_state
                h = di // self.ssm_head_dim
                total += (d * (2 * di + 2 * n + h) + di * d) * n_rep
            if tmpl.ffn == "dense":
                n_mats = 3 if self.mlp_gated else 2
                total += n_mats * d * ff * n_rep
            elif tmpl.ffn == "moe":
                total += (3 * d * self.moe_d_ff * self.num_experts + d * self.num_experts) * n_rep
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if not self.has_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        for tmpl in self.pattern:
            if tmpl.ffn == "moe":
                inactive = (
                    3 * d * self.moe_d_ff * (self.num_experts - self.top_k)
                ) * self.num_repeats
                total -= inactive
        return total


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
