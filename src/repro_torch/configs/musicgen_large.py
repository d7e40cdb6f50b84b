"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

Transformer backbone only: the EnCodec codec is a stub frontend per the
carve-out; the model consumes 4 parallel codebook token streams (summed
embeddings, delay-pattern handling lives in the data pipeline) and emits
4 codebook logit heads.

Port of ``repro.configs.musicgen_large``, the same numbers.
"""

from repro_torch.configs.base import LayerTemplate, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,  # MHA
    head_dim=64,
    pattern=(LayerTemplate("global", "dense"),),
    act="gelu",
    tie_embeddings=False,
    modality="audio-codec",
    num_codebooks=4,
    rope_theta=10_000.0,
)
