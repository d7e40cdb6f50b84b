"""Shape-and-dtype stand-ins for every model input (the dry-run contract).

Port of ``repro.launch.inputs``.  Where the reference returns
``jax.ShapeDtypeStruct``\\ s, these return tensors on the ``meta``
device: the shapes and dtypes of what the step functions consume (int32
token ids and labels, float32 patch embeddings), with no storage, so
nothing is allocated.  :mod:`repro_torch.data.token_stream` yields
exactly the train specs.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig


def _spec(dims: tuple, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return torch.empty(dims, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape, grad_accum: int = 1) -> dict:
    b, s = shape.global_batch, shape.seq_len

    def shaped(*dims, dtype=torch.int32):
        if grad_accum > 1:
            assert b % grad_accum == 0, (cfg.name, b, grad_accum)
            dims = (grad_accum, b // grad_accum) + dims[1:]
        return _spec(dims, dtype)

    if cfg.modality == "audio-codec":
        return {
            "tokens": shaped(b, s, cfg.num_codebooks),
            "labels": shaped(b, s, cfg.num_codebooks),
        }
    if cfg.modality == "vision":
        return {
            "tokens": shaped(b, s - cfg.num_patches),
            "patch_embeds": shaped(b, cfg.num_patches, cfg.frontend_dim, dtype=torch.float32),
            "labels": shaped(b, s),
        }
    return {"tokens": shaped(b, s), "labels": shaped(b, s)}


def decode_token_specs(cfg: ModelConfig, shape: InputShape) -> torch.Tensor:
    b = shape.global_batch
    if cfg.modality == "audio-codec":
        return _spec((b, 1, cfg.num_codebooks))
    return _spec((b, 1))


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.modality == "audio-codec":
        return {"tokens": _spec((b, s, cfg.num_codebooks))}
    if cfg.modality == "vision":
        return {
            "tokens": _spec((b, s - cfg.num_patches)),
            "patch_embeds": _spec((b, cfg.num_patches, cfg.frontend_dim), torch.float32),
        }
    return {"tokens": _spec((b, s))}
