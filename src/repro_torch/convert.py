"""Carry state across from the reference: numpy arrays -> the port's objects.

The JAX package's arrays go through ``numpy.asarray`` on the caller's
side; these functions build the port's :class:`PaddedCSR`,
:class:`BlockCSR`, initial ``w``, dense problem and LM parameters from
them, checking what the port's kernels take on trust (dtypes, shapes, ids
inside their block).  The tests use them to feed both packages identical
bytes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import FeaturePartition
from repro_torch.data.block_csr import BlockCSR
from repro_torch.data.sparse import PaddedCSR


def _tensor(a: np.ndarray, dtype: np.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != dtype:
        raise TypeError(f"expected {dtype} array, got {a.dtype}")
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def padded_csr(
    indices: np.ndarray, values: np.ndarray, labels: np.ndarray, dim: int
) -> PaddedCSR:
    """A :class:`PaddedCSR` from int32 ids, float32 values and labels."""
    idx = _tensor(indices, np.int32)
    val = _tensor(values, np.float32)
    if idx.shape != val.shape or idx.dim() != 2:
        raise ValueError(f"indices {tuple(idx.shape)} vs values {tuple(val.shape)}")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= dim):
        raise ValueError(f"feature ids must lie in [0, {dim})")
    return PaddedCSR(
        indices=idx, values=val, labels=_tensor(labels, np.float32), dim=int(dim)
    )


def block_csr(
    indices: Sequence[np.ndarray],
    values: Sequence[np.ndarray],
    labels: np.ndarray,
    bounds: Sequence[int],
    dim: int,
    nnz_max: int | None = None,
    nnz_col: Sequence[np.ndarray] | None = None,
) -> BlockCSR:
    """A :class:`BlockCSR` from per-block local ids/values and the bounds."""
    partition = FeaturePartition(dim=int(dim), bounds=tuple(int(b) for b in bounds))
    if len(indices) != partition.num_blocks or len(values) != partition.num_blocks:
        raise ValueError("one indices/values array per block required")
    idx = tuple(_tensor(i, np.int32) for i in indices)
    val = tuple(_tensor(v, np.float32) for v in values)
    for l, (i, v) in enumerate(zip(idx, val)):
        d_l = partition.block_sizes()[l]
        if i.shape != v.shape or i.dim() != 2:
            raise ValueError(f"block {l}: indices {tuple(i.shape)} vs values {tuple(v.shape)}")
        if i.numel() and (int(i.min()) < 0 or int(i.max()) >= d_l):
            raise ValueError(f"block {l}: local ids must lie in [0, {d_l})")
    cols = None
    if nnz_col is not None:
        cols = tuple(_tensor(c, np.int32) for c in nnz_col)
    return BlockCSR(
        partition=partition,
        indices=idx,
        values=val,
        labels=_tensor(labels, np.float32),
        dim=int(dim),
        nnz_col=cols,
        nnz_max=nnz_max,
    )


def init_w(w: np.ndarray) -> torch.Tensor:
    """An initial iterate (float32 [d]) from a reference array."""
    t = _tensor(w, np.float32)
    if t.dim() != 1:
        raise ValueError(f"w must be 1-D, got shape {tuple(t.shape)}")
    return t


def dense_problem(
    D: np.ndarray, y: np.ndarray, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense layout's data ``D [d, N]`` and labels ``y [N]`` on ``device``.

    Float32 arrays, as ``make_dense_classification`` makes them; ``D``
    comes back contiguous, the layout ``ops.margins_dense`` takes.
    """
    data = _tensor(D, np.float32)
    labels = _tensor(y, np.float32)
    if data.dim() != 2 or labels.shape != (data.shape[1],):
        raise ValueError(f"D {tuple(data.shape)} vs y {tuple(labels.shape)}: want [d, N] and [N]")
    return data.contiguous().to(device), labels.to(device)


def _float_tensor(path: str, a: np.ndarray) -> torch.Tensor:
    """float32 as is; bfloat16 (numpy's ``ml_dtypes`` type, which
    ``torch.from_numpy`` does not take) through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return torch.from_numpy(np.array(a, copy=True))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16), copy=True)).view(torch.bfloat16)
    raise TypeError(f"{path}: expected a float32 or bfloat16 array, got {a.dtype}")


def lm_params(
    tree: dict, cfg: ModelConfig | None = None, device: torch.device | str = "cpu"
) -> dict:
    """The port's LM parameters from the reference's pytree of numpy arrays
    (``jax.tree.map(np.asarray, params)``), leaf for leaf: the same keys,
    the stacked ``[R, ...]`` block leaves, the same bytes.

    Checks: the structure (a dense global-attention text model: ``embed``,
    optional ``lm_head``, ``blocks`` as a tuple of dicts, ``final_norm``),
    float32 or bfloat16 leaves with the norm scales in float32 and the
    weights in one dtype, one repeat count per block, and shapes that
    agree with each other — and, given ``cfg``, with its widths (the
    vocabulary may be padded to a multiple of 256) and its dtype.
    """
    if not isinstance(tree, dict) or not isinstance(tree.get("blocks"), tuple):
        raise ValueError("expected the reference's params dict with a tuple of blocks")
    extra = set(tree) - {"embed", "lm_head", "blocks", "final_norm"}
    if extra:
        raise ValueError(f"unported parameter groups {sorted(extra)} (ROADMAP queue 1 item 11)")
    weight_dtypes: set[torch.dtype] = set()

    def leaf(path: str, a, want_shape: tuple) -> torch.Tensor:
        t = _float_tensor(path, a)
        if "norm" in path.rsplit(".", 1)[-1]:
            if t.dtype != torch.float32:
                raise TypeError(f"{path}: norm scales are float32, got {t.dtype}")
        else:
            weight_dtypes.add(t.dtype)
        if t.dim() != len(want_shape) or any(
            w is not None and g != w for g, w in zip(t.shape, want_shape)
        ):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected {want_shape}")
        return t.to(device)

    embed = leaf("embed", tree["embed"], (None, None))
    vocab, d = embed.shape
    out: dict = {"embed": embed}
    if "lm_head" in tree:
        out["lm_head"] = leaf("lm_head", tree["lm_head"], (d, vocab))
    out["final_norm"] = leaf("final_norm", tree["final_norm"], (d,))
    blocks = []
    h = hkv = dh = ff = 0
    for i, block in enumerate(tree["blocks"]):
        if set(block) - {"norm1", "norm2", "norm1_post", "norm2_post", "attn", "ffn"}:
            raise ValueError(f"blocks[{i}]: unported layers {sorted(block)} "
                             "(ROADMAP queue 1 item 11)")
        r = np.asarray(block["norm1"]).shape[0]
        attn = block["attn"]
        _, _, h, dh = np.asarray(attn["wq"]).shape
        hkv = np.asarray(attn["wk"]).shape[2]
        shapes = {
            "wq": (r, d, h, dh), "wk": (r, d, hkv, dh), "wv": (r, d, hkv, dh),
            "wo": (r, h, dh, d), "q_norm": (r, dh), "k_norm": (r, dh),
        }
        new = {k: leaf(f"blocks[{i}].{k}", v, (r, d)) for k, v in block.items()
               if k not in ("attn", "ffn")}
        new["attn"] = {k: leaf(f"blocks[{i}].attn.{k}", v, shapes[k]) for k, v in attn.items()}
        if "ffn" in block:
            ff = np.asarray(block["ffn"]["w_up"]).shape[2]
            fshapes = {"w_up": (r, d, ff), "w_gate": (r, d, ff), "w_down": (r, ff, d)}
            new["ffn"] = {k: leaf(f"blocks[{i}].ffn.{k}", v, fshapes[k])
                          for k, v in block["ffn"].items()}
        blocks.append(new)
    out["blocks"] = tuple(blocks)
    if len(weight_dtypes) > 1:
        raise TypeError(f"weights of more than one dtype: {sorted(map(str, weight_dtypes))}")
    if cfg is not None:
        want_vocab = (cfg.vocab_size, -(-cfg.vocab_size // 256) * 256)
        hd = cfg.resolved_head_dim
        got = (vocab, d, h, hkv, dh, ff, sum(np.asarray(b["norm1"]).shape[0]
                                              for b in tree["blocks"]))
        want = (vocab if vocab in want_vocab else want_vocab, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, hd, cfg.d_ff, cfg.num_layers)
        if got != want or ("lm_head" in out) == cfg.tie_embeddings:
            raise ValueError(f"params (vocab, d, heads, kv heads, head dim, d_ff, layers) "
                             f"{got} do not fit {cfg.name}: {want}")
        if str(next(iter(weight_dtypes))).split(".")[1] != cfg.dtype:
            raise TypeError(f"weights are {next(iter(weight_dtypes))}, {cfg.name} is {cfg.dtype}")
    return out
