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


# Leaves that stay float32 whatever the weights' dtype: the norm scales
# (a key holding "norm"), the MoE router and the SSD decay, step bias and
# skip (as the reference's init_moe / init_ssm make them).
F32_LEAVES = ("router", "a_log", "dt_bias", "d_skip")


def lm_params(
    tree: dict,
    cfg: ModelConfig | None = None,
    device: torch.device | str = "cpu",
    weight_dtype: str | None = None,
) -> dict:
    """The port's LM parameters from the reference's pytree of numpy arrays
    (``jax.tree.map(np.asarray, params)``), leaf for leaf: the same keys,
    the stacked ``[R, ...]`` block leaves, the same bytes.

    Checks: the structure (``embed`` — ``[K, V, D]`` for audio —, optional
    ``lm_head``, optional ``vision_proj``, ``blocks`` as a tuple of dicts
    with an ``attn`` or ``ssm`` mixer and an optional ``ffn`` or ``moe``,
    ``final_norm``), float32 or bfloat16 leaves with the norm scales and
    :data:`F32_LEAVES` in float32 and every other weight in one dtype, one
    repeat count per block, and shapes that agree with each other — and,
    given ``cfg``, with its widths (the vocabulary may be padded to a
    multiple of 256) and its dtype, or ``weight_dtype`` where given (a
    train state's float32 masters under a bfloat16 ``cfg``).
    """
    if not isinstance(tree, dict) or not isinstance(tree.get("blocks"), tuple):
        raise ValueError("expected the reference's params dict with a tuple of blocks")
    extra = set(tree) - {"embed", "lm_head", "vision_proj", "blocks", "final_norm"}
    if extra:
        raise ValueError(f"unknown parameter groups {sorted(extra)}")
    weight_dtypes: set[torch.dtype] = set()

    def leaf(path: str, a, want_shape: tuple) -> torch.Tensor:
        t = _float_tensor(path, a)
        name = path.rsplit(".", 1)[-1]
        if "norm" in name or name in F32_LEAVES:
            if t.dtype != torch.float32:
                raise TypeError(f"{path}: norm scales and {', '.join(F32_LEAVES)} are "
                                f"float32, got {t.dtype}")
        else:
            weight_dtypes.add(t.dtype)
        if t.dim() != len(want_shape) or any(
            w is not None and g != w for g, w in zip(t.shape, want_shape)
        ):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected {want_shape}")
        return t.to(device)

    def group(path: str, sub: dict, shapes: dict) -> dict:
        unknown = set(sub) - set(shapes)
        if unknown:
            raise ValueError(f"{path}: unknown leaves {sorted(unknown)}")
        return {k: leaf(f"{path}.{k}", v, shapes[k]) for k, v in sub.items()}

    audio = np.asarray(tree["embed"]).ndim == 3
    embed = leaf("embed", tree["embed"], (None,) * (3 if audio else 2))
    codebooks = embed.shape[0] if audio else 0
    vocab, d = embed.shape[-2:]
    lead = (codebooks,) if audio else ()
    out: dict = {"embed": embed}
    if "lm_head" in tree:
        out["lm_head"] = leaf("lm_head", tree["lm_head"], lead + (d, vocab))
    elif audio:
        raise ValueError("lm_head: the audio heads [K, D, V] are missing")
    frontend = 0
    if "vision_proj" in tree:
        out["vision_proj"] = leaf("vision_proj", tree["vision_proj"], (None, d))
        frontend = out["vision_proj"].shape[0]
    out["final_norm"] = leaf("final_norm", tree["final_norm"], (d,))
    w = {k: 0 for k in ("heads", "kv_heads", "head_dim", "d_ff", "experts", "moe_d_ff",
                        "ssm_state", "d_inner", "ssm_head_dim", "ssm_conv")}
    blocks = []
    for i, block in enumerate(tree["blocks"]):
        path = f"blocks[{i}]"
        if set(block) - {"norm1", "norm2", "norm1_post", "norm2_post", "attn", "ssm", "ffn",
                         "moe"} or ("attn" in block) == ("ssm" in block):
            raise ValueError(f"{path}: unexpected layers {sorted(block)}")
        r = np.asarray(block["norm1"]).shape[0]
        new = {k: leaf(f"{path}.{k}", v, (r, d)) for k, v in block.items()
               if k.startswith("norm")}
        if "attn" in block:
            _, _, h, dh = np.asarray(block["attn"]["wq"]).shape
            hkv = np.asarray(block["attn"]["wk"]).shape[2]
            w.update(heads=h, kv_heads=hkv, head_dim=dh)
            new["attn"] = group(f"{path}.attn", block["attn"], {
                "wq": (r, d, h, dh), "wk": (r, d, hkv, dh), "wv": (r, d, hkv, dh),
                "wo": (r, h, dh, d), "q_norm": (r, dh), "k_norm": (r, dh)})
        else:
            di = np.asarray(block["ssm"]["out_proj"]).shape[1]
            nh = np.asarray(block["ssm"]["a_log"]).shape[1]
            width, conv_dim = np.asarray(block["ssm"]["conv_w"]).shape[1:]
            n = (conv_dim - di) // 2
            w.update(d_inner=di, ssm_state=n, ssm_head_dim=di // max(nh, 1), ssm_conv=width)
            new["ssm"] = group(f"{path}.ssm", block["ssm"], {
                "in_proj": (r, d, 2 * di + 2 * n + nh), "conv_w": (r, width, di + 2 * n),
                "conv_b": (r, di + 2 * n), "a_log": (r, nh), "dt_bias": (r, nh),
                "d_skip": (r, nh), "out_norm": (r, di), "out_proj": (r, di, d)})
        if "ffn" in block:
            ff = np.asarray(block["ffn"]["w_up"]).shape[2]
            w["d_ff"] = ff
            new["ffn"] = group(f"{path}.ffn", block["ffn"], {
                "w_up": (r, d, ff), "w_gate": (r, d, ff), "w_down": (r, ff, d)})
        if "moe" in block:
            _, e, _, f = np.asarray(block["moe"]["w_up"]).shape
            w.update(experts=e, moe_d_ff=f)
            new["moe"] = group(f"{path}.moe", block["moe"], {
                "router": (r, d, e), "w_gate": (r, e, d, f), "w_up": (r, e, d, f),
                "w_down": (r, e, f, d)})
        blocks.append(new)
    out["blocks"] = tuple(blocks)
    if len(weight_dtypes) > 1:
        raise TypeError(f"weights of more than one dtype: {sorted(map(str, weight_dtypes))}")
    if cfg is not None:
        want_vocab = (cfg.vocab_size, -(-cfg.vocab_size // 256) * 256)
        attn = cfg.has_attention
        ssm = cfg.has_ssm
        got = dict(w, vocab=vocab, d_model=d, codebooks=codebooks, frontend_dim=frontend,
                   layers=sum(np.asarray(b["norm1"]).shape[0] for b in tree["blocks"]))
        want = dict(
            vocab=vocab if vocab in want_vocab else want_vocab, d_model=cfg.d_model,
            heads=cfg.num_heads if attn else 0, kv_heads=cfg.num_kv_heads if attn else 0,
            head_dim=cfg.resolved_head_dim if attn else 0,
            d_ff=cfg.d_ff if any(t.ffn == "dense" for t in cfg.pattern) else 0,
            experts=cfg.num_experts if cfg.has_moe else 0,
            moe_d_ff=cfg.moe_d_ff if cfg.has_moe else 0,
            ssm_state=cfg.ssm_state if ssm else 0,
            d_inner=cfg.ssm_expand * cfg.d_model if ssm else 0,
            ssm_head_dim=cfg.ssm_head_dim if ssm else 0, ssm_conv=cfg.ssm_conv if ssm else 0,
            codebooks=cfg.num_codebooks if cfg.modality == "audio-codec" else 0,
            frontend_dim=cfg.frontend_dim if cfg.modality == "vision" else 0,
            layers=cfg.num_layers)
        tied = "lm_head" not in out
        if got != want or (tied != cfg.tie_embeddings and not audio):
            diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
            raise ValueError(f"params do not fit {cfg.name}: (got, want) {diff}, tied {tied}")
        want_dtype = weight_dtype or cfg.dtype
        if str(next(iter(weight_dtypes))).split(".")[1] != want_dtype:
            raise TypeError(f"weights are {next(iter(weight_dtypes))}, {cfg.name} wants "
                            f"{want_dtype}")
    return out


def _step_count(path: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.shape != () or a.dtype != np.int32:
        raise ValueError(f"{path}: expected a 0-dim int32 count, got {a.dtype} {a.shape}")
    return torch.tensor(int(a), dtype=torch.int32, device=device)


def train_state(tree: dict, cfg: ModelConfig, device: torch.device | str = "cpu") -> dict:
    """The port's train state (``repro_torch.train.loop``) from the
    reference's (``jax.tree.map(np.asarray, state)``): ``{"params":
    float32 masters, "opt": ..., "step": 0-dim int32}``.

    The masters and every moment tree go through :func:`lm_params`' checks
    against ``cfg`` with float32 weights whatever ``cfg.dtype``.  The
    optimizer state is told by its keys: adamw's ``{"m", "v", "t"}``,
    momentum's ``{"m"}``, sgd's ``()``.  A wrong structure, shape or
    optimizer kind raises ``ValueError``.
    """
    if not isinstance(tree, dict) or set(tree) != {"params", "opt", "step"}:
        raise ValueError("expected the reference's train state {'params', 'opt', 'step'}")
    params = lm_params(tree["params"], cfg, device, weight_dtype="float32")
    opt = tree["opt"]
    kinds = {("m", "t", "v"): "adamw", ("m",): "momentum"}
    if isinstance(opt, tuple) and not opt:
        kind = "sgd"
    elif isinstance(opt, dict) and tuple(sorted(opt)) in kinds:
        kind = kinds[tuple(sorted(opt))]
    else:
        keys = sorted(opt) if isinstance(opt, dict) else type(opt).__name__
        raise ValueError(f"opt: not an adamw, momentum or sgd state ({keys})")
    new_opt: dict | tuple = ()
    if kind != "sgd":
        new_opt = {}
        for k in ("m", "v"):
            if k not in opt:
                continue
            got, want = _leaf_paths(opt[k]), _leaf_paths(tree["params"])
            if [p for p, _ in got] != [p for p, _ in want]:
                raise ValueError(f"opt.{k}: not the masters' structure")
            for (path, a), (_, b) in zip(got, want):
                if np.shape(a) != np.shape(b):
                    raise ValueError(f"opt.{k}{path}: shape {np.shape(a)}, the masters' "
                                     f"{np.shape(b)}")
            new_opt[k] = lm_params(opt[k], cfg, device, weight_dtype="float32")
        if kind == "adamw":
            new_opt["t"] = _step_count("opt.t", opt["t"], device)
    return {"params": params, "opt": new_opt, "step": _step_count("step", tree["step"], device)}


def _leaf_paths(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_paths(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]
