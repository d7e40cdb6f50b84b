"""flash_decode: one-token GQA attention over a KV cache, a decode batch at once.

    out[b, j, g, :] = sum_{start <= s < length} softmax_s(cap(scale * q[b, j, g] . k[b, s, j]))
                      * v[b, s, j]

with ``cap(x) = softcap * tanh(x / softcap)`` for an attention logit
softcap (gemma2) and the identity without one, and ``start = max(0,
length - window)`` for a sliding window (gemma2's local layers), else 0.

``q [B, Hkv, G, Dh]``, ``k``/``v [B, S, Hkv, Dh]`` (float32 or bfloat16,
one dtype), ``out`` float32 ``[B, Hkv, G, Dh]``; query head ``h = j * G +
g`` uses KV head ``j``, as ``q.reshape(b, hkv, g, dh)`` groups them in
the reference's decode.

The CUDA kernel (``csrc/flash_decode.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_decode.py::flash_decode`` (one request per call,
validity as an additive 0 / -1e30 bias).  It is a flash-decoding split
over S: each block of grid ``(B * Hkv, n_split)`` streams its positions
through per-warp rings of K/V tiles in shared memory (``cp.async``), on
the tensor cores in bfloat16 at ``Dh <= 128`` and in float32 FFMA
otherwise, and leaves one ``(m, l, acc)`` per split; a second launch combines the splits
in split order, or with one split the block writes ``out`` itself — one
counted launch per call, no atomics.  Positions at or past ``length``, and
before a window's ``start``, are skipped (exactly what their -1e30 bias
does in float32), so a window reads ``min(length, window)`` rows.  The
softcap is ``tanhf`` on the scaled score, a compile-time flag of both
split passes.  This module owns the geometry (:func:`num_splits`, from
the card's SM count, over ``[start, length)``) and allocates the
partials.  Beside it is :func:`flash_decode_plain`, the arithmetic of
``repro.models.attention.attention_decode``: float32 scores over the
whole cache, the softcap, ``where(valid, ., -1e30)`` with the window in
``valid``, max, exp, sum, weighted sum, ``/ max(l, 1e-30)``.

Stated tolerance, kernel vs plain on the card: ``|d| <= 2e-5 * max|v|``
over the valid prefix (the scores' Dh products and the up to 524,288
weighted terms are summed in other orders, ``expf`` and ``tanhf`` against
PyTorch's ``exp`` and ``tanh``).  ``launches`` counts the wrapper's calls that launched.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

MASK_VALUE = -1e30
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 16
MAX_GROUP_X_DH = 2048  # q rows and the warps' accumulators fit the shared memory
BLOCKS_PER_SM = 2  # resident split blocks an SM at qwen3-14b's bfloat16, Dh 128 (104 KB each)
WAVES = 1  # the grid aims at one wave of resident blocks: fewer, longer splits stream best
MIN_SPLIT_ROWS = 128  # two 16-row tiles for each of a block's four warps
MAX_SPLITS = 65535
ALIGN = 16  # cp.async copies 16 bytes: k, v and their batch stride


def num_splits(batch_heads: int, length: int, sms: int) -> tuple[int, int]:
    """``(n_split, rows_per_split)``: about ``WAVES * BLOCKS_PER_SM * sms``
    blocks over the ``batch_heads`` (request, KV head) pairs, never more
    (so the last wave is full), at least ``MIN_SPLIT_ROWS`` positions a
    split, and no empty split.  One split (one launch) when ``length`` is
    at most ``MIN_SPLIT_ROWS`` or the pairs alone fill the waves."""
    want = max(1, (WAVES * BLOCKS_PER_SM * sms) // batch_heads)
    n = max(1, min(want, -(-length // MIN_SPLIT_ROWS), MAX_SPLITS))
    rows = -(-length // n)
    return -(-length // rows), rows


def flash_decode_plain(
    q: torch.Tensor,  # [B, Hkv, G, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    length: int,  # valid prefix: positions 0 .. length - 1
    scale: float,
    *,
    softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:  # float32 [B, Hkv, G, Dh]
    """The plain PyTorch version, step for step the reference's decode
    (query position ``length - 1``)."""
    pos = length - 1
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    kpos = torch.arange(k.shape[1], device=k.device)
    valid = kpos <= pos
    if window is not None:
        valid &= (pos - kpos) < window
    scores = torch.where(valid, scores, MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskd->bkgd", p, v.float()) / torch.clamp_min(l, 1e-30)


def window_start(length: int, window: int | None) -> int:
    """The first position a query at ``length - 1`` sees: ``(pos - kpos) <
    window`` holds from ``length - window`` on."""
    return 0 if window is None else max(0, length - window)


def flash_decode(
    q: torch.Tensor,  # [B, Hkv, G, Dh] contiguous
    k: torch.Tensor,  # [B, S, Hkv, Dh], each request's [S, Hkv, Dh] contiguous
    v: torch.Tensor,  # like k, with k's strides
    length: int,
    scale: float,
    *,
    softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:  # float32 [B, Hkv, G, Dh]
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Raises on a CPU tensor, another dtype, a shape or layout the kernel
    does not take, ``length < 1`` or ``length > S``, a softcap that is not
    positive, a window below 1, and on a non-zero ``cudaGetLastError()``.
    ``length``, ``scale``, ``softcap`` and ``window`` are host numbers, so
    the call never waits on the card.
    """
    global launches
    if not q.is_cuda:
        raise ValueError("flash_decode: the CUDA kernel needs CUDA tensors")
    dev = q.device
    code = _build.float_code("flash_decode", "q", q)
    _build.require_tensor("flash_decode", "q", q, q.dtype, dev, (None, None, None, None))
    b, hkv, group, dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != dev:
            raise TypeError(f"flash_decode: {name} must be {q.dtype} on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if t.dim() != 4 or t.shape[0] != b or t.shape[2:] != (hkv, dh):
            raise ValueError(f"flash_decode: {name} has shape {tuple(t.shape)}, expected "
                             f"({b}, S, {hkv}, {dh})")
        if t.stride()[1:] != (hkv * dh, dh, 1):
            raise ValueError(f"flash_decode: each request's {name} [S, Hkv, Dh] must be "
                             f"contiguous, strides {t.stride()}")
    if k.shape[1] != v.shape[1] or k.stride(0) != v.stride(0):
        raise ValueError("flash_decode: k and v must have one shape and one batch stride")
    s = k.shape[1]
    if not 1 <= length <= s:
        raise ValueError(f"flash_decode: length {length} outside [1, {s}]")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_decode: softcap {softcap} must be positive")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window {window} must be at least 1")
    start = window_start(length, window)
    if dh not in HEAD_DIMS or not 1 <= group <= MAX_GROUP or group * dh > MAX_GROUP_X_DH:
        raise ValueError(f"flash_decode: Dh {dh} (one of {HEAD_DIMS}) and group {group} "
                         f"(<= {MAX_GROUP}, group * Dh <= {MAX_GROUP_X_DH}) not taken")
    if (k.data_ptr() % ALIGN or v.data_ptr() % ALIGN
            or k.stride(0) * k.element_size() % ALIGN):
        raise ValueError(f"flash_decode: k, v and their batch stride must be aligned to "
                         f"{ALIGN} bytes")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, rows = num_splits(b * hkv, length - start, sms)
    out = torch.empty((b, hkv, group, dh), dtype=torch.float32, device=dev)
    m_part = l_part = acc_part = out  # one split: the kernel writes out alone
    if n_split > 1:
        m_part = torch.empty((b * hkv, n_split, group), dtype=torch.float32, device=dev)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((b * hkv, n_split, group, dh), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), out.data_ptr(), b, hkv, group, dh, k.stride(0), start,
            length, rows, n_split, scale, 0.0 if softcap is None else softcap, code, stream,
        )
    _build.check(rc, "flash_decode")
    launches += 1
    return out
