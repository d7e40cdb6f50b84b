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

Split-K across ranks, for a cache split by position over the mesh's
``model`` axis: :func:`flash_decode_partials` runs the same passes over a
rank's own rows ``[start, length)`` (local positions) and returns its
un-normalised float32 ``(m, l, acc)`` (``m [B, Hkv, G]`` the max score,
``l`` the sum of ``exp(score - m)``, ``acc [B, Hkv, G, Dh]`` the weighted
sum of ``v``); a rank with no row in range gets ``m = -1e30, l = 0, acc =
0`` without a launch, which merges with weight 0.  The ranks gather their
partials in rank order along a leading axis R, and
:func:`flash_decode_merge` combines them (the kernel's combine pass over
the gathered ``[R, B * Hkv, G(, Dh)]``, one launch) and divides by ``max(l,
1e-30)``.  Beside them, :func:`flash_decode_partials_plain` and
:func:`flash_decode_merge_plain` carry the reference's arithmetic per
shard (float32 scores, the softcap, ``where(valid, ., -1e30)``, max,
``exp``, sum, weighted sum) and across shards (the max of the ``m``,
``exp(m - max)`` weights, ``/ max(l, 1e-30)``).

Stated tolerance, kernel vs plain on the card: ``|d| <= 2e-5 * max|v|``
over the valid prefix (the scores' Dh products and the up to 524,288
weighted terms are summed in other orders, ``expf`` and ``tanhf`` against
PyTorch's ``exp`` and ``tanh``); the same for partials + merge against the
unsplit kernel.  ``launches`` counts the calls of :func:`flash_decode`
and :func:`flash_decode_partials` that launched, ``merge_launches`` the
calls of :func:`flash_decode_merge` that launched.  A decode step over R
position shards therefore launches, per attention layer, one partials
call on each rank whose shard meets ``[start, length)`` and one merge on
every rank.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0
merge_launches = 0

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


def _checked(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             softcap: float | None) -> int:
    """Raise unless the kernel takes ``q``, ``k``, ``v`` and ``softcap``;
    return the inputs' dtype code."""
    if not q.is_cuda:
        raise ValueError(f"{kernel}: the CUDA kernel needs CUDA tensors")
    dev = q.device
    code = _build.float_code(kernel, "q", q)
    _build.require_tensor(kernel, "q", q, q.dtype, dev, (None, None, None, None))
    b, hkv, group, dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != dev:
            raise TypeError(f"{kernel}: {name} must be {q.dtype} on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if t.dim() != 4 or t.shape[0] != b or t.shape[2:] != (hkv, dh):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected "
                             f"({b}, S, {hkv}, {dh})")
        if t.stride()[1:] != (hkv * dh, dh, 1):
            raise ValueError(f"{kernel}: each request's {name} [S, Hkv, Dh] must be "
                             f"contiguous, strides {t.stride()}")
    if k.shape[1] != v.shape[1] or k.stride(0) != v.stride(0):
        raise ValueError(f"{kernel}: k and v must have one shape and one batch stride")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{kernel}: softcap {softcap} must be positive")
    if dh not in HEAD_DIMS or not 1 <= group <= MAX_GROUP or group * dh > MAX_GROUP_X_DH:
        raise ValueError(f"{kernel}: Dh {dh} (one of {HEAD_DIMS}) and group {group} "
                         f"(<= {MAX_GROUP}, group * Dh <= {MAX_GROUP_X_DH}) not taken")
    if (k.data_ptr() % ALIGN or v.data_ptr() % ALIGN
            or k.stride(0) * k.element_size() % ALIGN):
        raise ValueError(f"{kernel}: k, v and their batch stride must be aligned to "
                         f"{ALIGN} bytes")
    return code


def _launch(q, k, v, start: int, length: int, scale: float, softcap: float | None, code: int,
            out: torch.Tensor, m_out: torch.Tensor | None, l_out: torch.Tensor | None) -> None:
    """One call of the C entry over ``[start, length)``: the geometry from
    the card's SM count, the split partials, the launches."""
    dev = q.device
    b, hkv, group, dh = q.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, rows = num_splits(b * hkv, length - start, sms)
    m_part = l_part = acc_part = out  # one split: the split pass writes alone
    if n_split > 1:
        m_part = torch.empty((b * hkv, n_split, group), dtype=torch.float32, device=dev)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((b * hkv, n_split, group, dh), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), out.data_ptr(), None if m_out is None else m_out.data_ptr(),
            None if l_out is None else l_out.data_ptr(), b, hkv, group, dh, k.stride(0), start,
            length, rows, n_split, scale, 0.0 if softcap is None else softcap, code, stream,
        )
    _build.check(rc, "flash_decode")


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
    code = _checked("flash_decode", q, k, v, softcap)
    s = k.shape[1]
    if not 1 <= length <= s:
        raise ValueError(f"flash_decode: length {length} outside [1, {s}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window {window} must be at least 1")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch(q, k, v, window_start(length, window), length, scale, softcap, code, out, None, None)
    launches += 1
    return out


def empty_partials(b: int, hkv: int, group: int, dh: int, device) -> tuple:
    """The partial of a shard with no row in range: ``m = -1e30``, ``l =
    0``, ``acc = 0`` (weight 0 in the merge, never a NaN)."""
    m = torch.full((b, hkv, group), MASK_VALUE, dtype=torch.float32, device=device)
    return (m, torch.zeros_like(m),
            torch.zeros((b, hkv, group, dh), dtype=torch.float32, device=device))


def flash_decode_partials(
    q: torch.Tensor,  # [B, Hkv, G, Dh] contiguous
    k: torch.Tensor,  # [B, S, Hkv, Dh]: this rank's positions, each request's rows contiguous
    v: torch.Tensor,  # like k, with k's strides
    start: int,  # this rank's rows [start, length), in its local positions
    length: int,
    scale: float,
    *,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:  # float32 m, l [B, Hkv, G]; acc [.., Dh]
    """This rank's un-normalised ``(m, l, acc)`` over its rows ``[start,
    length)``: the kernel's passes in partials mode (one counted launch),
    or, when ``length <= start`` or the batch is empty, the empty partial
    without a launch.  Raises as :func:`flash_decode` does, and for ``start
    < 0`` or ``length > S``."""
    global launches
    code = _checked("flash_decode_partials", q, k, v, softcap)
    s = k.shape[1]
    if start < 0 or length > s:
        raise ValueError(f"flash_decode_partials: rows [{start}, {length}) outside [0, {s}]")
    b, hkv, group, dh = q.shape
    if length <= start or b == 0:
        return empty_partials(b, hkv, group, dh, q.device)
    m = torch.empty((b, hkv, group), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch(q, k, v, start, length, scale, softcap, code, acc, m, l)
    launches += 1
    return m, l, acc


def flash_decode_partials_plain(
    q: torch.Tensor,  # [B, Hkv, G, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    start: int,
    length: int,
    scale: float,
    *,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`flash_decode_partials`: the
    reference's decode over this shard's rows, stopped before the
    division."""
    b, hkv, group, dh = q.shape
    if length <= start:
        return empty_partials(b, hkv, group, dh, q.device)
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    kpos = torch.arange(k.shape[1], device=k.device)
    scores = torch.where((kpos >= start) & (kpos < length), scores, MASK_VALUE)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd", p, v.float())


def flash_decode_merge(
    m: torch.Tensor,  # float32 [R, B, Hkv, G], the ranks' partials in rank order
    l: torch.Tensor,  # float32 [R, B, Hkv, G]
    acc: torch.Tensor,  # float32 [R, B, Hkv, G, Dh]
) -> torch.Tensor:  # float32 [B, Hkv, G, Dh]
    """Launch the merge on ``torch.cuda.current_stream()``: the partials
    combined in rank order and divided by ``max(l, 1e-30)``, one counted
    launch (none for an empty batch).  Raises on a CPU tensor, another
    dtype or layout, and on a non-zero ``cudaGetLastError()``."""
    global merge_launches
    if not m.is_cuda:
        raise ValueError("flash_decode_merge: the CUDA kernel needs CUDA tensors")
    dev = m.device
    _build.require_tensor("flash_decode_merge", "acc", acc, torch.float32, dev,
                          (None, None, None, None, None))
    r, b, hkv, group, dh = acc.shape
    for name, t in (("m", m), ("l", l)):
        _build.require_tensor("flash_decode_merge", name, t, torch.float32, dev,
                              (r, b, hkv, group))
    if r < 1 or dh not in HEAD_DIMS or not 1 <= group <= MAX_GROUP \
            or group * dh > MAX_GROUP_X_DH:
        raise ValueError(f"flash_decode_merge: R {r} (>= 1), Dh {dh} (one of {HEAD_DIMS}) "
                         f"and group {group} (<= {MAX_GROUP}, group * Dh <= "
                         f"{MAX_GROUP_X_DH}) not taken")
    out = torch.empty((b, hkv, group, dh), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_flash_decode_merge(m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                                          out.data_ptr(), b * hkv, group, dh, r, stream)
    _build.check(rc, "flash_decode_merge")
    merge_launches += 1
    return out


def flash_decode_merge_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_decode_merge`."""
    mx = m.amax(dim=0)
    c = torch.exp(m - mx)
    return (acc * c[..., None]).sum(dim=0) / torch.clamp_min((l * c).sum(dim=0), 1e-30)[..., None]
