"""Split-K of ``flash_decode`` across ranks, held against the whole-cache
decode and the JAX reference's decode attention.

A KV cache split by position over R ranks, played as threads of one
process (``dist.launch.play_ranks``), each running the mesh route's
``attention.split_k_decode``: its un-normalised partial ``(m, l, acc)``
over its own rows (``ops.decode_attention_partials``, the window reckoned
in global positions and clamped to the shard), the ranks' partials
gathered and merged in rank order (``ops.decode_attention_merge``) on
every rank.  On the CPU both take their plain versions.  Stated
tolerances:

* the plain partials + merge over R in {1, 2, 3, 4} uneven shards (one
  wholly past ``length``; with the softcap and the window, one wholly
  before the window's start) within ``SPLIT_TOL * max|v|`` of
  ``flash_decode_plain`` on the whole cache: the same float32 arithmetic,
  the max, the sum and the weighted sum taken per shard and then across
  shards (the measured worst, 9.4e-7, is a quarter of it);
* against the reference's ``repro.kernels.ops.decode_attention`` (its
  Pallas kernel in interpret mode), one request at a time, within
  ``DECODE_TOL`` (rtol and atol), the bound ``tests/test_torch_lm.py``
  holds the whole-cache plain version to.

The ``cuda``-marked test holds the kernel's partials + merge against the
unsplit kernel and the plain versions within ``2e-5 * max|v|`` (the
kernel's stated tolerance), bitwise across two runs, with one launch a
shard that holds a row of the window and one merge a rank; it skips here.  The
decode on a mesh is in ``tests/test_torch_train_mesh.py``.
``python tests/test_torch_decode_splitk.py`` prints the worst readings.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.dist.launch import RankError, play_ranks
from repro_torch.kernels import flash_decode as decode_mod
from repro_torch.kernels import ops
from repro_torch.models.attention import split_k_decode

SPLIT_TOL = 4e-6
DECODE_TOL = 2e-5
KERNEL_TOL = 2e-5
S, LENGTH, WINDOW, SOFTCAP = 40, 22, 10, 50.0  # the window starts at 12
# R -> shard bounds over the S positions: uneven, the last shard past LENGTH
# (R >= 2) and the first before the window's start (R >= 3)
BOUNDS = {1: (0, S), 2: (0, 23, S), 3: (0, 9, 22, S), 4: (0, 7, 16, 27, S)}
WORST: dict[str, float] = {}


def _record(name: str, ratio: float) -> None:
    WORST[name] = max(WORST.get(name, 0.0), float(ratio))


def _inputs(b: int, hkv: int, group: int, dh: int, s: int, seed: int, q_scale: float = 3.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, group, dh)).astype(np.float32) * q_scale
    k, v = (rng.normal(size=(b, s, hkv, dh)).astype(np.float32) for _ in range(2))
    return q, k, v


def _split(q, k, v, bounds, length, **opts):
    """One rank a shard, played as threads, each running ``split_k_decode``
    at its offset: the merged output (every rank's the same bits) and each
    rank's partials, as rank 0 gathered them."""
    opts = {"scale": q.shape[-1] ** -0.5, "softcap": None, "window": None, **opts}
    seen = []

    def rank(i, gather):
        lo, hi = bounds[i], bounds[i + 1]

        def keep(x):
            out = gather(x)
            if i == 0:
                seen.append(out)
            return out

        return split_k_decode(q, k[:, lo:hi], v[:, lo:hi], offset=lo, length=length,
                              gather=keep, **opts)

    outs = play_ranks(len(bounds) - 1, rank)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    return outs[0], list(zip(*seen))


@pytest.mark.parametrize("r", sorted(BOUNDS))
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dh", [64, 256])
@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("options", ["none", "softcap and window"])
def test_plain_split_matches_the_whole_cache(r, b, dh, group, options):
    opts = {"softcap": SOFTCAP, "window": WINDOW} if options != "none" else {}
    q, k, v = (torch.from_numpy(a) for a in _inputs(b, 2, group, dh, S, r * dh + group))
    ops.reset_launch_counts()
    got, parts = _split(q, k, v, BOUNDS[r], LENGTH, **opts)
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel
    want = decode_mod.flash_decode_plain(q, k, v, LENGTH, dh ** -0.5, **opts)
    assert got.dtype == torch.float32 and got.shape == want.shape
    start = decode_mod.window_start(LENGTH, opts.get("window"))
    err = float(torch.max(torch.abs(got - want)))
    ratio = err / (SPLIT_TOL * float(torch.max(torch.abs(v[:, start:LENGTH]))))
    _record(f"plain split vs whole cache, R = {r}", ratio)
    assert ratio <= 1.0, err
    # the shards with no row in [start, LENGTH) give the empty partial
    for (lo, hi), (m, l, acc) in zip(zip(BOUNDS[r], BOUNDS[r][1:]), parts):
        if max(lo, start) >= min(hi, LENGTH):
            assert bool(torch.all(m == decode_mod.MASK_VALUE))
            assert not bool(torch.any(l)) and not bool(torch.any(acc))
        else:
            assert bool(torch.all(l >= 1.0))  # the max's own term is exp(0)
    if r >= 2:
        assert BOUNDS[r][-2] >= LENGTH  # a shard wholly past the length
    if r >= 3 and opts:
        assert BOUNDS[r][1] <= start  # a shard wholly before the window


@pytest.mark.parametrize("h,hkv,dh,s,length", [(8, 8, 64, 1024, 1024), (8, 2, 64, 1024, 700),
                                               (16, 4, 128, 2048, 1), (4, 1, 32, 300, 257)])
@pytest.mark.parametrize("r", [2, 3])
def test_plain_split_matches_the_references_decode_attention(h, hkv, dh, s, length, r):
    """One request at a time against the reference's Pallas kernel in
    interpret mode (tests/test_kernels.py:113-120's shapes), the cache cut
    into r near-equal shards."""
    q, k, v = _inputs(2, hkv, h // hkv, dh, s, h * s + length + r, q_scale=1.0)
    bounds = tuple(round(i * s / r) for i in range(r + 1))
    got, _ = _split(*(torch.from_numpy(a) for a in (q, k, v)), bounds, length)
    interpret = jax.jit(lambda *a: r_ops.decode_attention(*a, length=length, interpret=True))
    for i in range(q.shape[0]):
        want = np.asarray(interpret(jnp.asarray(q[i].reshape(h, dh)), jnp.asarray(k[i]),
                                    jnp.asarray(v[i])))
        want = torch.from_numpy(want.reshape(hkv, h // hkv, dh).copy())
        err = torch.abs(got[i] - want)
        tol = DECODE_TOL + DECODE_TOL * torch.abs(want)
        _record(f"plain split vs reference, R = {r}", float(torch.max(err / tol)))
        assert bool(torch.all(err <= tol)), float(err.max())


def test_partials_map_the_global_window_onto_each_shard():
    """``decode_attention_partials`` at offset o over rows [o, o + S_r) is
    the plain partials over the local rows [clamp(start - o), clamp(length
    - o)); lengths and windows it does not take raise."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 3, 32, 64, 5))
    for offset, rows, length, window in ((0, 16, 40, None), (16, 16, 40, None),
                                         (32, 16, 40, None), (48, 16, 40, None),
                                         (16, 16, 40, 10), (32, 16, 40, 10), (0, 64, 7, 100),
                                         (8, 8, 16, 9)):
        kk, vv = k[:, offset:offset + rows], v[:, offset:offset + rows]
        got = ops.decode_attention_partials(q, kk, vv, offset=offset, length=length,
                                            window=window, softcap=SOFTCAP)
        start = decode_mod.window_start(length, window)
        lo = min(max(start - offset, 0), rows)
        hi = min(max(length - offset, 0), rows)
        want = decode_mod.flash_decode_partials_plain(q, kk, vv, lo, hi, 32 ** -0.5,
                                                      softcap=SOFTCAP)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (offset, rows, length, window)
    for kw in ({"length": 0, "offset": 0}, {"length": 5, "offset": -1},
               {"length": 5, "offset": 0, "window": 0}):
        with pytest.raises(ValueError, match="decode_attention_partials"):
            ops.decode_attention_partials(q, k, v, **kw)


def test_empty_partials_merge_with_weight_zero():
    """A merge of one real partial among empty ones is that partial
    divided by its sum, bit for bit; all empty gives zeros, never a NaN."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 2, 5, 64, 24, 9))
    m, l, acc = decode_mod.flash_decode_partials_plain(q, k, v, 4, 20, 0.125)
    empty = decode_mod.empty_partials(3, 2, 5, 64, "cpu")
    for where in range(3):
        parts = [empty] * 3
        parts[where] = (m, l, acc)
        got = ops.decode_attention_merge(*(torch.stack(x) for x in zip(*parts)))
        assert torch.equal(got, acc / l[..., None])
    none = ops.decode_attention_merge(*(torch.stack([x, x]) for x in empty))
    assert torch.equal(none, torch.zeros_like(none))


def test_played_ranks_gather_in_rank_order_and_raise_a_ranks_error():
    """``play_ranks``: each gather stacks the ranks' tensors in rank order,
    the results come back in rank order, and a rank that raises stops the
    others (waiting in a gather) and its exception reaches the caller."""
    def rank(i, gather):
        first = gather(torch.tensor([i, 10 * i]))
        second = gather(torch.full((2, 2), float(i)))
        return first, second

    outs = play_ranks(3, rank)
    for first, second in outs:
        assert torch.equal(first, torch.tensor([[0, 0], [1, 10], [2, 20]]))
        assert torch.equal(second[:, 0, 0], torch.tensor([0.0, 1.0, 2.0]))

    def failing(i, gather):
        if i == 1:
            raise KeyError("rank 1")
        return gather(torch.zeros(1))

    with pytest.raises(KeyError, match="rank 1"):
        play_ranks(3, failing)
    with pytest.raises(RankError, match="did not complete"):  # a rank that never gathers
        play_ranks(2, lambda i, gather: gather(torch.zeros(1)) if i else None, timeout_s=0.5)


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 32, 16, 1))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_mod.flash_decode_partials(q, k, v, 0, 8, 1.0)
    m, l, acc = decode_mod.flash_decode_partials_plain(q, k, v, 0, 8, 1.0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_mod.flash_decode_merge(m[None], l[None], acc[None])
    assert "flash_decode_merge" in ops.launch_counts()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,hkv,group,dh,dtype", [(1, 2, 5, 128, torch.bfloat16),
                                                  (3, 2, 5, 128, torch.bfloat16),
                                                  (2, 2, 2, 256, torch.bfloat16),
                                                  (3, 2, 5, 64, torch.float32)])
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("options", ["none", "softcap and window"])
def test_kernel_split_matches_the_unsplit_kernel_on_card(cuda_device, b, hkv, group, dh, dtype,
                                                         r, options):
    """700 positions, 690 valid, in r uneven shards (one wholly past the
    length; with the window of 300, the first before its start): the
    kernel's partials + merge against the unsplit kernel and the plain
    versions, bitwise across two runs, one launch a shard with rows and
    one merge a rank."""
    s, length = 700, 690
    opts = {"softcap": SOFTCAP, "window": 300} if options != "none" else {}
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _inputs(b, hkv, group, dh, s, r * dh + b))
    bounds = {2: (0, 500, s), 3: (0, 200, 690, s), 4: (0, 150, 400, 695, s)}[r]
    start = decode_mod.window_start(length, opts.get("window"))
    want_launches = sum(max(lo, start) < min(hi, length) for lo, hi in zip(bounds, bounds[1:]))
    ops.reset_launch_counts()
    got, _ = _split(q, k, v, bounds, length, **opts)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_decode"] == want_launches
    assert ops.launch_counts()["flash_decode_merge"] == r
    again, _ = _split(q, k, v, bounds, length, **opts)
    assert torch.equal(got, again)
    tol = KERNEL_TOL * float(torch.max(torch.abs(v[:, start:length].float())))
    whole = decode_mod.flash_decode(q, k, v, length, dh ** -0.5, **opts)
    assert float(torch.max(torch.abs(got - whole))) <= tol
    plain_parts = [decode_mod.flash_decode_partials_plain(
        q, k[:, lo:hi], v[:, lo:hi], min(max(start - lo, 0), hi - lo),
        min(max(length - lo, 0), hi - lo), dh ** -0.5, softcap=opts.get("softcap"))
        for lo, hi in zip(bounds, bounds[1:])]
    plain = decode_mod.flash_decode_merge_plain(*(torch.stack(x) for x in zip(*plain_parts)))
    assert float(torch.max(torch.abs(got - plain))) <= tol
    with pytest.raises(ValueError, match="outside"):
        decode_mod.flash_decode_partials(q, k, v, 0, s + 1, 1.0)


@pytest.mark.cuda
def test_empty_batch_and_empty_shard_launch_nothing_on_card(cuda_device):
    """A rank with no request (a batch split unevenly over the data axis)
    or no row in range gets the empty partial without a launch; merging an
    empty batch launches nothing."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _inputs(2, 2, 5, 128, 64, 3))
    ops.reset_launch_counts()
    for qq, kk, vv, start, length in ((q[:0], k[:0], v[:0], 0, 40), (q, k, v, 30, 30)):
        m, l, acc = decode_mod.flash_decode_partials(qq.contiguous(), kk, vv, start, length, 1.0)
        assert bool(torch.all(m == decode_mod.MASK_VALUE)) and not bool(torch.any(l))
        assert not bool(torch.any(acc)) and acc.shape == qq.shape
    out = decode_mod.flash_decode_merge(*(x[:0][None] for x in (m, l, acc)))
    assert out.shape == (0, 2, 5, 128)
    assert set(ops.launch_counts().values()) == {0}


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q", "-p", "no:cacheprovider"]) or
             print("\n".join(f"{k}: {v:.3g}" for k, v in sorted(WORST.items()))))
