"""The port's SSD mixer (``repro_torch.models.ssm``) and the blockwise
attention lever, held against the JAX reference.

The same numpy inputs (and the reference's ``init_ssm`` weights) go
through both packages in float32 on the CPU (``tests/test_ssm.py``'s and
``tests/test_attention.py:121``'s cases).  Stated tolerances:

* ``ssd_chunked`` within ``rtol = 2e-3, atol = 2e-4`` of a float64
  step-by-step recurrence (the reference test's tolerance) and within
  ``1e-5 * max|y|`` of the reference's ``ssd_chunked`` (the pairwise
  contractions sum in another order than XLA's 4-operand einsum);
  bfloat16 operands within ``5e-2`` of float32 (the reference's), and
  within ``2e-3 * max|y|`` of the reference's bfloat16 run;
* ``ssm_train`` and a token-by-token ``ssm_decode`` within ``1e-5 *
  max|y|`` of the reference's, decode within ``rtol = 3e-3, atol = 3e-4``
  of train (the reference's); ``ssm_prefill_cache`` within ``rtol = 2e-3,
  atol = 2e-4`` of a decode rollout (state) and ``1e-5`` (conv window);
* ``_attention_blockwise`` (``q_chunk`` set) within ``rtol = 3e-4, atol =
  3e-5`` of ``attention_ref`` (the reference's) and within ``rtol = 2e-4,
  atol = 2e-5`` of the reference's blockwise path.

``python tests/test_torch_ssm.py`` prints the worst readings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerTemplate as RLayerTemplate
from repro.configs.base import ModelConfig as RModelConfig
from repro.models import attention as r_attn
from repro.models import ssm as r_ssm
from repro.models import transformer as r_tf
from repro.sharding.specs import unsharded_ctx as r_unsharded_ctx

from repro_torch.configs.base import LayerTemplate, ModelConfig
from repro_torch.models import attention as t_attn
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.sharding.specs import unsharded_ctx

R_CTX = r_unsharded_ctx()
CTX = unsharded_ctx()
REF_RTOL = 1e-5
WORST: dict[str, float] = {}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _close(name, got: torch.Tensor, want, rtol, atol) -> None:
    want = torch.from_numpy(np.asarray(want, dtype=np.float32).copy())
    err = torch.abs(got.float() - want)
    tol = atol + rtol * torch.abs(want)
    WORST[name] = max(WORST.get(name, 0.0), float(torch.max(err / tol)))
    assert bool(torch.all(err <= tol)), f"{name}: max err {float(err.max())}"


def _scaled(name, got, want, rtol) -> None:
    _close(name, got, want, 0.0, rtol * float(np.abs(np.asarray(want)).max()))


def _naive_recurrence(x, dt, a, bmat, cmat):
    """tests/test_ssm.py's float64 step-by-step recurrence."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = np.zeros((b, h, p, n), np.float64)
    x, dt, a, bm, cm = (np.asarray(v, np.float64) for v in (x, dt, a, bmat, cmat))
    ys = np.zeros((b, s, h, p), np.float64)
    for t in range(s):
        decay = np.exp(dt[:, t, :] * a[None, :])
        xd = x[:, t] * dt[:, t][..., None]
        state = state * decay[..., None, None] + np.einsum("bhp,bn->bhpn", xd, bm[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", state, cm[:, t])
    return ys


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


@pytest.mark.parametrize("chunk,s", [(4, 32), (8, 32), (16, 64), (32, 64), (8, 13), (16, 37)])
def test_ssd_chunked_matches_recurrence_and_reference(chunk, s):
    """tests/test_ssm.py:45-58 and :82-96 (s = 13, 37: padded to the chunk)."""
    args = _ssd_inputs(2, s, 3, 4, 8, s * chunk)
    got = t_ssm.ssd_chunked(*map(_t, args), chunk)
    assert got.shape == (2, s, 3, 4) and got.dtype == torch.float32
    _close("ssd_chunked vs recurrence", got, _naive_recurrence(*args), 2e-3, 2e-4)
    want = jax.jit(lambda *a: r_ssm.ssd_chunked(*a, chunk))(*map(jnp.asarray, args))
    _scaled("ssd_chunked vs reference", got, want, REF_RTOL)


def test_ssd_bf16_operands_close_to_f32_and_reference():
    """tests/test_ssm.py:119-131: the compute_dtype lever."""
    args = _ssd_inputs(2, 64, 4, 8, 16, 3)
    y32 = t_ssm.ssd_chunked(*map(_t, args), 16, compute_dtype="float32")
    y16 = t_ssm.ssd_chunked(*map(_t, args), 16, compute_dtype="bfloat16")
    _close("ssd bf16 vs f32", y16, y32.numpy(), 5e-2, 5e-2)
    want = jax.jit(lambda *a: r_ssm.ssd_chunked(*a, 16, compute_dtype="bfloat16"))(
        *map(jnp.asarray, args))
    _scaled("ssd bf16 vs reference bf16", y16, want, 2e-3)


def _ssm_setup(seed):
    kw = dict(d_model=32, d_state=8, expand=2, head_dim=16, chunk=8)
    r_cfg, t_cfg = r_ssm.SSMConfig(**kw), t_ssm.SSMConfig(**kw)
    params = jax.tree.map(np.asarray, r_ssm.init_ssm(jax.random.key(seed), r_cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    params["conv_b"] = rng.normal(0, 0.1, size=params["conv_b"].shape).astype(np.float32)
    params["dt_bias"] = rng.normal(0, 0.5, size=params["dt_bias"].shape).astype(np.float32)
    params["out_norm"] = rng.normal(0, 0.1, size=params["out_norm"].shape).astype(np.float32)
    return (r_cfg, t_cfg, {k: jnp.asarray(v) for k, v in params.items()},
            {k: _t(v) for k, v in params.items()})


def test_ssm_train_and_decode_match_reference():
    """tests/test_ssm.py:61-79 through both packages: the chunked train
    path, a token-by-token decode (the cache written in place), and decode
    against train."""
    r_cfg, t_cfg, params, t_params = _ssm_setup(0)
    b, s = 2, 24
    x = (np.random.default_rng(10).normal(size=(b, s, 32)) * 0.3).astype(np.float32)
    y_train = t_ssm.ssm_train(t_params, _t(x), t_cfg, CTX)
    _scaled("ssm_train vs reference", y_train,
            jax.jit(lambda p, x: r_ssm.ssm_train(p, x, r_cfg, R_CTX))(params, jnp.asarray(x)),
            REF_RTOL)
    cache = t_ssm.init_ssm_cache(b, t_cfg, torch.float32, CTX)
    r_cache = r_ssm.init_ssm_cache(b, r_cfg, jnp.float32, R_CTX)
    r_step = jax.jit(lambda p, x, c: r_ssm.ssm_decode(p, x, c, r_cfg, R_CTX))
    ys, rys = [], []
    for t in range(s):
        conv, state = cache["conv"], cache["state"]
        y_t, cache = t_ssm.ssm_decode(t_params, _t(x[:, t:t + 1]), cache, t_cfg, CTX)
        assert cache["conv"] is conv and cache["state"] is state  # in place
        ry_t, r_cache = r_step(params, jnp.asarray(x[:, t:t + 1]), r_cache)
        ys.append(y_t)
        rys.append(np.asarray(ry_t))
    y_dec = torch.cat(ys, dim=1)
    _scaled("ssm_decode vs reference", y_dec, np.concatenate(rys, axis=1), REF_RTOL)
    _scaled("ssm_decode state vs reference", cache["state"], r_cache["state"], REF_RTOL)
    _close("ssm_decode vs train", y_dec, y_train.numpy(), 3e-3, 3e-4)


@pytest.mark.parametrize("s", [16, 2, 13])
def test_prefill_state_matches_decode_rollout(s):
    """tests/test_ssm.py:99-116 through both packages (s = 2: a prompt
    shorter than the conv window, its tail zero-padded)."""
    kw = dict(name="t", arch_type="ssm", source="", num_layers=2, d_model=32, d_ff=0,
              vocab_size=64, ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8,
              dtype="float32")
    r_mcfg = RModelConfig(pattern=(RLayerTemplate("ssm", "none"),), **kw)
    t_mcfg = ModelConfig(pattern=(LayerTemplate("ssm", "none"),), **kw)
    r_cfg, t_cfg, params, t_params = _ssm_setup(5)
    h = (np.random.default_rng(11).normal(size=(2, s, 32)) * 0.3).astype(np.float32)
    pre = t_tf.ssm_prefill_cache(t_params, _t(h), t_mcfg, CTX)
    r_pre = jax.jit(lambda p, h: r_tf.ssm_prefill_cache(p, h, r_mcfg, R_CTX))(
        params, jnp.asarray(h))
    _scaled("prefill state vs reference", pre["state"], r_pre["state"], REF_RTOL)
    _close("prefill conv vs reference", pre["conv"], r_pre["conv"], 1e-5, 1e-5)
    cache = t_ssm.init_ssm_cache(2, t_cfg, torch.float32, CTX)
    for t in range(s):
        _, cache = t_ssm.ssm_decode(t_params, _t(h[:, t:t + 1]), cache, t_cfg, CTX)
    _close("prefill state vs rollout", pre["state"], cache["state"].numpy(), 2e-3, 2e-4)
    _close("prefill conv vs rollout", pre["conv"], cache["conv"].numpy(), 1e-4, 1e-5)


def test_segsum_is_minus_inf_above_the_diagonal():
    x = torch.tensor([[0.5, -1.0, 2.0]])
    seg = t_ssm._segsum(x)
    want = jax.jit(r_ssm._segsum)(jnp.asarray(x.numpy()))
    assert torch.equal(seg, _t(want))  # the -inf entries too
    upper = torch.triu(torch.ones((3, 3), dtype=torch.bool), diagonal=1)
    assert bool(torch.all(torch.exp(seg)[:, upper] == 0))


def _attn_params(cfg, d, seed):
    rng = np.random.default_rng(seed)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": ((d, h, dh), d), "wk": ((d, hkv, dh), d), "wv": ((d, hkv, dh), d),
              "wo": ((h, dh, d), h * dh)}
    return {k: (rng.normal(size=s_) * fan ** -0.5).astype(np.float32)
            for k, (s_, fan) in shapes.items()}


@pytest.mark.parametrize("window", [None, 16, 20])
@pytest.mark.parametrize("q_chunk", [16, 32])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_blockwise_matches_reference(window, q_chunk, softcap):
    """tests/test_attention.py:121-133 through both packages, with and
    without the attention softcap: the q_chunk path against the oracle,
    the reference's blockwise path and the port's single-scan path."""
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, window=window, q_chunk=q_chunk,
              kv_chunk=16, attn_softcap=softcap)
    r_cfg, t_cfg = r_attn.AttnConfig(**kw), t_attn.AttnConfig(**kw)
    b, s, d = 2, 64, 96
    params = _attn_params(t_cfg, d, 5)
    x = np.random.default_rng(6).normal(0, 0.3, size=(b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    t_params = {k: _t(v) for k, v in params.items()}
    y, (k, v) = t_attn.attention_train(t_params, _t(x), _t(pos), t_cfg, CTX)
    oracle = t_attn.attention_ref(t_params, _t(x), _t(pos),
                                  dataclasses.replace(t_cfg, q_chunk=None), CTX)
    _close("blockwise vs attention_ref", y, oracle.numpy(), 3e-4, 3e-5)
    ry, _ = jax.jit(lambda p, x, pos: r_attn.attention_train(p, x, pos, r_cfg, R_CTX))(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x), jnp.asarray(pos))
    _close("blockwise vs reference", y, ry, 2e-4, 2e-5)
    y_scan, (k2, v2) = t_attn.attention_train(
        t_params, _t(x), _t(pos), dataclasses.replace(t_cfg, q_chunk=None), CTX)
    _close("blockwise vs single scan", y, y_scan.numpy(), 3e-4, 3e-5)
    assert torch.equal(k, k2) and torch.equal(v, v2)


if __name__ == "__main__":
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm.py
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    for name, ratio in sorted(sys.modules["test_torch_ssm"].WORST.items()):
        print(f"{name}: {ratio:.3g} of its tolerance")
    sys.exit(rc)
