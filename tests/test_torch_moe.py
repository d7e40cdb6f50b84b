"""The port's MoE layer (``repro_torch.models.moe``) held against the JAX reference.

The reference's ``init_moe`` weights and a numpy input go through both
packages in float32 on the CPU (``tests/test_moe.py``'s cases).  Stated
tolerances:

* ``moe_ffn`` within ``rtol = 5e-4, atol = 5e-5`` of the reference's
  ``moe_ffn`` and of both packages' dense oracles when nothing overflows
  (the reference's own sort-vs-oracle tolerance); under overflow within
  the same of the reference's ``moe_ffn``, with the same dropped pairs
  (``overflow_frac`` equal);
* the aux losses within ``1e-5`` (rtol and atol);
* a bfloat16 compute copy (router included) within ``BF16_RTOL`` of the
  reference's, its aux losses within ``1e-5``.

The port gathers where the reference scatters, so a token's k terms are
summed in top-k order, not slot order, and two runs repeat bit for bit.
``python tests/test_torch_moe.py`` prints the worst readings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as r_moe
from repro.sharding.specs import unsharded_ctx as r_unsharded_ctx

from repro_torch.models import moe as t_moe
from repro_torch.sharding.specs import unsharded_ctx

R_CTX = r_unsharded_ctx()
CTX = unsharded_ctx()
RTOL, ATOL = 5e-4, 5e-5
AUX_TOL = 1e-5
BF16_RTOL = 2 ** -7  # two bfloat16 roundings
WORST: dict[str, float] = {}


def _close(name, got: torch.Tensor, want, rtol, atol) -> None:
    want = torch.from_numpy(np.asarray(want, dtype=np.float32).copy()).reshape(got.shape)
    err = torch.abs(got.float() - want)
    tol = atol + rtol * torch.abs(want)
    WORST[name] = max(WORST.get(name, 0.0), float(torch.max(err / tol)))
    assert bool(torch.all(err <= tol)), f"{name}: max err {float(err.max())}"


def _setup(e, k, cf, d=32, f=64, b=2, s=16, seed=0):
    kw = dict(d_model=d, d_ff=f, num_experts=e, top_k=k, capacity_factor=cf)
    r_cfg, t_cfg = r_moe.MoEConfig(**kw), t_moe.MoEConfig(**kw)
    params = jax.tree.map(np.asarray, r_moe.init_moe(jax.random.key(seed), r_cfg, jnp.float32))
    x = (np.random.default_rng(seed).normal(size=(b, s, d)) * 0.5).astype(np.float32)
    t_params = {name: torch.from_numpy(a.copy()) for name, a in params.items()}
    return r_cfg, t_cfg, {n: jnp.asarray(a) for n, a in params.items()}, t_params, x


def test_config_and_capacity_match_reference():
    import dataclasses

    assert [f.name for f in dataclasses.fields(t_moe.MoEConfig)] == \
        [f.name for f in dataclasses.fields(r_moe.MoEConfig)]
    for tokens, e, k, cf in ((65536, 64, 8, 1.25), (4, 64, 8, 1.25), (2048, 64, 8, 1.25),
                             (2048, 16, 2, 1.25), (8, 4, 2, 4.0), (7, 3, 1, 0.5)):
        kw = dict(d_model=8, d_ff=8, num_experts=e, top_k=k, capacity_factor=cf)
        assert t_moe.capacity(tokens, t_moe.MoEConfig(**kw)) == \
            r_moe.capacity(tokens, r_moe.MoEConfig(**kw))
    assert t_moe._num_groups(CTX, 4) == r_moe._num_groups(R_CTX, 4) == 1


@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (8, 2), (8, 8)],
                         ids=["e4k1", "e4k2", "e8k2", "e8k8"])
def test_moe_ffn_matches_reference_and_dense_oracle(e, k):
    """tests/test_moe.py:25-33 through both packages: with capacity >= all
    assignments, sorted dispatch == dense compute == the reference."""
    r_cfg, t_cfg, params, t_params, x = _setup(e, k, float(e))
    y, aux = t_moe.moe_ffn(t_params, torch.from_numpy(x), t_cfg, CTX)
    ry, r_aux = jax.jit(lambda p, x: r_moe.moe_ffn(p, x, r_cfg, R_CTX))(params, jnp.asarray(x))
    assert float(aux["overflow_frac"]) == float(r_aux["overflow_frac"]) == 0.0
    _close("moe_ffn vs reference", y, ry, RTOL, ATOL)
    _close("moe_ffn vs dense oracle", y,
           t_moe.moe_ffn_dense_ref(t_params, torch.from_numpy(x), t_cfg).numpy(), RTOL, ATOL)
    _close("moe_ffn_dense_ref vs reference",
           t_moe.moe_ffn_dense_ref(t_params, torch.from_numpy(x), t_cfg),
           jax.jit(lambda p, x: r_moe.moe_ffn_dense_ref(p, x, r_cfg))(params, jnp.asarray(x)),
           RTOL, ATOL)
    for key in ("lb_loss", "z_loss"):
        _close(f"aux {key}", aux[key], r_aux[key], AUX_TOL, AUX_TOL)
    again, _ = t_moe.moe_ffn(t_params, torch.from_numpy(x), t_cfg, CTX)
    assert torch.equal(y, again)


@pytest.mark.parametrize("cf,b,s", [(0.25, 2, 32), (0.5, 2, 16), (1.0, 1, 64)])
def test_capacity_overflow_drops_the_reference_pairs(cf, b, s):
    """tests/test_moe.py:36-41 through both packages: the same pairs are
    dropped (the stable sort keeps the earlier tokens), the rest combined
    as the reference combines them."""
    r_cfg, t_cfg, params, t_params, x = _setup(4, 2, cf, d=16, f=32, b=b, s=s, seed=1)
    y, aux = t_moe.moe_ffn(t_params, torch.from_numpy(x), t_cfg, CTX)
    ry, r_aux = jax.jit(lambda p, x: r_moe.moe_ffn(p, x, r_cfg, R_CTX))(params, jnp.asarray(x))
    assert bool(torch.all(torch.isfinite(y)))
    assert 0.0 < float(aux["overflow_frac"]) < 1.0
    assert float(aux["overflow_frac"]) == pytest.approx(float(r_aux["overflow_frac"]), abs=1e-7)
    _close("moe_ffn overflow vs reference", y, ry, RTOL, ATOL)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2)], ids=["e4k2", "e8k2"])
def test_bfloat16_compute_copy_routes_in_float32(e, k):
    """A train step's bfloat16 compute copy casts every weight, the router
    too; the reference's routing einsum promotes a bfloat16 router against
    its float32 input, so both route on float32 logits of the same
    bfloat16 values: the aux losses within ``AUX_TOL``, the output within
    the bfloat16 rounding of the expert matmuls (``BF16_RTOL``)."""
    r_cfg, t_cfg, params, t_params, x = _setup(e, k, float(e))
    params = {n: a.astype(jnp.bfloat16) for n, a in params.items()}
    t_params = {n: a.to(torch.bfloat16) for n, a in t_params.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, aux = t_moe.moe_ffn(t_params, xb, t_cfg, CTX)
    ry, r_aux = jax.jit(lambda p, x: r_moe.moe_ffn(p, x, r_cfg, R_CTX))(
        params, jnp.asarray(x).astype(jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    _close("bfloat16 moe_ffn vs reference", y, np.asarray(ry.astype(jnp.float32)),
           BF16_RTOL, BF16_RTOL)
    for key in ("lb_loss", "z_loss"):
        _close(f"bfloat16 aux {key}", aux[key], r_aux[key], AUX_TOL, AUX_TOL)


def test_zero_gate_gives_zero_and_uniform_router_gives_lb_e():
    """tests/test_moe.py:44-72: silu(0) = 0 experts give 0; a uniform
    router with top_k = E gives lb_loss = E."""
    _, t_cfg, _, t_params, x = _setup(4, 2, 4.0, d=8, f=8, b=1, s=8, seed=2)
    y, _ = t_moe.moe_ffn(dict(t_params, w_gate=torch.zeros_like(t_params["w_gate"])),
                         torch.from_numpy(x), t_cfg, CTX)
    assert float(torch.max(torch.abs(y))) <= 1e-6
    r_cfg, t_cfg, params, t_params, x = _setup(4, 4, 4.0, d=16, f=16, b=2, s=64, seed=3)
    t_params["router"] = torch.zeros_like(t_params["router"])
    _, aux = t_moe.moe_ffn(t_params, torch.from_numpy(x), t_cfg, CTX)
    assert float(aux["lb_loss"]) == pytest.approx(4.0, rel=1e-5)


def test_num_groups_splits_dispatch_like_the_reference():
    """Explicit dispatch groups (the reference's GShard groups, a vmap
    there, a batch dimension here): capacity per group."""
    r_cfg, t_cfg, params, t_params, x = _setup(4, 2, 0.5, d=16, f=32, b=4, s=8, seed=4)
    for g in (1, 2, 4):
        y, aux = t_moe.moe_ffn(t_params, torch.from_numpy(x), t_cfg, CTX, num_groups=g)
        ry, r_aux = jax.jit(lambda p, x: r_moe.moe_ffn(p, x, r_cfg, R_CTX, num_groups=g))(
            params, jnp.asarray(x))
        _close(f"moe_ffn groups={g}", y, ry, RTOL, ATOL)
        assert float(aux["overflow_frac"]) == pytest.approx(float(r_aux["overflow_frac"]),
                                                            abs=1e-7)
        for key in ("lb_loss", "z_loss"):
            _close(f"aux {key}", aux[key], r_aux[key], AUX_TOL, AUX_TOL)


if __name__ == "__main__":
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe.py
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    for name, ratio in sorted(sys.modules["test_torch_moe"].WORST.items()):
        print(f"{name}: {ratio:.3g} of its tolerance")
    sys.exit(rc)
