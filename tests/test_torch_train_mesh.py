"""The LM train step on a mesh, held against the port's no-mesh step and
the JAX reference's step on a host mesh, on the CPU.

Four gloo ranks (``spawn_ranks``, a 2 data x 2 model ``DeviceMesh``) train
reduced smollm-360m, granite-moe-1b-a400m and smollm-360m with 2 query
heads a KV head (its KV heads split over ``model``, so whole on every rank
before the GQA expansion) (float32) for 2 adamw steps
(lr ``LR``) of ``grad_accum`` 2 from the reference's initial weights
(``test_torch_lm_family.reference_weights``), the state laid out by
``state_specs`` (masters and ``m`` / ``v`` in the ZeRO-1 layout).  The rank
code is ``tests/test_torch_train_mesh_ranks.py`` (no JAX).  Held against:

* the port's step without a mesh on the same state and batches, its MoE
  dispatch in as many groups as the mesh has data shards (2, what
  ``_num_groups`` gives on the mesh; the load-balance loss depends on the
  grouping, as in the reference);
* the reference's jitted step on a 2 x 2 host mesh (a subprocess with 4
  host devices), the state laid out by its ``state_specs``.

Stated tolerances (the mesh sums partial products, gradient shards and
the norm's squares in other orders than one device does): every metric
within ``METRIC_TOL * (1 + |value|)``; every master within ``ANY_ATOL``
(two adamw steps move a weight by about ``LR`` each, in either direction,
so a weight whose gradient lies within rounding of zero may differ by up
to two steps) and all but ``LOOSE_SHARE`` of each leaf's entries within
``MASTER_ATOL``.  Also: each rank's masters, ``m`` and ``v`` are its
``state_specs`` slice of the full values before and after the steps
(checked on the ranks), ``make_train_step`` runs on a mesh, and a
``flash_decode`` decode step raises on a mesh whose ``model`` axis splits
the cache.  ``python tests/test_torch_train_mesh.py`` prints the worst
readings.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import reduced_config as r_reduced_config
from repro.optim import optimizers as r_opt
from repro_torch import convert
from repro_torch.dist.launch import spawn_ranks
from repro_torch.models import moe as t_moe
from repro_torch.optim import optimizers as t_opt
from repro_torch.sharding.specs import unsharded_ctx
from repro_torch.train import loop as t_loop
from test_torch_lm_family import reference_weights
from test_torch_train_mesh_ranks import mesh_config, rank_train, variant

ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "smollm-360m-gqa2")
LR = 1e-3
ACCUM, MICRO, SEQ, STEPS = 2, 4, 32, 2
METRIC_TOL = 1e-5
MASTER_ATOL = 2e-5
ANY_ATOL = 2 * LR
LOOSE_SHARE = 1e-3
SPAWN_S = 240.0
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORST: dict[str, float] = {}


def _batches(cfg) -> list:
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, (ACCUM, MICRO, SEQ)).astype(np.int32)
        out.append({"tokens": tok, "labels": tok.copy()})
    return out


def _t_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _initial(arch: str):
    """The reference's weights as the port's plain train state."""
    r_cfg = variant(arch, r_reduced_config, r_get_config)
    tree = reference_weights(r_cfg)
    plain = {"params": tree,
             "opt": jax.tree.map(np.asarray, r_opt.adamw(LR).init(jax.tree.map(np.asarray, tree))),
             "step": np.zeros((), np.int32)}
    return convert.train_state(plain, mesh_config(arch))


_REF = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced_config
    from repro.dist.compat import make_mesh
    from repro.models import transformer
    from repro.optim import optimizers
    from repro.train import loop
    from test_torch_lm_family import reference_weights
    from test_torch_train_mesh import ARCHS, ACCUM, LR, _batches
    from test_torch_train_mesh_ranks import variant

    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = variant(arch, reduced_config, get_config)
        ctx = transformer.make_ctx(mesh, cfg)
        opt = optimizers.adamw(LR)
        params = jax.tree.map(jnp.asarray, reference_weights(cfg))
        state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
        sh = jax.tree.map(lambda s: NamedSharding(mesh, s), loop.state_specs(state, cfg, ctx),
                          is_leaf=lambda x: isinstance(x, P))
        state = jax.device_put(state, sh)
        step = jax.jit(loop.make_train_step(cfg, ctx, opt, loop.TrainSettings(grad_accum=ACCUM)),
                       in_shardings=(sh, None), out_shardings=(sh, None))
        metrics = []
        for b in _batches(cfg):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = {"metrics": metrics,
                     "params": [np.asarray(x) for x in jax.tree.leaves(state["params"])]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's host-mesh run (a subprocess, started first), the
    4-rank mesh run and the no-mesh runs."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    ref_path = str(tmp / "ref.pkl")
    ref = subprocess.Popen([sys.executable, "-c", _REF, ref_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        states = {a: _initial(a) for a in ARCHS}
        batches = {a: [_t_batch(b) for b in _batches(mesh_config(a))] for a in ARCHS}
        mesh = spawn_ranks(4, rank_train, [(a, states[a], batches[a]) for a in ARCHS], ACCUM, LR,
                           device="cpu", timeout_s=SPAWN_S, workdir=str(tmp / "ranks"),
                           mesh_shape=(2, 2), mesh_dim_names=("data", "model"))
        plain = {}
        groups = t_moe._num_groups
        t_moe._num_groups = lambda ctx, b: 2  # the mesh's data shards
        try:
            for a in ARCHS:
                cfg = mesh_config(a)
                step = t_loop.make_train_step(cfg, unsharded_ctx(), t_opt.adamw(LR),
                                              t_loop.TrainSettings(grad_accum=ACCUM))
                st, metrics = states[a], []
                for b in batches[a]:
                    st, m = step(st, b)
                    metrics.append(m)
                plain[a] = {"metrics": metrics, "params": st["params"]}
        finally:
            t_moe._num_groups = groups
        _, err = ref.communicate(timeout=SPAWN_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    with open(ref_path, "rb") as f:
        reference = pickle.load(f)
    return {"mesh": mesh, "plain": plain, "ref": reference}


def _close_metrics(name: str, got: dict, want: dict) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = float(got[k]), float(want[k])
        ratio = abs(g - w) / (METRIC_TOL * (1.0 + abs(w)))
        WORST[f"{name} {k}"] = max(WORST.get(f"{name} {k}", 0.0), ratio)
        assert ratio <= 1.0, f"{name} {k}: {g} vs {w}"


def _close_masters(name: str, got: list, want: list) -> None:
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        err = np.abs(np.asarray(g, dtype=np.float64) - w)
        assert err.shape == w.shape, name
        loose = float(np.mean(err > MASTER_ATOL))
        WORST[f"{name} any"] = max(WORST.get(f"{name} any", 0.0), float(err.max()) / ANY_ATOL)
        WORST[f"{name} loose share"] = max(WORST.get(f"{name} loose share", 0.0),
                                           loose / LOOSE_SHARE)
        assert float(err.max()) <= ANY_ATOL, name
        assert loose <= LOOSE_SHARE, (name, loose)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_the_no_mesh_step(runs, arch):
    got, want = runs["mesh"][arch], runs["plain"][arch]
    assert got["step"] == STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        _close_metrics(f"{arch} step {i + 1} vs no mesh", g, w)
    _close_masters(f"{arch} masters vs no mesh", [t.numpy() for t in t_opt.tree_leaves(got["params"])],
                   [t.numpy() for t in t_opt.tree_leaves(want["params"])])


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_the_references_mesh_step(runs, arch):
    got, want = runs["mesh"][arch], runs["ref"][arch]
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        _close_metrics(f"{arch} step {i + 1} vs reference", g, w)
    _close_masters(f"{arch} masters vs reference",
                   [t.numpy() for t in t_opt.tree_leaves(got["params"])], want["params"])
    if arch == "granite-moe-1b-a400m":
        assert float(got["metrics"][0]["lb_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_state_specs_slice(runs, arch):
    state = _initial(arch)
    leaves = len(t_opt.tree_leaves(state))
    # masters, m, v and the step counts, before and after the steps
    assert runs["mesh"][arch]["checked"] == 2 * leaves


def test_flash_decode_refuses_a_split_cache_on_a_mesh(runs):
    msg = runs["mesh"]["decode_error"]
    assert "flash_decode on a mesh" in msg and "use_kernels=False" in msg


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q", "-p", "no:cacheprovider"]) or
             print("\n".join(f"{k}: {v:.3g}" for k, v in sorted(WORST.items()))))
