"""The LM train step and decode on a mesh, held against the port's no-mesh
step and decode and the JAX reference's on a host mesh, on the CPU.

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
(checked on the ranks), and ``make_train_step`` runs on a mesh.

The same four ranks then decode (``DECODES``: reduced smollm-360m, and
reduced gemma2-9b with its attention softcap and a window of 8 shorter
than the 16 positions decoded, also with the dry-run's long_500k layout)
greedily through ``make_serve_step(cfg, make_ctx(mesh, cfg, overrides))``,
``GEN`` tokens after a ``PROMPT_LEN``-token prompt, the cache laid out by
``cache_specs``: its positions split over ``model`` (with the long_500k
overrides over ``data`` and ``model``, the batch whole), so
``use_kernels=True`` takes the split-K route (each rank's partials,
gathered over the axes that split the positions, merged in rank order; on
the CPU the plain versions).  Held against the port's no-mesh kernel-route decode,
its ``use_kernels=False`` DTensor decode and the reference's decode step
on a 2 x 2 host mesh (the same subprocess): tokens equal, float32 logits
within ``DECODE_RTOL * max|logits|`` (the split-K merge, the position
shards and the heads sum in other orders; XLA's CPU dots against
PyTorch's).  Every rank calls the partials and
the merge once a layer and token, and gets the empty partial exactly
where its shard holds no row of ``[max(0, length - window), length)``.
The kernel route refuses a cache split over heads.
``python tests/test_torch_train_mesh.py`` prints the worst readings.
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
from test_torch_train_mesh_ranks import greedy, mesh_config, rank_train, variant

ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "smollm-360m-gqa2")
LR = 1e-3
ACCUM, MICRO, SEQ, STEPS = 2, 4, 32, 2
METRIC_TOL = 1e-5
MASTER_ATOL = 2e-5
ANY_ATOL = 2 * LR
LOOSE_SHARE = 1e-3
SPAWN_S = 240.0
# the decodes: name -> (arch, the cache's length, make_ctx's overrides);
# smollm's 19 positions split unevenly (10 + 9), the long_500k layout's 16
# over all four ranks (launch/dryrun.py's _rules_overrides)
LONG_500K = {"batch": None, "seq_kv": ("data", "model")}
DECODES = {"smollm-360m": ("smollm-360m", 19, None), "gemma2-9b": ("gemma2-9b", 16, None),
           "gemma2-9b long_500k layout": ("gemma2-9b", 16, LONG_500K)}
DECODE_B, PROMPT_LEN, GEN = 4, 8, 9
DECODE_RTOL = 1e-5
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


def _prompt(cfg) -> np.ndarray:
    rng = np.random.default_rng(11)
    return rng.integers(0, cfg.vocab_size, (DECODE_B, PROMPT_LEN)).astype(np.int32)


def _decode_job(name: str) -> tuple:
    """``(name, arch, params, prompt, GEN, max_len, overrides)``: the
    reference's weights as the port's parameters."""
    arch, max_len, overrides = DECODES[name]
    cfg = mesh_config(arch)
    tree = reference_weights(variant(arch, r_reduced_config, r_get_config))
    return (name, arch, convert.lm_params(tree, cfg), torch.from_numpy(_prompt(cfg)), GEN,
            max_len, overrides)


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
    from repro.train.serve import make_serve_step
    from test_torch_lm_family import reference_weights
    from test_torch_train_mesh import ARCHS, ACCUM, DECODES, GEN, LR, PROMPT_LEN, _batches, _prompt
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
    out["decode"] = {}
    for name, (arch, max_len, overrides) in DECODES.items():
        cfg = variant(arch, reduced_config, get_config)
        ctx = transformer.make_ctx(mesh, cfg, overrides)
        params = jax.tree.map(jnp.asarray, reference_weights(cfg))
        prompt = jnp.asarray(_prompt(cfg))
        prefill = jax.jit(lambda p, t: transformer.prefill(p, cfg, {"tokens": t}, max_len, ctx))
        _, cache = prefill(params, prompt)
        step = jax.jit(make_serve_step(cfg, ctx))
        tok, tokens, logits = prompt[:, -1:], [], []
        for i in range(GEN):
            tok, lg, cache = step(params, cache, tok, jnp.asarray(PROMPT_LEN + i - 1, jnp.int32))
            tokens.append(np.asarray(tok))
            logits.append(np.asarray(lg[:, 0], np.float32))
        out["decode"][name] = {"tokens": np.concatenate(tokens, axis=1),
                               "logits": np.stack(logits)}
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
        decodes = [_decode_job(a) for a in DECODES]
        mesh = spawn_ranks(4, rank_train, [(a, states[a], batches[a]) for a in ARCHS], ACCUM, LR,
                           decodes, device="cpu", timeout_s=SPAWN_S, workdir=str(tmp / "ranks"),
                           mesh_shape=(2, 2), mesh_dim_names=("data", "model"))
        no_mesh = {name: greedy(params, mesh_config(arch), unsharded_ctx(), prompt, gen, max_len,
                                True)
                   for name, arch, params, prompt, gen, max_len, _ in decodes}
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
    return {"mesh": mesh, "plain": plain, "ref": reference, "no_mesh_decode": no_mesh}


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


def _logits_close(name: str, got: torch.Tensor, want, rtol: float, vocab: int) -> None:
    want = torch.as_tensor(np.asarray(want, dtype=np.float32))[..., :vocab]
    got = got[..., :vocab]
    assert got.shape == want.shape, (name, got.shape, want.shape)
    ratio = float(torch.max(torch.abs(got - want))) / (rtol * float(torch.max(torch.abs(want))))
    WORST[name] = max(WORST.get(name, 0.0), ratio)
    assert ratio <= 1.0, f"{name}: {ratio} of the bound"


@pytest.mark.parametrize("name", list(DECODES))
@pytest.mark.parametrize("against", ["no mesh", "use_kernels=False"])
def test_mesh_decode_matches_the_ports_decodes(runs, name, against):
    vocab = mesh_config(DECODES[name][0]).vocab_size
    tokens, logits = runs["mesh"]["decode"][name]["kernel"]
    want_tokens, want_logits = (runs["no_mesh_decode"][name] if against == "no mesh"
                                else runs["mesh"]["decode"][name]["plain"])
    assert tokens.shape == (DECODE_B, GEN) and torch.equal(tokens, want_tokens)
    assert bool(torch.all(torch.isfinite(logits[..., :vocab])))
    _logits_close(f"{name} mesh decode vs {against}", logits, want_logits, DECODE_RTOL, vocab)


@pytest.mark.parametrize("name", list(DECODES))
def test_mesh_decode_matches_the_references_mesh_decode(runs, name):
    tokens, logits = runs["mesh"]["decode"][name]["kernel"]
    want = runs["ref"]["decode"][name]
    assert np.array_equal(tokens.numpy(), want["tokens"])
    _logits_close(f"{name} mesh decode vs reference", logits, want["logits"], DECODE_RTOL,
                  mesh_config(DECODES[name][0]).vocab_size)


@pytest.mark.parametrize("name", list(DECODES))
def test_mesh_decode_takes_the_split_route_on_every_rank(runs, name):
    """One partials call and one merge a layer and token on every rank; an
    empty partial exactly where the rank's shard of the positions holds
    no row of the window (the (2, 2) mesh: over ``model``, ranks 0 and 2
    hold the first half, 1 and 3 the second; with the long_500k layout
    rank r the r-th quarter)."""
    arch, max_len, overrides = DECODES[name]
    cfg = mesh_config(arch)
    layers = [t.mixer for t in cfg.pattern] * cfg.num_repeats
    shards = 4 if overrides else 2
    size = -(-max_len // shards)
    for rank, calls in enumerate(runs["mesh"]["decode"][name]["calls"]):
        lo = size * (rank if overrides else rank % 2)
        hi = min(lo + size, max_len)
        empty = 0
        for i in range(GEN):
            length = PROMPT_LEN + i
            for mixer in layers:
                start = max(0, length - cfg.sliding_window) if mixer == "local" else 0
                empty += max(start, lo) >= min(length, hi)
        assert calls == {"partials": GEN * len(layers), "merge": GEN * len(layers),
                         "empty": empty}, (rank, calls)
    if name == "gemma2-9b":  # a shard past the length and one before the window
        assert [c["empty"] for c in runs["mesh"]["decode"][name]["calls"]] == [1, 2, 1, 2]


def test_flash_decode_refuses_a_heads_split_cache_on_a_mesh(runs):
    msg = runs["mesh"]["decode"]["heads_error"]
    assert "heads whole on every rank" in msg and "use_kernels=False" in msg


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q", "-p", "no:cacheprovider"]) or
             print("\n".join(f"{k}: {v:.3g}" for k, v in sorted(WORST.items()))))
