"""The port's optimizers, token stream, input specs and train-state
conversion, held against the JAX reference on the CPU.

* ``repro_torch.optim.optimizers`` against ``repro.optim.optimizers``
  over a small nest (a dict holding a tuple of dicts, leaves of 1 to 3
  dimensions, one bfloat16 gradient leaf) for 5 updates of sgd, momentum,
  adamw with and without weight decay and ``svrg(adamw)`` with an anchor
  refresh after update 3: updates, states and parameters within
  ``OPT_RTOL`` relative to each leaf's largest magnitude (both sides
  round in the same order; XLA may contract a multiply-add);
* ``data.token_stream.batches`` byte for byte the reference's (every
  preset, three batches, ``grad_accum`` 1 and 2), ``_token_stream``
  likewise, and the ``data.pipeline`` shim's ``DeprecationWarning``;
* ``launch.inputs``: every preset and every ``INPUT_SHAPES`` entry, shape
  for shape and dtype for dtype the reference's ``ShapeDtypeStruct``\\ s,
  on the ``meta`` device;
* ``convert.train_state``: float32 masters under a bfloat16 config, the
  three optimizer kinds, and its refusals.

``python tests/test_torch_optim.py`` prints the worst readings.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import INPUT_SHAPES as R_INPUT_SHAPES
from repro.configs import get_config as r_get_config
from repro.configs import reduced_config as r_reduced_config
from repro.data import token_stream as r_stream
from repro.launch import inputs as r_inputs
from repro.optim import optimizers as r_opt
from repro.train import loop as r_loop

from repro_torch import convert
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, reduced_config
from repro_torch.data import token_stream as t_stream
from repro_torch.launch import inputs as t_inputs
from repro_torch.optim import optimizers as t_opt

OPT_RTOL = 1e-6
WORST: dict[str, float] = {}


def _record(name: str, ratio: float) -> None:
    WORST[name] = max(WORST.get(name, 0.0), float(ratio))


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _close_tree(name, got, want, rtol=OPT_RTOL) -> None:
    g_leaves, w_leaves = t_opt.tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves), name
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype), (name, g.dtype)
        g = g.double().numpy()
        w = w.astype(np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        ratio = float(np.abs(g - w).max()) / (rtol * scale)
        _record(name, ratio)
        assert ratio <= 1.0, f"{name}: {ratio} of its tolerance"


def _nest(rng, dtype=np.float32):
    return {"w": rng.normal(size=(4, 3)).astype(dtype),
            "blocks": ({"a": rng.normal(size=(2, 5, 3)).astype(dtype),
                        "b": rng.normal(size=(5,)).astype(dtype)},
                       {"c": rng.normal(size=(6,)).astype(dtype)})}


def _grads(rng):
    g = _nest(rng)
    g["w"] = np.asarray(jnp.asarray(g["w"], jnp.bfloat16))  # a compute-dtype gradient
    return g


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.momentum(0.05, beta=0.8),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_wd": lambda m: m.adamw(1e-2, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_over_five_updates(name):
    rng = np.random.default_rng(0)
    params = _nest(rng)
    r_o, t_o = OPTIMIZERS[name](r_opt), OPTIMIZERS[name](t_opt)
    r_p = jax.tree.map(jnp.asarray, params)
    t_p = t_opt.tree_map(_t, params)
    r_s, t_s = r_o.init(r_p), t_o.init(t_p)
    _close_tree(f"{name} init", t_s, r_s)
    r_update = jax.jit(r_o.update)
    for i in range(5):
        g = _grads(rng)
        r_u, r_s = r_update(jax.tree.map(jnp.asarray, g), r_s, r_p)
        t_u, t_s = t_o.update(t_opt.tree_map(_t, g), t_s, t_p)
        _close_tree(f"{name} updates", t_u, r_u)
        _close_tree(f"{name} state", t_s, r_s)
        r_p, t_p = r_opt.apply_updates(r_p, r_u), t_opt.apply_updates(t_p, t_u)
        _close_tree(f"{name} params", t_p, r_p)
    if name.startswith("adamw"):
        assert t_s["t"].dtype == torch.int32 and t_s["t"].dim() == 0 and int(t_s["t"]) == 5


def test_svrg_wrapper_and_refresh_match_reference():
    """``svrg(adamw)``: the update uses g_current - g_anchor + z; the
    anchor is refreshed after update 3 with a full gradient."""
    rng = np.random.default_rng(1)
    params = _nest(rng)
    r_o, t_o = r_opt.svrg(r_opt.adamw(1e-2)), t_opt.svrg(t_opt.adamw(1e-2))
    r_p, t_p = jax.tree.map(jnp.asarray, params), t_opt.tree_map(_t, params)
    r_s, t_s = r_o.init(r_p), t_o.init(t_p)
    assert isinstance(t_s, t_opt.SVRGState)
    _close_tree("svrg init", t_s, r_s)
    for i in range(5):
        if i == 3:
            full = _nest(rng)
            r_s = r_opt.svrg_refresh(r_s, r_p, jax.tree.map(jnp.asarray, full))
            t_s = t_opt.svrg_refresh(t_s, t_p, t_opt.tree_map(_t, full))
            _close_tree("svrg refresh", t_s, r_s)
        gc, ga = _grads(rng), _nest(rng)
        r_u, r_s = r_o.update((jax.tree.map(jnp.asarray, gc), jax.tree.map(jnp.asarray, ga)),
                              r_s, r_p)
        t_u, t_s = t_o.update((t_opt.tree_map(_t, gc), t_opt.tree_map(_t, ga)), t_s, t_p)
        _close_tree("svrg updates", t_u, r_u)
        _close_tree("svrg state", t_s, r_s)
        r_p, t_p = r_opt.apply_updates(r_p, r_u), t_opt.apply_updates(t_p, t_u)
        _close_tree("svrg params", t_p, r_p)
    assert set(t_opt.OPTIMIZERS) == set(r_opt.OPTIMIZERS)


def test_updates_leave_their_inputs_untouched():
    """The functional contract: a caller may update twice from one state."""
    rng = np.random.default_rng(2)
    t_p = t_opt.tree_map(_t, _nest(rng))
    g = t_opt.tree_map(_t, _nest(rng))
    for make in OPTIMIZERS.values():
        o = make(t_opt)
        s = o.init(t_p)
        before = [x.clone() for x in t_opt.tree_leaves((t_p, s, g))]
        u1, _ = o.update(g, s, t_p)
        u2, _ = o.update(g, s, t_p)
        t_opt.apply_updates(t_p, u1)
        assert all(torch.equal(a, b) for a, b in zip(before, t_opt.tree_leaves((t_p, s, g))))
        assert all(torch.equal(a, b) for a, b in
                   zip(t_opt.tree_leaves(u1), t_opt.tree_leaves(u2)))


def test_tree_helpers_flatten_in_the_reference_order():
    rng = np.random.default_rng(3)
    nest = _nest(rng)
    nest["opt"] = r_opt.SVRGState(1.0, 2.0, ())
    got = t_opt.tree_leaves(t_opt.tree_map(lambda a: a, nest))
    want = jax.tree.leaves(nest)
    assert len(got) == len(want)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))
    rebuilt = t_opt.tree_unflatten(nest, got)
    assert isinstance(rebuilt["opt"], r_opt.SVRGState) and rebuilt["opt"].inner == ()
    with pytest.raises(ValueError, match="more leaves"):
        t_opt.tree_unflatten(nest, got + [0])
    with pytest.raises(ValueError, match="structure"):
        t_opt.tree_map(lambda a, b: a, nest, {"w": 1})


# ---------------------------------------------------------------------------
# The token stream and the input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_batches_are_the_references_byte_for_byte(arch, grad_accum):
    r_cfg = r_reduced_config(r_get_config(arch))
    t_cfg = reduced_config(get_config(arch))
    r_it = r_stream.batches(r_cfg, r_stream.PipelineConfig(4, 96, seed=5, grad_accum=grad_accum))
    t_it = t_stream.batches(t_cfg, t_stream.PipelineConfig(4, 96, seed=5, grad_accum=grad_accum))
    for _ in range(3):
        want, got = next(r_it), next(t_it)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (arch, k)
            assert got[k].tobytes() == want[k].tobytes(), (arch, k)
            assert got[k].shape[0] == (grad_accum if grad_accum > 1 else 4)
    if t_cfg.modality == "vision":
        assert not got["labels"][..., :t_cfg.num_patches].any()


def test_token_stream_is_the_references_and_learnable():
    for n, vocab in ((1, 7), (200, 512), (4096, 49152)):
        want = r_stream._token_stream(np.random.default_rng(n), n, vocab)
        got = t_stream._token_stream(np.random.default_rng(n), n, vocab)
        assert got.dtype == np.int32 and got.tobytes() == want.tobytes()
    toks = next(t_stream.batches(reduced_config(get_config("smollm-360m")),
                                 t_stream.PipelineConfig(2, 256, seed=1)))["tokens"]
    np.testing.assert_array_equal(toks[0, 64:72], toks[0, 56:64])


def test_pipeline_shim_warns_and_forwards():
    from repro_torch.data import pipeline

    for name in ("PipelineConfig", "batches", "_token_stream"):
        with pytest.warns(DeprecationWarning, match=f"pipeline.{name} moved to "
                                                    "repro_torch.data.token_stream"):
            obj = getattr(pipeline, name)
        assert obj is getattr(t_stream, name)
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        pipeline.nothing  # noqa: B018
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        from repro_torch.data import token_stream  # noqa: F401  (no warning)


def _same_spec(got: torch.Tensor, want) -> None:
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype)[6:] == str(want.dtype), (got.dtype, want.dtype)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
def test_input_specs_match_the_reference(arch, shape_name):
    r_cfg, t_cfg = r_get_config(arch), get_config(arch)
    r_shape, t_shape = R_INPUT_SHAPES[shape_name], INPUT_SHAPES[shape_name]
    assert dataclasses.asdict(t_shape) == dataclasses.asdict(r_shape)
    for accum in (1, 4):
        if t_shape.global_batch % accum:
            for fn, cfg, shape in ((t_inputs.train_batch_specs, t_cfg, t_shape),
                                   (r_inputs.train_batch_specs, r_cfg, r_shape)):
                with pytest.raises(AssertionError):
                    fn(cfg, shape, grad_accum=accum)
            continue
        got = t_inputs.train_batch_specs(t_cfg, t_shape, grad_accum=accum)
        want = r_inputs.train_batch_specs(r_cfg, r_shape, grad_accum=accum)
        assert list(got) == list(want)
        for k in want:
            _same_spec(got[k], want[k])
    got = t_inputs.prefill_batch_specs(t_cfg, t_shape)
    want = r_inputs.prefill_batch_specs(r_cfg, r_shape)
    assert list(got) == list(want)
    for k in want:
        _same_spec(got[k], want[k])
    _same_spec(t_inputs.decode_token_specs(t_cfg, t_shape),
               r_inputs.decode_token_specs(r_cfg, r_shape))
    assert set(ARCHS) == set(R_ARCHS)


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large", "paligemma-3b"])
def test_batches_match_the_train_specs(arch):
    """The pipeline emits exactly the batch dict the specs promise (the
    reference's ``tests/test_pipeline_inputs.py`` contract), here at
    ``train_4k``'s length with a batch of 2 and ``grad_accum`` 2."""
    cfg = get_config(arch)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=2)
    specs = t_inputs.train_batch_specs(cfg, shape, grad_accum=2)
    batch = next(t_stream.batches(cfg, t_stream.PipelineConfig(2, shape.seq_len,
                                                               grad_accum=2)))
    assert set(batch) == set(specs)
    for k in specs:
        t = torch.from_numpy(batch[k])
        assert t.shape == specs[k].shape and t.dtype == specs[k].dtype, k


# ---------------------------------------------------------------------------
# convert.train_state
# ---------------------------------------------------------------------------


def _reference_state(arch, opt, dtype="float32"):
    r_cfg = dataclasses.replace(r_reduced_config(r_get_config(arch)), dtype=dtype)
    t_cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    state = r_loop.init_state(r_cfg, jax.random.key(0), opt, tp=1)
    return jax.tree.map(np.asarray, state), t_cfg


@pytest.mark.parametrize("kind", ["adamw", "momentum", "sgd"])
def test_train_state_carries_masters_and_moments(kind):
    """Float32 masters under a bfloat16 config are accepted; every leaf
    and the step counts come across exactly."""
    tree, t_cfg = _reference_state("granite-moe-1b-a400m", r_opt.OPTIMIZERS[kind](1e-3),
                                   "bfloat16")
    tree["step"] = np.int32(7)
    if kind == "adamw":
        tree["opt"]["t"] = np.int32(7)
    got = convert.train_state(tree, t_cfg)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    flat_got, flat_want = t_opt.tree_leaves(got), jax.tree.leaves(tree)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        assert a.dtype in (torch.float32, torch.int32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got["opt"] == ()) == (kind == "sgd")
    assert kind == "sgd" or set(got["opt"]) == ({"m", "v", "t"} if kind == "adamw" else {"m"})


def test_train_state_refusals():
    tree, t_cfg = _reference_state("smollm-360m", r_opt.adamw(1e-3))
    with pytest.raises(ValueError, match="train state"):
        convert.train_state({"params": tree["params"]}, t_cfg)
    bad = dict(tree, opt={"m": tree["opt"]["m"], "s": tree["opt"]["v"]})
    with pytest.raises(ValueError, match="not an adamw, momentum or sgd state"):
        convert.train_state(bad, t_cfg)
    bad = dict(tree, opt=[1, 2])
    with pytest.raises(ValueError, match="not an adamw, momentum or sgd state"):
        convert.train_state(bad, t_cfg)
    m = dict(tree["opt"]["m"])
    m.pop("final_norm")
    bad = dict(tree, opt=dict(tree["opt"], m=m))
    with pytest.raises(ValueError, match="opt.m: not the masters' structure"):
        convert.train_state(bad, t_cfg)
    m = dict(tree["opt"]["m"], embed=tree["opt"]["m"]["embed"][:, :8])
    bad = dict(tree, opt=dict(tree["opt"], m=m))
    with pytest.raises(ValueError, match=r"opt.m.embed: shape \(512, 8\)"):
        convert.train_state(bad, t_cfg)
    p = dict(tree["params"], final_norm=tree["params"]["final_norm"][:5])
    with pytest.raises(ValueError, match="final_norm"):
        convert.train_state(dict(tree, params=p), t_cfg)
    with pytest.raises(ValueError, match="step"):
        convert.train_state(dict(tree, step=np.int64(0)), t_cfg)
    with pytest.raises(ValueError, match="opt.t"):
        convert.train_state(dict(tree, opt=dict(tree["opt"], t=np.zeros(2, np.int32))), t_cfg)
    with pytest.raises(ValueError, match="do not fit"):
        convert.train_state(tree, dataclasses.replace(t_cfg, d_model=128))
    bf16 = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "norm" in str(path[-1].key) else
        np.asarray(jnp.asarray(a, jnp.bfloat16)), tree["params"])
    with pytest.raises(TypeError, match="wants float32"):
        convert.train_state(dict(tree, params=bf16), t_cfg)


if __name__ == "__main__":
    # The worst reading of each check, as a fraction of its tolerance:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_optim.py
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    for name, ratio in sorted(sys.modules["test_torch_optim"].WORST.items()):
        print(f"{name}: {ratio:.3g} of its tolerance")
    sys.exit(rc)
