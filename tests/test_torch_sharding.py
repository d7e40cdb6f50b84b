"""The port's mesh rules, held against the JAX reference on the CPU.

``RULES`` is the reference's.  For all ten presets at full width, on the
production meshes (16 x 16 ``(data, model)`` and 2 x 16 x 16
``(pod, data, model)``) and with ``long_500k``'s overrides: ``make_ctx``'s
rules, ``param_specs(zero1=True/False)``, ``cache_specs``,
``state_specs``, ``axis_size`` and ``moe._num_groups`` equal the
reference's leaf for leaf.  Both packages only read the mesh's axis
sizes, so stand-in meshes drive them with no devices (the reference
reads ``mesh.shape`` as a dict, the port ``mesh_dim_names`` and
``mesh.shape``); the reference's parameter shapes come from
``jax.eval_shape``, the port's from ``init_params`` under
``FakeTensorMode``.  A spec compares as the tuple of its entries.

In a subprocess with 8 host devices and a fake process group of 8 ranks:
for reduced smollm-360m, granite-moe-1b-a400m and jamba-v0.1-52b on a
2 x 4 mesh, each rank's shard of every parameter (both layouts), cache
and state leaf (DTensor's local shape and offset for that rank's mesh
coordinate, from the port's placements) equals the reference's
``NamedSharding.devices_indices_map`` for the same device.  Also the
placements of a dimension split over two axes (the batch over
``(pod, data)``), their refusal of another axis order, ``constrain``'s
identity cases and ``distribute``.
"""

import functools
import os
import subprocess
import sys
import textwrap
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs import get_config as r_get_config
from repro.models import moe as r_moe
from repro.models import transformer as r_tf
from repro.optim import optimizers as r_opt
from repro.sharding import specs as r_specs
from repro.train import loop as r_loop
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from repro_torch.sharding import specs as t_specs
from repro_torch.train import loop as t_loop

PRESETS = sorted(ARCHS)
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
OVERRIDES = {"base": {}, "long_500k": {"batch": None, "seq_kv": ("data", "model")}}
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _r_mesh(axes: dict):
    """The reference reads ``mesh.shape`` as a dict."""
    return types.SimpleNamespace(shape=dict(axes))


def _t_mesh(axes: dict):
    """The port reads ``mesh_dim_names`` and ``mesh.shape``."""
    return types.SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(axes.values()))


def _r_specs(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, RP))]


def _t_specs(tree) -> list:
    return [tuple(s) for s in t_specs.spec_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    """(reference param and state shapes, port param and state shapes) at
    full width: abstract on both sides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    r_cfg = r_get_config(arch)
    r_params = jax.eval_shape(lambda: r_tf.init_params(r_cfg, jax.random.key(0)))
    r_state = jax.eval_shape(lambda: r_loop.init_state(r_cfg, jax.random.key(0),
                                                       r_opt.adamw(1e-3)))
    with FakeTensorMode():
        t_state = t_loop.init_state(get_config(arch), 0, t_opt.adamw(1e-3), device="cpu")
        t_params = t_tf.init_params(get_config(arch), 0, "cpu")
    return r_params, r_state, t_params, t_state


def test_rules_are_the_reference():
    assert t_specs.RULES == r_specs.RULES


@pytest.mark.parametrize("over", sorted(OVERRIDES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", PRESETS)
def test_mesh_rules_match_reference(arch, mesh_name, over):
    axes = MESHES[mesh_name]
    r_mesh, t_mesh = _r_mesh(axes), _t_mesh(axes)
    r_cfg, t_cfg = r_get_config(arch), get_config(arch)
    r_ctx = r_tf.make_ctx(r_mesh, r_cfg, overrides=OVERRIDES[over])
    t_ctx = t_tf.make_ctx(t_mesh, t_cfg, overrides=OVERRIDES[over])
    assert t_ctx.rules == r_ctx.rules
    r_params, r_state, t_params, t_state = _shapes(arch)
    assert [tuple(x.shape) for x in t_opt.tree_leaves(t_params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(r_params)]
    for zero1 in (True, False):
        want = _r_specs(r_tf.param_specs(r_params, r_cfg, r_ctx, zero1=zero1))
        got = _t_specs(t_tf.param_specs(t_params, t_cfg, t_ctx, zero1=zero1))
        assert got == want, (zero1, [(g, w) for g, w in zip(got, want) if g != w][:4])
    assert _t_specs(t_tf.cache_specs(t_cfg, t_ctx)) == _r_specs(r_tf.cache_specs(r_cfg, r_ctx))
    assert _t_specs(t_loop.state_specs(t_state, t_cfg, t_ctx)) == \
        _r_specs(r_loop.state_specs(r_state, r_cfg, r_ctx))
    for name in t_specs.RULES:
        assert t_specs.axis_size(t_mesh, name) == r_specs.axis_size(r_mesh, name), name
    for b in (1, 2, 3, 6, 8, 16, 24, 32, 128, 256):
        assert t_moe._num_groups(t_ctx, b) == r_moe._num_groups(r_ctx, b), b
    # spec / spec_div of the activation names the model code uses
    for names in (("batch", "seq", "embed"), ("batch", "heads", None, None),
                  ("batch", "seq_kv", None, None), (None, "batch", "ssm_heads", None, None),
                  ("batch", "experts", None, "expert_mlp"), ("vocab", "zero1")):
        assert tuple(t_ctx.spec(*names)) == tuple(r_ctx.spec(*names)), names
        shape = (48, 40, 8, 2, 3)[: len(names)]
        assert tuple(t_ctx.spec_div(shape, *names)) == tuple(r_ctx.spec_div(shape, *names))


def test_without_a_mesh_every_spec_is_empty():
    ctx, r_ctx = t_specs.unsharded_ctx(), r_specs.unsharded_ctx()
    assert tuple(ctx.spec("batch", "seq")) == tuple(r_ctx.spec("batch", "seq")) == ()
    assert t_specs.axis_size(None, "batch") == r_specs.axis_size(None, "batch") == 1
    assert t_tf.make_ctx(None, get_config("smollm-360m")).rules == t_specs.RULES
    x = torch.ones(2, 3)
    assert ctx.constrain(x, "batch", "embed") is x
    assert t_moe._num_groups(ctx, 8) == 1


def test_placements_split_a_dimension_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _t_mesh(MESHES["2x16x16"])
    ctx = t_specs.ShardingCtx(mesh=mesh)
    # the batch over (pod, data), the heads over model
    assert ctx.placements(4, "batch", "heads", None, None) == (Shard(0), Shard(0), Shard(1))
    assert ctx.placements((32, 48, 7, 128), "batch", "heads", None, None) == \
        (Shard(0), Shard(0), Shard(1))
    # spec_div drops an axis whose product does not divide the dimension
    assert ctx.placements((30, 48), "batch", "heads") == (Replicate(), Replicate(), Shard(1))
    assert t_specs.spec_placements(mesh, t_specs.P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        t_specs.spec_placements(mesh, t_specs.P(("model", "data")))
    with pytest.raises(ValueError, match="mesh_dim_names"):
        t_specs.mesh_axes(types.SimpleNamespace(mesh_dim_names=None, shape=(4,)))


def test_placement_rewrites():
    from torch.distributed.tensor import Partial, Replicate, Shard

    layout = (Shard(0), Shard(1), Partial())
    assert t_specs.with_dim(layout, 1, Replicate()) == (Shard(0), Replicate(), Partial())
    assert t_specs.with_dim(layout, 1, Shard(2)) == (Shard(0), Shard(2), Partial())
    assert t_specs.with_dim(layout, 0, Partial("max")) == (Partial("max"), Shard(1), Partial())
    assert t_specs.with_dim(layout, 3, Replicate()) == layout
    assert t_specs.only_dims(layout, (0,)) == (Shard(0), Replicate(), Replicate())
    assert t_specs.only_dims(layout, range(2)) == (Shard(0), Shard(1), Replicate())
    assert t_specs.only_dims(layout, ()) == (Replicate(),) * 3


_SUB = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax
    import numpy as np
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    from repro.configs import get_config as r_get_config, reduced_config as r_reduced
    from repro.dist.compat import make_mesh
    from repro.models import transformer as r_tf
    from repro.optim import optimizers as r_opt
    from repro.train import loop as r_loop
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as t_tf
    from repro_torch.optim import optimizers as t_opt
    from repro_torch.sharding import specs as t_specs
    from repro_torch.train import loop as t_loop

    r_mesh = make_mesh((2, 4), ("data", "model"))
    t_mesh = make_test_mesh(2, 4)
    coords = {int(d.id): (i, j) for (i, j), d in np.ndenumerate(r_mesh.devices)}

    def r_slices(spec, shape):
        idx = NamedSharding(r_mesh, spec).devices_indices_map(tuple(shape))
        return {coords[int(d.id)]: tuple((s.start or 0, s.stop if s.stop is not None else n)
                                         for s, n in zip(sl, shape))
                for d, sl in idx.items()}

    def t_slices(spec, shape):
        pl = t_specs.spec_placements(t_mesh, spec)
        out = {}
        for c in coords.values():
            local, off = _compute_local_shape_and_global_offset(tuple(shape), (2, 4), list(c), pl)
            out[c] = tuple((o, o + n) for o, n in zip(off, local))
        local, off = t_specs.local_offset(shape, t_mesh, pl)  # this process is rank 0
        assert out[(0, 0)] == tuple((o, o + n) for o, n in zip(off, local))
        return out

    checked = 0
    for arch in ("smollm-360m", "granite-moe-1b-a400m", "jamba-v0.1-52b"):
        r_cfg = dataclasses.replace(r_reduced(r_get_config(arch)), ssm_chunk=16)
        t_cfg = dataclasses.replace(reduced_config(get_config(arch)), ssm_chunk=16)
        r_ctx, t_ctx = r_tf.make_ctx(r_mesh, r_cfg), t_tf.make_ctx(t_mesh, t_cfg)
        r_state = r_loop.init_state(r_cfg, jax.random.key(0), r_opt.adamw(1e-3), 4)
        t_state = t_loop.init_state(t_cfg, 0, t_opt.adamw(1e-3), 4, device="cpu")
        r_cache = jax.eval_shape(lambda: r_tf.init_cache(r_cfg, 8, 32, r_ctx, 4))
        t_cache = t_tf.init_cache(t_cfg, 8, 32, t_specs.unsharded_ctx())
        pairs = [(r_loop.state_specs(r_state, r_cfg, r_ctx), r_state,
                  t_loop.state_specs(t_state, t_cfg, t_ctx), t_state),
                 (r_tf.cache_specs(r_cfg, r_ctx), r_cache, t_tf.cache_specs(t_cfg, t_ctx), t_cache)]
        for zero1 in (True, False):
            pairs.append((r_tf.param_specs(r_state["params"], r_cfg, r_ctx, zero1=zero1),
                          r_state["params"],
                          t_tf.param_specs(t_state["params"], t_cfg, t_ctx, zero1=zero1),
                          t_state["params"]))
        for r_sp, r_tree, t_sp, t_tree in pairs:
            r_leaves = jax.tree.leaves(r_tree)
            r_sl = jax.tree.leaves(r_sp, is_leaf=lambda x: isinstance(x, P))
            t_leaves, t_sl = t_opt.tree_leaves(t_tree), t_specs.spec_leaves(t_sp)
            assert len(r_leaves) == len(t_leaves) == len(r_sl) == len(t_sl), arch
            for ra, rs, ta, ts in zip(r_leaves, r_sl, t_leaves, t_sl):
                assert tuple(ra.shape) == tuple(ta.shape)
                want, got = r_slices(rs, ra.shape), t_slices(ts, ta.shape)
                assert got == want, (arch, rs, ts, ra.shape)
                checked += 1
        # distribute lays a leaf out as those placements on this rank (rank 0)
        lm = t_state["params"]["embed"]
        d = t_specs.distribute({"e": lm}, {"e": t_tf.param_specs({"embed": lm}, t_cfg, t_ctx)["embed"]},
                               t_mesh)["e"]
        (r0,) = [s for c, s in t_slices(t_tf.param_specs({"embed": lm}, t_cfg, t_ctx)["embed"],
                                         lm.shape).items() if c == (0, 0)]
        assert torch.equal(d.to_local(), lm[tuple(slice(a, b) for a, b in r0)])
        # constrain redistributes a DTensor, leaves a plain tensor alone
        x = distribute_tensor(torch.arange(8 * 6.0).reshape(8, 6), t_mesh,
                              t_specs.spec_placements(t_mesh, t_ctx.spec("batch", None)))
        y = t_ctx.constrain(x, None, "vocab")
        assert tuple(y.placements) == t_specs.spec_placements(t_mesh, t_ctx.spec(None, "vocab"))
        assert (t_specs.split_ways(x, 0), t_specs.split_ways(x, 1)) == (2, 1)
        assert (t_specs.split_ways(y, 0), t_specs.split_ways(y, 1)) == (1, 4)
        assert t_ctx.constrain(x, "batch", None) is x
        plain = torch.ones(8, 6)
        assert t_ctx.constrain(plain, None, "vocab") is plain
        assert dataclasses.replace(t_ctx, enable=False).constrain(x, None, "vocab") is x
    print("SHARD-SLICES-OK", checked)
""")


def test_each_rank_holds_the_references_slice():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _SUB], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "SHARD-SLICES-OK" in proc.stdout
    assert int(proc.stdout.split("SHARD-SLICES-OK")[1].split()[0]) > 100
