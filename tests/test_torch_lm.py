"""The port's LM serving path (qwen3-14b family), held against the JAX reference.

The same inputs, made from a seed with numpy, go through ``repro`` and
``repro_torch``; the reference's weights go through
:func:`repro_torch.convert.lm_params`.  Everything runs in float32 on the
CPU, where each kernel wrapper takes its plain version.  Stated
tolerances, port against reference (XLA's CPU dots and transcendentals
against PyTorch's, summed in other orders):

* layers: ``rms_norm``, ``mlp``, ``lm_logits`` within ``1e-5`` (rtol and
  atol); ``apply_rope`` at positions up to 32,768 within ``2e-6 *
  max|x|`` of the reference run op by op (float32 ``cos``/``sin`` of the
  same float32 angles; jitted, XLA's CPU ``cos``/``sin`` of such angles are
  5e-3 off);
* ``attention_train`` (several ``kv_chunk``, query blocks) and the plain
  ``attention_decode`` (with window and softcap) within ``rtol = 2e-4,
  atol = 2e-5`` of the reference's, the reference's own flash-vs-oracle
  tolerance, caches within ``1e-5``;
* the plain ``decode_attention`` within ``2e-5`` (rtol and atol) of the
  reference's ``ops.decode_attention`` (Pallas kernel, interpret mode) and
  ``ref.flash_decode_ref``, in float32 and bfloat16 (both compute in
  float32 from the same bfloat16 values);
* ``forward``, ``prefill`` (logits and caches) and ``decode_step`` logits
  within ``1e-4 * max|logits|``; ``greedy_generate`` and
  ``launch.serve.main`` tokens equal.

The ``cuda``-marked tests hold the ``flash_decode`` kernel against its
plain version (also with gemma2's attention softcap and sliding window,
at gemma2's and paligemma's decode shapes), and the kernel path of
``decode_step`` against the plain path (also for reduced MoE, hybrid and
SSM models), on a card; they skip here.  The other presets' CPU parity
is in ``tests/test_torch_lm_family.py``.  ``python tests/test_torch_lm.py``
prints the worst readings against these tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import INPUT_SHAPES as R_INPUT_SHAPES
from repro.configs import LINEAR as R_LINEAR
from repro.configs import get_config as r_get_config
from repro.configs import reduced_config as r_reduced_config
from repro.configs.base import LayerTemplate as RLayerTemplate
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.launch import serve as r_launch
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import transformer as r_tf
from repro.sharding.specs import unsharded_ctx as r_unsharded_ctx
from repro.train import serve as r_serve

from repro_torch import convert
from repro_torch.configs import ARCHS, INPUT_SHAPES, LINEAR, get_config, reduced_config
from repro_torch.configs import fdsvrg_linear
from repro_torch.configs.base import LayerTemplate, ModelConfig
from repro_torch.kernels import flash_decode as decode_mod
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_launch
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.sharding.specs import unsharded_ctx
from repro_torch.train import serve as t_serve

R_CTX = r_unsharded_ctx()
CTX = unsharded_ctx()
LAYER_TOL = 1e-5
ROPE_RTOL = 2e-6
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5
CACHE_TOL = 1e-5
DECODE_TOL = 2e-5
LOGIT_RTOL = 1e-4
# A small qwen3-shaped model with GQA (group 4); reduced_config gives qwen3
# group 1.
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=512, num_heads=8,
             num_kv_heads=2, head_dim=16, dtype="float32")
# tests/test_kernels.py:113-120: MHA, GQA, a single valid position, MQA
# with S not a multiple of the TPU block.
DECODE_SHAPES = [(8, 8, 64, 1024, 1024), (8, 2, 64, 1024, 700), (16, 4, 128, 2048, 1),
                 (4, 1, 32, 300, 257)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WORST: dict[str, float] = {}


def _record(name: str, ratio: float) -> None:
    WORST[name] = max(WORST.get(name, 0.0), float(ratio))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _close(name, got: torch.Tensor, want, rtol, atol) -> None:
    """|got - want| <= atol + rtol * |want|, recorded as a fraction of it."""
    want = torch.from_numpy(np.asarray(want, dtype=np.float32).copy())
    err = torch.abs(got.float() - want)
    tol = atol + rtol * torch.abs(want)
    _record(name, float(torch.max(err / tol)))
    assert bool(torch.all(err <= tol)), f"{name}: max err {float(err.max())}"


_FAN_IN = {"embed": -1, "lm_head": 0, "wq": 1, "wk": 1, "wv": 1, "w_up": 1, "w_gate": 1,
           "w_down": 1}


def _weights(r_cfg, tp: int = 1, seed: int = 0) -> dict:
    """Weights in the reference's layout (its ``init_params`` tree, shapes
    from ``jax.eval_shape``) drawn with numpy: matrices ``N(0, 1/fan_in)``,
    norm scales ``N(0, 0.1)`` so the ``(1 + scale)`` form matters."""
    shapes = jax.eval_shape(lambda: r_tf.init_params(r_cfg, jax.random.key(0), tp=tp))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if "norm" in name:
            return rng.normal(0, 0.1, size=s.shape).astype(np.float32)
        fan_in = s.shape[1] * s.shape[2] if name == "wo" else s.shape[_FAN_IN[name]]
        return (rng.normal(size=s.shape) * fan_in ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _configs():
    return (dataclasses.replace(r_get_config("qwen3-14b"), **SMALL),
            dataclasses.replace(get_config("qwen3-14b"), **SMALL))


@pytest.fixture(scope="module")
def small_model():
    r_cfg, t_cfg = _configs()
    tree = _weights(r_cfg)
    return r_cfg, t_cfg, jax.tree.map(jnp.asarray, tree), convert.lm_params(tree, t_cfg)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


# param_count() of the reference's presets (its own formula, run on both).
PARAM_COUNTS = {
    "paligemma-3b": 2_508_589_056, "smollm-360m": 361_759_680, "qwen3-14b": 14_767_887_360,
    "olmoe-1b-7b": 6_919_030_784, "musicgen-large": 3_229_616_128,
    "jamba-v0.1-52b": 51_458_347_008, "minitron-4b": 4_190_112_768,
    "mamba2-2.7b": 2_700_352_000, "gemma2-9b": 9_241_103_872,
    "granite-moe-1b-a400m": 1_334_579_200,
}


def test_configs_match_reference():
    """All ten LM presets, in the reference's order: the same fields, the
    same numbers, the same reduced variants and parameter counts."""
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(type(r_get_config("qwen3-14b")))]
    assert list(ARCHS) == list(R_ARCHS) and len(ARCHS) == 10
    for arch in R_ARCHS:
        t_cfg, r_cfg = get_config(arch), r_get_config(arch)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(r_cfg), arch
        assert dataclasses.asdict(reduced_config(t_cfg)) == \
            dataclasses.asdict(r_reduced_config(r_cfg)), arch
        assert t_cfg.param_count() == r_cfg.param_count() == PARAM_COUNTS[arch], arch
        assert t_cfg.active_param_count() == r_cfg.active_param_count(), arch
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_INPUT_SHAPES.items()}
    assert set(LINEAR) == set(R_LINEAR)
    assert fdsvrg_linear.CONFIGS.keys() == R_LINEAR.keys()


def test_get_config_raises_for_unported_arch():
    """Every reference preset resolves; only an unknown arch raises."""
    for arch in R_ARCHS:
        assert get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_unported_layers_and_levers_raise():
    """Every layer pattern and modality the reference builds builds here
    too (init, prefill, one decode step on the CPU), and the q_chunk lever
    runs; only what the reference refuses raises."""
    cfg = dataclasses.replace(get_config("qwen3-14b"), **SMALL)
    moe = dict(num_experts=4, top_k=2, moe_d_ff=32, capacity_factor=4.0)
    ssm = dict(ssm_state=8, ssm_head_dim=16, ssm_chunk=8)
    variants = [
        dict(pattern=(LayerTemplate("ssm", "none"),), num_heads=0, num_kv_heads=0, **ssm),
        dict(pattern=(LayerTemplate("global", "moe"),), **moe),
        dict(pattern=(LayerTemplate("local", "dense"), LayerTemplate("ssm", "moe")),
             sliding_window=4, **moe, **ssm),
        dict(modality="vision", frontend_dim=24, num_patches=3),
        dict(modality="audio-codec", num_codebooks=3, tie_embeddings=False),
    ]
    for kw in variants:
        vcfg = dataclasses.replace(cfg, **kw)
        params = t_tf.init_params(vcfg, 0, "cpu", tp=1)
        tokens = torch.zeros((1, 5) + ((3,) if kw.get("modality") == "audio-codec" else ()),
                             dtype=torch.int64)
        batch = {"tokens": tokens}
        if kw.get("modality") == "vision":
            batch["patch_embeds"] = torch.ones((1, 3, 24))
        last, cache = t_tf.prefill(params, vcfg, batch, 12, CTX)
        pos = 5 + (3 if kw.get("modality") == "vision" else 0)
        step, _ = t_tf.decode_step(params, vcfg, cache, tokens[:, -1:], pos, CTX)
        assert step.shape == last.shape and bool(torch.all(torch.isfinite(step)))
    for kw, exc in ((dict(pattern=(LayerTemplate("conv", "dense"),)), ValueError),
                    (dict(pattern=(LayerTemplate("global", "sparse"),)), ValueError),
                    (dict(modality="video"), ValueError)):
        with pytest.raises(exc):
            t_tf.init_params(dataclasses.replace(cfg, **kw), 0, "cpu")
    acfg = t_attn.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16, q_chunk=8, kv_chunk=8)
    params = t_attn.init_attention(torch.Generator().manual_seed(0), 32, acfg, torch.float32)
    x = torch.randn((1, 16, 32), generator=torch.Generator().manual_seed(1))
    y, _ = t_attn.attention_train(params, x, torch.arange(16)[None], acfg, CTX)
    want = t_attn.attention_ref(params, x, torch.arange(16)[None], acfg, CTX)
    assert float(torch.max(torch.abs(y - want))) <= 3e-5 + 3e-4 * float(torch.max(torch.abs(want)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(0, 0.1, size=64).astype(np.float32)
    _close("rms_norm", t_layers.rms_norm(_t(x), _t(scale)),
           jax.jit(r_layers.rms_norm)(jnp.asarray(x), jnp.asarray(scale)), LAYER_TOL, LAYER_TOL)

    for theta in (1e4, 1e6):
        xr = rng.normal(size=(1, 6, 4, 128)).astype(np.float32)
        pos = np.array([[0, 1, 17, 1000, 32767, 32768]], dtype=np.int32)
        got = t_layers.apply_rope(_t(xr), _t(pos), theta)
        # Eager, op by op: under jit, XLA's CPU cos/sin of these float32
        # angles (up to 32,768 rad) are off by up to 5e-3 against float64,
        # while eager XLA and PyTorch are within 2e-6.
        want = r_layers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), theta)
        _close("apply_rope", got, want, 0.0, ROPE_RTOL * float(np.abs(xr).max()))

    h = rng.normal(size=(2, 3, 64)).astype(np.float32)
    mlp = {k: rng.normal(0, 0.1, size=s).astype(np.float32)
           for k, s in (("w_up", (64, 96)), ("w_gate", (64, 96)), ("w_down", (96, 64)))}
    _close("mlp", t_layers.mlp({k: _t(v) for k, v in mlp.items()}, _t(h), "silu", CTX),
           jax.jit(lambda p, x: r_layers.mlp(p, x, "silu", R_CTX))(
               {k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(h)),
           LAYER_TOL, LAYER_TOL)
    head = rng.normal(0, 0.1, size=(64, 300)).astype(np.float32)
    for tied, table, cap in ((False, head, None), (True, head.T.copy(), 30.0)):
        got = t_layers.lm_logits(_t(h), _t(table), tied=tied, cap=cap, ctx=CTX)
        want = jax.jit(lambda x, w: r_layers.lm_logits(x, w, tied=tied, cap=cap, ctx=R_CTX))(
            jnp.asarray(h), jnp.asarray(table))
        assert got.dtype == torch.float32
        _close("lm_logits", got, want, LAYER_TOL, LAYER_TOL)
    tokens = rng.integers(0, 300, size=(2, 4))
    got = t_layers.embed_tokens(_t(head.T.copy()), _t(tokens), CTX, True)
    want = r_layers.embed_tokens(jnp.asarray(head.T.copy()), jnp.asarray(tokens), R_CTX, True)
    _close("embed_tokens", got, want, 0.0, 0.0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CFGS = {
    "gqa": dict(num_heads=8, num_kv_heads=2, head_dim=16),
    "mqa": dict(num_heads=4, num_kv_heads=1, head_dim=16),
    "qknorm": dict(num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True, rope_theta=1e6),
    "window": dict(num_heads=4, num_kv_heads=2, head_dim=16, window=16),
    "softcap": dict(num_heads=4, num_kv_heads=2, head_dim=16, attn_softcap=20.0),
}


def _attn_setup(kw, b, s, d, seed):
    r_cfg, t_cfg = r_attn.AttnConfig(**kw), t_attn.AttnConfig(**kw)
    rng = np.random.default_rng(seed)
    h, hkv, dh = r_cfg.num_heads, r_cfg.num_kv_heads, r_cfg.head_dim
    shapes = {"wq": ((d, h, dh), d), "wk": ((d, hkv, dh), d), "wv": ((d, hkv, dh), d),
              "wo": ((h, dh, d), h * dh)}
    params = {k: (rng.normal(size=s_) * fan ** -0.5).astype(np.float32)
              for k, (s_, fan) in shapes.items()}
    if kw.get("qk_norm"):  # non-zero norm scales, so the (1 + scale) form matters
        for name in ("q_norm", "k_norm"):
            params[name] = rng.normal(0, 0.2, size=dh).astype(np.float32)
    x = rng.normal(0, 0.3, size=(b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return (r_cfg, t_cfg, {k: jnp.asarray(v) for k, v in params.items()},
            {k: _t(v) for k, v in params.items()}, x, pos)


@pytest.mark.parametrize("name,kv_chunk", [
    ("gqa", 16), ("gqa", 32), ("gqa", 64), ("mqa", 32), ("qknorm", 16), ("window", 16),
    ("softcap", 64),
])
def test_attention_train_matches_reference(name, kv_chunk, monkeypatch):
    r_cfg, t_cfg, params, t_params, x, pos = _attn_setup(ATTN_CFGS[name], 2, 64, 96, 0)
    if kv_chunk == 16:  # query blocks of 5 rows: the blocked path, ragged last block
        monkeypatch.setattr(t_attn, "SCORE_BLOCK_BYTES", 4 * 2 * t_cfg.num_heads * 16 * 5)
    y, (k, v) = t_attn.attention_train(t_params, _t(x), _t(pos), t_cfg, CTX, kv_chunk=kv_chunk)
    ry, (rk, rv) = jax.jit(lambda p, x, pos: r_attn.attention_train(
        p, x, pos, r_cfg, R_CTX, kv_chunk=kv_chunk))(params, jnp.asarray(x), jnp.asarray(pos))
    _close("attention_train", y, ry, ATTN_RTOL, ATTN_ATOL)
    _close("attention_train k/v", torch.stack([k, v]), np.stack([rk, rv]), CACHE_TOL, CACHE_TOL)
    if kv_chunk == 64 or name == "window":
        r_ref_y = jax.jit(lambda p, x, pos: r_attn.attention_ref(p, x, pos, r_cfg, R_CTX))(
            params, jnp.asarray(x), jnp.asarray(pos))
        _close("attention_ref", t_attn.attention_ref(t_params, _t(x), _t(pos), t_cfg, CTX),
               r_ref_y, ATTN_RTOL, ATTN_ATOL)


@pytest.mark.parametrize("name,kw", [
    ("plain", dict(num_heads=4, num_kv_heads=2, head_dim=16)),
    ("window", dict(num_heads=4, num_kv_heads=2, head_dim=16, window=8)),
    ("qknorm-softcap", dict(num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True,
                            attn_softcap=30.0)),
])
def test_attention_decode_matches_reference(name, kw):
    """tests/test_attention.py:53-83 through both packages: decoding token
    by token, on both of the port's paths (through ``ops`` and straight
    to the plain version), and the cache decode writes."""
    b, s, d = 2, 24, 64
    r_cfg, t_cfg, params, t_params, x, pos = _attn_setup(kw, b, s, d, 3)
    r_cache = r_attn.init_kv_cache(b, s, r_cfg, jnp.float32, R_CTX)
    r_step = jax.jit(lambda p, x, c, t: r_attn.attention_decode(p, x, c, t, r_cfg, R_CTX))
    rys = []
    for t in range(s):
        ry_t, r_cache = r_step(params, jnp.asarray(x[:, t:t + 1]), r_cache,
                               jnp.asarray(t, jnp.int32))
        rys.append(np.asarray(ry_t))
    y_train, _ = t_attn.attention_train(t_params, _t(x), _t(pos), t_cfg, CTX, kv_chunk=8)
    for use_kernels in (True, False):
        t_cache = t_attn.init_kv_cache(b, s, t_cfg, torch.float32, CTX)
        ys = []
        for t in range(s):
            y_t, t_cache = t_attn.attention_decode(t_params, _t(x[:, t:t + 1]), t_cache, t,
                                                   t_cfg, CTX, use_kernels=use_kernels)
            ys.append(y_t)
        _close("attention_decode", torch.cat(ys, dim=1), np.concatenate(rys, axis=1),
               ATTN_RTOL, ATTN_ATOL)
        _close("attention_decode cache", torch.stack([t_cache["k"], t_cache["v"]]),
               np.stack([r_cache["k"], r_cache["v"]]), CACHE_TOL, CACHE_TOL)
        _close("decode vs train", torch.cat(ys, dim=1), y_train.numpy(), 3e-4, 3e-5)


@pytest.mark.parametrize("h,hkv,dh,s,length", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_plain_matches_reference(h, hkv, dh, s, length, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(h * s + length)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((h, dh), (s, hkv, dh), (s, hkv, dh)))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(tdt) for a in (q, k, v))
    assert torch.equal(tk.float(), _t(np.asarray(jk.astype(jnp.float32))))
    got = ops.decode_attention(tq, tk, tv, length=length)
    assert got.dtype == torch.float32 and got.shape == (h, dh)
    interpret = jax.jit(lambda *a: r_ops.decode_attention(*a, length=length, interpret=True))
    _close("decode_attention vs interpret", got, interpret(jq, jk, jv), DECODE_TOL, DECODE_TOL)
    oracle = jax.jit(lambda *a: r_ref.flash_decode_ref(*a, length=length))
    _close("decode_attention vs flash_decode_ref", got, oracle(jq, jk, jv), DECODE_TOL,
           DECODE_TOL)


def test_decode_attention_rejects_bad_lengths_and_cpu_launches():
    q, k = torch.zeros((8, 16)), torch.zeros((32, 2, 16))
    for length in (0, 33):
        with pytest.raises(ValueError, match="outside"):
            ops.decode_attention(q, k, k, length=length)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_mod.flash_decode(q.reshape(1, 2, 4, 16), k[None], k[None], 4, 0.25)


@pytest.mark.parametrize("batch_heads,length", [(8, 1), (8, 700), (8, 32_768), (32, 528),
                                                (8, 524_288), (4 * 8, 524_288), (1, 63),
                                                (8, 128), (32, 100), (4096, 32_768),
                                                (32, 32_768)])
def test_flash_decode_splits_cover_the_prefix(batch_heads, length):
    """The split geometry on an H100 (132 SMs): every position in exactly
    one non-empty split of at least MIN_SPLIT_ROWS (but for a shorter
    prefix), at most WAVES waves of resident blocks, one split (so one
    launch, no combine) for a short prefix or when the pairs fill the waves,
    and qwen3-14b's long decodes a full wave: B = 1 x 32,768 (8 pairs) 33
    splits, B = 4 x 32,768 (32 pairs) 8."""
    sms = 132
    n_split, rows = decode_mod.num_splits(batch_heads, length, sms)
    assert 1 <= n_split <= decode_mod.MAX_SPLITS and rows >= 1
    assert (n_split - 1) * rows < length <= n_split * rows  # no empty split
    assert n_split <= -(-length // decode_mod.MIN_SPLIT_ROWS)
    target = decode_mod.WAVES * decode_mod.BLOCKS_PER_SM * sms
    assert n_split * batch_heads <= max(batch_heads, target)
    single = length <= decode_mod.MIN_SPLIT_ROWS or batch_heads * 2 > target
    assert (n_split == 1) == single
    if length == 32_768 and batch_heads in (8, 32):
        assert n_split * batch_heads > target - batch_heads  # the wave is full


# ---------------------------------------------------------------------------
# the model and the serving loops
# ---------------------------------------------------------------------------


def _logits_close(name, got, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    _close(name, got, want, 0.0, LOGIT_RTOL * float(np.abs(want).max()))


def test_forward_prefill_decode_match_reference(small_model):
    r_cfg, t_cfg, r_params, t_params = small_model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, t_cfg.vocab_size, size=(2, 16))
    logits, aux = t_tf.forward(t_params, t_cfg, {"tokens": _t(tokens)}, CTX)
    r_logits, r_aux = jax.jit(lambda p, b: r_tf.forward(p, r_cfg, b, R_CTX))(
        r_params, {"tokens": jnp.asarray(tokens)})
    _logits_close("forward", logits, r_logits)
    assert torch.equal(aux["loss_mask"], _t(r_aux["loss_mask"]).float())

    s0, max_len = 12, 16
    last, cache = t_tf.prefill(t_params, t_cfg, {"tokens": _t(tokens[:, :s0])}, max_len, CTX)
    r_last, r_cache = jax.jit(lambda p, b: r_tf.prefill(p, r_cfg, b, max_len, R_CTX))(
        r_params, {"tokens": jnp.asarray(tokens[:, :s0])})
    _logits_close("prefill", last, r_last)
    assert cache[0]["k"].shape == r_cache[0]["k"].shape == (2, 2, max_len, 2, 16)
    _close("prefill cache", torch.stack([cache[0]["k"], cache[0]["v"]]),
           np.stack([r_cache[0]["k"], r_cache[0]["v"]]), CACHE_TOL, CACHE_TOL)
    r_decode = jax.jit(lambda p, c, tok, t: r_tf.decode_step(p, r_cfg, c, tok, t, R_CTX))
    for t in range(s0, max_len):
        step, cache = t_tf.decode_step(t_params, t_cfg, cache, _t(tokens[:, t:t + 1]), t, CTX)
        r_step, r_cache = r_decode(r_params, r_cache, jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.asarray(t, jnp.int32))
        _logits_close("decode_step", step, r_step)
        _logits_close("decode_step vs forward", step, logits[:, t:t + 1].numpy())


def test_greedy_generate_matches_reference(small_model):
    r_cfg, t_cfg, r_params, t_params = small_model
    prompt = np.random.default_rng(2).integers(0, t_cfg.vocab_size, size=(2, 8))
    got = t_serve.greedy_generate(t_params, t_cfg, CTX, _t(prompt), 6, 16)
    want = jax.jit(lambda p, pr: r_serve.greedy_generate(p, r_cfg, R_CTX, pr, 6, 16))(
        r_params, jnp.asarray(prompt, jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    step = t_serve.make_serve_step(t_cfg, CTX, use_kernels=False)
    _, cache = t_serve.make_prefill(t_cfg, CTX, 16)(t_params, {"tokens": _t(prompt)})
    tok, logits, _ = step(t_params, cache, _t(prompt[:, -1:]), 7)
    assert tok.shape == (2, 1) and int(tok[0, 0]) == int(got[0, 0])


def test_serve_step_masks_the_padded_vocab(small_model):
    _, t_cfg, _, _ = small_model
    cfg = dataclasses.replace(t_cfg, vocab_size=500)  # padded to 512 at tp = 16
    params = t_tf.init_params(cfg, 3, "cpu", tp=16)
    params["lm_head"][:, 500:] = 100.0  # the padded tail would win argmax
    _, cache = t_tf.prefill(params, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                            8, CTX)
    tok, logits, _ = t_serve.make_serve_step(cfg, CTX)(params, cache,
                                                      torch.zeros((1, 1), dtype=torch.int64), 4)
    assert logits.shape[-1] == 512 and int(tok) < 500
    assert bool(torch.all(logits[..., 500:] == -1e30))


def test_launch_serve_main_matches_reference(monkeypatch, capsys):
    argv = ["--arch", "qwen3-14b", "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen", "5"]
    tree = _weights(r_reduced_config(r_get_config("qwen3-14b")))

    def r_weights(cfg, key, tp):  # both entry points get these weights
        assert (tp, cfg.name) == (1, "qwen3-14b-smoke")
        return jax.tree.map(jnp.asarray, tree)

    def t_weights(cfg, seed, device, tp):
        assert (seed, tp, cfg.name) == (0, 1, "qwen3-14b-smoke")
        return convert.lm_params(tree, cfg, device)

    monkeypatch.setattr(r_launch.transformer, "init_params", r_weights)
    monkeypatch.setattr(t_launch.transformer, "init_params", t_weights)
    want = r_launch.main(argv)
    got = t_launch.main(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert "ms/token" in capsys.readouterr().out


def test_launch_serve_cuts_depth_and_sets_dtype_on_request():
    """--layers and --dtype reach the config, the weights, the cache and the
    logits; the twin of a cut float32 run is the same arithmetic."""
    r = t_launch.run(["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--batch", "1",
                      "--prompt-len", "4", "--gen", "2", "--layers", "4", "--dtype", "float32"])
    assert (r.cfg.num_layers, r.cfg.dtype) == (4, "float32")
    assert r.cache[0]["k"].shape[0] == 4 and r.cache[0]["k"].dtype == torch.float32
    leaves = [t for t in jax.tree_util.tree_leaves(r.params) if torch.is_floating_point(t)]
    assert leaves and all(t.dtype == torch.float32 for t in leaves)
    assert r.tokens.shape == (1, 2) and all(lg.dtype == torch.float32 for lg in r.logits)
    with pytest.raises(SystemExit):
        t_launch.run(["--arch", "qwen3-14b", "--reduced", "--device", "cpu", "--dtype", "int8"])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--arch", "qwen3-14b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tf.init_params(reduced_config(get_config("qwen3-14b")))


def test_init_params_layout_matches_reference():
    r_cfg, t_cfg = _configs()
    want = jax.eval_shape(lambda: r_tf.init_params(r_cfg, jax.random.key(0), tp=16))
    got = t_tf.init_params(t_cfg, 0, "cpu", tp=16)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in flat_got] == \
        [jax.tree_util.keystr(p) for p, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == str(w.dtype)
    again = t_tf.init_params(t_cfg, 0, "cpu", tp=16)
    assert torch.equal(got["blocks"][0]["attn"]["wq"], again["blocks"][0]["attn"]["wq"])
    other = t_tf.init_params(t_cfg, 1, "cpu", tp=16)
    assert not torch.equal(got["embed"], other["embed"])
    w = got["blocks"][0]["ffn"]["w_up"]
    assert abs(float(w.float().std()) - t_cfg.d_model ** -0.5) < 0.01


def test_convert_lm_params_checks_dtypes_and_shapes(small_model):
    r_cfg, t_cfg, r_params, _ = small_model
    tree = jax.tree.map(np.asarray, r_params)
    bf16 = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "norm" in str(path[-1].key) else np.asarray(
            jnp.asarray(a, jnp.bfloat16)), tree)
    got = convert.lm_params(bf16, dataclasses.replace(t_cfg, dtype="bfloat16"))
    assert got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["embed"].view(torch.int16), _t(bf16["embed"].view(np.int16)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        convert.lm_params({**tree, "embed": tree["embed"].astype(np.float64)})
    block = dict(tree["blocks"][0], attn={**tree["blocks"][0]["attn"],
                                          "wo": tree["blocks"][0]["attn"]["wq"]})
    with pytest.raises(ValueError, match="wo"):
        convert.lm_params({**tree, "blocks": (block,)})
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_params(tree, dataclasses.replace(t_cfg, num_layers=4))
    with pytest.raises(TypeError, match="float32"):
        convert.lm_params(tree, dataclasses.replace(t_cfg, dtype="bfloat16"))


# ---------------------------------------------------------------------------
# on the card (skipped on a machine without CUDA)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels compile with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,dh,s,length", [
    (1, 8, 8, 64, 1024, 1024), (1, 8, 2, 64, 1024, 700), (1, 16, 4, 128, 2048, 1),
    (1, 4, 1, 32, 300, 257), (3, 40, 8, 128, 600, 529), (2, 8, 1, 256, 100, 97),
    (2, 32, 2, 128, 5000, 4099),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain_on_card(cuda_device, b, h, hkv, dh, s, length, dtype):
    rng = np.random.default_rng(s + length)
    q = _t(rng.normal(size=(b, hkv, h // hkv, dh)).astype(np.float32)).to(cuda_device, dtype)
    k, v = (_t(rng.normal(size=(b, s, hkv, dh)).astype(np.float32)).to(cuda_device, dtype)
            for _ in range(2))
    before = decode_mod.launches
    got = decode_mod.flash_decode(q, k, v, length, dh ** -0.5)
    want = decode_mod.flash_decode_plain(q, k, v, length, dh ** -0.5)
    torch.cuda.synchronize()
    assert decode_mod.launches == before + 1
    assert torch.equal(got, decode_mod.flash_decode(q, k, v, length, dh ** -0.5))
    tol = 2e-5 * float(torch.max(torch.abs(v[:, :length].float())))
    assert float(torch.max(torch.abs(got - want))) <= tol
    with pytest.raises(ValueError, match="outside"):
        decode_mod.flash_decode(q, k, v, s + 1, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,group", [(dh, g) for dh in (64, 128, 256) for g in (1, 5, 16)
                                      if g * dh <= decode_mod.MAX_GROUP_X_DH])
@pytest.mark.parametrize("length", [5, 17, 129, 333])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_ragged_lengths_on_card(cuda_device, dh, group, length, dtype):
    """Ragged prefixes: inside one 16-row tile (5), one row past a tile (17),
    one row past the one-split limit (129: two splits and the combine), and
    no multiple of a tile (333); two requests, two KV heads."""
    rng = np.random.default_rng(dh * group + length)
    q = _t(rng.normal(size=(2, 2, group, dh)).astype(np.float32)).to(cuda_device, dtype)
    k, v = (_t(rng.normal(size=(2, length + 7, 2, dh)).astype(np.float32)).to(cuda_device, dtype)
            for _ in range(2))
    got = decode_mod.flash_decode(q, k, v, length, dh ** -0.5)
    want = decode_mod.flash_decode_plain(q, k, v, length, dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, decode_mod.flash_decode(q, k, v, length, dh ** -0.5))
    tol = 2e-5 * float(torch.max(torch.abs(v[:, :length].float())))
    assert float(torch.max(torch.abs(got - want))) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_kernel_path_matches_plain_on_card(cuda_device, dtype):
    # head_dim 32: the kernel takes Dh in (32, 64, 128, 256).
    cfg = dataclasses.replace(get_config("qwen3-14b"), **{**SMALL, "head_dim": 32, "dtype": dtype})
    params = t_tf.init_params(cfg, 0, cuda_device, tp=1)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 512, size=(3, 9))).to(cuda_device)
    _, cache = t_tf.prefill(params, cfg, {"tokens": prompt}, 16, CTX)
    twin = tuple({k: c.clone() for k, c in layer.items()} for layer in cache)
    ops.reset_launch_counts()
    tok = prompt[:, -1:]
    for pos in range(9, 13):
        got, cache = t_tf.decode_step(params, cfg, cache, tok, pos, CTX)
        want, twin = t_tf.decode_step(params, cfg, twin, tok, pos, CTX, use_kernels=False)
        scale = float(torch.max(torch.abs(want)))
        rtol = 1e-5 if dtype == "float32" else 5e-2
        assert float(torch.max(torch.abs(got - want))) <= rtol * scale
        tok = torch.argmax(want, dim=-1)
    assert ops.launch_counts()["flash_decode"] == 4 * cfg.num_layers


@pytest.mark.cuda
def test_softcap_and_window_raise_on_card(cuda_device):
    """gemma2's layers on the card: attention_decode with the softcap and
    the window runs the kernel (one launch a call) and agrees with the
    plain path."""
    for kw in (dict(attn_softcap=30.0), dict(window=8), dict(attn_softcap=50.0, window=5)):
        cfg = t_attn.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=32, **kw)
        params = t_attn.init_attention(torch.Generator(cuda_device).manual_seed(0), 64, cfg,
                                       torch.float32)
        cache = t_attn.init_kv_cache(1, 16, cfg, torch.float32, CTX, cuda_device)
        twin = {k: c.clone() for k, c in cache.items()}
        xs = torch.randn((12, 1, 1, 64), generator=torch.Generator(cuda_device).manual_seed(1),
                         device=cuda_device)
        before = decode_mod.launches
        for t in range(12):
            got, cache = t_attn.attention_decode(params, xs[t], cache, t, cfg, CTX)
            want, twin = t_attn.attention_decode(params, xs[t], twin, t, cfg, CTX,
                                                 use_kernels=False)
            torch.cuda.synchronize()
            assert float(torch.max(torch.abs(got - want))) <= 1e-5 * float(
                torch.max(torch.abs(want))) + 1e-6
        assert decode_mod.launches == before + 12


# gemma2-9b (Hkv 8, G 2, Dh 256) and paligemma-3b (Hkv 1, G 8, Dh 256) in
# bfloat16, the Dh 128 tensor-core pass, and float32.
CAP_SHAPES = [(1, 8, 2, 256, torch.bfloat16), (4, 8, 2, 256, torch.bfloat16),
              (2, 1, 8, 256, torch.bfloat16), (2, 4, 5, 128, torch.bfloat16),
              (2, 2, 3, 64, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hkv,group,dh,dtype", CAP_SHAPES)
@pytest.mark.parametrize("softcap,window", [(50.0, None), (None, 100), (50.0, 100),
                                            (30.0, 1), (50.0, 5000)])
@pytest.mark.parametrize("length", [1, 99, 100, 101, 777, 4097])
def test_flash_decode_softcap_and_window_on_card(cuda_device, b, hkv, group, dh, dtype, softcap,
                                                 window, length):
    """The kernel with the attention softcap and the sliding window against
    its plain version: lengths inside, at and past the window, one split
    and several, within 2e-5 * max|v| of the window's rows."""
    rng = np.random.default_rng(length * dh + group)
    q = _t(rng.normal(size=(b, hkv, group, dh)).astype(np.float32) * 4).to(cuda_device, dtype)
    k, v = (_t(rng.normal(size=(b, length + 3, hkv, dh)).astype(np.float32)).to(cuda_device, dtype)
            for _ in range(2))
    scale = dh ** -0.5
    before = decode_mod.launches
    got = decode_mod.flash_decode(q, k, v, length, scale, softcap=softcap, window=window)
    want = decode_mod.flash_decode_plain(q, k, v, length, scale, softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert decode_mod.launches == before + 1
    assert torch.equal(got, decode_mod.flash_decode(q, k, v, length, scale, softcap=softcap,
                                                    window=window))
    start = decode_mod.window_start(length, window)
    tol = 2e-5 * float(torch.max(torch.abs(v[:, start:length].float())))
    assert float(torch.max(torch.abs(got - want))) <= tol
    with pytest.raises(ValueError, match="softcap"):
        decode_mod.flash_decode(q, k, v, length, scale, softcap=0.0)
    with pytest.raises(ValueError, match="window"):
        decode_mod.flash_decode(q, k, v, length, scale, window=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b", "mamba2-2.7b"])
def test_reduced_moe_and_ssm_decode_step_on_card(cuda_device, arch):
    """A reduced MoE, hybrid and SSM model on the card: prefill then
    decode_step, the kernel path against the plain path and against the
    same model on the CPU, flash_decode launched once per attention layer
    and step; two kernel-path runs bit for bit."""
    cfg = reduced_config(get_config(arch))
    params = t_tf.init_params(cfg, 0, cuda_device, tp=1)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, size=(3, 9)))
    attn_layers = sum(t.mixer != "ssm" for t in cfg.pattern) * cfg.num_repeats

    fed = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(4, 3, 1)))

    def run(device, use_kernels):
        p = jax.tree.map(lambda a: a.to(device), params)
        _, cache = t_tf.prefill(p, cfg, {"tokens": prompt.to(device)}, 16, CTX)
        outs = []
        for i, pos in enumerate(range(9, 13)):
            logits, cache = t_tf.decode_step(p, cfg, cache, fed[i].to(device), pos, CTX,
                                             use_kernels=use_kernels)
            outs.append(logits.cpu())
        return torch.stack(outs)

    ops.reset_launch_counts()
    got = run(cuda_device, True)
    assert ops.launch_counts()["flash_decode"] == 4 * attn_layers
    assert torch.equal(got, run(cuda_device, True))
    scale = float(torch.max(torch.abs(got)))
    assert float(torch.max(torch.abs(got - run(cuda_device, False)))) <= 1e-5 * scale
    assert float(torch.max(torch.abs(got - run("cpu", True)))) <= 1e-4 * scale


if __name__ == "__main__":
    # The worst reading of each check, as a fraction of its tolerance:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm.py
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    for name, ratio in sorted(sys.modules["test_torch_lm"].WORST.items()):
        print(f"{name}: {ratio:.3g} of its tolerance")
    sys.exit(rc)
