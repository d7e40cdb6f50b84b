"""Every LM preset of the port, at ``reduced_config`` size, held against the JAX reference.

For each of the nine presets beside qwen3-14b (``tests/test_torch_lm.py``)
the reference's own weights (``repro.models.transformer.init_params``,
with numpy noise on the leaves it initialises to constants, so the norm
scales' ``(1 + scale)`` form, the conv bias and the step bias matter) go
through :func:`repro_torch.convert.lm_params`; the same prompts, made
with numpy, go through both packages on the CPU in float32.  Stated
tolerances (XLA's CPU dots, transcendentals and scans against PyTorch's,
summed in other orders):

* ``forward`` logits, ``prefill``'s last logits and every ``decode_step``'s
  logits within ``1e-4 * max|logits|`` of the reference's; each decode
  step within the same of the port's own ``forward`` at that position;
* the prefill caches within ``1e-5`` (rtol and atol) for k, v and the
  conv window, and ``2e-4 * max|state|`` for the SSD state (the
  reference sums its closed form in another order);
* the MoE aux losses within ``1e-5`` (rtol and atol); ``greedy_generate``
  and ``launch.serve.main`` (paligemma-3b and musicgen-large) tokens equal.

``python tests/test_torch_lm_family.py`` prints the worst readings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import reduced_config as r_reduced_config
from repro.launch import serve as r_launch
from repro.models import transformer as r_tf
from repro.sharding.specs import unsharded_ctx as r_unsharded_ctx
from repro.train import serve as r_serve

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as t_launch
from repro_torch.models import transformer as t_tf
from repro_torch.sharding.specs import unsharded_ctx
from repro_torch.train import serve as t_serve

R_CTX = r_unsharded_ctx()
CTX = unsharded_ctx()
LOGIT_RTOL = 1e-4
CACHE_TOL = 1e-5
STATE_RTOL = 2e-4
AUX_TOL = 1e-5
PRESETS = ["gemma2-9b", "minitron-4b", "smollm-360m", "olmoe-1b-7b", "granite-moe-1b-a400m",
           "mamba2-2.7b", "jamba-v0.1-52b", "paligemma-3b", "musicgen-large"]
WORST: dict[str, float] = {}


def _record(name: str, ratio: float) -> None:
    WORST[name] = max(WORST.get(name, 0.0), float(ratio))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _close(name, got: torch.Tensor, want, rtol, atol) -> None:
    want = torch.from_numpy(np.asarray(want, dtype=np.float32).copy())
    err = torch.abs(got.float() - want)
    tol = atol + rtol * torch.abs(want)
    _record(name, float(torch.max(err / tol)))
    assert bool(torch.all(err <= tol)), f"{name}: max err {float(err.max())}"


def _logits_close(name, got, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    _close(name, got, want, 0.0, LOGIT_RTOL * float(np.abs(want).max()))


_NOISE = {"conv_b": 0.1, "dt_bias": 0.5}


def reference_weights(r_cfg, seed: int = 0) -> dict:
    """The reference's initial parameters as numpy arrays, the leaves it
    sets to constants (norm scales, conv bias, step bias) given N(0, s)
    noise so that they matter."""
    tree = jax.tree.map(np.asarray, r_tf.init_params(r_cfg, jax.random.key(seed), tp=1))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(path[-1].key)
        if "norm" in name or name in _NOISE:
            return (a + rng.normal(0, _NOISE.get(name, 0.1), size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _batch(cfg, tokens: np.ndarray, rng) -> dict:
    batch = {"tokens": tokens}
    if cfg.modality == "vision":
        batch["patch_embeds"] = rng.normal(size=(tokens.shape[0], cfg.num_patches,
                                                 cfg.frontend_dim)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=PRESETS)
def preset(request):
    name = request.param
    r_cfg = r_reduced_config(r_get_config(name))
    t_cfg = reduced_config(get_config(name))
    tree = reference_weights(r_cfg)
    r_params = jax.tree.map(jnp.asarray, tree)
    return name, r_cfg, t_cfg, r_params, convert.lm_params(tree, t_cfg)


def test_preset_forward_prefill_decode_greedy_match_reference(preset):
    name, r_cfg, t_cfg, r_params, t_params = preset
    rng = np.random.default_rng(1)
    b, s, s0, steps = 2, 12, 8, 4
    shape = (b, s, t_cfg.num_codebooks) if t_cfg.modality == "audio-codec" else (b, s)
    tokens = rng.integers(0, t_cfg.vocab_size, size=shape)
    batch = _batch(t_cfg, tokens, rng)
    patches = t_cfg.num_patches if t_cfg.modality == "vision" else 0

    # forward
    logits, aux = t_tf.forward(t_params, t_cfg, {k: _t(v) for k, v in batch.items()}, CTX)
    r_logits, r_aux = jax.jit(lambda p, bt: r_tf.forward(p, r_cfg, bt, R_CTX))(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    _logits_close(f"forward {name}", logits, r_logits)
    assert logits.shape == r_logits.shape
    assert torch.equal(aux["loss_mask"], _t(r_aux["loss_mask"]).float())
    for key in ("lb_loss", "z_loss", "overflow_frac"):
        _close(f"forward aux {key}", aux[key].reshape(1), np.reshape(r_aux[key], 1),
               AUX_TOL, AUX_TOL)

    # prefill the first s0 tokens, then decode the rest one at a time
    max_len = s + patches
    pre = dict(batch, tokens=tokens[:, :s0])
    last, cache = t_tf.prefill(t_params, t_cfg, {k: _t(v) for k, v in pre.items()}, max_len, CTX)
    r_last, r_cache = jax.jit(lambda p, bt: r_tf.prefill(p, r_cfg, bt, max_len, R_CTX))(
        r_params, {k: jnp.asarray(v) for k, v in pre.items()})
    _logits_close(f"prefill {name}", last, r_last)
    for tmpl, c, rc in zip(t_cfg.pattern, cache, r_cache):
        assert set(c) == set(rc)
        for key in c:
            assert tuple(c[key].shape) == rc[key].shape and str(c[key].dtype)[6:] == \
                str(rc[key].dtype), (name, key)
            if key == "state":
                _close("prefill cache state", c[key], rc[key], 0.0,
                       STATE_RTOL * float(np.abs(np.asarray(rc[key])).max()))
            else:
                _close(f"prefill cache {key}", c[key], rc[key], CACHE_TOL, CACHE_TOL)
    r_decode = jax.jit(lambda p, c, tok, t: r_tf.decode_step(p, r_cfg, c, tok, t, R_CTX))
    for t in range(s0, s):
        tok = tokens[:, t:t + 1]
        step, cache = t_tf.decode_step(t_params, t_cfg, cache, _t(tok), patches + t, CTX)
        r_step, r_cache = r_decode(r_params, r_cache, jnp.asarray(tok),
                                   jnp.asarray(patches + t, jnp.int32))
        _logits_close(f"decode_step {name}", step, r_step)
        _logits_close(f"decode_step vs forward {name}", step,
                      logits[:, patches + t:patches + t + 1].numpy())

    # greedy generation from the first s0 tokens
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    got = t_serve.greedy_generate(t_params, t_cfg, CTX, _t(tokens[:, :s0]), steps, max_len,
                                  {k: _t(v) for k, v in extra.items()})
    want = jax.jit(lambda p, pr, ex: r_serve.greedy_generate(
        p, r_cfg, R_CTX, pr, steps, max_len, ex))(
        r_params, jnp.asarray(tokens[:, :s0], jnp.int32),
        {k: jnp.asarray(v) for k, v in extra.items()})
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_launch_serve_main_matches_reference_for_front_ends(arch, monkeypatch, capsys):
    """The vision prompt (ids, then patch embeddings from the same rng) and
    the audio prompt ([B, S, K]) built as the reference builds them; the
    same weights in both entry points, the same tokens out."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "6", "--gen", "4"]
    tree = reference_weights(r_reduced_config(r_get_config(arch)))

    def r_weights(cfg, key, tp):
        assert (tp, cfg.name) == (1, f"{arch}-smoke")
        return jax.tree.map(jnp.asarray, tree)

    def t_weights(cfg, seed, device, tp):
        assert (seed, tp, cfg.name) == (0, 1, f"{arch}-smoke")
        return convert.lm_params(tree, cfg, device)

    monkeypatch.setattr(r_launch.transformer, "init_params", r_weights)
    monkeypatch.setattr(t_launch.transformer, "init_params", t_weights)
    want = r_launch.main(argv)
    run = t_launch.run(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(run.tokens, np.asarray(want))
    patches = 4 if arch == "paligemma-3b" else 0
    assert run.pos0 == 6 + patches
    assert run.cache[0]["k"].shape[2] == 6 + 4 + patches  # max_len counts the patches
    got = t_launch.main(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert "ms/token" in capsys.readouterr().out


def test_convert_keeps_float32_leaves_beside_bfloat16_weights():
    """The router and the SSD decay, step bias and skip stay float32 in a
    bfloat16 model, as the norm scales do; a bfloat16 router is refused."""
    r_cfg = dataclasses.replace(r_reduced_config(r_get_config("jamba-v0.1-52b")),
                                dtype="bfloat16")
    t_cfg = dataclasses.replace(reduced_config(get_config("jamba-v0.1-52b")), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, r_tf.init_params(r_cfg, jax.random.key(0), tp=1))
    got = convert.lm_params(tree, t_cfg)
    ssm = got["blocks"][0]["ssm"]
    assert got["blocks"][1]["moe"]["router"].dtype == torch.float32
    assert all(ssm[k].dtype == torch.float32 for k in ("a_log", "dt_bias", "d_skip", "out_norm"))
    assert ssm["in_proj"].dtype == got["blocks"][1]["moe"]["w_up"].dtype == torch.bfloat16
    init = t_tf.init_params(t_cfg, 0, "cpu", tp=1)
    for a, b_ in zip(jax.tree_util.tree_leaves(init), jax.tree_util.tree_leaves(got)):
        assert a.dtype == b_.dtype and a.shape == b_.shape
    bad = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(jnp.asarray(a, jnp.bfloat16)) if str(p[-1].key) == "router"
        else a, tree)
    with pytest.raises(TypeError, match="router"):
        convert.lm_params(bad)
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_params(tree, dataclasses.replace(t_cfg, num_experts=8))


if __name__ == "__main__":
    # The worst reading of each check, as a fraction of its tolerance:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_family.py
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    for name, ratio in sorted(sys.modules["test_torch_lm_family"].WORST.items()):
        print(f"{name}: {ratio:.3g} of its tolerance")
    sys.exit(rc)
