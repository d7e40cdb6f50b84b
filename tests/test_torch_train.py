"""The port's LM train step, held against the JAX reference on the CPU.

Every preset at ``reduced_config`` (float32) starts from the same
state: the reference's ``init_params`` weights (numpy noise on the
leaves it sets to constants, so norm scales and biases matter:
``test_torch_lm_family.reference_weights``) and a
fresh adamw state, carried across by :func:`repro_torch.convert.train_state`.
The same batches (``token_stream.batches``, byte for byte the same) go
through ``repro.train.loop.make_train_step`` (jitted) and the port's for
3 steps.  The optimizer is adamw (lr 1e-3) wrapped so that its state
also keeps the gradients it was handed (after accumulation and clipping),
so the gradients before the optimizer are read off the step itself.
Stated tolerances (XLA's CPU dots, transcendentals, scans and
reductions against PyTorch's, summed in other orders; the gradients run
through ~10 contractions each way):

* metrics (``loss``, ``ce``, ``lb_loss``, ``z_loss``, ``overflow_frac``,
  ``grad_norm``) within ``METRIC_TOL`` (rtol and atol);
* each gradient leaf within ``GRAD_RTOL * max|g_leaf|`` of the
  reference's after step 1;
* each master within ``MASTER_ATOL`` after steps 1 and 3 where its
  step-1 gradient is at least ``DETERMINED`` of its leaf's largest, and
  within ``ADAMW_ATOL`` (half of one step's ``lr``) everywhere: adamw
  moves a weight by about ``lr`` whatever its gradient's size, so where
  the gradient lies within rounding of zero (under 1e-4 of the leaf's
  largest) the two packages' steps differ in size and sign.

The bfloat16 compute copy (float32 masters) is held against the
reference's jitted bfloat16 step for ``BF16_PRESETS`` (the dense and the
MoE preset the card trains at full depth, the SSD, and qwen3-14b, whose
ce rises in three full-width steps on the card), with tolerances set
from the readings: the two
packages round the forward's activations and the gradients to bfloat16
(eps 2**-8) at different points, which moves the metrics by up to 8.1e-3
(granite-moe's lb_loss at step 3) and each gradient leaf by up to 2.6e-2
of its largest (mamba2):

* metrics within ``BF16_METRIC_TOL``;
* each gradient leaf within ``BF16_GRAD_RTOL * max|g_leaf|`` after step 1;
* each master within ``BF16_MASTER_ATOL`` where its step-1 gradient is at
  least ``BF16_DETERMINED`` of its leaf's largest (below that, bf16
  rounding flips the sign of gradients up to ~3e-2 of the largest), and
  within ``BF16_ADAMW_ATOL`` a step everywhere (each adamw step moves a
  weight by about ``lr``, in either direction).

jamba-v0.1-52b is not in that set: at (2, 16), seed 3, one token's router
probabilities at its second MoE layer lie 8e-4 apart between the 2nd and
3rd expert, bfloat16 rounding flips that choice, and the token's logits
then differ by 0.19 of the largest (a discrete divergence, not rounding).

Within the port: ``grad_accum`` 2 against 1 on the same 4 rows, without
the MoE aux losses (their batch statistics differ by design between one
batch and two halves): the gradients within ``ACCUM_RTOL * max|g_leaf|``,
the masters after an sgd step within ``MASTER_ATOL``; remat on against off (bitwise: the recomputation
repeats the same ops), remat inactive in ``prefill`` / ``decode_step``
and without autograd, ``launch.train.main(device="cpu")`` against the
reference's ``main`` with the same weights (printed values and the saved
checkpoint within the tolerances above), resume from a checkpoint
bitwise, the entry points' refusal without a card, and ``cuda``-marked
twins of the step on the card (skipped here).

``python tests/test_torch_train.py`` prints the worst readings.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import reduced_config as r_reduced_config
from repro.launch import train as r_launch
from repro.models import transformer as r_tf
from repro.optim import optimizers as r_opt
from repro.sharding.specs import unsharded_ctx as r_unsharded_ctx
from repro.train import loop as r_loop

from repro_torch import convert
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.data.token_stream import PipelineConfig, batches
from repro_torch.launch import train as t_launch
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from repro_torch.sharding.specs import unsharded_ctx
from repro_torch.train import loop as t_loop

from test_torch_lm_family import reference_weights  # the reference's weights, noised

R_CTX = r_unsharded_ctx()
CTX = unsharded_ctx()
PRESETS = sorted(ARCHS)
LR = 1e-3
METRIC_TOL = 1e-5
GRAD_RTOL = 1e-4
MASTER_ATOL = 2e-5
DETERMINED = 1e-2
ADAMW_ATOL = 0.5 * LR
ACCUM_RTOL = 1e-5
BF16_PRESETS = ("smollm-360m", "qwen3-14b", "granite-moe-1b-a400m", "mamba2-2.7b")
BF16_METRIC_TOL = 2e-2
BF16_GRAD_RTOL = 5e-2
BF16_DETERMINED = 1e-1
BF16_MASTER_ATOL = LR
BF16_ADAMW_ATOL = 2.5 * LR  # a step
TOLS = {"float32": {"metric": METRIC_TOL, "grad": GRAD_RTOL, "determined": DETERMINED,
                    "master": MASTER_ATOL, "any": lambda steps: ADAMW_ATOL},
        "bfloat16": {"metric": BF16_METRIC_TOL, "grad": BF16_GRAD_RTOL,
                     "determined": BF16_DETERMINED, "master": BF16_MASTER_ATOL,
                     "any": lambda steps: BF16_ADAMW_ATOL * steps}}
WORST: dict[str, float] = {}


def _record(name: str, ratio: float) -> None:
    WORST[name] = max(WORST.get(name, 0.0), float(ratio))


def _keeping_grads(mod, base: str = "adamw"):
    """adamw(LR) (or sgd) whose state also holds the gradients it was handed."""
    inner = getattr(mod, base)(LR)
    zeros = (lambda p: jnp.zeros(p.shape, jnp.float32)) if mod is r_opt else \
        (lambda p: torch.zeros(p.shape, dtype=torch.float32))
    tmap = jax.tree.map if mod is r_opt else t_opt.tree_map

    def init(params):
        return {"inner": inner.init(params), "g": tmap(zeros, params)}

    def update(grads, state, params):
        updates, s = inner.update(grads, state["inner"], params)
        return updates, {"inner": s, "g": grads}

    return mod.Optimizer(init, update)


def _states(arch: str, dtype: str = "float32"):
    """(r_cfg, t_cfg, reference state, port state) from the same float32
    masters, under a ``dtype`` compute copy."""
    r_cfg = r_reduced_config(r_get_config(arch))
    tree = reference_weights(r_cfg)
    r_cfg = dataclasses.replace(r_cfg, dtype=dtype)
    t_cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    r_params = jax.tree.map(jnp.asarray, tree)
    r_state = {"params": r_params, "opt": _keeping_grads(r_opt).init(r_params),
               "step": jnp.zeros((), jnp.int32)}
    plain = {"params": tree, "opt": jax.tree.map(np.asarray, r_opt.adamw(LR).init(r_params)),
             "step": np.zeros((), np.int32)}
    conv = convert.train_state(plain, t_cfg)
    t_state = {"params": conv["params"],
               "opt": {"inner": conv["opt"],
                       "g": t_opt.tree_map(torch.zeros_like, conv["params"])},
               "step": conv["step"]}
    return r_cfg, t_cfg, r_state, t_state


def _t_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}


def _close_leaves(name, got, want, rtol=0.0, atol=0.0, per_leaf_scale=False) -> None:
    g_leaves, w_leaves = t_opt.tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves), name
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w, dtype=np.float64)
        assert tuple(g.shape) == w.shape, name
        err = np.abs(g.double().numpy() - w)
        tol = atol + rtol * (float(np.abs(w).max()) if per_leaf_scale else np.abs(w))
        ratio = float(np.max(err / np.maximum(tol, 1e-300)))
        _record(name, ratio)
        assert ratio <= 1.0, f"{name}: {ratio} of its tolerance"


def _close_masters(name, got, want, grads, determined=DETERMINED, master_atol=MASTER_ATOL,
                   any_atol=ADAMW_ATOL) -> None:
    """The two-tier adamw bound: ``master_atol`` where the step-1
    gradient ``grads`` is at least ``determined`` of its leaf's largest,
    ``any_atol`` everywhere."""
    for g, w, gr in zip(t_opt.tree_leaves(got), jax.tree.leaves(want), jax.tree.leaves(grads)):
        err = np.abs(g.double().numpy() - np.asarray(w, dtype=np.float64))
        gr = np.abs(np.asarray(gr))
        big = gr >= determined * gr.max()
        _record(f"{name} (determined)", float(err[big].max(initial=0.0)) / master_atol)
        _record(f"{name} (any)", float(err.max()) / any_atol)
        assert float(err[big].max(initial=0.0)) <= master_atol, name
        assert float(err.max()) <= any_atol, name


def _close_metrics(name, got: dict, want: dict, tol=METRIC_TOL) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        ratio = abs(g - w) / (tol * (1.0 + abs(w)))
        _record(f"{name} {k}", ratio)
        assert ratio <= 1.0, f"{name} {k}: {g} vs {w}"


@pytest.mark.parametrize("arch, dtype", [pytest.param(a, "float32", id=a) for a in PRESETS] + [
    pytest.param(a, "bfloat16", id=f"{a}-bfloat16") for a in BF16_PRESETS])
def test_train_step_matches_reference(arch, dtype):
    r_cfg, t_cfg, r_state, t_state = _states(arch, dtype)
    tol = TOLS[dtype]
    settings = t_loop.TrainSettings()
    r_step = jax.jit(r_loop.make_train_step(r_cfg, R_CTX, _keeping_grads(r_opt),
                                            r_loop.TrainSettings()))
    t_step = t_loop.make_train_step(t_cfg, CTX, _keeping_grads(t_opt), settings)
    it = batches(t_cfg, PipelineConfig(2, 16, seed=3))
    for i in range(3):
        batch = next(it)
        r_state, r_m = r_step(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
        t_state, t_m = t_step(t_state, _t_batch(batch))
        tag = "" if dtype == "float32" else f" {dtype}"
        _close_metrics(f"metrics{tag} step {i + 1}", t_m, r_m, tol["metric"])
        if i == 0:
            _close_leaves(f"gradients{tag} step 1", t_state["opt"]["g"], r_state["opt"]["g"],
                          rtol=tol["grad"], per_leaf_scale=True)
            grads1 = r_state["opt"]["g"]
        if i in (0, 2):
            _close_masters(f"masters{tag} step {i + 1}", t_state["params"], r_state["params"],
                           grads1, tol["determined"], tol["master"], tol["any"](i + 1))
    assert t_state["step"].dtype == torch.int32 and int(t_state["step"]) == 3
    assert int(t_state["opt"]["inner"]["t"]) == 3
    assert all(p.dtype == torch.float32 for p in t_opt.tree_leaves(t_state["params"]))
    if t_cfg.has_moe:
        assert float(t_m["lb_loss"]) > 0 and float(t_m["z_loss"]) > 0


def test_cross_entropy_and_loss_fn_match_reference():
    rng = np.random.default_rng(4)
    for shape, vocab in (((2, 7, 33), 30), ((2, 5, 3, 17), 17)):
        logits = rng.normal(size=shape).astype(np.float32) * 3
        labels = rng.integers(0, vocab, size=shape[:-1]).astype(np.int32)
        mask = (rng.random(shape[:2]) > 0.3).astype(np.float32)
        want = r_loop.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(mask), vocab)
        got = t_loop.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(mask), vocab)
        _close_metrics("cross_entropy", {"ce": got}, {"ce": want})
    zero = t_loop.cross_entropy(torch.zeros(1, 2, 4), torch.zeros(1, 2, dtype=torch.int32),
                                torch.zeros(1, 2), 4)
    assert float(zero) == 0.0  # an all-masked batch divides by max(0, 1)
    for arch in ("paligemma-3b", "musicgen-large", "olmoe-1b-7b"):
        r_cfg, t_cfg, r_state, t_state = _states(arch)
        batch = next(batches(t_cfg, PipelineConfig(2, 16, seed=6)))
        settings = t_loop.TrainSettings(lb_coef=0.5, z_coef=0.25)
        r_total, r_m = r_loop.loss_fn(r_state["params"], r_cfg,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      R_CTX, r_loop.TrainSettings(lb_coef=0.5, z_coef=0.25))
        with torch.no_grad():
            t_total, t_m = t_loop.loss_fn(t_state["params"], t_cfg, _t_batch(batch), CTX,
                                          settings)
        _close_metrics(f"loss_fn {arch}", dict(t_m, total=t_total), dict(r_m, total=r_total))


def _recorded_step(t_cfg, state, batch, accum, base="adamw", **settings):
    step = t_loop.make_train_step(t_cfg, CTX, _keeping_grads(t_opt, base),
                                  t_loop.TrainSettings(grad_accum=accum, max_grad_norm=None,
                                                       **settings))
    return step(state, batch)


@pytest.mark.parametrize("arch", PRESETS)
def test_grad_accum_two_matches_one(arch):
    """grad_accum=2 over a split batch == one step over the whole batch
    (the reference's ``tests/test_models_smoke.py`` contract, here with
    the gradients and metrics read off the step)."""
    _, t_cfg, _, state = _states(arch)
    full = next(batches(t_cfg, PipelineConfig(4, 16, seed=3)))
    split = next(batches(t_cfg, PipelineConfig(4, 16, seed=3, grad_accum=2)))
    assert all(np.array_equal(split[k].reshape(full[k].shape), full[k]) for k in full)
    state = dict(state, opt={"inner": (), "g": state["opt"]["g"]})
    s1, m1 = _recorded_step(t_cfg, state, _t_batch(full), 1, "sgd", lb_coef=0.0, z_coef=0.0)
    s2, m2 = _recorded_step(t_cfg, state, _t_batch(split), 2, "sgd", lb_coef=0.0, z_coef=0.0)
    ratio = abs(float(m1["ce"]) - float(m2["ce"])) / (ACCUM_RTOL * float(m1["ce"]))
    _record("grad_accum ce", ratio)
    assert ratio <= 1.0
    g1 = t_opt.tree_leaves(s1["opt"]["g"])
    _close_leaves("grad_accum gradients", s2["opt"]["g"],
                  [a.numpy() for a in g1], rtol=ACCUM_RTOL, per_leaf_scale=True)
    _close_leaves("grad_accum masters", s2["params"],
                  [a.numpy() for a in t_opt.tree_leaves(s1["params"])], atol=MASTER_ATOL)
    assert all(g.dtype == torch.float32 for g in t_opt.tree_leaves(s2["opt"]["g"]))


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-9b", "jamba-v0.1-52b",
                                  "musicgen-large"])
def test_remat_gives_the_same_gradients(arch, monkeypatch):
    """Each repeat recomputed in the backward pass against every
    activation kept: the same ops in the same order, so bitwise."""
    _, t_cfg, _, state = _states(arch)
    batch = _t_batch(next(batches(t_cfg, PipelineConfig(2, 16, seed=8))))
    calls = []
    remat = t_tf._remat

    def counted(fn, *args):
        calls.append(1)
        return remat(fn, *args)

    monkeypatch.setattr(t_tf, "_remat", counted)
    on, m_on = _recorded_step(t_cfg, state, batch, 1)
    assert len(calls) == t_cfg.num_repeats
    monkeypatch.setattr(t_tf, "_remat", lambda fn, *args: fn(*args))
    off, m_off = _recorded_step(t_cfg, state, batch, 1)
    for a, b in zip(t_opt.tree_leaves((on, m_on)), t_opt.tree_leaves((off, m_off))):
        assert torch.equal(a, b)


def test_remat_only_while_autograd_records(monkeypatch):
    """Serving (prefill, decode_step) and a forward without autograd never
    reach the remat wrapper."""
    _, t_cfg, _, state = _states("jamba-v0.1-52b")
    params = state["params"]

    def refuse(fn, *args):
        raise AssertionError("remat reached")

    monkeypatch.setattr(t_tf, "_remat", refuse)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 100, size=(2, 8)))
    t_tf.forward(params, t_cfg, {"tokens": tokens}, CTX)  # no leaf requires grad
    with torch.no_grad():
        t_tf.forward(t_opt.tree_map(lambda p: p.detach().requires_grad_(), params), t_cfg,
                     {"tokens": tokens}, CTX)
    _, cache = t_tf.prefill(params, t_cfg, {"tokens": tokens}, 12, CTX)
    t_tf.decode_step(params, t_cfg, cache, tokens[:, :1], 8, CTX)
    with pytest.raises(AssertionError, match="remat reached"):
        t_tf.forward(t_opt.tree_map(lambda p: p.detach().requires_grad_(), params), t_cfg,
                     {"tokens": tokens}, CTX)


def _patch_weights(monkeypatch, arch):
    tree = reference_weights(r_reduced_config(r_get_config(arch)))

    def r_weights(cfg, key, tp):
        assert (tp, cfg.name) == (1, f"{arch}-smoke")
        return jax.tree.map(jnp.asarray, tree)

    def t_weights(cfg, seed, device, tp):
        assert (seed, tp, cfg.name) == (0, 1, f"{arch}-smoke")
        return convert.lm_params(tree, cfg, device)

    monkeypatch.setattr(r_loop.transformer, "init_params", r_weights)
    monkeypatch.setattr(t_loop.transformer, "init_params", t_weights)


def _values(line: str) -> dict:
    return {k: float(v) for k, v in (f.split("=") for f in line.split()
                                      if "=" in f and not f.startswith("arch"))
            if not v.endswith("M")}


@pytest.mark.parametrize("arch, extra", [
    ("smollm-360m", []),
    ("granite-moe-1b-a400m", ["--optimizer", "momentum", "--grad-accum", "2", "--lr", "1e-2"]),
])
def test_launch_train_main_matches_reference(arch, extra, monkeypatch, capsys, tmp_path):
    """The same weights in both entry points: the same printed lines (the
    values within the stated tolerances) and checkpoints whose masters
    agree within ``MASTER_ATOL``."""
    _patch_weights(monkeypatch, arch)
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "4", "--seq", "32",
            "--log-every", "2"] + extra
    want = r_launch.main(argv + ["--ckpt", str(tmp_path / "r")])
    r_out = capsys.readouterr().out.splitlines()
    got = t_launch.main(argv + ["--ckpt", str(tmp_path / "t")], device="cpu")
    t_out = capsys.readouterr().out.splitlines()
    assert isinstance(got, float)
    ratio = abs(got - want) / (METRIC_TOL * (1.0 + abs(want)))
    _record("launch.train loss", ratio)
    assert ratio <= 1.0
    assert len(t_out) == len(r_out) == 4  # the header, steps 1 and 2, the checkpoint
    assert t_out[0] == r_out[0]
    assert t_out[-1] == r_out[-1].replace(str(tmp_path / "r"), str(tmp_path / "t"))
    for t_line, r_line in zip(t_out[1:-1], r_out[1:-1]):
        assert t_line.split()[:2] == r_line.split()[:2]
        t_v, r_v = _values(t_line), _values(r_line)
        assert set(t_v) == set(r_v) == {"loss", "ce", "gnorm"}
        for k in r_v:  # printed with 3-4 decimals
            assert abs(t_v[k] - r_v[k]) <= 1.5e-3, (k, t_line, r_line)
    saved_t = np.load(str(tmp_path / "t.npz"))
    saved_r = np.load(str(tmp_path / "r.npz"))
    assert len(saved_t.files) == len(saved_r.files)
    meta_t = t_ckpt.load_meta(str(tmp_path / "t"))
    n_params = sum(1 for k in meta_t["keys"] if k.startswith("['params']"))
    for i, key in enumerate(meta_t["keys"]):
        a, b = saved_t[f"arr_{i}"], saved_r[f"arr_{i}"]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key.startswith("['params']"):
            # adamw: the bound on any weight; momentum: the tight one
            atol = 0.5 * 3e-3 if "--optimizer" not in extra else MASTER_ATOL
            err = float(np.max(np.abs(a.astype(np.float64) - b)))
            _record(f"launch.train masters {arch}", err / atol)
            assert err <= atol, key
    assert n_params > 0


def test_training_resumes_bitwise(tmp_path):
    """step -> save -> restore -> step  ==  step -> step (the reference's
    ``tests/test_checkpoint.py`` contract)."""
    cfg = reduced_config(get_config("granite-moe-1b-a400m"))
    opt = t_opt.adamw(1e-3)
    state = t_loop.init_state(cfg, 1, opt, tp=1, device="cpu")
    step = t_loop.make_train_step(cfg, CTX, opt, t_loop.TrainSettings())
    batch = _t_batch(next(batches(cfg, PipelineConfig(2, 16, seed=0))))
    s1, _ = step(state, batch)
    path = os.path.join(tmp_path, "ck")
    t_ckpt.save(path, s1)
    s1r = t_ckpt.restore(path, t_opt.tree_map(torch.zeros_like, s1))
    s2a, m2a = step(s1, batch)
    s2b, m2b = step(s1r, batch)
    leaves_a, leaves_b = t_opt.tree_leaves((s2a, m2a)), t_opt.tree_leaves((s2b, m2b))
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_init_state_and_entry_points(monkeypatch):
    """Float32 masters and a zero int32 step; bfloat16 presets too; the
    entry point raises without a card unless asked for the CPU."""
    cfg = dataclasses.replace(reduced_config(get_config("smollm-360m")), dtype="bfloat16")
    state = t_loop.init_state(cfg, 0, t_opt.momentum(0.1), tp=1, device="cpu")
    assert all(p.dtype == torch.float32 for p in t_opt.tree_leaves(state["params"]))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert set(state["opt"]) == {"m"}
    # a bfloat16 step: gradients of the bfloat16 copy, float32 masters
    step = t_loop.make_train_step(cfg, CTX, t_opt.momentum(0.1), t_loop.TrainSettings())
    new, m = step(state, _t_batch(next(batches(cfg, PipelineConfig(2, 16)))))
    assert all(p.dtype == torch.float32 for p in t_opt.tree_leaves(new["params"]))
    assert all(bool(torch.isfinite(v)) for v in m.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_loop.init_state(cfg, 0, t_opt.sgd(0.1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One step at reduced_config (float32, TF32 off) on the card against
    the same step on the CPU, within the tolerances held against the
    reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, t_cfg, _, state = _states(arch)
    batch = _t_batch(next(batches(t_cfg, PipelineConfig(2, 16, seed=3))))
    step = t_loop.make_train_step(t_cfg, CTX, _keeping_grads(t_opt), t_loop.TrainSettings())
    want, m_want = step(state, batch)
    on_card = t_opt.tree_map(lambda t: t.to(cuda_device), state)
    got, m_got = step(on_card, {k: v.to(cuda_device) for k, v in batch.items()})
    got = t_opt.tree_map(lambda t: t.cpu(), got)
    _close_metrics("card metrics", {k: v.cpu() for k, v in m_got.items()}, m_want)
    _close_leaves("card gradients", got["opt"]["g"],
                  [a.numpy() for a in t_opt.tree_leaves(want["opt"]["g"])],
                  rtol=GRAD_RTOL, per_leaf_scale=True)
    _close_masters("card masters", got["params"],
                   [a.numpy() for a in t_opt.tree_leaves(want["params"])],
                   [a.numpy() for a in t_opt.tree_leaves(want["opt"]["g"])])


@pytest.mark.cuda
def test_launch_train_on_card_bfloat16(cuda_device):
    """The entry point on the card at reduced_config in bfloat16: finite,
    float32 masters, ce falls."""
    cfg = dataclasses.replace(reduced_config(get_config("smollm-360m")), dtype="bfloat16")
    r = t_launch.run(["--arch", "smollm-360m", "--steps", "20", "--batch", "4", "--seq", "64"],
                     cfg=cfg)
    ce = [float(m["ce"]) for m in r.metrics]
    assert all(np.isfinite(ce)) and np.mean(ce[-5:]) < ce[0]
    assert all(p.dtype == torch.float32 and p.is_cuda
               for p in t_opt.tree_leaves(r.state["params"]))


if __name__ == "__main__":
    # The worst reading of each check, as a fraction of its tolerance:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py
    import sys

    rc = pytest.main([__file__, "-q", "-p", "no:cacheprovider"])
    for name, ratio in sorted(sys.modules["test_torch_train"].WORST.items()):
        print(f"{name}: {ratio:.3g} of its tolerance")
    sys.exit(rc)
