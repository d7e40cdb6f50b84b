"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060].

Port of ``repro.models.ssm``.  Train path: the chunked SSD algorithm — an
intra-chunk "attention-like" quadratic term plus an inter-chunk
recurrence over compressed states.  The reference writes the intra- and
inter-chunk terms as 3- and 4-operand einsums; here each is a chain of
pairwise contractions whose intermediates have known sizes (the largest
is the ``[B, H, C, L, L]`` decay matrix, built once), and the recurrence
over the chunks is a Python loop.

Decode path: the equivalent linear recurrence,
    h' = exp(dt·A) h + dt · B ⊗ x,   y = C·h' + D_skip·x,
carrying (conv_state, ssm_state) per layer; :func:`ssm_decode` writes
both into the cache IN PLACE (the reference returns a new cache).

The float32 parameters ``a_log``, ``dt_bias``, ``d_skip`` (and the norm
scale) stay float32 whatever the model's dtype, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_rms_scale, normal, rms_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64  # SSD "P"
    conv_width: int = 4
    chunk: int = 256
    norm_eps: float = 1e-6
    # The reference's operand-dtype lever for the SSD contractions:
    # "bfloat16" rounds the operands to bfloat16 and accumulates in float32
    # (its preferred_element_type), "float32" is the faithful default.
    compute_dtype: str = "float32"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def init_ssm(gen: torch.Generator, cfg: SSMConfig, dtype) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.num_heads
    # in_proj emits [z (gate, di), x (di), B (n), C (n), dt (h)]
    proj_out = 2 * di + 2 * n + h
    conv_dim = di + 2 * n  # x, B, C go through the depthwise conv
    dev = gen.device
    return {
        "in_proj": normal(gen, (d, proj_out), d ** -0.5, dtype),
        "conv_w": normal(gen, (cfg.conv_width, conv_dim), 0.3, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "out_norm": init_rms_scale(di, dev),
        "out_proj": normal(gen, (di, d), di ** -0.5, dtype),
    }


def _split_proj(proj: torch.Tensor, cfg: SSMConfig):
    di, n = cfg.d_inner, cfg.d_state
    z = proj[..., :di]
    xbc = proj[..., di : di + di + 2 * n]
    dt = proj[..., di + di + 2 * n :]
    return z, xbc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., L] -> [..., L, L] lower-triangular pairwise segment sums,
    -inf above the diagonal (so exp gives 0 there)."""
    l = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    seg = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def _mul_unless_recorded(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``t * s``: in place when autograd does not record ``t`` (serving),
    out of place when it does (``exp`` saved ``t`` for its backward in
    float32, where ``op`` returns its argument).  The same numbers either way."""
    return t * s if t.requires_grad else t.mul_(s)


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (post-softplus)
    a: torch.Tensor,  # [H] (negative)
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    chunk: int,
    ctx=None,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Chunked SSD scan; returns float32 y [B, S, H, P].

    Sequences that don't divide the chunk size are zero-padded at the end
    (dt = 0 => decay 1, zero input: padding is inert) and sliced back."""
    b, s0, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-s0) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    s = s0 + pad
    c = s // chunk
    cdt = _DTYPES[compute_dtype]

    def op(t: torch.Tensor) -> torch.Tensor:
        """An operand of the reference's contractions: rounded to the
        compute dtype, then used in float32."""
        return t.to(cdt).float()

    la = dt * a[None, None, :]  # discretized decay per step (log space), [B, S, H]
    xd = x * dt[..., None]  # input discretization

    la_c = la.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # [B, H, C, L]
    x_c = op(xd.reshape(b, c, chunk, h, p))  # [B, C, L, H, P]
    b_c = op(bmat.reshape(b, c, chunk, n))  # [B, C, L, N]
    c_c = op(cmat.reshape(b, c, chunk, n))
    la_cum = torch.cumsum(la_c, dim=-1)  # [B, H, C, L]

    # 1) intra-chunk: y_diag[b,c,l,h,p] = sum_s (C_l . B_s) exp(segsum)[h,l,s] x[s,h,p]
    lmat = op(torch.exp(_segsum(la_c)))  # [B, H, C, L, L]
    cb = torch.einsum("bcln,bcsn->bcls", c_c, b_c)  # [B, C, L, L]
    lmat = _mul_unless_recorded(lmat, cb[:, None])
    y_diag = torch.einsum("bhcls,bcshp->bclhp", lmat, x_c)
    del lmat, cb

    # 2) per-chunk compressed states: sum_l B_l (x) (decay_l x_l)
    decay_states = op(torch.exp(la_cum[..., -1:] - la_cum))  # [B, H, C, L]
    xs_decayed = x_c * decay_states.permute(0, 2, 3, 1)[..., None]  # [B, C, L, H, P]
    states = torch.einsum("bcln,bclhp->bchpn", b_c, xs_decayed)  # [B, C, H, P, N]
    del xs_decayed

    # 3) inter-chunk recurrence over compressed states (sequential in C only)
    chunk_decay = torch.exp(la_cum[..., -1])  # [B, H, C]
    h_cur = torch.zeros_like(states[:, 0])  # [B, H, P, N] float32
    entering = []  # the state entering each chunk
    for i in range(c):
        entering.append(h_cur)
        h_cur = h_cur * chunk_decay[:, :, i, None, None] + states[:, i]
    h_prevs = torch.stack(entering, dim=1)  # [B, C, H, P, N]
    del entering

    # 4) inter-chunk output: y_off[b,c,l,h,p] = (C_l . h_prev[h,p,:]) exp(la_cum[h,l])
    state_decay_out = op(torch.exp(la_cum))  # [B, H, C, L]
    y_off = torch.einsum("bcln,bchpn->bclhp", c_c, op(h_prevs))
    y_off = _mul_unless_recorded(y_off, state_decay_out.permute(0, 2, 3, 1)[..., None])

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :s0] if pad else y


def _causal_conv(xbc: torch.Tensor, params: dict, width: int) -> torch.Tensor:
    """Depthwise causal conv over (x, B, C) plus bias, then SiLU: [B, S, C]."""
    s = xbc.shape[1]
    w = params["conv_w"]  # [W, conv_dim]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    conv = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        conv = conv + pad[:, i : i + s, :] * w[i][None, None, :]
    return F.silu(conv + params["conv_b"][None, None, :])


def ssm_train(params: dict, x: torch.Tensor, cfg: SSMConfig, ctx) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    di, n, h, p = cfg.d_inner, cfg.d_state, cfg.num_heads, cfg.head_dim

    proj = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xbc, dt_raw = _split_proj(proj, cfg)
    conv = _causal_conv(xbc, params, cfg.conv_width)

    xs = ctx.constrain(conv[..., :di].reshape(b, s, h, p), "batch", None, "ssm_heads", None)
    bmat = conv[..., di : di + n]
    cmat = conv[..., di + n :]

    dt = _softplus(dt_raw.float() + params["dt_bias"])  # [B, S, H]
    a = -torch.exp(params["a_log"])  # [H]

    y = ssd_chunked(xs.float(), dt, a, bmat.float(), cmat.float(), cfg.chunk, ctx,
                    compute_dtype=cfg.compute_dtype)
    y = y + xs.float() * params["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)

    y = y * F.silu(z)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"])
    return ctx.constrain(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Decode (recurrent form)
# ---------------------------------------------------------------------------


def init_ssm_cache(
    batch: int, cfg: SSMConfig, dtype, ctx, device: torch.device | str = "cpu"
) -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    conv = torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype, device=device)
    state = torch.zeros((batch, cfg.num_heads, cfg.head_dim, cfg.d_state),
                        dtype=torch.float32, device=device)
    return {
        "conv": ctx.constrain(conv, "batch", None, None),
        "state": ctx.constrain(state, "batch", "ssm_heads", None, None),
    }


def ssm_decode(
    params: dict,
    x: torch.Tensor,  # [B, 1, D]
    cache: dict,  # {"conv": [B, W-1, C], "state": [B, H, P, N] f32}, written in place
    cfg: SSMConfig,
    ctx,
) -> tuple[torch.Tensor, dict]:
    b, one, d = x.shape
    di, n, h, p = cfg.d_inner, cfg.d_state, cfg.num_heads, cfg.head_dim

    proj = torch.einsum("bsd,de->bse", x, params["in_proj"])[:, 0]  # [B, E]
    z, xbc, dt_raw = _split_proj(proj, cfg)

    # conv state update: window = [cache, current]
    win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # [B, W, C]
    conv = torch.einsum("bwc,wc->bc", win, params["conv_w"]) + params["conv_b"]
    conv = F.silu(conv)

    xs = conv[:, :di].reshape(b, h, p)
    bvec = conv[:, di : di + n].float()  # [B, N]
    cvec = conv[:, di + n :].float()

    dt = _softplus(dt_raw.float() + params["dt_bias"])  # [B, H]
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a[None, :])  # [B, H]

    xd = xs.float() * dt[..., None]  # [B, H, P]
    state = cache["state"] * decay[..., None, None] + torch.einsum("bhp,bn->bhpn", xd, bvec)
    y = torch.einsum("bhpn,bn->bhp", state, cvec)
    y = y + xs.float() * params["d_skip"][None, :, None]
    y = y.reshape(b, 1, di)

    y = y.to(x.dtype) * F.silu(z)[:, None, :]
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    out = ctx.constrain(torch.einsum("bse,ed->bsd", y, params["out_proj"]), "batch", None, "embed")
    cache["conv"].copy_(win[:, 1:, :])
    cache["state"].copy_(state)
    return out, cache
