"""Plain reference of FD-SVRG with the logistic loss and an L2 term.

Paper Algorithm 1 (Option I) as plain PyTorch over the global rows, the
feature blocks summed away: the blocked algorithm computes the same
iterates, since its margins are the sums of the blocks' partial margins
and its update is elementwise.  It imports nothing of the program and
takes nothing the program made: it is handed the generated rows, labels
and dimensions, and draws the sampled rows itself from the run's seed.

    snapshot at w:  s0_i = w.x_i;  z = (1/N) sum_i phi'(s0_i, y_i) x_i
    inner step m:   S = u rows drawn uniformly;  s_i = w.x_i  (i in S)
                    g = (1/u) sum_{i in S} (phi'(s_i, y_i) - phi'(s0_i, y_i)) x_i
                        + z + lam * w
                    w <- w - eta * g
    report:         objective  mean_i log(1 + exp(-y_i s0_i)) + lam/2 |w|^2
                    and |z + lam * w|, both at the post-epoch iterate

The sample ids follow the program's documented stream: one
``numpy.random.default_rng(seed)`` per run, an ``integers(0, N, (M, u))``
draw per outer.  ``dtype`` is float64 for the reference and the
precision below the configuration's float32, bfloat16, for the control.
Two variants plant the faults the correctness check must catch:
``half_batch`` takes the mean over the first half of each mini-batch
only, and ``blocks`` (the feature bounds of the ranks) leaves out the
exchange between them, each block stepping on its own partial margins.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ROW_CHUNK_ENTRIES = 1 << 24  # entries gathered at once in a snapshot


@dataclasses.dataclass
class Outputs:
    """What a run of the program or of this reference is judged by: the
    objective and gradient norm after every outer of the warm-up and of
    the window's first outers, and the norm of the iterate after the
    warm-up, which starts from zeros."""

    objectives: list[float]
    grad_norms: list[float]
    change_norm: float


def _dphi(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -y * torch.sigmoid(-y * s)


class Problem:
    def __init__(self, indices, values, labels, dim: int, *, lam: float, eta: float,
                 batch: int, inner_steps: int, dtype=torch.float64, half_batch=False,
                 blocks: tuple[int, ...] | None = None):
        self.idx = indices.to(torch.int64)
        self.val = values.to(dtype)
        self.y = labels.to(dtype)
        self.dim, self.lam, self.eta = dim, lam, eta
        self.u, self.m = batch, inner_steps
        self.dtype = dtype
        self.half_batch = half_batch
        self.n = int(self.idx.shape[0])
        if blocks is not None:
            bounds = torch.tensor(blocks[1:-1], device=self.idx.device, dtype=torch.int64)
            self.blk = torch.bucketize(self.idx, bounds, right=True)
            self.q = len(blocks) - 1
        else:
            self.blk, self.q = None, 1

    def _margins(self, w, rows):
        """[R] margins, or [R, q] partial margins without the exchange."""
        prod = w[self.idx[rows]] * self.val[rows]
        if self.blk is None:
            return prod.sum(dim=1)
        out = torch.zeros((prod.shape[0], self.q), dtype=prod.dtype, device=prod.device)
        return out.scatter_add_(1, self.blk[rows], prod)

    def _scatter(self, out, rows, coef, alpha=1.0):
        """out += alpha * sum_i coef_i x_i over ``rows`` (coef [R] or [R, q])."""
        if self.blk is None:
            contrib = self.val[rows] * coef[:, None]
        else:
            contrib = self.val[rows] * torch.gather(coef, 1, self.blk[rows])
        out.index_add_(0, self.idx[rows].reshape(-1), contrib.reshape(-1), alpha=alpha)

    def _y(self, rows, like):
        y = self.y[rows]
        return y if like.dim() == 1 else y[:, None]

    def snapshot(self, w):
        z = torch.zeros(self.dim, dtype=self.dtype, device=w.device)
        chunk = max(1, ROW_CHUNK_ENTRIES // self.idx.shape[1])
        parts = []
        for lo in range(0, self.n, chunk):
            rows = torch.arange(lo, min(self.n, lo + chunk), device=w.device)
            s0 = self._margins(w, rows)
            self._scatter(z, rows, _dphi(s0, self._y(rows, s0)) / self.n)
            parts.append(s0)
        return z, torch.cat(parts)

    def epoch(self, w, z, s0, samples: np.ndarray):
        ids_all = torch.from_numpy(samples).to(w.device)
        used = self.u // 2 if self.half_batch else self.u
        # w - eta * (z + lam * w) is a lerp of w toward -z / lam: one pass.
        target = -z / self.lam if self.lam else None
        w = w.clone()
        for m in range(self.m):
            rows = ids_all[m, :used]
            s = self._margins(w, rows)
            y = self._y(rows, s)
            coef = (_dphi(s, y) - _dphi(s0[rows], y)) / used
            if target is not None:
                w.lerp_(target, self.eta * self.lam)
            else:
                w.add_(z, alpha=-self.eta)
            self._scatter(w, rows, coef, alpha=-self.eta)
        return w

    def report(self, w, z, s0) -> tuple[float, float]:
        s = s0 if s0.dim() == 1 else s0.sum(dim=1)
        obj = torch.mean(torch.logaddexp(torch.zeros_like(s), -self.y * s)) \
            + 0.5 * self.lam * torch.sum(w * w)
        return float(obj), float(torch.linalg.vector_norm(z + self.lam * w))

    def run(self, w, seed: int, outers: int):
        """One solve: ``outers`` outer iterations from ``w`` with the
        sample stream of ``seed``; the iterate and one (objective, norm)
        pair an outer."""
        rng = np.random.default_rng(seed)
        z, s0 = self.snapshot(w)
        history = []
        for _ in range(outers):
            samples = rng.integers(0, self.n, size=(self.m, self.u), dtype=np.int64)
            w = self.epoch(w, z, s0, samples)
            z, s0 = self.snapshot(w)
            history.append(self.report(w, z, s0))
        return w, history


def replay(data, *, lam: float, eta: float, batch: int, inner_steps: int,
           warmup: tuple[int, int], window: tuple[int, int], dtype=torch.float64,
           half_batch: bool = False, blocks: tuple[int, ...] | None = None) -> Outputs:
    """The warm-up solve from zeros and then the window's solve from its
    iterate, each a ``(seed, outers)`` pair, as the cell drives them (the
    window's first outers only)."""
    prob = Problem(data.indices, data.values, data.labels, data.dim, lam=lam, eta=eta,
                   batch=batch, inner_steps=inner_steps, dtype=dtype, half_batch=half_batch,
                   blocks=blocks)
    w0 = torch.zeros(data.dim, dtype=dtype, device=data.indices.device)
    w_warm, hist_warm = prob.run(w0, *warmup)
    _, hist_win = prob.run(w_warm, *window)
    hist = hist_warm + hist_win
    change = float(torch.linalg.vector_norm(w_warm.to(torch.float64)))
    return Outputs(objectives=[h[0] for h in hist], grad_norms=[h[1] for h in hist],
                   change_norm=change)
