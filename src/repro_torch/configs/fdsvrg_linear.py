"""The paper's own model configs: regularized logistic regression on the
four Table-1 data sets, solved with FD-SVRG (eq. 5).

The objective (paper §2, eq. 3) covers the L1 family too — the classic
sparse-text workload and the regime of Mahajan et al.'s distributed block
coordinate descent for l1-regularized linear classifiers — so alongside
the L2 presets there are L1 / elastic-net variants solved with
FD-Prox-SVRG (same communication, block-local prox).

Port of ``repro.configs.fdsvrg_linear``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import losses


@dataclasses.dataclass(frozen=True)
class LinearConfig:
    name: str
    dataset: str  # repro_torch.data.datasets key
    loss: str = "logistic"
    reg: str = "l2"  # "l2" | "l1" | "elastic_net" | "none"
    lam: float = 1e-4  # paper §5.3 default (L1 strength for l1/elastic_net)
    lam2: float = 0.0  # elastic-net L2 strength
    eta: float = 0.25
    batch_size: int = 1  # paper default; §4.4.1 mini-batch is a flag
    workers: int = 16  # paper: 8 for news20, 16 otherwise
    outer_iters: int = 10

    def regularizer(self) -> losses.Regularizer:
        return losses.Regularizer(self.reg, self.lam, self.lam2)

    def to_spec(self, method: str = "fdsvrg", **overrides):
        """This config as an :class:`repro_torch.api.ExperimentSpec` for any
        registered method — the bridge from the paper's presets to the
        one front door (``solve(cfg.to_spec(method="dsvrg"))``).

        Keyword ``overrides`` replace any spec field (e.g.
        ``outer_iters=2, inner_steps=300, device="cpu"``); the config's
        own eta/batch/workers are the paper's operating point, not the
        registry's scaled-trajectory ``"paper"`` defaults.
        """
        from repro_torch.api.spec import ExperimentSpec  # deferred: configs load early

        kw = dict(
            method=method,
            dataset=self.dataset,
            loss=self.loss,
            reg=self.regularizer(),
            q=self.workers,
            eta=self.eta,
            batch_size=self.batch_size,
            outer_iters=self.outer_iters,
        )
        kw.update(overrides)
        return ExperimentSpec(**kw)


def get_config(name: str) -> LinearConfig:
    """CONFIGS lookup with the registry's one-line error convention —
    a misspelled preset fails with the valid names, not a raw KeyError."""
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(
            f"unknown config {name!r}; available configs: "
            f"{', '.join(sorted(CONFIGS))}"
        ) from None


CONFIGS = {
    "fdsvrg-news20": LinearConfig("fdsvrg-news20", "news20", workers=8),
    "fdsvrg-url": LinearConfig("fdsvrg-url", "url"),
    "fdsvrg-webspam": LinearConfig("fdsvrg-webspam", "webspam"),
    "fdsvrg-kdd2010": LinearConfig("fdsvrg-kdd2010", "kdd2010"),
    # Avazu CTR (d ≈ 10^6 one-hot features, tiny per-row nnz): the
    # ad-click workload of the mxnet feature-distributed exemplar, and
    # the first preset sized for the streaming ingestion path.
    "fdsvrg-avazu": LinearConfig("fdsvrg-avazu", "avazu"),
    # Proximal variants (FD-Prox-SVRG): sparse-text L1 on the two d >> N
    # sets, plus an elastic-net middle ground on webspam.
    "fdsvrg-news20-l1": LinearConfig(
        "fdsvrg-news20-l1", "news20", reg="l1", lam=1e-5, workers=8
    ),
    "fdsvrg-webspam-l1": LinearConfig(
        "fdsvrg-webspam-l1", "webspam", reg="l1", lam=1e-5
    ),
    "fdsvrg-webspam-elastic": LinearConfig(
        "fdsvrg-webspam-elastic", "webspam", reg="elastic_net",
        lam=1e-5, lam2=1e-4,
    ),
}
