"""`FDSVRGClassifier` — a scikit-learn-style fit/predict estimator over
the solver registry.

Port of ``repro.api.estimator``.  Fit on a
:class:`~repro_torch.data.sparse.PaddedCSR`, a dense ``(X, y)`` pair
(converted to a float32 PaddedCSR), or a
:class:`~repro_torch.data.pipeline.DataSource` / LibSVM file path (labels
come from the source; the global matrix is never materialized), then
``decision_function`` / ``predict`` / ``score`` like any sklearn linear
classifier.  Any registered method is a constructor argument away, run
through the same :func:`repro_torch.api.solve` front door.

As in the rest of the port, ``use_kernels`` defaults to ``True`` and
``device=None`` means ``cuda`` (raising without a card): training and
scoring run the CUDA kernels there, float32 only.

``partial_fit`` warm-starts from the current coefficients via the
harness's snapshot rotation; each call advances the seed so the sample
stream does not replay.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.api.registry import solve
from repro_torch.api.spec import PAPER, ExperimentSpec
from repro_torch.core import losses as losses_lib
from repro_torch.core.driver import OuterRecord
from repro_torch.data.pipeline import (
    as_source,
    is_source,
    source_labels,
    streamed_margins,
)
from repro_torch.data.sparse import PaddedCSR
from repro_torch.serve.engine import batched_margins


def _coerce_input(X):
    """A path becomes a streaming LibSVM source; everything else passes."""
    if isinstance(X, (str, os.PathLike)):
        return as_source(X)
    return X


def _host(x) -> np.ndarray:
    """A NumPy view of labels or coefficients wherever they live."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def as_padded_csr(X, y=None) -> PaddedCSR:
    """Coerce estimator input to a PaddedCSR.

    * ``X`` already a PaddedCSR: returned as-is (``y``, if given, must
      match its stored labels' length).
    * ``X`` a dense ``[n, d]`` array with labels ``y``: converted to a
      float32 padded sparse layout (CPU tensors) with the per-row maximum
      nnz as the budget — the dtype the kernel route takes, and what the
      reference's conversion gives without JAX's 64-bit mode.
    """
    if isinstance(X, PaddedCSR):
        if y is not None and len(y) != X.num_instances:
            raise ValueError(
                f"y has {len(y)} labels but the PaddedCSR holds "
                f"{X.num_instances} instances"
            )
        return X
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"X must be [n_samples, n_features], got {X.shape}")
    if y is None:
        raise ValueError("dense X requires y")
    n, d = X.shape
    if len(np.asarray(y)) != n:
        raise ValueError(
            f"y has {len(np.asarray(y))} labels but X holds {n} instances"
        )
    nnz_rows = np.count_nonzero(X, axis=1)
    budget = max(1, int(nnz_rows.max())) if n else 1
    indices = np.zeros((n, budget), dtype=np.int32)
    values = np.zeros((n, budget), dtype=np.float32)
    # One vectorized pack: np.nonzero is row-major, so positions within
    # each row are the running index minus the row's starting offset.
    rows, cols = np.nonzero(X)
    pos = np.arange(rows.size) - np.repeat(
        np.cumsum(nnz_rows) - nnz_rows, nnz_rows
    )
    indices[rows, pos] = cols
    values[rows, pos] = X[rows, cols]
    return PaddedCSR(
        indices=torch.from_numpy(indices),
        values=torch.from_numpy(values),
        labels=torch.from_numpy(np.asarray(y, dtype=np.float32)),
        dim=d,
    )


class FDSVRGClassifier:
    """Linear classifier trained by any registered solver.

    Parameters mirror :class:`~repro_torch.api.spec.ExperimentSpec`; the
    defaults are the registry's per-method ``"paper"`` operating point.
    Labels may be any values: two classes are mapped onto {-1, +1}
    (sorted order); three or more train one-vs-rest as a single
    multi-output run ``w ∈ R^{d×k}`` (``coef_`` becomes sklearn's
    ``[k, d]`` and :meth:`predict` takes the argmax margin), which needs a
    method with multi-output support (``serial``/``fdsvrg``).  ``coef_``
    is a NumPy array.
    """

    def __init__(
        self,
        *,
        method: str = "fdsvrg",
        workers: int | None = None,
        eta: float | str = PAPER,
        reg: str = "l2",
        lam: float = 1e-4,
        lam2: float = 0.0,
        loss: str = "logistic",
        batch_size: int | str = PAPER,
        inner_steps: int | str = PAPER,
        outer_iters: int = 10,
        option: str = "I",
        seed: int = 0,
        use_kernels: bool = True,
        lazy_updates: str | None = None,
        cluster=None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        resume: bool = False,
        data_cache_dir: str | None = None,
        ingest_chunk_rows: int = 65536,
        device: torch.device | str | None = None,
    ) -> None:
        self.method = method
        self.workers = workers
        self.eta = eta
        self.reg = reg
        self.lam = lam
        self.lam2 = lam2
        self.loss = loss
        self.batch_size = batch_size
        self.inner_steps = inner_steps
        self.outer_iters = outer_iters
        self.option = option
        self.seed = seed
        self.use_kernels = use_kernels
        self.lazy_updates = lazy_updates
        self.cluster = cluster
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        self.data_cache_dir = data_cache_dir
        self.ingest_chunk_rows = ingest_chunk_rows
        self.device = device
        self._fits = 0

    # -- sklearn-style attributes set by fit: coef_, classes_, history_ --

    @property
    def is_fitted(self) -> bool:
        return getattr(self, "coef_", None) is not None

    def _spec(self, data, outer_iters: int, init_w) -> ExperimentSpec:
        if is_source(data):
            data_kw = dict(
                source=data,
                data_cache_dir=self.data_cache_dir,
                ingest_chunk_rows=self.ingest_chunk_rows,
            )
        else:
            data_kw = dict(data=data)
        return ExperimentSpec(
            method=self.method,
            **data_kw,
            loss=self.loss,
            reg=losses_lib.Regularizer(self.reg, self.lam, self.lam2),
            q=self.workers,
            eta=self.eta,
            batch_size=self.batch_size,
            inner_steps=self.inner_steps,
            outer_iters=outer_iters,
            option=self.option,
            # advance the stream per call so partial_fit never replays
            # the previous call's samples
            seed=self.seed + self._fits,
            use_kernels=self.use_kernels,
            lazy_updates=self.lazy_updates,
            cluster=self.cluster,
            init_w=init_w,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_every=self.checkpoint_every,
            # only the first solve of this estimator resumes; warm-start
            # continuations already carry their state in init_w
            resume=self.resume and self._fits == 0,
            device=self.device,
        )

    def _encode_labels(self, raw) -> np.ndarray:
        """Map arbitrary labels (any dtype, including strings) onto what
        the losses expect, recording ``classes_``: two classes become the
        1-D {-1,+1} coding; three or more a one-vs-rest ``[N, k]`` sign
        matrix (column j is +1 where the label is ``classes_[j]``),
        trained as one multi-output run ``w ∈ R^{d×k}``."""
        raw = _host(raw)
        classes = np.unique(raw)
        if classes.size < 2:
            raise ValueError(
                f"classification requires at least 2 classes, got "
                f"{classes.size}"
            )
        if self.is_fitted and not np.array_equal(classes, self.classes_):
            raise ValueError(
                f"classes {classes} differ from the fitted {self.classes_}"
            )
        self.classes_ = classes
        if classes.size == 2:
            return np.where(raw == classes[1], 1.0, -1.0).astype(np.float32)
        return np.where(
            raw[:, None] == classes[None, :], 1.0, -1.0
        ).astype(np.float32)

    def _encoded_data(self, X, y) -> PaddedCSR:
        """The training PaddedCSR with ±1 labels, memoized per input
        object: repeated partial_fit on the same (X, y) reuses ONE data
        object, which keeps the identity-keyed BlockCSR cache hitting
        across warm-start calls.  A PaddedCSR whose labels already are the
        ±1 coding is used as it is."""
        cached = getattr(self, "_encoded", None)
        if cached is not None and cached[0] is X and cached[1] is y:
            return cached[2]
        if is_source(X):
            # Streamed sources carry their own canonical {-1, +1} labels.
            if y is not None:
                raise ValueError(
                    "a DataSource carries its own labels; pass y=None"
                )
            classes = np.array([-1.0, 1.0], dtype=np.float32)
            if self.is_fitted and not np.array_equal(classes, self.classes_):
                raise ValueError(
                    f"classes {classes} differ from the fitted {self.classes_}"
                )
            self.classes_ = classes
            self._encoded = (X, y, X)
            return X
        if isinstance(X, PaddedCSR):
            as_padded_csr(X, y)  # one home for the y-length validation
            signed = self._encode_labels(X.labels if y is None else y)
            if np.array_equal(signed, _host(X.labels)):
                data = X
            else:
                # labels follow the data's values dtype and device: a
                # re-encoded float64 run must not go mixed-precision
                data = PaddedCSR(
                    indices=X.indices, values=X.values,
                    labels=torch.as_tensor(
                        signed, dtype=X.values.dtype, device=X.values.device
                    ),
                    dim=X.dim,
                )
        else:
            if y is None:
                raise ValueError("dense X requires y")
            data = as_padded_csr(X, self._encode_labels(y))
        # Strong refs to the inputs: identity keys stay valid.
        self._encoded = (X, y, data)
        return data

    def fit(self, X, y=None) -> "FDSVRGClassifier":
        """Train from scratch for ``outer_iters`` outer iterations."""
        self.coef_ = None
        self.history_: list[OuterRecord] = []
        self._fits = 0
        self._encoded = None
        return self.partial_fit(X, y, outer_iters=self.outer_iters)

    def partial_fit(self, X, y=None, *, outer_iters: int = 1) -> "FDSVRGClassifier":
        """Continue training from the current coefficients (warm start via
        the harness's snapshot rotation); trains from zeros if unfitted."""
        data = self._encoded_data(_coerce_input(X), y)
        if not hasattr(self, "history_"):
            self.history_ = []
        if self.is_fitted:
            # Multiclass stores sklearn's [k, d]; the drivers run [d, k].
            init_w = self.coef_.T if self.coef_.ndim == 2 else self.coef_
        else:
            init_w = None
        result = solve(self._spec(data, outer_iters, init_w))
        self._fits += 1
        w = _host(result.w)
        self.coef_ = w.T if w.ndim == 2 else w
        self.n_features_in_ = (
            data.stats().dim if is_source(data) else data.dim
        )
        # Each solve() starts a fresh meter/clock, so rebase ALL the
        # cumulative fields onto the previous history's totals: history_
        # then reads as one continuous run.
        if self.history_:
            last = self.history_[-1]
            base, scal0, rnd0, mod0, wall0 = (
                last.outer + 1, last.comm_scalars, last.comm_rounds,
                last.modeled_time_s, last.wall_time_s,
            )
        else:
            base, scal0, rnd0, mod0, wall0 = 0, 0, 0, 0.0, 0.0
        self.history_.extend(
            OuterRecord(base + h.outer, h.objective, h.grad_norm,
                        scal0 + h.comm_scalars, rnd0 + h.comm_rounds,
                        mod0 + h.modeled_time_s, wall0 + h.wall_time_s)
            for h in result.history
        )
        self.result_ = result
        return self

    def free_training_cache(self) -> "FDSVRGClassifier":
        """Release the memoized training data and the inference-input
        memo (serving: a fitted estimator keeps only
        ``coef_``/``classes_``/``history_``)."""
        self._encoded = None
        self._infer_encoded = None
        self.result_ = None
        return self

    def _check_fitted(self) -> None:
        if not self.is_fitted:
            raise ValueError("this FDSVRGClassifier is not fitted yet")

    def decision_function(self, X) -> np.ndarray:
        """Margins ``w^T x_i`` (``[n, k]`` for one-vs-rest models);
        positive means ``classes_[1]``.

        In-memory input runs :func:`repro_torch.serve.engine.batched_margins`
        on the estimator's device — the margin kernel on the card with
        ``use_kernels``, bit for bit what a
        :class:`~repro_torch.serve.engine.PredictionEngine` holding
        ``coef_`` serves for the same rows.  Streamed input is scored one
        chunk at a time through
        :func:`repro_torch.data.pipeline.streamed_margins`.  Dense ``X``
        converts to the padded layout once per input object.
        """
        self._check_fitted()
        X = self._inference_data(_coerce_input(X))
        # The engine's [d(, k)] orientation; sklearn's coef_ is [k, d].
        w = self.coef_.T if self.coef_.ndim == 2 else self.coef_
        if is_source(X):
            return streamed_margins(
                X, w, chunk_rows=self.ingest_chunk_rows,
                use_kernels=self.use_kernels, device=self.device,
            )
        return batched_margins(
            X.indices.cpu(), X.values.cpu(), w,
            use_kernels=self.use_kernels, device=self.device,
        )

    def _inference_data(self, X):
        """Sources and PaddedCSRs pass through; a dense matrix converts
        to PaddedCSR ONCE per input object."""
        if is_source(X) or isinstance(X, PaddedCSR):
            return X
        cached = getattr(self, "_infer_encoded", None)
        if cached is not None and cached[0] is X:
            return cached[1]
        arr = np.asarray(X)
        if arr.ndim != 2:
            raise ValueError(
                f"X must be [n_samples, n_features], got {arr.shape}"
            )
        data = as_padded_csr(arr, np.zeros(arr.shape[0], dtype=np.float32))
        self._infer_encoded = (X, data)
        return data

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        df = self.decision_function(X)
        if df.ndim == 2:
            return self.classes_[np.argmax(df, axis=1)]
        return self.classes_[(df > 0).astype(int)]

    def score(self, X, y=None) -> float:
        """Mean accuracy on ``(X, y)``.  ``y=None`` uses a PaddedCSR's (or
        a streamed source's) own stored labels; if the model was fitted on
        classes other than the stored ±1 coding, the ±1 labels are decoded
        through ``classes_`` (+1 is ``classes_[1]``)."""
        X = _coerce_input(X)
        if y is None:
            if is_source(X):
                y = source_labels(X, chunk_rows=self.ingest_chunk_rows)
            elif isinstance(X, PaddedCSR):
                y = _host(X.labels)
            else:
                raise ValueError(
                    "score() needs y unless X is a PaddedCSR or a source"
                )
            if self.is_fitted and not np.isin(y, self.classes_).all():
                if set(np.unique(y)) <= {-1.0, 1.0}:
                    y = self.classes_[(y > 0).astype(int)]
                else:
                    raise ValueError(
                        f"the PaddedCSR's labels are neither the fitted "
                        f"classes {self.classes_} nor ±1-coded; pass y "
                        "explicitly"
                    )
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def final_objective(self) -> float:
        self._check_fitted()
        return self.history_[-1].objective
