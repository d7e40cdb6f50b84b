"""repro_torch.serve — the inference half of the linear system.

Port of ``repro.serve``: training produces a linear model ``w ∈ R^d``
(or ``R^{d×k}`` one-vs-rest), served here:

* :class:`~repro_torch.serve.engine.PredictionEngine` — holds a
  versioned, frozen :class:`~repro_torch.serve.engine.WeightSnapshot` on
  the card and computes request-batch margins through the margin kernel
  of the training hot path (the plain ``margins_rows`` on the CPU);
* :class:`~repro_torch.serve.batching.MicroBatcher` — maps sparse
  requests onto a bounded set of power-of-two shapes with a deadline
  flush;
* :func:`~repro_torch.serve.loop.run_serve_loop` — drives a request
  stream through both against a frozen model.
"""

from repro_torch.serve.batching import Batch, MicroBatcher, Request, bucket_width
from repro_torch.serve.engine import PredictionEngine, WeightSnapshot, batched_margins
from repro_torch.serve.loop import (
    ServedRequest,
    ServeReport,
    run_serve_loop,
    synthetic_request_source,
)

__all__ = [
    "Batch",
    "MicroBatcher",
    "PredictionEngine",
    "Request",
    "ServeReport",
    "ServedRequest",
    "WeightSnapshot",
    "batched_margins",
    "bucket_width",
    "run_serve_loop",
    "synthetic_request_source",
]
