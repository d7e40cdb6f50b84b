"""Spans: named ranges of the FD-SVRG path on the profiler's clock.

A span is a ``torch.profiler`` range, so it lands in the same kineto trace
as the kernels and the host's runtime calls, nested under the span around
it on the same thread.  Spans exist only while a profiler records: the
profiler keeps them and ``export_chrome_trace`` writes them out, and with
no profiler recording no range is made at all.  A span is the profiler's
C++ range guard (``_RecordFunctionFast``, about 0.9 us under a CPU
profile) rather than ``record_function`` (about 8 us): a span a step must
not slow the host that launches the step's kernels.

Run a solve under ``torch.profiler.profile(activities=[CPU, CUDA])`` to
see them:

==================  =======================================================
``rt/solve``        ``api.registry.solve``, around the driver call
``rt/outer``        one outer iteration of ``core.driver.run_outer_loop``
``rt/epoch``        its inner epoch (the rule's draw, the steps, the flush)
``rt/snapshot``     a full gradient: the outer-0 one, then one an outer
``rt/evaluate``     the objective and residual, where the host waits
``rt/draw``         the sample draw and the ids' copy to the device
``rt/step``         one inner step
``rt/flush``        the exact-lazy epoch-end flush
``rt/block_of``     a sharded rank's one-block layout
``rt/all_reduce``   a sharded rank's all-reduce (``ShardMapBackend``)
``rt/all_gather``   a sharded rank's all-gather (``ShardMapBackend``)
==================  =======================================================

A loop reads :func:`recording` once and passes it to every span it opens.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

#: Whether a profiler records (about 0.1 us a call).
recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str, on: bool | None = None):
    """A context manager that records ``name`` as a profiler range while a
    profiler records, and does nothing otherwise.  ``on`` is
    :func:`recording` as the caller last read it (read here if omitted)."""
    if on is None:
        on = recording()
    return _RecordFunctionFast(name) if on else _OFF
