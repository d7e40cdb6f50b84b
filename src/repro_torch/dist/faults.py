"""Fault types the outer-loop harness recovers from.

Only :class:`FaultError` is ported with the main path: the harness
(:func:`repro_torch.core.driver.run_outer_loop`) catches it to abort an
epoch back to its snapshot.  Seeded fault injection (``FaultPlan``,
``RetryPolicy``, ``FaultyBackend``) comes with the serving/faults slice.
"""

from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for run faults (see also
    :class:`repro_torch.core.driver.DivergenceError`, which subclasses it
    so the harness's recovery path catches both with one handler)."""
