"""Checkpoint save / restore of a run's state (port of ``repro.checkpoint``)."""
