"""Serving loops of the LM scaffolding, ported from ``repro.train``."""
