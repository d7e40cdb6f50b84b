"""Command-line entry points of the LM scaffolding, ported from ``repro.launch``."""
