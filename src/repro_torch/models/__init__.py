"""The LM scaffolding's model code (dense global-attention stacks), ported from ``repro.models``."""
