"""Sparse data layouts, the synthetic generator, and the Table-1 presets."""
