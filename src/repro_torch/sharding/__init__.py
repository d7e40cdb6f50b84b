"""Sharding context of the port (single device; the LM's mesh rules wait for ROADMAP queue 1)."""
