"""Sharding context of the port (single device; mesh rules wait for ROADMAP queue 10)."""
