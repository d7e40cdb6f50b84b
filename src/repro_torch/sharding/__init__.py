"""Sharding context of the port (single device; the LM's mesh rules wait for ROADMAP queue 1 item 11 step 9)."""
