"""Checkpointing (``repro.checkpoint``): atomic save / restore on the
reference's layout, and the elastic refit of per-worker state."""
