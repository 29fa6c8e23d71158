"""Synthetic LM data (copy of ``repro.data``)."""
