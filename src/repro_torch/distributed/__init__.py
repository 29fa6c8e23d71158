"""Fault tolerance around the vote (``repro.distributed``)."""
