"""The training step: M stacked voters on one device."""
