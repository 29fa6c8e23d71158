"""Dense decoder-only model: layers, stack, init and loss."""
