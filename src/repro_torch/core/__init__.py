"""Sign compression and the SIGNUM optimizer (Algorithm 1, Mode A)."""
