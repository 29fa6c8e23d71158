"""Entry points of the port (``repro.launch``): the training launcher."""
