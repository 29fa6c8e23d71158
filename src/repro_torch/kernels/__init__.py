"""Hand-written CUDA kernels for the SIGNUM hot loops (``csrc/``), their
plain PyTorch versions (``ref``) and the dispatching wrappers (``ops``).

Nothing here builds or loads a kernel at import: ``build`` runs ``nvcc``
at the first launch on a CUDA tensor."""
