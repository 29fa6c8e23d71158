"""Optimizer facade (``repro.optim``): the paper's sign-vote family plus
the dense baselines.

Implementations live in ``repro_torch.core.signum``; this package
re-exports the stable public API.
"""
from repro_torch.core.signum import (Optimizer, build_optimizer, lr_at,
                                     make_dense_optimizer,
                                     make_sign_optimizer)

__all__ = ["Optimizer", "build_optimizer", "lr_at", "make_dense_optimizer",
           "make_sign_optimizer"]
