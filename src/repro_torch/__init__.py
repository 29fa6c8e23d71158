"""PyTorch / CUDA port of the signSGD-with-majority-vote system.

A second package beside the JAX reference ``repro``, with the same module
names, parameter names and stacked parameter layout, so each function has
a counterpart there that the parity tests (``tests/test_torch_*.py``) hold
it against. It imports neither ``jax`` nor ``repro``.

Entry points take a ``device`` and default to ``"cuda"``. Without a card
they raise unless the caller asks for ``device="cpu"``; they never fall
back to the CPU on their own. The hand-written CUDA kernels
(``kernels/csrc``) are built on their first launch, never at import.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise.

    ``"meta"``, when the caller names it, builds and runs a step on
    tensors with shapes and no data (``launch.dryrun``). Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default) and
    no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         "'meta'")
    return dev
