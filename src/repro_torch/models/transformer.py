"""Decoder-only transformer stack, dense family (``repro.models.transformer``).

Layers stay stacked (leading ``L`` axis) as in the JAX package; the stack
is a Python loop over depth over views of each layer's weights in the
stacked tensors, so autograd assembles each stacked leaf's gradient from
its layers' gradients. ``remat="full"`` recomputes each block in the
backward pass instead of keeping its activations; ``"nested"`` is the
reference's sqrt-remat: groups of about sqrt(L) blocks are checkpointed
as one (the same as "full" below 4 layers). Neither changes a value.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

REMAT_MODES = ("none", "full", "nested")


def maybe_remat(fn: Callable, remat: str) -> Callable:
    """`fn` checkpointed as the reference's ``maybe_remat`` does it: for
    "full" and "nested" only its inputs are kept and it is recomputed in
    the backward pass. The non-reentrant checkpoint, since the train step
    differentiates with ``torch.autograd.grad``, which the reentrant one
    does not support. "dots" (keep the matrix products' outputs)
    raises."""
    if remat not in REMAT_MODES:
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet (ROADMAP.md Queue 4 item 4: "
            "trainer options of the launcher); the port runs "
            f"{REMAT_MODES}")
    if remat == "none":
        return fn

    def rematted(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return rematted


def _layer_tree(p: Dict[str, torch.Tensor], prefix: str = "layers."
                ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def decoder_block(lp: Dict[str, torch.Tensor], h: torch.Tensor, cfg, *,
                  positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block. Returns (h, aux_loss)."""
    if cfg.moe.enabled:
        raise NotImplementedError(
            "MoE blocks arrive with the rest of the model zoo (ROADMAP.md "
            "Queue 1 item 11)")
    attn_in = L.rms_norm(h, lp["norm1_scale"], cfg.norm_eps)
    attn_out, _ = L.self_attention_block(lp, "attn", attn_in, cfg,
                                         positions=positions)
    h = h + attn_out
    ffn_in = L.rms_norm(h, lp["norm2_scale"], cfg.norm_eps)
    h = h + L.swiglu_mlp(lp, "mlp", ffn_in)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def decoder_stack(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                  positions: Optional[torch.Tensor] = None,
                  remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop over the stacked layers, each block under `remat` (see
    :func:`maybe_remat`). Returns (h, total_aux_loss)."""
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window layers (gemma3) arrive with the rest of the "
            "model zoo (ROADMAP.md Queue 1 item 11)")
    # unbind, not v[i]: its backward stacks the L layer gradients in one
    # op, where indexing zero-fills a full (L, ...) gradient per layer
    lp = {k: v.unbind(0) for k, v in _layer_tree(p).items()}
    n_layers = cfg.num_layers
    # sqrt-remat (the reference's "nested" from 4 layers): a checkpoint
    # per group of k blocks, so the backward keeps L/k group inputs
    k = _best_group(n_layers) if remat == "nested" and n_layers >= 4 else 1

    def group(g: int, h: torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(g * k, (g + 1) * k):
            h, a = decoder_block({n: v[i] for n, v in lp.items()}, h, cfg,
                                 positions=positions)
            aux = aux + a
        return h, aux

    run = maybe_remat(group, remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(n_layers // k):
        h, a = run(g, h)
        aux = aux + a
    return h, aux


def _best_group(n_layers: int) -> int:
    """Divisor of L nearest sqrt(L): the sqrt-remat group size (the
    reference's ``_best_group``)."""
    best, target = 1, math.sqrt(n_layers)
    for k in range(1, n_layers + 1):
        if n_layers % k == 0 and abs(k - target) < abs(best - target):
            best = k
    return best
