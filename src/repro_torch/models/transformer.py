"""Decoder-only transformer stack, dense family (``repro.models.transformer``).

Layers stay stacked (leading ``L`` axis) as in the JAX package; the stack
is a Python loop over depth over views of each layer's weights in the
stacked tensors, so autograd assembles each stacked leaf's gradient from
its layers' gradients.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L


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
                  positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop over the stacked layers. Returns (h, total_aux_loss)."""
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window layers (gemma3) arrive with the rest of the "
            "model zoo (ROADMAP.md Queue 1 item 11)")
    # unbind, not v[i]: its backward stacks the L layer gradients in one
    # op, where indexing zero-fills a full (L, ...) gradient per layer
    lp = {k: v.unbind(0) for k, v in _layer_tree(p).items()}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_layers):
        h, a = decoder_block({k: v[i] for k, v in lp.items()}, h, cfg,
                             positions=positions)
        aux = aux + a
    return h, aux
