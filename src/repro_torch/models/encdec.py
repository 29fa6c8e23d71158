"""Whisper-style encoder-decoder (``repro.models.encdec``; the training
path).

The convolutional frontend is stubbed, as in the reference: the batch
carries precomputed mel-frame embeddings ``enc_embeds`` (B, T_src, d). The
encoder adds the learned position table ``enc_embed.pos`` and runs
bidirectional blocks without RoPE. The decoder is causal, without RoPE
(``model.forward_logits`` adds its sinusoidal positions), and each of its
layers projects K and V from the encoder output for its cross-attention.
Decoding, the cache holds each layer's self-attention K / V and its
cross-attention K / V (``xk`` / ``xv``), projected once from the encoder
output by :func:`encdec_precompute_cross`.

Over a model group (`tp`) every attention (the encoder's bidirectional,
the decoder's causal and its cross-attention) takes the reference's three
forms and the MLPs are tensor-parallel (``models.layers``); the encoder
output and the position table stay whole on every rank, and the cross
cache is the rank's block of ``train.serve_step``'s layout.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer_tree, maybe_remat


def _stack(p: Dict[str, torch.Tensor], prefix: str, block, h: torch.Tensor,
           hook, remat: str) -> torch.Tensor:
    """`block(layer_tree, h)` over the stacked layers under `prefix`, each
    under `remat`, `hook(layer, "layers")` applied inside it."""
    lp = {k: v.unbind(0) for k, v in _layer_tree(p, prefix).items()}
    depth = len(next(iter(lp.values())))

    def body(i: int, carry: torch.Tensor) -> torch.Tensor:
        layer_p = {n: v[i] for n, v in lp.items()}
        if hook is not None:
            layer_p = hook(layer_p, "layers")
        return block(layer_p, carry)

    run = maybe_remat(body, remat)
    for i in range(depth):
        h = run(i, h)
    return h


def encoder_forward(p: Dict[str, torch.Tensor], enc_embeds: torch.Tensor,
                    cfg, hook=None, remat: str = "none", tp=None
                    ) -> torch.Tensor:
    """enc_embeds (B, T_src, d) -> the encoder output (B, T_src, d)."""
    T = enc_embeds.shape[1]
    h = enc_embeds + p["enc_embed.pos"][:T].to(enc_embeds.dtype)

    def block(layer_p, carry):
        x = L.rms_norm(carry, layer_p["norm1_scale"], cfg.norm_eps)
        attn_out, _ = L.self_attention_block(
            layer_p, "attn", x, cfg, causal=False, use_rope=False, tp=tp)
        carry = carry + attn_out
        x = L.rms_norm(carry, layer_p["norm2_scale"], cfg.norm_eps)
        return carry + L.swiglu_mlp(layer_p, "mlp", x, tp)

    h = _stack(p, "encoder.", block, h, hook, remat)
    return L.rms_norm(h, p["enc_final_norm.scale"], cfg.norm_eps)


def decoder_forward(p: Dict[str, torch.Tensor], h: torch.Tensor,
                    enc: torch.Tensor, cfg, hook=None, remat: str = "none",
                    tp=None) -> torch.Tensor:
    """h (B, S, d): the token embeddings with their positions; enc the
    encoder output."""
    def block(layer_p, carry):
        x = L.rms_norm(carry, layer_p["norm1_scale"], cfg.norm_eps)
        attn_out, _ = L.self_attention_block(
            layer_p, "attn", x, cfg, causal=True, use_rope=False, tp=tp)
        carry = carry + attn_out
        x = L.rms_norm(carry, layer_p["norm_xattn_scale"], cfg.norm_eps)
        k, v = L.project_kv_cross(layer_p, "xattn", enc, cfg, tp)
        carry = carry + L.cross_attention_block(layer_p, "xattn", x, k, v,
                                                cfg, tp)
        x = L.rms_norm(carry, layer_p["norm2_scale"], cfg.norm_eps)
        return carry + L.swiglu_mlp(layer_p, "mlp", x, tp)

    return _stack(p, "layers.", block, h, hook, remat)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def encdec_init_cache(cfg, batch: int, max_len: int, t_src: int,
                      dtype: torch.dtype, device=None
                      ) -> Dict[str, torch.Tensor]:
    """Zero self-attention caches ``k`` / ``v`` (L, B, max_len, K, hd) and
    cross-attention ``xk`` / ``xv`` (L, B, t_src, K, hd)."""
    K, hd, Ld = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers

    def zeros(t):
        return torch.zeros((Ld, batch, t, K, hd), dtype=dtype, device=device)
    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(t_src),
            "xv": zeros(t_src)}


def encdec_precompute_cross(p: Dict[str, torch.Tensor], enc: torch.Tensor,
                            cfg, tp=None, hook=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K and V of the encoder output
    enc (B, T_src, d): (L, B, T_src, K, hd) each; over a model group `tp`
    the rank's kv heads, or every head (``layers.cross_cache_block``);
    `hook(layer, "layers")` gathers a layer's FSDP slices."""
    lp = _layer_tree(p, "layers.")
    ks, vs = [], []
    for i in range(cfg.num_layers):
        layer = {n: t[i] for n, t in lp.items()}
        if hook is not None:
            layer = hook(layer, "layers")
        k, v = L.project_kv_cross(layer, "xattn", enc, cfg, tp)
        if L.model_group(tp) is not None:
            k, v = L.cross_cache_block(k, cfg, tp), L.cross_cache_block(
                v, cfg, tp)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def encdec_decode_step(p: Dict[str, torch.Tensor], h: torch.Tensor,
                       cache: Dict[str, torch.Tensor], pos, cfg, tp=None,
                       seq_names=(), seq_len: int = 0, cross_names=(),
                       hook=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """h (B,1,d), its sinusoidal position added by the caller; the cache
    from :func:`encdec_init_cache` with ``xk`` / ``xv`` filled. Each layer:
    causal self-attention without RoPE against its cache (written in
    place), cross-attention against every row of ``xk`` / ``xv``, the MLP.
    Returns (h, cache). Over a model group `tp` the cache is the rank's
    block: the self-attention's read as ``layers.decode_self_attention``
    reads it (`seq_names`, `seq_len`), the cross cache's by
    ``layers.decode_cross_attention`` (`cross_names`: the axes of its
    rows, none when heads-sharded or whole). `hook(layer, "layers")`
    gathers each decoder layer's FSDP slices as the layer runs."""
    lp = {k: v.unbind(0) for k, v in _layer_tree(p, "layers.").items()}
    layers = {k: v.unbind(0) for k, v in cache.items()}
    pos = L.decode_positions(pos, h.shape[0], h.device)
    for i in range(cfg.num_layers):
        layer_p = {n: v[i] for n, v in lp.items()}
        if hook is not None:
            layer_p = hook(layer_p, "layers")
        x = L.rms_norm(h, layer_p["norm1_scale"], cfg.norm_eps)
        h = h + L.decode_self_attention(
            layer_p, "attn", x, cfg, k_cache=layers["k"][i],
            v_cache=layers["v"][i], pos=pos, use_rope=False, tp=tp,
            seq_names=seq_names, seq_len=seq_len)
        x = L.rms_norm(h, layer_p["norm_xattn_scale"], cfg.norm_eps)
        h = h + L.decode_cross_attention(layer_p, "xattn", x, cfg,
                                         layers["xk"][i], layers["xv"][i],
                                         tp, cross_names)
        x = L.rms_norm(h, layer_p["norm2_scale"], cfg.norm_eps)
        h = h + L.swiglu_mlp(layer_p, "mlp", x, tp)
    return h, cache
