"""Decoder-only transformer stack, dense and MoE blocks
(``repro.models.transformer``): the training stack, and the serving path's
KV cache, prefill and one-token decode step.

Layers stay stacked (leading ``L`` axis) as in the JAX package; the stack
is a Python loop over depth over views of each layer's weights in the
stacked tensors, so autograd assembles each stacked leaf's gradient from
its layers' gradients. ``remat="full"`` recomputes each block in the
backward pass instead of keeping its activations; ``"nested"`` is the
reference's sqrt-remat: groups of about sqrt(L) blocks are checkpointed
as one (the same as "full" below 4 layers); ``"dots"`` keeps the matrix
products' outputs and recomputes the rest (the reference's
``checkpoint_dots`` policy). None changes a value.

A parameter `hook` (``core.majority_vote.make_fsdp_hooks``, the ZeRO-3
gather whose backward votes) runs on each layer's tree inside the
checkpointed block, so a rematted block gathers its layer's weights again
in the backward pass instead of keeping them: ZeRO-3.

The decode step updates the cache in place, one layer's slice at a time,
as the reference carries it through a ``fori_loop`` so that a multi-GB
cache never exists twice.

Over a mesh's model axis (`tp`, ``distributed.tensor_parallel``) the
block runs tensor-parallel on the rank's weight slices (an MoE block's
experts in the EP or M2 form, ``models.moe``); the residual
stream stays whole on every rank (the reference's ``residual_shard`` is a
layout hint, an identity on the function). The serving cache is then the
rank's block of ``train.serve_step``'s layout.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.models.moe import moe_ffn

REMAT_MODES = ("none", "full", "nested", "dots")


def _dots():
    """The matrix products whose outputs "dots" keeps (the reference's
    ``checkpoint_dots``: every dot_general): ``h @ W`` reaches autograd as
    ``mm`` (``addmm`` with a bias), the attention einsums as ``bmm``."""
    aten = torch.ops.aten
    return [aten.mm.default, aten.addmm.default, aten.bmm.default]


def maybe_remat(fn: Callable, remat: str) -> Callable:
    """`fn` checkpointed as the reference's ``maybe_remat`` does it: for
    "full" and "nested" only its inputs are kept and it is recomputed in
    the backward pass; for "dots" the outputs of its matrix products are
    kept too and the rest is recomputed (a selective checkpoint whose
    policy is a list of ops, a form PyTorch 2.4 and later accept). The
    non-reentrant checkpoint, since the train step differentiates with
    ``torch.autograd.grad``, which the reentrant one does not support."""
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {remat!r}; the reference has "
                         f"{REMAT_MODES}")
    if remat == "none":
        return fn
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots())

    def rematted(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)
    return rematted


def _layer_tree(p: Dict[str, torch.Tensor], prefix: str = "layers."
                ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _window_for(cfg, is_local: bool, seq_len: int) -> Optional[int]:
    """The attention window of a layer (the reference's ``_window_for``):
    None without a sliding window; else ``sliding_window`` for a local
    layer and ``seq_len + 1`` (the whole causal context) for a global one."""
    if not cfg.sliding_window:
        return None
    return cfg.sliding_window if is_local else seq_len + 1


def decoder_block(lp: Dict[str, torch.Tensor], h: torch.Tensor, cfg, *,
                  window: Optional[int] = None,
                  positions: Optional[torch.Tensor] = None, tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block, its FFN a SwiGLU MLP or the MoE block. Returns
    (h, aux_loss). The reference's ``residual_shard`` (``act_seq_shard``)
    is an identity on one device, and over a model group `tp` too: the
    stream stays whole on every rank."""
    attn_in = L.rms_norm(h, lp["norm1_scale"], cfg.norm_eps)
    attn_out, _ = L.self_attention_block(lp, "attn", attn_in, cfg,
                                         window=window, positions=positions,
                                         tp=tp)
    h = h + attn_out
    ffn_in = L.rms_norm(h, lp["norm2_scale"], cfg.norm_eps)
    if cfg.moe.enabled:
        ffn_out, aux = moe_ffn(lp, ffn_in, cfg.moe, tp=tp)
    else:
        ffn_out = L.swiglu_mlp(lp, "mlp", ffn_in, tp)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ffn_out, aux


def decoder_stack(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                  positions: Optional[torch.Tensor] = None,
                  hook=None, remat: str = "none", tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop over the stacked layers, each block under `remat` (see
    :func:`maybe_remat`), `hook(layer_tree, "layers")` applied to each
    layer's weights inside it, each layer's window from
    ``cfg.local_layer_mask()`` (gemma3's local / global pattern). Returns
    (h, the aux losses summed over the layers). Over a model group `tp`
    each block is tensor-parallel."""
    # unbind, not v[i]: its backward stacks the L layer gradients in one
    # op, where indexing zero-fills a full (L, ...) gradient per layer
    lp = {k: v.unbind(0) for k, v in _layer_tree(p).items()}
    n_layers = cfg.num_layers
    local = cfg.local_layer_mask()
    S = h.shape[1]
    # sqrt-remat (the reference's "nested" from 4 layers): a checkpoint
    # per group of k blocks, so the backward keeps L/k group inputs
    k = _best_group(n_layers) if remat == "nested" and n_layers >= 4 else 1

    def group(g: int, h: torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(g * k, (g + 1) * k):
            layer = {n: v[i] for n, v in lp.items()}
            if hook is not None:
                layer = hook(layer, "layers")
            h, a = decoder_block(layer, h, cfg,
                                 window=_window_for(cfg, local[i], S),
                                 positions=positions, tp=tp)
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


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zero caches ``k`` / ``v`` (L, B, max_len, K, hd) in `dtype`, or for
    ``kv_cache_dtype="int8"`` int8 ones with (L, B, max_len, K) bf16
    ``k_scale`` / ``v_scale``. (Over a mesh a rank's block of it is made
    by ``train.serve_step.make_cache_rehome``.)"""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len, K, hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ffn(layer_p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
         min_capacity: int = 0, tp=None) -> torch.Tensor:
    """The block's FFN without its aux loss: the MoE block or the MLP."""
    if cfg.moe.enabled:
        return moe_ffn(layer_p, x, cfg.moe, min_capacity=min_capacity,
                       tp=tp)[0]
    return L.swiglu_mlp(layer_p, "mlp", x, tp)


def decoder_prefill(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                    tp=None, keep: Optional[Callable] = None, hook=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The forward pass over the prompt stream h (B, S, d) that also
    returns the populated cache: each layer's K (after RoPE) and V at S
    positions (quantized for an int8 cache), written into the (L, B, S,
    ...) cache as the layer makes them. Over a model group `tp`, a layer's
    K / V are the rank's kv heads (grouped form) or every head, and
    `keep(name, t)` cuts each to the rank's block of the serving layout
    before it is stored; `hook` gathers each layer's FSDP slices (the
    ZeRO-3 hook, ``core.majority_vote.make_fsdp_hooks``)."""
    lp = {k: v.unbind(0) for k, v in _layer_tree(p).items()}
    local = cfg.local_layer_mask()
    B, S, _ = h.shape
    keep = keep or (lambda name, t: t)
    cache = None
    for i in range(cfg.num_layers):
        layer_p = {n: v[i] for n, v in lp.items()}
        if hook is not None:
            layer_p = hook(layer_p, "layers")
        attn_in = L.rms_norm(h, layer_p["norm1_scale"], cfg.norm_eps)
        attn_out, (k, v) = L.self_attention_block(
            layer_p, "attn", attn_in, cfg,
            window=_window_for(cfg, local[i], S), tp=tp)
        h = h + attn_out
        ffn_in = L.rms_norm(h, layer_p["norm2_scale"], cfg.norm_eps)
        h = h + _ffn(layer_p, ffn_in, cfg, tp=tp)
        if cfg.kv_cache_dtype == "int8":
            (kq, ksc), (vq, vsc) = L.quantize_kv(k), L.quantize_kv(v)
            new = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
        else:
            new = {"k": k, "v": v}
        new = {name: keep(name, t) for name, t in new.items()}
        if cache is None:
            cache = {name: torch.zeros((cfg.num_layers,) + tuple(t.shape),
                                       dtype=t.dtype, device=h.device)
                     for name, t in new.items()}
        for name, t in new.items():
            cache[name][i].copy_(t)
    return h, cache


def decoder_decode_step(p: Dict[str, torch.Tensor], h: torch.Tensor,
                        cache: Dict[str, torch.Tensor], pos, cfg, tp=None,
                        seq_names=(), seq_len: int = 0, hook=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """h (B,1,d); cache {'k','v'[,'k_scale','v_scale']} (L,B,Smax,...),
    written in place; `pos` one position (scalar) or one a row (B,). A
    local layer reads within ``sliding_window``, a global one the whole
    cache (the reference's window of 2^30). With one position a row, each
    row is also its own batch in an MoE block's routing (the engine's
    slots are the reference's vmapped batch-1 decodes), so no row's token
    is dropped for another's. Over a model group `tp` the cache is the
    rank's block (``layers.decode_self_attention``'s `seq_names` and
    `seq_len`); `hook` gathers each layer's FSDP slices as the prefill's
    does. Returns (h, cache)."""
    lp = {k: v.unbind(0) for k, v in _layer_tree(p).items()}
    layers = {k: v.unbind(0) for k, v in cache.items()}
    local = cfg.local_layer_mask()
    min_capacity = h.shape[0] if torch.as_tensor(pos).ndim == 1 else 0
    pos = L.decode_positions(pos, h.shape[0], h.device)
    for i in range(cfg.num_layers):
        layer_p = {n: v[i] for n, v in lp.items()}
        if hook is not None:
            layer_p = hook(layer_p, "layers")
        window = None
        if cfg.sliding_window:
            window = cfg.sliding_window if local[i] else 1 << 30
        attn_in = L.rms_norm(h, layer_p["norm1_scale"], cfg.norm_eps)
        h = h + L.decode_self_attention(
            layer_p, "attn", attn_in, cfg, k_cache=layers["k"][i],
            v_cache=layers["v"][i], pos=pos, window=window,
            k_scale=layers["k_scale"][i] if "k_scale" in layers else None,
            v_scale=layers["v_scale"][i] if "v_scale" in layers else None,
            tp=tp, seq_names=seq_names, seq_len=seq_len)
        ffn_in = L.rms_norm(h, layer_p["norm2_scale"], cfg.norm_eps)
        h = h + _ffn(layer_p, ffn_in, cfg, min_capacity, tp=tp)
    return h, cache
