"""zamba2-style hybrid stack (``repro.models.hybrid``; the training path):
a Mamba2 backbone and one weight-shared attention block, run after each
full segment of ``shared_attn_every`` mamba layers.

The backbone runs in segments of the stacked layer parameters; after each
full segment the shared block (one set of weights, ``shared_block.*``)
runs again, so its gradient is the sum over its calls. At zamba2's 38
layers and every 6 that is 6 calls, and the last segment of 2 layers has
none. mamba2's own stack (the SSM family) is :func:`mamba_stack`, a
mamba block every layer. Decoding, each call of the shared block owns its
own slot of the KV cache (``attn_k`` / ``attn_v``, one per call), and
:func:`mamba_decode_layers` advances the mamba layers' states in place.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (mamba2_decode_step, mamba2_forward,
                                       mamba2_init_state)
from repro_torch.models.transformer import _layer_tree, maybe_remat


def _segments(cfg) -> List[Tuple[int, int, bool]]:
    """(start, end, shared_after) segments of the mamba stack."""
    segs = []
    e = cfg.shared_attn_every
    start = 0
    while start < cfg.num_layers:
        end = min(start + e, cfg.num_layers)
        segs.append((start, end, end - start == e))
        start = end
    return segs


def mamba_layer(layer_p: Dict[str, torch.Tensor], h: torch.Tensor, cfg
                ) -> torch.Tensor:
    """One pre-norm Mamba2 block with its residual (the reference's scan
    body, ``residual_shard`` an identity on one device)."""
    x = L.rms_norm(h, layer_p["norm1_scale"], cfg.norm_eps)
    return h + mamba2_forward(layer_p, x, cfg)


def _mamba_segment_scan(lp: Dict[str, Tuple[torch.Tensor, ...]],
                        h: torch.Tensor, cfg, start: int, end: int,
                        hook=None, remat: str = "none") -> torch.Tensor:
    """Layers [start, end) of the unbound stacked layer tree `lp`, each
    block under `remat`, `hook(layer, "layers")` applied inside it."""
    def body(i: int, carry: torch.Tensor) -> torch.Tensor:
        layer_p = {n: v[i] for n, v in lp.items()}
        if hook is not None:
            layer_p = hook(layer_p, "layers")
        return mamba_layer(layer_p, carry, cfg)

    run = maybe_remat(body, remat)
    for i in range(start, end):
        h = run(i, h)
    return h


def _shared_attn_block(sp: Dict[str, torch.Tensor], h: torch.Tensor, cfg
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    x = L.rms_norm(h, sp["norm1_scale"], cfg.norm_eps)
    attn_out, kv = L.self_attention_block(sp, "attn", x, cfg, causal=True)
    h = h + attn_out
    x = L.rms_norm(h, sp["norm2_scale"], cfg.norm_eps)
    h = h + L.swiglu_mlp(sp, "mlp", x)
    return h, kv


def _unbound_layers(p: Dict[str, torch.Tensor]
                    ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Each stacked layer leaf as its L layer views: unbound once, so the
    backward stacks the L layers' gradients in one op (see
    ``transformer.decoder_stack``)."""
    return {k: v.unbind(0) for k, v in _layer_tree(p).items()}


def mamba_stack(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                hook=None, remat: str = "none") -> torch.Tensor:
    """The SSM family's stack (mamba2): a mamba block every layer."""
    return _mamba_segment_scan(_unbound_layers(p), h, cfg, 0,
                               cfg.num_layers, hook=hook, remat=remat)


def hybrid_forward(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                   hook=None, remat: str = "none") -> torch.Tensor:
    """The hybrid stack on the (B, S, d) stream: each segment's mamba
    layers, then, after a full segment, the shared block (under `remat`
    too, as the reference's ``maybe_remat(shared_fn, remat)``)."""
    lp = _unbound_layers(p)
    sp = _layer_tree(p, "shared_block.")

    def shared_fn(sp_: Dict[str, torch.Tensor], h_: torch.Tensor
                  ) -> torch.Tensor:
        return _shared_attn_block(sp_, h_, cfg)[0]

    shared_fn = maybe_remat(shared_fn, remat)
    for start, end, shared_after in _segments(cfg):
        h = _mamba_segment_scan(lp, h, cfg, start, end, hook=hook,
                                remat=remat)
        if shared_after:
            h = shared_fn(sp, h)
    return h


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def hybrid_init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                      device=None) -> Dict[str, torch.Tensor]:
    """The mamba layers' stacked states (``ssm`` float32, ``conv``) and one
    KV cache slot per call of the shared block (``attn_k`` / ``attn_v``
    (calls, B, max_len, K, hd))."""
    st = mamba2_init_state(cfg, batch, dtype, device=device)
    shape = (cfg.num_shared_attn_calls, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "ssm": torch.zeros((cfg.num_layers,) + tuple(st["ssm"].shape),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.num_layers,) + tuple(st["conv"].shape),
                            dtype=dtype, device=device),
        "attn_k": torch.zeros(shape, dtype=dtype, device=device),
        "attn_v": torch.zeros(shape, dtype=dtype, device=device),
    }


def mamba_decode_layers(lp: Dict[str, Tuple[torch.Tensor, ...]],
                        h: torch.Tensor,
                        cache: Dict[str, Tuple[torch.Tensor, ...]], cfg,
                        start: int, end: int) -> torch.Tensor:
    """Layers [start, end) of the unbound layer tree `lp`, one token each:
    a pre-norm mamba decode step with its residual, each layer's slice of
    the unbound ``cache["ssm"]`` / ``cache["conv"]`` advanced in place."""
    for i in range(start, end):
        layer_p = {n: v[i] for n, v in lp.items()}
        x = L.rms_norm(h, layer_p["norm1_scale"], cfg.norm_eps)
        h = h + mamba2_decode_step(
            layer_p, x, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
            cfg)
    return h


def hybrid_decode_step(p: Dict[str, torch.Tensor], h: torch.Tensor,
                       cache: Dict[str, torch.Tensor], pos, cfg
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """h (B,1,d) through each segment's mamba layers and, after a full
    segment, the shared block against its call's KV slot; `pos` one
    position (scalar) or one a row (B,). The cache is advanced in place;
    returns (h, cache)."""
    lp, sp = _unbound_layers(p), _layer_tree(p, "shared_block.")
    layers = {k: v.unbind(0) for k, v in cache.items()}
    pos = L.decode_positions(pos, h.shape[0], h.device)
    call = 0
    for start, end, shared_after in _segments(cfg):
        h = mamba_decode_layers(lp, h, layers, cfg, start, end)
        if shared_after:
            x = L.rms_norm(h, sp["norm1_scale"], cfg.norm_eps)
            h = h + L.decode_self_attention(
                sp, "attn", x, cfg, k_cache=layers["attn_k"][call],
                v_cache=layers["attn_v"][call], pos=pos)
            x = L.rms_norm(h, sp["norm2_scale"], cfg.norm_eps)
            h = h + L.swiglu_mlp(sp, "mlp", x)
            call += 1
    return h, cache
