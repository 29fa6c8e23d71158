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

Over a model group (`tp`) the mamba layers run on the rank's heads
(``models.mamba2``). The shared block follows its leaves' layout (``distri
buted.tensor_parallel``): q / k / v, the attention and gate / up whole on
every rank, ``attn_wo`` and ``mlp_w_down`` the rank's output columns,
gathered (:func:`_shared_out`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

import torch.nn.functional as F

from repro_torch.distributed import mesh as pm
from repro_torch.distributed import tensor_parallel as tpar
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


def mamba_layer(layer_p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                tp=None) -> torch.Tensor:
    """One pre-norm Mamba2 block with its residual (the reference's scan
    body, ``residual_shard`` an identity on one device)."""
    x = L.rms_norm(h, layer_p["norm1_scale"], cfg.norm_eps)
    return h + mamba2_forward(layer_p, x, cfg, tp=tp)


def _mamba_segment_scan(lp: Dict[str, Tuple[torch.Tensor, ...]],
                        h: torch.Tensor, cfg, start: int, end: int,
                        hook=None, remat: str = "none", tp=None
                        ) -> torch.Tensor:
    """Layers [start, end) of the unbound stacked layer tree `lp`, each
    block under `remat`, `hook(layer, "layers")` applied inside it."""
    def body(i: int, carry: torch.Tensor) -> torch.Tensor:
        layer_p = {n: v[i] for n, v in lp.items()}
        if hook is not None:
            layer_p = hook(layer_p, "layers")
        return mamba_layer(layer_p, carry, cfg, tp)

    run = maybe_remat(body, remat)
    for i in range(start, end):
        h = run(i, h)
    return h


def _shared_out(x: torch.Tensor, w: torch.Tensor, cfg, tp=None
                ) -> torch.Tensor:
    """``x @ w`` of the shared block's ``attn_wo`` / ``mlp_w_down``: over
    a model group whose axis divides d, the rank's output columns of the
    replicated x, gathered (``tensor_parallel.out_columns``)."""
    tp = L.model_group(tp)
    if tp is None or w.shape[-1] == cfg.d_model:
        return x @ w
    return tpar.out_columns(x, w, tp)


def _shared_mlp(sp: Dict[str, torch.Tensor], x: torch.Tensor, cfg, tp=None
                ) -> torch.Tensor:
    """The shared block's SwiGLU (gate and up whole)."""
    if L.model_group(tp) is None:
        return L.swiglu_mlp(sp, "mlp", x)
    h = F.silu(x @ sp["mlp_w_gate"]) * (x @ sp["mlp_w_up"])
    return _shared_out(h, sp["mlp_w_down"], cfg, tp)


def _shared_attn_block(sp: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                       tp=None) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                            torch.Tensor]]:
    x = L.rms_norm(h, sp["norm1_scale"], cfg.norm_eps)
    if L.model_group(tp) is None:
        attn_out, kv = L.self_attention_block(sp, "attn", x, cfg,
                                              causal=True)
    else:
        B, S, _ = x.shape
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = L.attn_project_qkv(sp, "attn", x, H, K, hd,
                                     bias=cfg.qkv_bias)
        if cfg.rope_theta:
            cos, sin = L.rope_cos_sin(torch.arange(S, device=x.device), hd,
                                      cfg.rope_theta)
            q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
        out = L.attention(q, k, v, causal=True).reshape(B, S, H * hd)
        attn_out, kv = _shared_out(out, sp["attn_wo"], cfg, tp), (k, v)
    h = h + attn_out
    x = L.rms_norm(h, sp["norm2_scale"], cfg.norm_eps)
    h = h + _shared_mlp(sp, x, cfg, tp)
    return h, kv


def _unbound_layers(p: Dict[str, torch.Tensor]
                    ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Each stacked layer leaf as its L layer views: unbound once, so the
    backward stacks the L layers' gradients in one op (see
    ``transformer.decoder_stack``)."""
    return {k: v.unbind(0) for k, v in _layer_tree(p).items()}


def mamba_stack(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                hook=None, remat: str = "none", tp=None) -> torch.Tensor:
    """The SSM family's stack (mamba2): a mamba block every layer."""
    return _mamba_segment_scan(_unbound_layers(p), h, cfg, 0,
                               cfg.num_layers, hook=hook, remat=remat, tp=tp)


def hybrid_forward(p: Dict[str, torch.Tensor], h: torch.Tensor, cfg,
                   hook=None, remat: str = "none", tp=None) -> torch.Tensor:
    """The hybrid stack on the (B, S, d) stream: each segment's mamba
    layers, then, after a full segment, the shared block (under `remat`
    too, as the reference's ``maybe_remat(shared_fn, remat)``)."""
    lp = _unbound_layers(p)
    sp = _layer_tree(p, "shared_block.")

    def shared_fn(sp_: Dict[str, torch.Tensor], h_: torch.Tensor
                  ) -> torch.Tensor:
        return _shared_attn_block(sp_, h_, cfg, tp)[0]

    shared_fn = maybe_remat(shared_fn, remat)
    for start, end, shared_after in _segments(cfg):
        h = _mamba_segment_scan(lp, h, cfg, start, end, hook=hook,
                                remat=remat, tp=tp)
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
                        start: int, end: int, tp=None) -> torch.Tensor:
    """Layers [start, end) of the unbound layer tree `lp`, one token each:
    a pre-norm mamba decode step with its residual, each layer's slice of
    the unbound ``cache["ssm"]`` / ``cache["conv"]`` advanced in place."""
    for i in range(start, end):
        layer_p = {n: v[i] for n, v in lp.items()}
        x = L.rms_norm(h, layer_p["norm1_scale"], cfg.norm_eps)
        h = h + mamba2_decode_step(
            layer_p, x, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
            cfg, tp=tp)
    return h


def hybrid_decode_step(p: Dict[str, torch.Tensor], h: torch.Tensor,
                       cache: Dict[str, torch.Tensor], pos, cfg, tp=None,
                       seq_names=(), seq_len: int = 0
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """h (B,1,d) through each segment's mamba layers and, after a full
    segment, the shared block against its call's KV slot; `pos` one
    position (scalar) or one a row (B,). The cache is advanced in place;
    returns (h, cache). Over a model group `tp` the cache is the rank's
    block (the KV slots' as ``layers.decode_self_attention`` reads them,
    `seq_names` / `seq_len`)."""
    lp, sp = _unbound_layers(p), _layer_tree(p, "shared_block.")
    layers = {k: v.unbind(0) for k, v in cache.items()}
    pos = L.decode_positions(pos, h.shape[0], h.device)
    call = 0
    for start, end, shared_after in _segments(cfg):
        h = mamba_decode_layers(lp, h, layers, cfg, start, end, tp)
        if shared_after:
            x = L.rms_norm(h, sp["norm1_scale"], cfg.norm_eps)
            kc, vc = layers["attn_k"][call], layers["attn_v"][call]
            if L.model_group(tp) is None:
                h = h + L.decode_self_attention(sp, "attn", x, cfg,
                                                k_cache=kc, v_cache=vc,
                                                pos=pos)
            else:
                h = h + _shared_decode_attention(sp, x, cfg, kc, vc, pos,
                                                 tp, seq_names)
            x = L.rms_norm(h, sp["norm2_scale"], cfg.norm_eps)
            h = h + _shared_mlp(sp, x, cfg, tp)
            call += 1
    return h, cache


def _shared_decode_attention(sp: Dict[str, torch.Tensor], x: torch.Tensor,
                             cfg, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos, tp, seq_names
                             ) -> torch.Tensor:
    """The shared block's one-token attention over a model group `tp`: q,
    k and v whole on every rank (its q / k / v leaves are), the cache the
    rank's block of the serving layout: its kv heads (it attends its q
    heads, and the heads' outputs are gathered), or the rows of the axes
    `seq_names` (the sharded online softmax), or whole; then ``attn_wo``'s
    output columns (:func:`_shared_out`)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m, r = tp.model, tp.axis_index("model")
    if K % m == 0:
        # the rank's heads' columns of the whole q / k / v leaves
        L.DECODE_PATHS["shared_heads"] += 1
        local = {}
        for n, heads in (("q", H // m), ("k", K // m), ("v", K // m)):
            cols = slice(r * heads * hd, (r + 1) * heads * hd)
            local[f"attn_w{n}"] = sp[f"attn_w{n}"][:, cols]
            if cfg.qkv_bias:
                local[f"attn_b{n}"] = sp[f"attn_b{n}"][cols]
        out = L.decode_self_attention(
            local, "attn", x, L._local_cfg(cfg, H // m, K // m),
            k_cache=k_cache, v_cache=v_cache, pos=pos, project_out=False)
        out = pm.model_gather(out.contiguous(), tp, dim=-1)
        return _shared_out(out, sp["attn_wo"], cfg, tp)
    q, k, v = L.attn_project_qkv(sp, "attn", x, H, K, hd, bias=cfg.qkv_bias)
    if cfg.rope_theta:
        cos, sin = pos.rope(hd, cfg.rope_theta)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    qg = q.reshape(B, 1, K, H // K, hd)
    start = (pm.line_index(tp, seq_names) * k_cache.shape[1]
             if seq_names else 0)
    L._masked_local_update(k_cache, k, pos, start)
    L._masked_local_update(v_cache, v, pos, start)
    if seq_names:
        L.DECODE_PATHS["shared_sharded"] += 1
        parts = L._flash_decode_local(qg, k_cache, v_cache, None, None,
                                      pos, start, None, hd ** -0.5)
        out = L.flash_decode_combine(*parts, tp, seq_names)
    else:
        L.DECODE_PATHS["shared_replicated"] += 1
        out = L._decode_attention_chunked(qg, k_cache, v_cache, pos,
                                          None, None, None, hd ** -0.5)
    out = out.to(x.dtype).reshape(B, 1, H * hd)
    return _shared_out(out, sp["attn_wo"], cfg, tp)
