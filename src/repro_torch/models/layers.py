"""Shared layers: RMSNorm, RoPE and sinusoidal positions, GQA attention
(causal, sliding-window and bidirectional self-attention, and
cross-attention), SwiGLU MLP, embedding and cross-entropy
(``repro.models.layers``; the training path: query chunking, no cache).

Plain functions on tensors; parameters arrive as slices of the flat
stacked-parameter dict. Compute dtype follows the inputs (bf16 by default);
normalisation statistics, attention scores and softmax, and the loss run in
float32, with the casts where the JAX package places them, so the numerics
stay comparable. Autograd gives every backward: none of these is a kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_CHUNK = 1024  # query-chunk size for long-sequence attention


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm: float32 sum of squares; ``inv`` is cast to x's dtype before
    ``x * inv * scale``."""
    x32 = x.to(torch.float32)
    inv = torch.rsqrt((x32 * x32).sum(-1) / x.shape[-1] + eps)
    return x * inv.to(x.dtype)[..., None] * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin (..., head_dim//2) float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D//2) broadcast over heads.
    Half-split (not interleaved), computed in float32."""
    dtype = x.dtype
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, float32; positions
    (...,) int -> (..., d_model): sines of the first half, cosines of the
    second."""
    half = d_model // 2
    dev = positions.device
    rate = torch.log(torch.tensor(10_000.0, device=dev)) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                      * rate)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------


def _scores_softmax_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], scale: float
                        ) -> torch.Tensor:
    """The reference's "grouped" form. q (B,S,K,G,D), k/v (B,T,K,D), mask
    broadcastable to (B,K,G,S,T). Scores and softmax in float32; probs
    are cast to v's dtype before PV."""
    scores = torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask,
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def _causal_window_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                        window: Optional[int]) -> torch.Tensor:
    """(S, T) bool: causal, and with `window` a sliding window of that many
    positions (the query's own included)."""
    rel = q_pos[:, None] - kv_pos[None, :]
    mask = rel >= 0
    if window is not None:
        mask = mask & (rel < window)
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              q_positions: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              window: Optional[int] = None,
              q_chunk: Optional[int] = None) -> torch.Tensor:
    """Exact attention with GQA grouping, written as plain products (the
    reference's ``attention``): causal, optionally in a sliding `window`,
    or with ``causal=False`` unmasked (bidirectional self-attention, or
    cross-attention, where T may differ from S). For S > `q_chunk`
    (default ``Q_CHUNK``, read at the call) with S a multiple of it the
    queries run in chunks, each under a non-reentrant checkpoint (the
    reference's ``jax.checkpoint`` scan body), so one chunk's (B, K, G,
    q_chunk, T) float32 scores live at a time, in the forward and in the
    backward. Cached attention waits for serving (ROADMAP.md Queue 1 item
    12).

    q: (B, S, H, D); k/v: (B, T, K, D) with H = K * G. Returns (B, S, H, D).
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    q_chunk = Q_CHUNK if q_chunk is None else q_chunk
    qg = q.reshape(B, S, K, G, D)
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=q.device)

    def chunk(q_i: torch.Tensor, qpos_i: torch.Tensor) -> torch.Tensor:
        mask = (_causal_window_mask(qpos_i, kv_positions, window)
                if causal else None)
        return _scores_softmax_out(q_i, k, v, mask, scale)

    if S <= max(q_chunk, 1) or S % q_chunk != 0:
        return chunk(qg, q_positions).reshape(B, S, H, D)
    outs = [checkpoint(chunk, qg[:, i:i + q_chunk],
                       q_positions[i:i + q_chunk], use_reentrant=False)
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, S, H, D)


# ---------------------------------------------------------------------------
# attention block (projection + rope + core + output)
# ---------------------------------------------------------------------------


def attn_project_qkv(p: dict, prefix: str, x: torch.Tensor, num_heads: int,
                     num_kv_heads: int, head_dim: int, *, bias: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = x @ p[f"{prefix}_wq"]
    k = x @ p[f"{prefix}_wk"]
    v = x @ p[f"{prefix}_wv"]
    if bias:
        q = q + p[f"{prefix}_bq"]
        k = k + p[f"{prefix}_bk"]
        v = v + p[f"{prefix}_bv"]
    q = q.reshape(B, S, num_heads, head_dim)
    k = k.reshape(B, S, num_kv_heads, head_dim)
    v = v.reshape(B, S, num_kv_heads, head_dim)
    return q, k, v


def self_attention_block(
    p: dict, prefix: str, x: torch.Tensor, cfg, *,
    causal: bool = True,
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention sublayer (no residual): causal, in a sliding `window`
    when one is given, or bidirectional (``causal=False``); RoPE when
    `use_rope` and the config has a ``rope_theta``. Returns (out, (k, v))."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = attn_project_qkv(p, prefix, x, H, K, hd, bias=cfg.qkv_bias)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if use_rope and cfg.rope_theta:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = attention(q, k, v, causal=causal, q_positions=positions,
                    kv_positions=positions, window=window)
    out = out.reshape(B, S, H * hd) @ p[f"{prefix}_wo"]
    return out, (k, v)


def cross_attention_block(p: dict, prefix: str, x: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor, cfg
                          ) -> torch.Tensor:
    """Cross-attention against the encoder's k / v (whisper), unmasked."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q = x @ p[f"{prefix}_wq"]
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"]
    q = q.reshape(B, S, H, hd)
    out = attention(q, k, v, causal=False)
    return out.reshape(B, S, H * hd) @ p[f"{prefix}_wo"]


def project_kv_cross(p: dict, prefix: str, enc: torch.Tensor, cfg
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V for one decoder layer's
    cross-attention: (B, T_src, K, hd) each."""
    B, T, _ = enc.shape
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = enc @ p[f"{prefix}_wk"]
    v = enc @ p[f"{prefix}_wv"]
    if cfg.qkv_bias:
        k = k + p[f"{prefix}_bk"]
        v = v + p[f"{prefix}_bv"]
    return k.reshape(B, T, K, hd), v.reshape(B, T, K, hd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_mlp(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    gate = x @ p[f"{prefix}_w_gate"]
    up = x @ p[f"{prefix}_w_up"]
    return (F.silu(gate) * up) @ p[f"{prefix}_w_down"]


# ---------------------------------------------------------------------------
# embedding / loss
# ---------------------------------------------------------------------------


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """Mean next-token CE; logits (B,S,V) bf16/f32, targets (B,S) int.
    float32 logsumexp; the gradient reaches the logits in their dtype."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)
