"""Shared layers: RMSNorm, RoPE and sinusoidal positions, GQA attention
(causal, sliding-window and bidirectional self-attention, and
cross-attention), SwiGLU MLP, embedding and cross-entropy
(``repro.models.layers``): the training path's query-chunked attention,
and the decode path's attention of one new token against a KV cache
(bf16, or int8 with per-row scales), written into the cache in place.

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
    """x (..., S, H, D); cos/sin (..., S, D//2) as :func:`rope_cos_sin`
    gives them, or each half already repeated to (..., S, D) (a decode
    tick's tables, shared by its layers), broadcast over heads. Half-split
    (not interleaved), computed in float32 as ``x * cos + rotate_half(x) *
    sin``, whose halves are ``x1 c - x2 s`` and ``x2 c + x1 s``."""
    if cos.shape[-1] != x.shape[-1]:
        cos, sin = (torch.cat([t, t], dim=-1) for t in (cos, sin))
    x32 = x.to(torch.float32)
    x1, x2 = x32.chunk(2, dim=-1)
    return (x32 * cos[..., None, :] + torch.cat([-x2, x1], dim=-1)
            * sin[..., None, :]).to(x.dtype)


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
    backward. Attention against a cache is :func:`decode_self_attention`.

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


# --- decode path (one new token against a cache) ---------------------------

KV_CHUNK = 4096  # online-softmax chunk for long / quantized caches


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 values, (...,) bf16 scale), symmetric: the
    float32 scale ``max|x| / 127 + 1e-8`` divides x, the quotient rounded
    half to even (``jnp.round``)."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.round(x32 / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


class DecodePositions:
    """One decode tick's positions, one a row (B,) int64, and what each
    layer would otherwise derive from them again: the row indices of the
    cache writes, RoPE's cos / sin per (head_dim, theta), and the mask of
    readable cache rows per (start, length, window). A decode stack makes
    one a tick (:func:`decode_positions`) and hands it to every layer's
    :func:`decode_self_attention`."""

    def __init__(self, pos, batch: int, device):
        pos = torch.as_tensor(pos, device=device).to(torch.int64)
        self.pos = pos.expand(batch) if pos.ndim == 0 else pos
        self.rows = torch.arange(batch, device=device)
        self._rope: dict = {}
        self._masks: dict = {}
        self._writes: dict = {}

    def rope(self, head_dim: int, theta: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RoPE's cos and sin at each row's position, each half repeated
        to the head's width: (B, 1, head_dim) float32, as
        :func:`apply_rope` takes them."""
        key = (head_dim, theta)
        if key not in self._rope:
            cos, sin = rope_cos_sin(self.pos, head_dim, theta)
            self._rope[key] = tuple(torch.cat([t, t], dim=-1)[:, None]
                                    for t in (cos, sin))
        return self._rope[key]

    def write_index(self, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, positions) of the cache writes into a cache of `length`
        rows, each position clamped into it as ``dynamic_update_slice``
        clamps its start."""
        if length not in self._writes:
            self._writes[length] = (self.rows,
                                    self.pos.clamp(0, length - 1))
        return self._writes[length]

    def masked(self, start: int, length: int, window: Optional[int]
               ) -> torch.Tensor:
        """(B, 1, 1, 1, length) bool: the cache rows [start, start +
        length) that row b may NOT read at its position (ahead of it, or
        outside its sliding `window`)."""
        key = (start, length, window)
        if key not in self._masks:
            kv_pos = torch.arange(start, start + length,
                                  device=self.pos.device)
            rel = self.pos[:, None] - kv_pos[None, :]
            valid = rel >= 0
            if window is not None:
                valid = valid & (rel < window)
            self._masks[key] = (~valid)[:, None, None, None, :]
        return self._masks[key]


def decode_positions(pos, batch: int, device) -> DecodePositions:
    """`pos` (an int, a 0-d tensor, one position a row (B,), or already a
    :class:`DecodePositions`) as a :class:`DecodePositions`."""
    if isinstance(pos, DecodePositions):
        return pos
    return DecodePositions(pos, batch, device)


def _decode_attention_chunked(qg: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos,
                              window: Optional[int],
                              k_scale: Optional[torch.Tensor],
                              v_scale: Optional[torch.Tensor],
                              scale: float) -> torch.Tensor:
    """Online-softmax (flash-decode) attention of one query a row against
    a long, optionally int8 cache, ``KV_CHUNK`` rows (read at the call) at
    a time; an int8 chunk is dequantised on its own (bf16 values times
    bf16 scales), so no full-precision copy of the cache exists. Chunk-
    sized products run in the compute dtype (bf16 for an int8 cache, else
    the cache's), scores and the running max, numerator and denominator
    in float32. As in the reference, ``T // chunk`` chunks are read, so a
    cache longer than ``KV_CHUNK`` and not a multiple of it raises (the
    reference leaves its last rows unread); a chunk whose rows are all
    masked (outside the window) adds nothing: ``exp(-inf - -inf)`` is
    never let into the sums.

    qg (B,1,K,G,D); caches (B,T,K,D); scales (B,T,K) or None; `pos` as
    :func:`decode_positions` takes it. Returns (B,1,K,G,D) float32.
    """
    B, _, K, G, D = qg.shape
    pos = decode_positions(pos, B, qg.device)
    T = k_cache.shape[1]
    chunk = min(KV_CHUNK, T)
    if T % chunk:
        raise ValueError(
            f"a cache of {T} rows is longer than KV_CHUNK ({KV_CHUNK}) and "
            f"not a multiple of it: the chunked decode reads {T // chunk} "
            f"chunks and would never attend rows {T // chunk * chunk}-"
            f"{T - 1}; give the cache a multiple of {KV_CHUNK} rows")
    compute_dt = torch.bfloat16 if k_scale is not None else k_cache.dtype
    qc = qg.to(compute_dt)
    f32 = torch.float32
    m = torch.full((B, K, G, 1), -torch.inf, dtype=f32, device=qg.device)
    num = torch.zeros((B, K, G, 1, D), dtype=f32, device=qg.device)
    den = torch.zeros((B, K, G, 1), dtype=f32, device=qg.device)
    for start in range(0, (T // chunk) * chunk, chunk):
        ks = k_cache[:, start:start + chunk]
        vs = v_cache[:, start:start + chunk]
        if k_scale is not None:
            ks = ks.to(compute_dt) * k_scale[:, start:start + chunk].to(
                compute_dt)[..., None]
            vs = vs.to(compute_dt) * v_scale[:, start:start + chunk].to(
                compute_dt)[..., None]
        s = torch.einsum("bskgd,btkd->bkgst", qc, ks).to(f32) * scale
        s = s.masked_fill(pos.masked(start, chunk, window), -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                           torch.zeros_like(m))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        num = num * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(compute_dt), vs).to(f32)
        den = den * corr + p.sum(dim=-1)
        m = m_new
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.movedim(3, 1)


def _write_rows(cache: torch.Tensor, new: torch.Tensor,
                pos: DecodePositions) -> None:
    """cache[b, pos[b]] = new[b, 0] in place (positions clamped)."""
    new = new[:, 0]
    cache[pos.write_index(cache.shape[1])] = (
        new if new.dtype == cache.dtype else new.to(cache.dtype))


def decode_self_attention(
    p: dict, prefix: str, x: torch.Tensor, cfg, *,
    k_cache: torch.Tensor, v_cache: torch.Tensor, pos,
    use_rope: bool = True, window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One token's self-attention sublayer (no residual) against its
    cache: x (B,1,d); caches (B,Smax,K,hd) in the model's dtype, or int8
    with (B,Smax,K) bf16 scales. `pos` is one position for every row (the
    reference's scalar) or one a row (B,), as the serving engine's slots
    decode: each row is RoPE'd at, writes at, and reads up to its own
    position (and within `window` of it). The new K / V (int8 and scales,
    quantized) are written into the caches in place, which are views of
    the stacked cache, so no second copy of it exists. Up to ``KV_CHUNK``
    rows an unquantized cache takes the direct float32 softmax (masked
    with float32's min, the reference's); a longer or int8 one the chunked
    online softmax (masked with -inf). `pos` may be the tick's
    :class:`DecodePositions`, which a decode stack shares among its
    layers. Returns the sublayer's output."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = attn_project_qkv(p, prefix, x, H, K, hd, bias=cfg.qkv_bias)
    pos = decode_positions(pos, B, x.device)
    if use_rope and cfg.rope_theta:
        cos, sin = pos.rope(hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    quantized = k_scale is not None
    T = k_cache.shape[1]
    if quantized:
        kq, ksc = quantize_kv(k)
        vq, vsc = quantize_kv(v)
        for cache, new in ((k_cache, kq), (v_cache, vq), (k_scale, ksc),
                           (v_scale, vsc)):
            _write_rows(cache, new, pos)
    else:
        _write_rows(k_cache, k, pos)
        _write_rows(v_cache, v, pos)
    qg = q.reshape(B, 1, K, H // K, hd)
    if quantized or T > KV_CHUNK:
        out = _decode_attention_chunked(qg, k_cache, v_cache, pos, window,
                                        k_scale, v_scale, hd ** -0.5)
        out = out.to(x.dtype)
    else:
        scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                              k_cache.to(torch.float32)) * hd ** -0.5
        scores = scores.masked_fill(pos.masked(0, T, window),
                                    torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(v_cache.dtype),
                           v_cache)
    return out.reshape(B, 1, H * hd) @ p[f"{prefix}_wo"]


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
