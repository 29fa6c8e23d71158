"""Shared layers: RMSNorm, RoPE and sinusoidal positions, GQA attention
(causal, sliding-window and bidirectional self-attention, and
cross-attention), SwiGLU MLP, embedding and cross-entropy
(``repro.models.layers``): the training path's query-chunked attention,
and the decode path's attention of one new token against a KV cache
(bf16, or int8 with per-row scales), written into the cache in place.

Over a mesh's ``"model"`` axis (`tp`, a ``distributed.mesh.ProcessMesh``
whose model axis is larger than 1) the same functions run tensor-parallel
on a rank's slices of the weights, as ``distributed.tensor_parallel`` sets
out: attention in the reference's three forms (:func:`_attn_form`), self-
(causal or bidirectional) and cross-attention alike, the SwiGLU MLP
column- then row-parallel, the vocab-parallel embedding and cross-entropy
(or the plain ones, where the table stays whole: :func:`vocab_group`), and
the decode path against a heads-sharded cache or, through the sharded
flash decode, a sequence-sharded one (a cross cache's unmasked).

Plain functions on tensors; parameters arrive as slices of the flat
stacked-parameter dict. Compute dtype follows the inputs (bf16 by default);
normalisation statistics, attention scores and softmax, and the loss run in
float32, with the casts where the JAX package places them, so the numerics
stay comparable. Autograd gives every backward: none of these is a kernel.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import mesh as pm
from repro_torch.distributed import tensor_parallel as tpar

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


def model_group(mesh):
    """`mesh` when its model axis has more than one rank, else None (the
    single-device functions)."""
    return mesh if mesh is not None and mesh.model > 1 else None


def _attn_form(num_heads: int, num_kv: int, model: int) -> str:
    """How attention splits over a model axis of `model` ranks (the
    reference's ``_attn_form``): "grouped" when the kv heads divide it (a
    rank holds whole kv heads and their q heads), "repeat" when only the
    q heads do (the k / v columns are gathered), "seq" when neither does
    (q, k and v gathered, each rank attends its share of the query rows,
    or every row where the axis does not divide them)."""
    if model <= 1 or num_kv % model == 0:
        return "grouped"
    if num_heads % model == 0:
        return "repeat"
    return "seq"


def _local_cfg(cfg, heads: int, kv_heads: int):
    """`cfg` with a rank's head counts (the head width kept)."""
    return dataclasses.replace(cfg, num_heads=heads, num_kv_heads=kv_heads,
                               head_dim=cfg.resolved_head_dim)


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
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention sublayer (no residual): causal, in a sliding `window`
    when one is given, or bidirectional (``causal=False``); RoPE when
    `use_rope` and the config has a ``rope_theta``. Returns (out, (k, v)).
    Over a model group `tp` the weights are this rank's column (q, k, v)
    and row (o) slices and the form is :func:`_attn_form`'s; (k, v) are
    the rank's kv heads (grouped) or every head (repeat, seq)."""
    if model_group(tp) is not None:
        return _tp_self_attention(p, prefix, x, cfg, tp, causal=causal,
                                  window=window, positions=positions,
                                  use_rope=use_rope)
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


def _tp_project_qkv(p: dict, prefix: str, x: torch.Tensor, cfg, tp
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rank's q, k, v columns (B, S, columns) of the stream `x`, each
    a column-parallel product rounded once to x's dtype (biases added
    after, as :func:`attn_project_qkv` adds them)."""
    x32 = tpar.enter_model(x, tp)
    q, k, v = (tpar.column_parallel(x32, p[f"{prefix}_w{n}"], x.dtype)
               for n in "qkv")
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"]
        k = k + p[f"{prefix}_bk"]
        v = v + p[f"{prefix}_bv"]
    return q, k, v


def _tp_self_attention(p: dict, prefix: str, x: torch.Tensor, cfg, tp, *,
                       causal: bool, window: Optional[int],
                       positions: Optional[torch.Tensor], use_rope: bool):
    """:func:`self_attention_block` over the model group `tp`."""
    q, k, v = _tp_project_qkv(p, prefix, x, cfg, tp)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    return _tp_attend(p, prefix, q, k, v, cfg, tp, causal=causal,
                      window=window, q_pos=positions, kv_pos=positions,
                      use_rope=use_rope)


def _tp_attend(p: dict, prefix: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, cfg, tp, *, causal: bool,
               window: Optional[int], q_pos: torch.Tensor,
               kv_pos: torch.Tensor, use_rope: bool):
    """Attention over the model group `tp` in :func:`_attn_form`'s form,
    from the rank's q columns (B, S, .) and k / v columns (B, T, .) (self-
    or cross-attention), then the row-parallel ``wo``. Returns (out, (k,
    v)): k / v the rank's kv heads (grouped) or every head."""
    B, S, _ = q.shape
    T = k.shape[1]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m, r = tp.model, tp.axis_index("model")
    form = _attn_form(H, K, m)
    rope = use_rope and cfg.rope_theta
    if form == "grouped":
        q = q.reshape(B, S, H // m, hd)
        k = k.reshape(B, T, K // m, hd)
        v = v.reshape(B, T, K // m, hd)
        if rope:   # self-attention: q_pos is kv_pos
            cos, sin = rope_cos_sin(q_pos, hd, cfg.rope_theta)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = attention(q, k, v, causal=causal, q_positions=q_pos,
                        kv_positions=kv_pos, window=window)
        out = tpar.row_parallel(out.reshape(B, S, H // m * hd),
                                p[f"{prefix}_wo"], tp)
        return out, (k, v)
    k = tpar.gather_from_model(k, tp).reshape(B, T, K, hd)
    v = tpar.gather_from_model(v, tp).reshape(B, T, K, hd)
    if form == "seq":
        q = tpar.gather_from_model(q, tp).reshape(B, S, H, hd)
    else:
        q = q.reshape(B, S, H // m, hd)
    if rope:
        cos, sin = rope_cos_sin(q_pos, hd, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    G = H // K
    if form == "repeat":
        # the rank's q heads each read their kv head, repeated per head
        heads = torch.arange(r * (H // m), (r + 1) * (H // m),
                             device=q.device) // G
        out = attention(q, k.index_select(2, heads),
                        v.index_select(2, heads), causal=causal,
                        q_positions=q_pos, kv_positions=kv_pos,
                        window=window)
        out = out.reshape(B, S, H // m * hd)
    elif S % m:
        # rows the axis does not divide (whisper's 1500 frames at 8 or 16)
        # stay whole, as the reference's shard() drops the constraint:
        # every rank attends every row and keeps its columns
        out = attention(q, k, v, causal=causal, q_positions=q_pos,
                        kv_positions=kv_pos, window=window)
        cols = H * hd // m
        out = out.reshape(B, S, H * hd)[..., r * cols:(r + 1) * cols]
    else:
        rows = slice(r * (S // m), (r + 1) * (S // m))
        out = attention(q[:, rows], k, v, causal=causal,
                        q_positions=q_pos[rows], kv_positions=kv_pos,
                        window=window)
        out = tpar.gather_from_model(out.reshape(B, S // m, H * hd), tp,
                                     dim=1)
        cols = H * hd // m
        out = out[..., r * cols:(r + 1) * cols]
    return tpar.row_parallel(out, p[f"{prefix}_wo"], tp), (k, v)


def cross_attention_block(p: dict, prefix: str, x: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor, cfg, tp=None
                          ) -> torch.Tensor:
    """Cross-attention against the encoder's k / v (whisper), unmasked.
    Over a model group `tp`, k / v are :func:`project_kv_cross`'s column
    blocks and the queries the rank's columns of x's, in
    :func:`_attn_form`'s form (seq: the rank's decoder rows against the
    gathered source)."""
    if model_group(tp) is not None:
        x32 = tpar.enter_model(x, tp)
        q = tpar.column_parallel(x32, p[f"{prefix}_wq"], x.dtype)
        if cfg.qkv_bias:
            q = q + p[f"{prefix}_bq"]
        S, T = x.shape[1], k.shape[1]
        dev = x.device
        return _tp_attend(p, prefix, q, k, v, cfg, tp, causal=False,
                          window=None, q_pos=torch.arange(S, device=dev),
                          kv_pos=torch.arange(T, device=dev),
                          use_rope=False)[0]
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q = x @ p[f"{prefix}_wq"]
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"]
    q = q.reshape(B, S, H, hd)
    out = attention(q, k, v, causal=False)
    return out.reshape(B, S, H * hd) @ p[f"{prefix}_wo"]


def project_kv_cross(p: dict, prefix: str, enc: torch.Tensor, cfg, tp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V for one decoder layer's
    cross-attention: (B, T_src, K, hd) each. Over a model group `tp` the
    rank's column blocks (B, T_src, K hd / m) of each, column-parallel
    products of the replicated encoder output."""
    B, T, _ = enc.shape
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if model_group(tp) is not None:
        e32 = tpar.enter_model(enc, tp)
        k, v = (tpar.column_parallel(e32, p[f"{prefix}_w{n}"], enc.dtype)
                for n in "kv")
        if cfg.qkv_bias:
            k = k + p[f"{prefix}_bk"]
            v = v + p[f"{prefix}_bv"]
        return k, v
    k = enc @ p[f"{prefix}_wk"]
    v = enc @ p[f"{prefix}_wv"]
    if cfg.qkv_bias:
        k = k + p[f"{prefix}_bk"]
        v = v + p[f"{prefix}_bv"]
    return k.reshape(B, T, K, hd), v.reshape(B, T, K, hd)


def cross_cache_block(k: torch.Tensor, cfg, tp) -> torch.Tensor:
    """:func:`project_kv_cross`'s column block (B, T, K hd / m) of K or V
    as the cross cache holds it over `tp`: the rank's kv heads (B, T,
    K / m, hd) when they divide the axis, else every head (B, T, K, hd),
    gathered (``serve_step``'s layout then keeps the rank's rows)."""
    B, T, _ = k.shape
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if K % tp.model == 0:
        return k.reshape(B, T, K // tp.model, hd)
    return pm.model_gather(k.contiguous(), tp, dim=-1).reshape(B, T, K, hd)


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


def _flash_decode_local(qg: torch.Tensor, kc: torch.Tensor,
                        vc: torch.Tensor, ksc: Optional[torch.Tensor],
                        vsc: Optional[torch.Tensor], pos, shard_start: int,
                        window: Optional[int], scale: float,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The online softmax of one query a row over a cache shard whose rows
    sit at global positions ``shard_start ..`` (the reference's
    ``_flash_decode_local``): ``KV_CHUNK`` rows (read at the call) at a
    time, an int8 chunk dequantised on its own (bf16 values times bf16
    scales), so no full-precision copy of the shard exists. Chunk-sized
    products run in the compute dtype (bf16 for an int8 cache, else the
    cache's), scores and the running max, numerator and denominator in
    float32. As in the reference, ``T_loc // chunk`` chunks are read, so a
    shard longer than ``KV_CHUNK`` and not a multiple of it raises (the
    reference leaves its last rows unread); a chunk whose rows are all
    masked (ahead of the row's position or outside its window) adds
    nothing: ``exp(-inf - -inf)`` is never let into the sums. With
    ``causal=False`` (a cross-attention cache) no row is masked and `pos`
    is not read.

    qg (B,1,K,G,D); kc / vc (B,T_loc,K,D); scales (B,T_loc,K) or None;
    `pos` as :func:`decode_positions` takes it. Returns the partials (m
    (B,K,G,1), num (B,K,G,1,D), den (B,K,G,1)), float32."""
    B, _, K, G, D = qg.shape
    if causal:
        pos = decode_positions(pos, B, qg.device)
    T = kc.shape[1]
    chunk = min(KV_CHUNK, T)
    if T % chunk:
        raise ValueError(
            f"a cache of {T} rows is longer than KV_CHUNK ({KV_CHUNK}) and "
            f"not a multiple of it: the chunked decode reads {T // chunk} "
            f"chunks and would never attend rows {T // chunk * chunk}-"
            f"{T - 1}; give the cache a multiple of {KV_CHUNK} rows")
    compute_dt = torch.bfloat16 if ksc is not None else kc.dtype
    qc = qg.to(compute_dt)
    f32 = torch.float32
    m = torch.full((B, K, G, 1), -torch.inf, dtype=f32, device=qg.device)
    num = torch.zeros((B, K, G, 1, D), dtype=f32, device=qg.device)
    den = torch.zeros((B, K, G, 1), dtype=f32, device=qg.device)
    for start in range(0, (T // chunk) * chunk, chunk):
        ks = kc[:, start:start + chunk]
        vs = vc[:, start:start + chunk]
        if ksc is not None:
            ks = ks.to(compute_dt) * ksc[:, start:start + chunk].to(
                compute_dt)[..., None]
            vs = vs.to(compute_dt) * vsc[:, start:start + chunk].to(
                compute_dt)[..., None]
        s = torch.einsum("bskgd,btkd->bkgst", qc, ks).to(f32) * scale
        if causal:
            s = s.masked_fill(pos.masked(shard_start + start, chunk,
                                         window), -torch.inf)
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
    return m, num, den


def _finish(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den of the online softmax, (B,K,G,1,D) -> (B,1,K,G,D)."""
    return (num / torch.clamp(den[..., None], min=1e-30)).movedim(3, 1)


def _decode_attention_chunked(qg: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos,
                              window: Optional[int],
                              k_scale: Optional[torch.Tensor],
                              v_scale: Optional[torch.Tensor],
                              scale: float) -> torch.Tensor:
    """Online-softmax (flash-decode) attention of one query a row against
    a long, optionally int8 cache (:func:`_flash_decode_local` over the
    whole cache, then num / den). qg (B,1,K,G,D); caches (B,T,K,D); scales
    (B,T,K) or None. Returns (B,1,K,G,D) float32."""
    _, num, den = _flash_decode_local(qg, k_cache, v_cache, k_scale,
                                      v_scale, pos, 0, window, scale)
    return _finish(num, den)


def combine_partials(parts: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]]) -> torch.Tensor:
    """The sharded flash decode's combine of every shard's (m, num, den),
    in shard order, on one process: the maximum of the m's, then num and
    den each weighted by exp(m - max) and summed in float32 shard by
    shard, as :func:`flash_decode_combine` sums them over a group.
    Returns (B,1,K,G,D) float32."""
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    num = den = None
    for m, n, d in parts:
        w = torch.exp(m - top)
        num = n * w[..., None] if num is None else num + n * w[..., None]
        den = d * w if den is None else den + d * w
    return _finish(num, den)


def flash_decode_combine(m: torch.Tensor, num: torch.Tensor,
                         den: torch.Tensor, mesh, names: Sequence[str]
                         ) -> torch.Tensor:
    """The reference's combine of ``flash_decode_sharded`` over the line
    of `names` of `mesh`: ``pmax`` of m, then ``psum`` of num and den
    weighted by exp(m - max), the sums in shard order (model-index order;
    data-major over ("data", "model")), which is :func:`combine_partials`'
    arithmetic. Only (B, K, G, D)-sized partials cross the group: the
    maximum, then num and den in one sum."""
    top = pm.model_max(m, mesh, names)
    w = torch.exp(m - top)
    both = torch.cat([(num * w[..., None]).reshape(-1), (den * w).reshape(
        -1)])
    both = pm.model_sum(both, mesh, names)
    return _finish(both[:num.numel()].view(num.shape),
                   both[num.numel():].view(den.shape))


def _masked_local_update(cache: torch.Tensor, new: torch.Tensor, pos,
                         shard_start: int) -> None:
    """cache[b, pos[b] - shard_start] = new[b, 0] in place for each row
    whose position lands in this shard (the reference's
    ``_masked_local_update``); other rows leave the shard as it is."""
    pos = decode_positions(pos, new.shape[0], new.device)
    local = pos.pos - shard_start
    if local.is_meta:
        # the dry run knows no position: count the rank whose shard holds
        # every row's, the most one rank writes
        rows = torch.arange(new.shape[0], device=new.device)
    else:
        rows = ((local >= 0) & (local < cache.shape[1])).nonzero()[:, 0]
    if rows.numel():
        val = new[rows, 0]
        cache[rows, local[rows]] = (val if val.dtype == cache.dtype
                                    else val.to(cache.dtype))


def _should_flash_decode(num_kv_heads: int, seq_len: int, model: int
                         ) -> bool:
    """The reference's gate of the sharded flash decode: a model axis whose
    size the kv heads do not divide (so the cache is sequence-sharded),
    a cache of at least 4096 rows that divide over it."""
    return (model > 1 and num_kv_heads % model != 0
            and seq_len % model == 0 and seq_len >= 4096)


#: the decode path each layer took over a model group, by kind: "heads"
#: (a heads-sharded cache), "flash_sharded" (a sequence-sharded cache that
#: ``_should_flash_decode`` sends to the sharded flash decode),
#: "sharded_short" (a sequence-sharded cache shorter than its gate: the
#: port takes the same sharded online softmax), "replicated" (a cache no
#: axis shards), and for a cross-attention cache "cross_heads",
#: "cross_sharded" (the sharded online softmax, unmasked) and
#: "cross_replicated"; :func:`reset_decode_paths` zeroes it
DECODE_PATHS: collections.Counter = collections.Counter()


def reset_decode_paths() -> collections.Counter:
    """Zero :data:`DECODE_PATHS`; returns the counts before."""
    old = collections.Counter(DECODE_PATHS)
    DECODE_PATHS.clear()
    return old


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
    tp=None, seq_names: Sequence[str] = (), seq_len: int = 0,
    project_out: bool = True,
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
    layers. Returns the sublayer's output.

    Over a model group `tp` the weights are the rank's slices and the
    caches its block of the serving layout: when the kv heads divide the
    axis, its heads (the single-device path on its heads, the output's
    partials summed over the group); else the rows of the global cache of
    `seq_len` rows that the axes `seq_names` give it (``("model",)``, or
    ``("data", "model")`` at batch 1; none: the whole cache). Such a cache
    takes the sharded flash decode (:func:`_flash_decode_local` and
    :func:`flash_decode_combine`): where ``_should_flash_decode`` says so,
    as the reference, and, where the reference would read its cache whole
    (fewer than 4096 rows), the same sharded online softmax, held to the
    reference's plain decode within the tests' tolerance. With
    ``project_out=False`` the attention's output before ``wo`` (B, 1,
    H*hd) is returned."""
    if model_group(tp) is not None:
        return _tp_decode_attention(
            p, prefix, x, cfg, tp, k_cache=k_cache, v_cache=v_cache,
            pos=pos, use_rope=use_rope, window=window, k_scale=k_scale,
            v_scale=v_scale, seq_names=tuple(seq_names), seq_len=seq_len)
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
    out = out.reshape(B, 1, H * hd)
    return out @ p[f"{prefix}_wo"] if project_out else out


def _tp_decode_attention(p: dict, prefix: str, x: torch.Tensor, cfg, tp, *,
                         k_cache, v_cache, pos, use_rope, window, k_scale,
                         v_scale, seq_names, seq_len) -> torch.Tensor:
    """:func:`decode_self_attention` over the model group `tp`."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m, r = tp.model, tp.axis_index("model")
    pos = decode_positions(pos, B, x.device)
    if K % m == 0:
        DECODE_PATHS["heads"] += 1
        out = decode_self_attention(
            p, prefix, x, _local_cfg(cfg, H // m, K // m), k_cache=k_cache,
            v_cache=v_cache, pos=pos, use_rope=use_rope, window=window,
            k_scale=k_scale, v_scale=v_scale, project_out=False)
        return tpar.row_parallel(out, p[f"{prefix}_wo"], tp)
    q, k, v = _tp_project_qkv(p, prefix, x, cfg, tp)
    # the new token's q, k and v columns of every rank, in one gather
    cols = [t.shape[-1] for t in (q, k, v)]
    qkv = pm.model_gather(torch.cat([q, k, v], dim=-1), tp, dim=0).view(
        m, B, 1, sum(cols))
    q, k, v = (t.movedim(0, 2).reshape(B, 1, -1) for t in qkv.split(cols,
                                                                   dim=-1))
    q, k, v = (q.reshape(B, 1, H, hd), k.reshape(B, 1, K, hd),
               v.reshape(B, 1, K, hd))
    if use_rope and cfg.rope_theta:
        cos, sin = pos.rope(hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    quantized = k_scale is not None
    t_loc = k_cache.shape[1]
    shard = pm.line_index(tp, seq_names) if seq_names else 0
    start = shard * t_loc
    if quantized:
        (kq, ksc), (vq, vsc) = quantize_kv(k), quantize_kv(v)
        for cache, new in ((k_cache, kq), (v_cache, vq), (k_scale, ksc),
                           (v_scale, vsc)):
            _masked_local_update(cache, new, pos, start)
    else:
        _masked_local_update(k_cache, k, pos, start)
        _masked_local_update(v_cache, v, pos, start)
    qg = q.reshape(B, 1, K, H // K, hd)
    if seq_names:
        DECODE_PATHS["flash_sharded" if _should_flash_decode(
            K, seq_len, m) else "sharded_short"] += 1
        parts = _flash_decode_local(qg, k_cache, v_cache, k_scale, v_scale,
                                    pos, start, window, hd ** -0.5)
        out = flash_decode_combine(*parts, tp, seq_names).to(x.dtype)
    else:
        DECODE_PATHS["replicated"] += 1
        out = _decode_attention_chunked(qg, k_cache, v_cache, pos, window,
                                        k_scale, v_scale, hd ** -0.5
                                        ).to(x.dtype)
    cols = H * hd // m
    out = out.reshape(B, 1, H * hd)[..., r * cols:(r + 1) * cols]
    return tpar.row_parallel(out, p[f"{prefix}_wo"], tp)


def decode_cross_attention(p: dict, prefix: str, x: torch.Tensor, cfg,
                           xk: torch.Tensor, xv: torch.Tensor, tp=None,
                           seq_names: Sequence[str] = ()) -> torch.Tensor:
    """One token's cross-attention sublayer against the cross cache xk /
    xv (B, T_src, K, hd), every row read (the reference's zero padding
    too). Over a model group `tp` the cache is the rank's block of
    ``serve_step.cache_leaf_spec``'s layout: its kv heads (the rank's q
    heads against them), or the rows the axes `seq_names` give it (every
    q head, gathered, through the sharded online softmax without the
    causal mask), or whole (every q head); the output's partials are
    summed over the group."""
    if model_group(tp) is None:
        return cross_attention_block(p, prefix, x, xk, xv, cfg)
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m, r = tp.model, tp.axis_index("model")
    q = tpar.column_parallel(tpar.enter_model(x, tp), p[f"{prefix}_wq"],
                             x.dtype)
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"]
    if K % m == 0:
        DECODE_PATHS["cross_heads"] += 1
        out = attention(q.reshape(B, 1, H // m, hd), xk, xv, causal=False)
        return tpar.row_parallel(out.reshape(B, 1, H // m * hd),
                                 p[f"{prefix}_wo"], tp)
    q = pm.model_gather(q.contiguous(), tp, dim=-1).reshape(B, 1, H, hd)
    if seq_names:
        DECODE_PATHS["cross_sharded"] += 1
        start = pm.line_index(tp, seq_names) * xk.shape[1]
        parts = _flash_decode_local(q.reshape(B, 1, K, H // K, hd), xk, xv,
                                    None, None, None, start, None,
                                    hd ** -0.5, causal=False)
        out = flash_decode_combine(*parts, tp, seq_names).to(x.dtype)
    else:
        DECODE_PATHS["cross_replicated"] += 1
        out = attention(q, xk, xv, causal=False)
    cols = H * hd // m
    out = out.reshape(B, 1, H * hd)[..., r * cols:(r + 1) * cols]
    return tpar.row_parallel(out, p[f"{prefix}_wo"], tp)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_mlp(p: dict, prefix: str, x: torch.Tensor, tp=None
               ) -> torch.Tensor:
    """SwiGLU MLP; over a model group `tp`, gate and up column-parallel
    and down row-parallel, its partials summed over the group."""
    tp = model_group(tp)
    if tp is not None:
        x32 = tpar.enter_model(x, tp)
        gate, up = (tpar.column_parallel(x32, p[f"{prefix}_w_{n}"], x.dtype)
                    for n in ("gate", "up"))
        return tpar.row_parallel(F.silu(gate) * up, p[f"{prefix}_w_down"], tp)
    gate = x @ p[f"{prefix}_w_gate"]
    up = x @ p[f"{prefix}_w_up"]
    return (F.silu(gate) * up) @ p[f"{prefix}_w_down"]


# ---------------------------------------------------------------------------
# embedding / loss
# ---------------------------------------------------------------------------


def vocab_group(table: torch.Tensor, vocab: int, tp=None):
    """`tp` when the table (V, d) holds a vocab shard, None when it is
    whole on every rank (``param_spec`` drops ``"model"`` from a
    vocabulary the axis does not divide: whisper's, mamba2's at 16): a
    whole table takes the plain lookup, whole logits and the plain
    float32 CE, every rank computing the same bits."""
    tp = model_group(tp)
    return tp if tp is not None and table.shape[0] != vocab else None


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, tp=None
                 ) -> torch.Tensor:
    """The tokens' rows of `table`; over a model group `tp`, of the
    rank's vocab-sharded table, summed over the group."""
    if model_group(tp) is not None:
        return tpar.embed_tokens(table, tokens, tp)
    return F.embedding(tokens, table)


def unembed(table: torch.Tensor, h: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits ``h @ table.T`` in h's dtype; over a model group `tp`, the
    rank's vocab shard of them (h enters the group; a column-parallel
    product)."""
    if model_group(tp) is not None:
        return tpar.column_parallel(tpar.enter_model(h, tp), table.T,
                                    h.dtype)
    return h @ table.T


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, tp=None
                       ) -> torch.Tensor:
    """Mean next-token CE; logits (B,S,V) bf16/f32, targets (B,S) int.
    float32 logsumexp; the gradient reaches the logits in their dtype.
    Over a model group `tp` the logits are the rank's vocab shard and the
    CE is vocab-parallel (``tensor_parallel.cross_entropy``)."""
    if model_group(tp) is not None:
        return tpar.cross_entropy(logits, targets, tp)
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)
