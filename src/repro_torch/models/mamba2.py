"""Mamba2 / SSD (state-space duality) mixer (``repro.models.mamba2``; Dao &
Gu, arXiv:2405.21060): the chunked-scan training path, and the decode
step, which carries ``{ssm (B, H, P, N) float32, conv (B, W-1, CD)}``.

The sequence is cut into chunks of ``cs`` positions: within a chunk the
output is a masked quadratic (attention-like) term, across chunks a linear
recurrence carries the (H, P, N) state, one B / C group as in
mamba2-2.7b. ``cs = min(chunk_size, S)``, halved until it divides S.

Dtypes follow the reference: the (B, S, d_inner) tensors and the
intra-chunk decay matrix ``L`` stay in the activation dtype; ``dt``, the
decays, their cumulative sums and the state recurrence are float32
(``softplus`` of the float32 ``dt + dt_bias``); the chunk states are a
float32 product of activation-dtype operands (the reference's
``preferred_element_type=float32``: the operands' products are exact in
float32 and summed there). The three-operand products are written as two
steps each, in the order given below; XLA picks its own order, so a bf16
forward agrees with the reference's to a bf16 tolerance, not bit for bit.
Autograd gives the backward.

Over a model group (`tp`; ``distributed.tensor_parallel``) a rank holds
its heads: z, xBC and dt are column-parallel, the conv runs on its
channels, xBC is then gathered and the rank takes its heads' x columns and
the whole of B and C; the gated RMSNorm sums its squares over the group
and ``out_proj`` is row-parallel. Decoding, the state is the rank's heads
and the conv window its channels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.models.layers import model_group, rms_norm


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., S) -> (..., S, S) with out[..., i, j] = sum_{j < k <= i}
    x_k, and -inf above the diagonal: written with ``torch.where`` before
    any ``exp``, since above the diagonal the difference of a decreasing
    cumulative sum is positive and its ``exp`` could overflow (and make
    NaN in the backward) if it were taken first and masked after."""
    S = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """Depthwise causal convolution: x (B, S, C), w (W, C), b (C,); the
    taps added in order from zeros, then the bias."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b


def _project(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
             tp=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three aligned input projections (z | xBC | dt); over a model
    group `tp` the rank's columns of each, column-parallel."""
    names = ("zproj", "xbcproj", "dtproj")
    if tp is None:
        return tuple(x @ p[f"{prefix}_{n}"] for n in names)
    x32 = tpar.enter_model(x, tp)
    return tuple(tpar.column_parallel(x32, p[f"{prefix}_{n}"], x.dtype)
                 for n in names)


def _split_xbc(xBC: torch.Tensor, di: int, N: int, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, B, C) of the conv's output; over a model group `tp` the
    rank's column block is gathered first (its backward a reduce-scatter)
    and x is the rank's heads' columns: the blocks do not line up with the
    x / B / C split."""
    if tp is None:
        return torch.split(xBC, [di, N, N], dim=-1)
    xBC = tpar.gather_from_model(xBC, tp, dim=-1)
    cols = di // tp.model
    r = tp.axis_index("model")
    return (xBC[..., r * cols:(r + 1) * cols], xBC[..., di:di + N],
            xBC[..., di + N:])


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float, di: int,
                tp=None) -> torch.Tensor:
    """The RMSNorm over the whole ``d_inner`` of y (the rank's columns over
    a model group `tp`: the float32 sum of squares summed over the group
    in model-index order), in :func:`rms_norm`'s casts."""
    if tp is None:
        return rms_norm(y, scale, eps)
    y32 = y.to(torch.float32)
    ss = tpar.group_sum((y32 * y32).sum(-1), tp)
    inv = torch.rsqrt(ss / di + eps)
    return y * inv.to(y.dtype)[..., None] * scale.to(y.dtype)


def _out_proj(y: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    return y @ w if tp is None else tpar.row_parallel(y, w, tp)


def chunk_size(cfg, S: int) -> int:
    """The SSD chunk length for a sequence of S positions."""
    cs = min(cfg.ssm.chunk_size, S)
    while S % cs:
        cs //= 2
    return cs


def mamba2_forward(p: Dict[str, torch.Tensor], x_in: torch.Tensor, cfg,
                   prefix: str = "mamba", tp=None) -> torch.Tensor:
    """One Mamba2 mixer (no residual): x_in (B, S, d) -> (B, S, d); over a
    model group `tp` on the rank's heads (see the module doc)."""
    s = cfg.ssm
    B, S, d = x_in.shape
    tp = model_group(tp)
    m = 1 if tp is None else tp.model
    di, N, nh, P = s.d_inner(d), s.state_dim, s.n_heads(d) // m, s.head_dim
    cs = chunk_size(cfg, S)
    nc = S // cs

    z, xBC, dt = _project(p, prefix, x_in, tp)
    xBC = F.silu(causal_conv1d(xBC, p[f"{prefix}_conv_w"],
                               p[f"{prefix}_conv_b"]))
    x, B_, C_ = _split_xbc(xBC, di, N, tp)

    dt = F.softplus(dt.to(torch.float32) + p[f"{prefix}_dt_bias"])
    A = -torch.exp(p[f"{prefix}_A_log"].to(torch.float32))      # (nh,)

    cdt = x_in.dtype
    xh = x.reshape(B, nc, cs, nh, P).to(cdt)
    Bc = B_.reshape(B, nc, cs, N).to(cdt)
    Cc = C_.reshape(B, nc, cs, N).to(cdt)
    dtc = dt.reshape(B, nc, cs, nh)                             # float32
    dA = dtc * A                                                # (b,c,l,h)
    dA_cs = torch.cumsum(dA, dim=2)
    xdt = xh * dtc[..., None].to(cdt)

    # intra-chunk (quadratic) term: L (b,c,h,l,s) in the activation dtype
    L = torch.exp(_segsum(dA.transpose(-1, -2))).to(cdt)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)            # (b,c,l,s)
    Y_diag = torch.einsum("bchls,bcshp->bclhp", scores[:, :, None] * L,
                          xdt)

    # chunk states (a float32 product of activation-dtype operands) and
    # the recurrence across chunks in float32
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (b,c,l,h)
    states = torch.einsum(
        "bcln,bclhp->bchpn", Bc.to(torch.float32),
        decay_states.to(cdt).to(torch.float32)[..., None]
        * xdt.to(torch.float32))
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                 # (b,c,h)
    carry = torch.zeros((B, nh, P, N), dtype=torch.float32,
                        device=x_in.device)
    entering = []                         # the state entering each chunk
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)                  # (b,c,h,p,n)

    state_decay = torch.exp(dA_cs)                              # (b,c,l,h)
    Y_off = (torch.einsum("bcln,bchpn->bclhp", Cc, prev_states.to(cdt))
             * state_decay.to(cdt)[..., None])

    Y = (Y_diag + Y_off).reshape(B, S, nh, P)
    Y = Y + xh.reshape(B, S, nh, P) * p[f"{prefix}_D"].to(cdt)[:, None]
    Y = Y.reshape(B, S, nh * P)

    # gated RMSNorm, then the output projection
    Y = Y * F.silu(z).to(cdt)
    Y = _gated_norm(Y, p[f"{prefix}_norm_scale"], cfg.norm_eps, di, tp)
    return _out_proj(Y, p[f"{prefix}_out_proj"], tp)


# ---------------------------------------------------------------------------
# decode (single-token) path
# ---------------------------------------------------------------------------


def mamba2_init_state(cfg, batch: int, dtype: torch.dtype = torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    """Zero decode state: the float32 SSM state (B, H, P, N) and the last
    W-1 inputs of the causal conv (B, W-1, conv_dim) in `dtype`."""
    s, d = cfg.ssm, cfg.d_model
    return {
        "ssm": torch.zeros((batch, s.n_heads(d), s.head_dim, s.state_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, s.conv_dim(d)),
                            dtype=dtype, device=device),
    }


def mamba2_decode_step(p: Dict[str, torch.Tensor], x_in: torch.Tensor,
                       state: Dict[str, torch.Tensor], cfg,
                       prefix: str = "mamba", tp=None) -> torch.Tensor:
    """x_in (B,1,d) -> out (B,1,d); `state` {'ssm','conv'} (views of the
    stacked cache) is advanced in place. The conv reads its window, the
    state's W-1 columns and the new one; the decays and the state update
    are float32 (``softplus`` and ``exp`` of float32 operands). Over a
    model group `tp` the state is the rank's heads and channels, and the
    conv's output row (B, conv_dim) is gathered."""
    s = cfg.ssm
    B, _, d = x_in.shape
    tp = model_group(tp)
    m = 1 if tp is None else tp.model
    di, N, nh, P = s.d_inner(d), s.state_dim, s.n_heads(d) // m, s.head_dim
    f32 = torch.float32

    z, xBC, dt = _project(p, prefix, x_in[:, 0], tp)
    window = torch.cat([state["conv"], xBC[:, None, :]], dim=1)
    xBC = F.silu(torch.einsum("bwc,wc->bc", window, p[f"{prefix}_conv_w"])
                 + p[f"{prefix}_conv_b"])
    state["conv"].copy_(window[:, 1:])

    x, B_, C_ = _split_xbc(xBC, di, N, tp)
    dt = F.softplus(dt.to(f32) + p[f"{prefix}_dt_bias"])
    A = -torch.exp(p[f"{prefix}_A_log"].to(f32))
    dA = torch.exp(dt * A)                                      # (B,nh)

    xh = x.reshape(B, nh, P).to(f32)
    xdt = xh * dt[..., None]
    ssm = state["ssm"] * dA[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xdt, B_.to(f32))
    state["ssm"].copy_(ssm)
    y = torch.einsum("bhpn,bn->bhp", ssm, C_.to(f32))
    y = y + xh * p[f"{prefix}_D"].to(f32)[:, None]
    y = y.reshape(B, nh * P) * F.silu(z.to(f32))
    y = _gated_norm(y.to(x_in.dtype), p[f"{prefix}_norm_scale"],
                    cfg.norm_eps, di, tp)
    return _out_proj(y, p[f"{prefix}_out_proj"], tp)[:, None, :]
