"""``weighted_vote`` — reliability-weighted sign decoding
(``repro.core.codecs.weighted``; SignSGD-FD).

The server tracks how often each voter disagrees with the decoded vote
(an EMA `flip_ema`, shape (M,)) and decodes the Chair–Varshney weighted
vote

    w_m  = log((1 - p_m) / p_m)
    vote = sign( Σ_m w_m · s_m )          (ties → +1, the 1-bit wire rule)

The weights are quantised to multiples of 1/256, so every term and every
partial sum is an exact float32 multiple of 2^-8: the weighted sum is
exact in any order, which is what lets the port sum voter by voter and
still match the reference bit for bit. The codec rides only
``allgather_1bit`` (weighting needs the individual votes).

Mismatch counts are int64 here; the reference counts them in float32
(exact only below 2^24 coordinates per voter; ROADMAP.md Queue 3). Both
are divided by the coordinate count in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import VoteStrategy
from repro_torch.core import sign_compress as sc
from repro_torch.core.codecs.base import GradientCodec
from repro_torch.kernels import ops

#: EMA rate of the per-worker disagreement estimate
RHO = 0.5
#: flip-probability clip: bounds the weights to ±log((1-eps)/eps) and
#: keeps the all-zero prior finite
P_MIN = 0.05


def reliability_weights(flip_ema: torch.Tensor) -> torch.Tensor:
    """(M,) float32 flip-rate estimates -> (M,) Chair–Varshney log-odds
    weights, quantised to multiples of 1/256."""
    p = torch.clamp(flip_ema, P_MIN, 1.0 - P_MIN)
    return torch.round(torch.log((1.0 - p) / p) * 256.0) / 256.0


def stacked_signs(words: torch.Tensor, n: int) -> torch.Tensor:
    """(M, w) gathered 1-bit words -> (M, n) int8 ±1 signs, with one
    ``bitunpack`` launch. The bit-pack padding lanes are cropped BEFORE
    decoding: padding always agrees with the vote, so counting it would
    dilute the flip-rate observations by n/32w."""
    m = words.shape[0]
    return ops.bitunpack(words.view(-1), words.numel() * sc.PACK,
                         torch.int8).view(m, -1)[:, :n]


def decode_leaf_fixed(stacked: torch.Tensor,
                      w: Union[torch.Tensor, Sequence[float]]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, ...) ±1 signs + (M,) FIXED weights -> ((...) int8 ±1 vote,
    (M,) int64 per-voter mismatch counts against that vote).

    The weighted sum is accumulated one voter at a time in float32 (exact,
    see the module doc), so no (M, n) float tensor is made. Callers crop
    bit-pack padding lanes BEFORE calling."""
    weights = w.tolist() if torch.is_tensor(w) else list(w)
    wsum = torch.zeros(stacked.shape[1:], dtype=torch.float32,
                       device=stacked.device)
    for r, wr in enumerate(weights):
        wsum.add_(stacked[r], alpha=wr)
    vote = (wsum >= 0).to(torch.int8).mul_(2).sub_(1)
    mismatch = torch.stack([(stacked[r] != vote).sum()
                            for r in range(stacked.shape[0])])
    return vote, mismatch


def ema_update(flip_ema: torch.Tensor, mismatch: torch.Tensor,
               n: int) -> torch.Tensor:
    """One EMA step of the flip-rate estimates from `mismatch` counts over
    `n` coordinates, in float32 in the reference's order of operations,
    each subnormal operand and result flushed to a zero (an estimate that
    decays below 2^-126 becomes 0, as in XLA)."""
    f = sc.flush_subnormals
    observed = RHO * mismatch.to(torch.float32)
    # XLA turns the reference's division by the constant n into a product
    # with its float32 reciprocal; so does this, for equal bits
    inv_n = float(np.float32(1.0) / np.float32(n))
    return f(f((1.0 - RHO) * f(flip_ema)) + f(observed * inv_n))


def ema_update_fused(flip_ema: torch.Tensor, mismatch: torch.Tensor,
                     n: int) -> torch.Tensor:
    """:func:`ema_update` rounded as the reference's plan walk rounds it:
    under ``jit`` XLA fuses ``(1 - RHO) * ema + (RHO * mismatch) * (1 / n)``
    into one FMA, a single rounding of the sum. ``(1 - RHO) * ema`` is
    exact (a halving) and the product of two float32 values is exact in
    float64, so the float64 sum rounded to float32 is that FMA (up to a
    double rounding where the exact sum needs more than 53 bits)."""
    f = sc.flush_subnormals
    observed = f(RHO * mismatch.to(torch.float32)).double()
    inv_n = float(np.float32(1.0) / np.float32(n))
    total = (1.0 - RHO) * f(flip_ema).double() + observed * inv_n
    return f(total.to(torch.float32))


def decode_stacked(stacked: torch.Tensor, flip_ema: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, ...) ±1 signs + (M,) state -> ((...) int8 ±1 vote, (M,) new
    state): one decode and one EMA update; `stacked` must already be
    cropped to the true coordinate count."""
    vote, mismatch = decode_leaf_fixed(stacked,
                                       reliability_weights(flip_ema))
    return vote, ema_update(flip_ema, mismatch,
                            stacked.numel() // stacked.shape[0])


class WeightedVoteCodec(GradientCodec):
    name = "weighted_vote"
    bits_per_param = 1.0
    supported_strategies = (VoteStrategy.ALLGATHER_1BIT,)
    server_state = True

    def init_server_state(self, n_workers: int, device=None
                          ) -> Dict[str, torch.Tensor]:
        # all-zero = uninformed prior: equal weights, unweighted decode
        return {"flip_ema": torch.zeros((n_workers,), dtype=torch.float32,
                                        device=device)}

    def ties(self, strategy: VoteStrategy) -> str:
        return "plus_one"   # weighted sum >= 0 -> +1 (1-bit wire rule)

    # the trainer: weights fixed for the step; the mismatch counts of all
    # leaves make one EMA update (as the reference's tree vote does)

    def begin_step(self, server_state: Optional[Dict[str, torch.Tensor]]
                   ) -> Dict:
        ema = server_state["flip_ema"]
        return {"weights": reliability_weights(ema).tolist(),
                "mismatch": torch.zeros_like(ema, dtype=torch.int64),
                "coords": 0}

    def vote_(self, words: torch.Tensor, n: int, ctx: Dict,
              two_bit: bool, ties: str = "plus_one") -> torch.Tensor:
        """The weighted vote of the leaf's (M, w) 1-bit words, repacked to
        1-bit words for ``apply_vote``; its mismatches go into `ctx`."""
        vote, mismatch = decode_leaf_fixed(stacked_signs(words, n),
                                           ctx["weights"])
        ctx["mismatch"] += mismatch
        ctx["coords"] += n
        return ops.bitpack(vote.view(1, -1))[0]

    def end_step(self, server_state: Optional[Dict[str, torch.Tensor]],
                 ctx: Dict) -> None:
        ema = server_state["flip_ema"]
        ema.copy_(ema_update(ema, ctx["mismatch"], ctx["coords"]))
