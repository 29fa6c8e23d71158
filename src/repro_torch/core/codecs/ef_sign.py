"""``ef_sign`` — error-feedback sign compression
(``repro.core.codecs.ef_sign``).

Per voter, with `v` the momentum and `e` the residual:

    t  = e + v                     (encode input)
    wire = sign(t)                 (the same 1-bit symbols as sign1bit)
    e' = t - mean|t| * vote        (residual against the APPLIED vote)

The wire is sign1bit's, so every strategy transports it. The helpers
below are the codec's arithmetic in place, as the trainer's hooks run it
on 26 GB of residual; ``encode_leaf`` / ``feedback_leaf`` are the
reference's out-of-place interface over the same helpers.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import VoteStrategy
from repro_torch.core.codecs.base import GradientCodec
from repro_torch.kernels import ops


def encode_(error: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """error <- error + values in place: the encode input t."""
    return error.add_(values)


#: elements of |t| made at a time by :func:`scale_of` (256 MB in float32)
SCALE_CHUNK = 1 << 26


def scale_of(t: torch.Tensor) -> torch.Tensor:
    """mean|t| as a 0-d float32 tensor: the 1-bit symbol carries no
    magnitude, so the residual prices the vote at the tensor's own mean
    amplitude. |t| is summed a chunk at a time, so no temporary as large
    as t is made. (``torch.linalg.vector_norm(t, 1)`` would make none at
    all, but on the CPU it sums in an order that loses ~1e-4 of the value
    on a 65,536-element leaf.)"""
    flat = t.reshape(-1)
    total = sum(c.abs().sum() for c in flat.split(SCALE_CHUNK))
    return total / flat.numel()


def feedback_(t: torch.Tensor, vote: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """t <- t - scale * vote in place, with no temporary when `vote`
    already has t's dtype (vote ±1/0: the product is exact, so there is
    one rounding, as in the reference)."""
    return t.addcmul_(vote.to(t.dtype), scale, value=-1.0)


class EFSignCodec(GradientCodec):
    name = "ef_sign"
    bits_per_param = 1.0
    supported_strategies = (VoteStrategy.PSUM_INT8,
                            VoteStrategy.ALLGATHER_1BIT,
                            VoteStrategy.HIERARCHICAL)
    worker_state = True

    def init_state(self, values: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(values)

    def encode_leaf(self, values: torch.Tensor,
                    state: Optional[torch.Tensor]) -> torch.Tensor:
        if state is None:
            return values
        return encode_(state.clone(), values)

    def feedback_leaf(self, encoded: torch.Tensor, vote: torch.Tensor,
                      state: Optional[torch.Tensor]) -> torch.Tensor:
        return feedback_(encoded.clone(), vote, scale_of(encoded))

    def encode_voter_(self, g: torch.Tensor, m: torch.Tensor, beta: float,
                      words: torch.Tensor, error: Optional[torch.Tensor]
                      ) -> torch.Tensor:
        """m' in place (no sign words: the wire carries t's), t = e + m'
        into the residual row, the signs of t into `words`; returns the
        voter's mean|t|."""
        ops.momentum_sign_pack(g, m, beta, m_out=m, pack=False)
        t = encode_(error, m)
        ops.bitpack(t.view(1, -1), out=words.view(1, -1))
        return scale_of(t)

    def feedback_voters_(self, votes: torch.Tensor,
                         error: Optional[torch.Tensor],
                         sent: List[torch.Tensor]) -> None:
        """e_r <- t_r - scale_r * vote for every voter r, the ±1 vote
        unpacked once in float32."""
        vote = ops.bitunpack(votes, error.shape[1], torch.float32)
        for r, scale in enumerate(sent):
            feedback_(error[r], vote, scale)
