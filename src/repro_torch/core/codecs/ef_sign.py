"""``ef_sign`` — error-feedback sign compression
(``repro.core.codecs.ef_sign``).

Per voter, with `v` the momentum (the gradient at beta = 0) and `e` the
residual:

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
from repro_torch.core import sign_compress as sc
from repro_torch.core.codecs.base import GradientCodec
from repro_torch.kernels import ops


def encode_(error: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """error <- error + values in place, a subnormal sum flushed to a zero
    of its sign (as the reference's XLA add): the encode input t."""
    return sc.flush_subnormals(error.add_(values), out=error)


#: elements of |t| made at a time by :func:`scale_of` (256 MB in float32)
SCALE_CHUNK = 1 << 26


def scale_of(t: torch.Tensor) -> torch.Tensor:
    """mean|t| as a 0-d tensor of t's dtype: the 1-bit symbol carries no
    magnitude, so the residual prices the vote at the tensor's own mean
    amplitude. As the reference's ``jnp.mean``, |t| is summed in float32,
    divided by the count in float32 and rounded to t's dtype (bf16 for
    bf16 momentum, so ``scale * vote`` and the feedback then round in
    bf16 too). |t| is summed a chunk at a time, so no temporary as large
    as t is made. (``torch.linalg.vector_norm(t, 1)`` would make none at
    all, but on the CPU it sums in an order that loses ~1e-4 of the value
    on a 65,536-element leaf.)"""
    flat = t.reshape(-1)
    total = sum(c.abs().sum(dtype=torch.float32)
                for c in flat.split(SCALE_CHUNK))
    return sc.flush_subnormals((total / flat.numel()).to(t.dtype))


def feedback_(t: torch.Tensor, vote: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """t <- t - scale * vote in place, with no temporary when `vote`
    already has t's dtype (vote ±1/0 and scale of t's dtype: the product
    is exact, so there is one rounding to t's dtype, as in the
    reference), then a subnormal result flushed to a zero of its sign."""
    return sc.flush_subnormals(t.addcmul_(vote.to(t.dtype), scale,
                                          value=-1.0), out=t)


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

    def vote_input_(self, m: torch.Tensor, error: Optional[torch.Tensor]
                    ) -> torch.Tensor:
        """t = e + m' into the residual row, in place."""
        return encode_(error, m)

    def raw_input_(self, g: torch.Tensor, error: Optional[torch.Tensor]
                   ) -> torch.Tensor:
        """t = e + g into the residual row, in place (beta = 0): a
        subnormal of g is read as a zero of its sign, as the reference's
        XLA add reads its operand."""
        return encode_(error, sc.flush_subnormals(g))

    def sent_(self, x: torch.Tensor) -> torch.Tensor:
        """The voter's mean|t|."""
        return scale_of(x)

    def feedback_voters_(self, votes: torch.Tensor,
                         error: Optional[torch.Tensor],
                         sent: List[torch.Tensor], two_bit: bool) -> None:
        """e_r <- t_r - scale_r * vote for every voter r, the vote (±1, or
        ±1/0 on the 2-bit wire) decoded once in the residual's dtype."""
        n = error.shape[1]
        vote = (ops.ternary_unpack(votes, n, error.dtype) if two_bit
                else ops.bitunpack(votes, n, error.dtype))
        self.feedback_decoded_(vote, error, sent)

    def feedback_decoded_(self, vote: torch.Tensor,
                          error: Optional[torch.Tensor],
                          sent: List[torch.Tensor]) -> None:
        for r, scale in enumerate(sent):
            feedback_(error[r], vote, scale)
