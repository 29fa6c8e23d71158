"""``ternary2bit`` — abstain-capable 2-bit packed wire
(``repro.core.codecs.ternary``).

Ternary symbols {-1, 0, +1} packed 16 per word in 2-bit fields
(``sign_compress.pack_ternary``): on ``allgather_1bit``'s exchange the
2-bit words replace the 1-bit words, so the wire costs 2 bits/param and
keeps abstention — the majority is the sign of the symbol sum, ties and
abstentions give 0. On ``psum_int8`` the symbols ARE the counts the
strategy already sums, so that transport is unchanged (and equal to
``sign1bit`` over it). ``hierarchical`` is excluded: its 1-bit
rebroadcast would binarise the decision. Stateless on both sides.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import VoteStrategy
from repro_torch.core.codecs.base import GradientCodec
from repro_torch.kernels import ops


class TernaryWire:
    """The 2-bit packed transport, shaped like a strategy's stages; the
    exchange is an all-gather of the words over the vote axes of a
    ``distributed.mesh.ProcessMesh`` (pod first, collapsed data-major, as
    ``allgather_1bit``'s), or is virtualised by the caller over a stacked
    voter dim. On a CUDA tensor pack, tally and unpack are the
    ``ternary_pack``, ``ternary_majority`` and ``ternary_unpack`` kernels.

    Unlike the reference, whose tally decodes to int8, ``tally`` keeps the
    majority packed (kernel 8 of the port's table repacks it, as the TPU
    kernel does) and ``unpack`` decodes it."""

    wire_bits_per_param = 2.0
    ties = "zero"

    def pack(self, signs: torch.Tensor, n_voters: int) -> torch.Tensor:
        """(M, n) int8 signs -> (M, ceil(n/16)) words, each row padded with
        abstaining fields on its own."""
        return ops.ternary_pack(signs)

    def exchange(self, wire: torch.Tensor, axes) -> torch.Tensor:
        """(rows, w) local words -> (M * rows, w) gathered over `axes`."""
        from repro_torch.core.vote_engine import STRATEGIES
        return STRATEGIES[VoteStrategy.ALLGATHER_1BIT].exchange(wire, axes)

    def tally(self, arrived: torch.Tensor, n_voters: int) -> torch.Tensor:
        """(M, w) gathered words -> (w,) packed ternary majority."""
        return ops.ternary_majority(arrived)

    def unpack(self, decision: torch.Tensor, n: int,
               dtype: torch.dtype) -> torch.Tensor:
        """(w,) packed majority -> (n,) {-1, 0, +1} in `dtype`."""
        return ops.ternary_unpack(decision, n).to(dtype)

    def vote(self, signs: torch.Tensor, axes=None) -> torch.Tensor:
        """(M, n) stacked int8 signs -> (n,) int8 majority; with vote
        `axes`, this rank's (n,) signs -> the majority over them."""
        if axes is None:
            m, n = signs.shape
            return self.unpack(self.tally(self.pack(signs, m), m), n,
                               torch.int8)
        from repro_torch.distributed.mesh import num_voters
        m, n = num_voters(axes), signs.shape[-1]
        arrived = self.exchange(self.pack(signs.view(1, -1), m), axes)
        return self.unpack(self.tally(arrived, m), n, torch.int8)


TERNARY_WIRE = TernaryWire()


class Ternary2BitCodec(GradientCodec):
    name = "ternary2bit"
    bits_per_param = 2.0
    supported_strategies = (VoteStrategy.PSUM_INT8,
                            VoteStrategy.ALLGATHER_1BIT)

    def ties(self, strategy: VoteStrategy) -> str:
        return "zero"   # ternary symbols carry abstention on every wire

    def two_bit(self, strategy: VoteStrategy) -> bool:
        # the trainer: 2-bit words, the ternary tally and apply on every
        # wire, so an abstaining coordinate stays where it is
        return True
