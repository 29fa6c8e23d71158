"""``sign1bit`` — the paper's codec (``repro.core.codecs.sign1bit``).

Encode is the identity (the wire takes the signs of whatever it is
handed), decode is the strategy's own unweighted majority; no state on
either side. Every wire strategy transports it, at the strategy's native
width.
"""
from __future__ import annotations

from repro_torch.configs.base import VoteStrategy
from repro_torch.core.codecs.base import GradientCodec


class Sign1BitCodec(GradientCodec):
    name = "sign1bit"
    bits_per_param = 1.0
    supported_strategies = (VoteStrategy.PSUM_INT8,
                            VoteStrategy.ALLGATHER_1BIT,
                            VoteStrategy.HIERARCHICAL)
