"""The GradientCodec interface (``repro.core.codecs.base``; DESIGN.md §8).

A codec decides what each voter puts on the wire and how the tally
decodes it. Of the reference's interface the port carries the wire side:
which strategies can transport the codec's symbols (``supported_
strategies``), at what width (``wire_bits``) and with which tie rule
(``ties``). The worker- and server-side state (``init_state``,
``encode_leaf``, ``init_server_state``, ...) arrives with the stateful
codecs (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

import abc
from typing import Tuple

from repro_torch.configs.base import VoteStrategy


class GradientCodec(abc.ABC):
    """One point on the compression/robustness frontier."""

    #: registry key (also the OptimizerConfig spelling)
    name: str
    #: wire bits per parameter on the codec's native packed exchange
    bits_per_param: float
    #: strategies whose exchange can transport this codec's symbols
    supported_strategies: Tuple[VoteStrategy, ...]

    def ties(self, strategy: VoteStrategy) -> str:
        """Decoded tie convention under `strategy` ("zero"/"plus_one")."""
        from repro_torch.core.vote_engine import STRATEGIES
        return STRATEGIES[strategy].ties

    def wire_bits(self, strategy: VoteStrategy) -> float:
        """Wire bits per param this codec puts on `strategy`'s exchange."""
        from repro_torch.core.vote_engine import STRATEGIES
        if strategy == VoteStrategy.ALLGATHER_1BIT:
            return self.bits_per_param
        return STRATEGIES[strategy].wire_bits_per_param

    def validate_strategy(self, strategy: VoteStrategy) -> None:
        if strategy not in self.supported_strategies:
            raise ValueError(
                f"codec {self.name!r} cannot ride strategy "
                f"{strategy.value!r}; supported: "
                f"{tuple(s.value for s in self.supported_strategies)}")
