"""Virtual mesh: the production vote pipeline over a stacked voter dim
(``repro.sim.virtual_mesh``).

The host-side execution lives in
:class:`repro_torch.core.vote_api.VirtualBackend`: the strategies' own
pack / tally / unpack stages with only the exchange replaced by its exact
equivalent over the stacked voter dim (a psum is a sum over the voters,
an all-gather is the stack itself, a reduce-scatter a sum split into M
shards). This module keeps the reference's ``virtual_*`` entry points and
:class:`VirtualVoteEngine`, the stacked-engine wrapper the failure drills
drive. Each takes the backend's `device` (``"cuda"`` unless told
otherwise).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.configs.base import ByzantineConfig, VoteStrategy
from repro_torch.core import vote_api as va


def virtual_vote(signs, strategy: VoteStrategy,
                 device: DeviceLike = None) -> torch.Tensor:
    """(M, n) stacked int8 signs -> (n,) int8 majority through the
    strategy's own pack / tally / unpack stages (exchange virtualised)."""
    return va.VirtualBackend(device=device).execute(va.VoteRequest(
        payload=signs, form="stacked", strategy=strategy)).votes


def virtual_vote_codec(signs, strategy: VoteStrategy,
                       codec: str = "sign1bit", server_state=None,
                       device: DeviceLike = None):
    """(M, n) stacked int8 signs -> ((n,) int8 majority, new server state)
    through the codec's wire stages."""
    out = va.VirtualBackend(device=device).execute(va.VoteRequest(
        payload=signs, form="stacked", strategy=strategy, codec=codec,
        server_state=server_state))
    return out.votes, out.server_state


def virtual_plan_vote(signs, plan, server_state=None,
                      device: DeviceLike = None):
    """(M, n_params) stacked int8 signs -> ((n_params,) int8 votes, new
    server state) through a ``VotePlan``'s bucket schedule."""
    out = va.VirtualBackend(device=device).execute(va.VoteRequest(
        payload=signs, form="stacked", plan=plan,
        server_state=server_state))
    return out.votes, out.server_state


@dataclasses.dataclass(frozen=True)
class VirtualVoteEngine:
    """Stacked-voter-dim engine semantics over
    :class:`~repro_torch.core.vote_api.VirtualBackend`: ternary sign
    extraction, then stale-vote substitution, then the Byzantine model
    (the same ``core.byzantine`` transforms and keys; voter index = row
    index), then the strategy's wire, in the pinned ``FailureSpec``
    order."""

    strategy: VoteStrategy
    byz: Optional[ByzantineConfig] = None
    salt: int = 0
    codec: str = "sign1bit"
    device: DeviceLike = None

    def _backend(self) -> va.VirtualBackend:
        return va.VirtualBackend(device=self.device)

    def effective_signs(self, values, prev_signs=None, n_stale: int = 0,
                        step: Optional[int] = None) -> torch.Tensor:
        """The (M, n) int8 sign tensor that reaches the wire: sign
        extraction -> stale substitution -> adversary perturbation."""
        x = torch.as_tensor(values, device=self._backend().device)
        if x.dtype == torch.float64:     # JAX's 64-bit mode is off
            x = x.to(torch.float32)
        return va.effective_stacked_signs(x, prev_signs, n_stale, self.byz,
                                          step, self.salt)

    def _request(self, values, prev=None, n_stale: int = 0, step=None):
        return va.VoteRequest(
            payload=values, form="stacked", strategy=self.strategy,
            codec=self.codec,
            failures=va.FailureSpec(n_stale=n_stale, byz=self.byz),
            prev=prev, step=step, salt=self.salt)

    def vote(self, values, step: Optional[int] = None) -> torch.Tensor:
        """(M, n) stacked voter-local values -> (n,) int8 majority."""
        return self._backend().execute(self._request(values,
                                                     step=step)).votes

    def vote_with_failures(self, values, prev_signs=None, n_stale: int = 0,
                           step: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One aggregation under failures; returns (vote, the signs that
        reached the wire, ``VoteOutcome.wire_signs``)."""
        out = self._backend().execute(
            self._request(values, prev_signs, n_stale, step))
        return out.votes, out.wire_signs


__all__ = ["VirtualVoteEngine", "virtual_plan_vote", "virtual_vote",
           "virtual_vote_codec"]
