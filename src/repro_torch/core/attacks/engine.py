"""The stateful attack engine (``repro.core.attacks.engine``; DESIGN.md §15):
adversaries that observe the protocol and adapt.

An adaptive adversary is a :class:`~repro_torch.configs.base.ByzantineConfig`
mode like the oblivious ones, dispatched from ``core.byzantine.evil_signs_``
with the same predicate (``id < num_adversaries``) and the same
stale-then-adversary order. What it adds is an observation channel: a small
dict of tensors (the previous round's vote, its |tally| counts, or the
weighted vote's reputation EMA) passed as ``VoteRequest.attack_obs`` and
built by :class:`AttackState`, the attacker's memory, which the Scenario Lab
carries beside the server state and updates once a round from the published
outcome.

Modes (all deterministic given the observation; they draw no random
numbers):

* ``adaptive_flip`` (channel ``vote``) sends the negation of the previous
  round's vote, and its honest sign where that vote was 0;
* ``low_margin`` (channel ``margin``) negates the previous vote on the
  ``target_fraction`` of coordinates with the smallest previous |tally| and
  is honest elsewhere;
* ``reputation`` (channel ``reputation``) negates its signs while its own
  flip-EMA is below ``strike_below`` and is honest while it is not.

Numerics follow the reference's: ``low_margin``'s threshold is the k-th
smallest |count| with ``k = max(1, min(n, round(target_fraction * n)))``
under Python's round-half-even, and every coordinate at or below it
strikes, ties included; the counts enter the state as int32, wrapped as
JAX narrows an int64 array with 64-bit mode off. The reputation EMA is
``(1 - RHO) * rep + RHO * mis`` in float32 with ``RHO = 1/2``, so both
products are exact and the one rounding is the sum's; the dense update's
``mis`` is the mean that XLA computes under ``jit``, the mismatch count
times the float32 reciprocal of n.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ByzantineConfig
from repro_torch.core import sign_compress as sc
from repro_torch.core.byzantine import ATTACK_MODES
from repro_torch.core.codecs import weighted as _weighted

#: the observation channel each adaptive mode consumes
MODE_CHANNEL = {"adaptive_flip": "vote",
                "low_margin": "margin",
                "reputation": "reputation"}

#: legal values of AdversarySpec.observe / AttackState.observation
OBSERVE_CHANNELS = ("none", "vote", "margin", "reputation")

#: exactly the tensors each channel shows the attacker (the VoteRequest
#: validates attack_obs against this table)
CHANNEL_KEYS = {"none": (),
                "vote": ("prev_vote",),
                "margin": ("prev_vote", "prev_abs_counts"),
                "reputation": ("rep",)}


def required_channel(modes: Iterable[str]) -> str:
    """The one observation channel a set of (scheduled) modes needs, or
    ``"none"``; more than one distinct channel is an error."""
    chans = sorted({MODE_CHANNEL[m] for m in modes if m in MODE_CHANNEL})
    if len(chans) > 1:
        raise ValueError(
            f"attack schedule mixes observation channels {chans}; "
            "a schedule may hop fraction and mode but all adaptive "
            "modes in it must share one channel")
    return chans[0] if chans else "none"


def _obs_tensor(obs: Dict[str, Any], key: str, like: torch.Tensor
                ) -> torch.Tensor:
    return torch.as_tensor(obs[key], device=like.device)


def _low_margin_mask(abs_counts: torch.Tensor, prev_vote: torch.Tensor,
                    target_fraction: float) -> torch.Tensor:
    """The coordinates a ``low_margin`` adversary strikes: |count| at or
    below the k-th smallest (ties included) where the previous vote was not
    0."""
    n = abs_counts.shape[-1]
    k = max(1, min(n, int(round(target_fraction * n))))
    thresh = torch.sort(abs_counts).values[k - 1]
    return (abs_counts <= thresh) & (prev_vote != 0)


def adaptive_evil_signs_(signs: torch.Tensor, cfg: ByzantineConfig,
                         ids, obs: Optional[Dict[str, Any]]) -> torch.Tensor:
    """In place on the ``(rows, n)`` int8 `signs` of adversarial voters
    `ids` (logical indices): what each sends given the observation of the
    previous n-coordinate vote. Returns `signs`."""
    if obs is None:
        raise ValueError(
            f"adaptive mode {cfg.mode!r} needs its observation channel "
            f"({MODE_CHANNEL.get(cfg.mode)!r}) threaded as "
            "VoteRequest.attack_obs — build it with "
            "AttackState.observation()")
    if cfg.mode == "adaptive_flip":
        pv = _obs_tensor(obs, "prev_vote", signs).to(torch.int8)
        strike = pv != 0
        signs[:, strike] = -pv[strike]
        return signs
    if cfg.mode == "low_margin":
        pv = _obs_tensor(obs, "prev_vote", signs).to(torch.int8)
        counts = _obs_tensor(obs, "prev_abs_counts", signs)
        strike = _low_margin_mask(counts, pv, cfg.target_fraction)
        signs[:, strike] = -pv[strike]
        return signs
    if cfg.mode == "reputation":
        rep = _obs_tensor(obs, "rep", signs)
        idx = torch.as_tensor(ids, dtype=torch.int64, device=signs.device)
        strike = rep[idx] < float(np.float32(cfg.strike_below))
        signs[strike] = -signs[strike]
        return signs
    raise ValueError(f"unknown adaptive attack mode {cfg.mode!r}; "
                     f"have {ATTACK_MODES}")


# ---------------------------------------------------------------------------
# the attacker's memory
# ---------------------------------------------------------------------------


def _wrap_abs(counts) -> torch.Tensor:
    """|counts| as int32, the int64 counts first narrowed (two's-complement
    wrap) as JAX narrows them."""
    return torch.as_tensor(counts).to(torch.int32).abs()


@dataclasses.dataclass(frozen=True)
class AttackState:
    """The attacker's memory, one per scenario run, updated once a round
    from the published outcome, refit on elastic rescale / churn like the
    reliability EMA, and shown to attackers only through
    :meth:`observation`.

    ``prev_vote`` (n,) int8 and ``prev_abs_counts`` (n,) int32 describe the
    previous round's broadcast (zeros before the first round, which the
    adaptive modes read as: act honestly); ``rep`` (M,) float32 mirrors the
    weighted vote's flip-EMA over the logical population."""

    prev_vote: Any
    prev_abs_counts: Any
    rep: Any

    @classmethod
    def init(cls, n_coords: int, n_voters: int,
             device=None) -> "AttackState":
        return cls(
            prev_vote=torch.zeros(n_coords, dtype=torch.int8, device=device),
            prev_abs_counts=torch.zeros(n_coords, dtype=torch.int32,
                                        device=device),
            rep=torch.zeros(n_voters, dtype=torch.float32, device=device))

    def observation(self, channel: str) -> Optional[Dict[str, Any]]:
        """The dict an attacker on `channel` may see (None for ``"none"``):
        exactly :data:`CHANNEL_KEYS`, nothing more."""
        if channel not in OBSERVE_CHANNELS:
            raise ValueError(f"unknown observation channel {channel!r}; "
                             f"have {OBSERVE_CHANNELS}")
        keys = CHANNEL_KEYS[channel]
        if not keys:
            return None
        return {k: getattr(self, k) for k in keys}

    def refit(self, n_voters: int) -> "AttackState":
        """Elastic rescale / churn: the per-voter reputation axis truncates
        or zero-pads by the checkpoint rule (newcomers fully trusted); the
        per-coordinate tensors are untouched."""
        from repro_torch.checkpoint.checkpoint import refit_leading_axis
        return dataclasses.replace(
            self, rep=refit_leading_axis(self.rep, (n_voters,)))


def _ema(rep: torch.Tensor, mis: torch.Tensor) -> torch.Tensor:
    f = sc.flush_subnormals
    return f(f((1.0 - _weighted.RHO) * f(rep)) + f(_weighted.RHO * f(mis)))


def update_attack_state(state: AttackState, vote, counts,
                        eff) -> AttackState:
    """One round's observation on the dense path: the published vote, its
    per-coordinate signed tally and the ``(M, n)`` effective signs that
    reached the wire. ``rep`` replays the weighted vote's flip-EMA from the
    1-bit wire signs (an abstention goes on the wire as +1)."""
    eff = torch.as_tensor(eff)
    vote = torch.as_tensor(vote, device=eff.device)
    n = eff.shape[-1]
    wire = sc.nonneg(eff)
    mism = (wire != (vote >= 0)[None, :]).sum(dim=1)
    inv_n = float(np.float32(1.0) / np.float32(n))
    mis = sc.flush_subnormals(mism.to(torch.float32) * inv_n)
    return AttackState(prev_vote=torch.sign(vote).to(torch.int8),
                       prev_abs_counts=_wrap_abs(counts),
                       rep=_ema(state.rep, mis))


def update_attack_state_population(state: AttackState, vote, counts,
                                   ids, mis_frac) -> AttackState:
    """The population round's update: the EMA touches only the sampled
    logical `ids`; `mis_frac` is each sampled voter's mismatch fraction
    against the vote (float32, assembled chunk by chunk by the runner)."""
    rep = state.rep.clone()
    idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                          device=rep.device)
    mis = torch.as_tensor(np.asarray(mis_frac, np.float32), device=rep.device)
    rep[idx] = _ema(rep[idx], mis)
    return AttackState(prev_vote=torch.sign(torch.as_tensor(vote))
                       .to(torch.int8),
                       prev_abs_counts=_wrap_abs(counts), rep=rep)


__all__ = ["ATTACK_MODES", "AttackState", "CHANNEL_KEYS", "MODE_CHANNEL",
           "OBSERVE_CHANNELS", "adaptive_evil_signs_", "required_channel",
           "update_attack_state", "update_attack_state_population"]
