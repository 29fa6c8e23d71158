"""Time-varying coalitions: the adversary fraction / mode as a step
schedule (``repro.core.attacks.schedule``; DESIGN.md §15).

An :class:`AttackPhase` is a step-keyed override: *at* ``step`` the
coalition's ``fraction`` and/or ``mode`` change, and stay changed until a
later phase overrides them again; a field left ``None`` inherits. The
coalition is re-counted at each phase through the exact-``Fraction`` rule
(``byzantine.coalition_config``), so a schedule composes with elastic
rescale. ``step`` must be >= 1: the pre-run coalition is the spec's own.

Beside the schedule, the reference's tables of the adaptive modes'
observation channels (``attacks/engine.py``), which the Scenario Lab's
spec validation reads; the adaptive modes themselves are ROADMAP.md
Queue 1 item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

from repro_torch.core import byzantine
from repro_torch.core.byzantine import ATTACK_MODES

#: the observation channel each adaptive mode consumes
MODE_CHANNEL = {"adaptive_flip": "vote",
                "low_margin": "margin",
                "reputation": "reputation"}

#: legal values of AdversarySpec.observe
OBSERVE_CHANNELS = ("none", "vote", "margin", "reputation")


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


@dataclasses.dataclass(frozen=True)
class AttackPhase:
    """At ``step``, override the coalition's ``fraction`` and/or
    ``mode`` (``None`` inherits the value in force)."""

    step: int
    fraction: Optional[float] = None
    mode: Optional[str] = None

    def __post_init__(self):
        if self.step < 1:
            raise ValueError(
                f"AttackPhase.step must be >= 1 (got {self.step}); the "
                "pre-run coalition is the AdversarySpec's own "
                "mode/fraction, not a phase")
        if self.fraction is None and self.mode is None:
            raise ValueError(
                f"AttackPhase(step={self.step}) overrides nothing — "
                "set fraction and/or mode")
        if self.fraction is not None and not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"AttackPhase.fraction must be in [0, 1], "
                             f"got {self.fraction}")
        if (self.mode is not None and self.mode not in byzantine.MODES
                and self.mode not in ATTACK_MODES):
            raise ValueError(
                f"unknown AttackPhase.mode {self.mode!r}; have "
                f"{byzantine.MODES} plus adaptive {ATTACK_MODES}")


def validate_schedule(schedule: Sequence[AttackPhase]) -> None:
    """Reject non-phase entries and steps that do not strictly increase."""
    prev = 0
    for p in schedule:
        if not isinstance(p, AttackPhase):
            raise ValueError(f"schedule entries must be AttackPhase, "
                             f"got {type(p).__name__}")
        if p.step <= prev:
            raise ValueError(
                f"AttackPhase steps must be strictly increasing, got "
                f"step {p.step} after {prev}")
        prev = p.step


def phase_at(schedule: Sequence[AttackPhase], base_mode: str,
             base_fraction: float, step: int) -> Tuple[str, float]:
    """The (mode, fraction) in force at ``step``: the base values with every
    phase whose ``step`` <= the query applied in order."""
    mode, fraction = base_mode, base_fraction
    for p in schedule:
        if p.step > step:
            break
        if p.mode is not None:
            mode = p.mode
        if p.fraction is not None:
            fraction = p.fraction
    return mode, fraction


def modes_used(schedule: Sequence[AttackPhase],
               base_mode: str) -> Tuple[str, ...]:
    """Every mode the run can be in (base + overrides)."""
    modes = [base_mode] + [p.mode for p in schedule if p.mode is not None]
    return tuple(dict.fromkeys(modes))


__all__ = ["ATTACK_MODES", "MODE_CHANNEL", "OBSERVE_CHANNELS", "AttackPhase",
           "modes_used", "phase_at", "required_channel", "validate_schedule"]
