"""Time-varying coalitions (``repro.core.attacks``; DESIGN.md §15): the
step schedule of the adversary's fraction and mode.

Only the schedule is ported (:mod:`.schedule`). The adaptive modes, their
observation channels and ``breaking_point`` (``engine.py``,
``breaking_point.py``) are ROADMAP.md Queue 1 item 10; this package keeps
their names (``ATTACK_MODES``, ``MODE_CHANNEL``, ``OBSERVE_CHANNELS``) so
specs naming them validate as in the reference and then raise there.
"""
from repro_torch.core.attacks.schedule import (ATTACK_MODES, MODE_CHANNEL,
                                               OBSERVE_CHANNELS, AttackPhase,
                                               modes_used, phase_at,
                                               required_channel,
                                               validate_schedule)
from repro_torch.core.byzantine import build_config, coalition_config

__all__ = [
    "ATTACK_MODES", "MODE_CHANNEL", "OBSERVE_CHANNELS", "AttackPhase",
    "build_config", "coalition_config", "modes_used", "phase_at",
    "required_channel", "validate_schedule",
]
