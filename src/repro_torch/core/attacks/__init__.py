"""Adaptive, scheduled and defense-aware adversaries (``repro.core.attacks``;
DESIGN.md §15).

:mod:`.engine` holds the adaptive sign transforms, the :class:`AttackState`
observation memory and the channel tables; :mod:`.schedule` the step-keyed
coalition. The ``ByzantineConfig`` factories live in ``core.byzantine`` and
are re-exported here. ``breaking_point`` imports the Scenario Lab and is not
imported here (``core.byzantine`` dispatches into this package from inside
the vote): ``from repro_torch.core.attacks import breaking_point``.
"""
from repro_torch.core.attacks.engine import (ATTACK_MODES, CHANNEL_KEYS,
                                             MODE_CHANNEL, OBSERVE_CHANNELS,
                                             AttackState,
                                             adaptive_evil_signs_,
                                             required_channel,
                                             update_attack_state,
                                             update_attack_state_population)
from repro_torch.core.attacks.schedule import (AttackPhase, modes_used,
                                               phase_at, validate_schedule)
from repro_torch.core.byzantine import build_config, coalition_config

__all__ = [
    "ATTACK_MODES", "CHANNEL_KEYS", "MODE_CHANNEL", "OBSERVE_CHANNELS",
    "AttackPhase", "AttackState", "adaptive_evil_signs_", "build_config",
    "coalition_config", "modes_used", "phase_at", "required_channel",
    "update_attack_state", "update_attack_state_population",
    "validate_schedule",
]
