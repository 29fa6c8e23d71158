"""Byzantine adversary models (``repro.core.byzantine``; paper §3.4, Fig. 4;
DESIGN.md §7), over a stacked ``(M, ...)`` int8 sign tensor.

Modes: ``sign_flip`` sends the negation, ``zero`` abstains, ``random``
sends random ±1, ``colluding`` sends one random ±1 vector shared by every
adversary, ``blind`` flips each sign with probability ``flip_prob`` (0
stays 0), ``none`` is honest. Voters whose index is below
``num_adversaries`` act adversarially; the index is the row's position, or
the ``ids`` given.

The stochastic modes draw what the reference draws, bit for bit:
``jax.random.bernoulli`` under :func:`adversary_key`, ``PRNGKey(seed +
salt)`` folded with the voter index (not for ``colluding``, whose draw
every adversary shares) and the step, reproduced by ``core.prng``. On the
card the draw is the ``adversary`` kernel (``kernels/csrc/byzantine.cu``),
in place on the adversarial rows; ``sign_flip`` and ``zero`` are plain
in-place PyTorch ops. Element j of a row draws at counter ``offset + j``,
so a window of a longer row (a bucket of a plan's flat buffer) draws what
the whole row would.

The adaptive modes (``adaptive_flip``, ``low_margin``, ``reputation``)
read an observation dict (``obs``, the request's ``attack_obs``) and are
dispatched to ``core.attacks.engine``; they draw nothing.

Not ported: :func:`apply_adversary` over mesh axes (ROADMAP.md Queue 1
item 5), which raises.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import ByzantineConfig
from repro_torch.core import prng
from repro_torch.kernels import ops

#: modes where the adversary's vector depends on PRNG draws
STOCHASTIC_MODES = ("random", "colluding", "blind")
MODES = ("none", "sign_flip", "random", "zero", "colluding", "blind")
#: the reference's adaptive adversaries (``attacks.ATTACK_MODES``)
ATTACK_MODES = ("adaptive_flip", "low_margin", "reputation")


def adversary_key(cfg: ByzantineConfig, idx: Optional[int] = None, *,
                  step: Optional[int] = None, salt: int = 0) -> prng.Key:
    """The threefry key a stochastic adversary draws from: ``PRNGKey(seed +
    salt)`` folded with the voter index (omitted for colluding adversaries)
    and the step, as the reference derives it."""
    key = prng.prng_key(cfg.seed + salt)
    if idx is not None:
        key = prng.fold_in(key, idx)
    if step is not None:
        key = prng.fold_in(key, step)
    return key


def check_mode(mode: str) -> None:
    """Raise ``ValueError`` for a mode neither table knows."""
    if mode not in MODES and mode not in ATTACK_MODES:
        raise ValueError(f"unknown byzantine mode {mode!r}")


def evil_signs_(signs: torch.Tensor, cfg: ByzantineConfig,
                ids: Sequence[int], *, step: Optional[int] = None,
                salt: int = 0, offset: int = 0, obs=None) -> torch.Tensor:
    """In place: what voters `ids` send if adversarial, row r of the
    ``(rows, n)`` int8 `signs` (a view whose rows may be apart) being voter
    ``ids[r]``'s honest signs; `obs` is an adaptive mode's observation.
    Returns `signs`."""
    check_mode(cfg.mode)
    if cfg.mode in ATTACK_MODES:
        from repro_torch.core.attacks import engine
        return engine.adaptive_evil_signs_(signs, cfg, ids, obs)
    if cfg.mode == "sign_flip":
        return signs.neg_()
    if cfg.mode == "zero":
        return signs.zero_()
    if cfg.mode == "none":
        return signs
    if cfg.mode == "colluding":
        keys = [adversary_key(cfg, None, step=step, salt=salt)] * len(ids)
    else:
        keys = [adversary_key(cfg, int(i), step=step, salt=salt)
                for i in ids]
    p = cfg.flip_prob if cfg.mode == "blind" else 0.5
    return ops.adversary_(signs, keys, p, cfg.mode == "blind", offset)


def build_config(mode: str, num_adversaries: int = 0, *, seed: int = 0,
                 flip_prob: float = 0.5, target_fraction: float = 0.25,
                 strike_below: float = 0.1) -> ByzantineConfig:
    """A validated :class:`ByzantineConfig` for an absolute adversary count
    (the reference's ``attacks.build_config``): an honest mode or a count
    of 0 collapses to the canonical ``mode="none"``, 0 adversaries."""
    if mode not in MODES and mode not in ATTACK_MODES:
        raise ValueError(f"unknown adversary mode {mode!r}; have {MODES} "
                         f"plus adaptive {ATTACK_MODES}")
    if num_adversaries < 0:
        raise ValueError(f"num_adversaries must be >= 0, got "
                         f"{num_adversaries}")
    if mode == "none" or num_adversaries == 0:
        mode, num_adversaries = "none", 0
    return ByzantineConfig(mode=mode, num_adversaries=num_adversaries,
                           seed=seed, flip_prob=flip_prob,
                           target_fraction=target_fraction,
                           strike_below=strike_below)


def coalition_config(mode: str, fraction: float, n_workers: int, *,
                     seed: int = 0, flip_prob: float = 0.5,
                     target_fraction: float = 0.25,
                     strike_below: float = 0.1) -> ByzantineConfig:
    """:func:`build_config` with the coalition counted from a fraction of
    `n_workers` by the exact half-up rule
    (``fault_tolerance.count_for_fraction``)."""
    from repro_torch.distributed.fault_tolerance import count_for_fraction
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"adversary fraction must be in [0, 1], got "
                         f"{fraction}")
    return build_config(mode, count_for_fraction(fraction, n_workers),
                        seed=seed, flip_prob=flip_prob,
                        target_fraction=target_fraction,
                        strike_below=strike_below)


def _runs(rows: List[int]) -> List[tuple]:
    """Sorted row positions -> (start, stop) runs of adjacent rows."""
    out = []
    for r in rows:
        if out and out[-1][1] == r:
            out[-1] = (out[-1][0], r + 1)
        else:
            out.append((r, r + 1))
    return out


def apply_adversary_stacked(stacked: torch.Tensor, cfg: ByzantineConfig, *,
                            step: Optional[int] = None, salt: int = 0,
                            ids: Optional[Sequence[int]] = None,
                            offset: int = 0, obs=None) -> torch.Tensor:
    """In place on the ``(M, ...)`` int8 voter stack: rows whose voter index
    (the position, or ``ids[r]``) is below ``cfg.num_adversaries`` take
    :func:`evil_signs_` (an adaptive mode with the observation `obs`); the
    others stay honest. Returns `stacked` (the reference returns a new
    array). The trailing dims are drawn as one flat row, as JAX draws a
    shape."""
    if cfg.mode == "none" or cfg.num_adversaries == 0:
        return stacked
    check_mode(cfg.mode)
    m = stacked.shape[0]
    idx = list(range(m)) if ids is None else [int(i) for i in ids]
    if len(idx) != m:
        raise ValueError(f"{m} rows need {m} ids, got {len(idx)}")
    flat = stacked.view(m, -1) if stacked.dim() != 2 else stacked
    evil = [r for r in range(m) if idx[r] < cfg.num_adversaries]
    for lo, hi in _runs(evil):
        evil_signs_(flat[lo:hi], cfg, idx[lo:hi], step=step, salt=salt,
                    offset=offset, obs=obs)
    return stacked


def apply_adversary(signs, cfg: ByzantineConfig, axis_names, **kwargs):
    """The mesh path (replica index from the vote axes): not ported."""
    raise NotImplementedError(
        "byzantine.apply_adversary over mesh axes needs the multi-process "
        "wire, not ported yet (ROADMAP.md Queue 1 item 5); use "
        "apply_adversary_stacked over a stacked voter dim")


__all__ = ["ATTACK_MODES", "MODES", "STOCHASTIC_MODES", "adversary_key",
           "apply_adversary", "apply_adversary_stacked", "build_config",
           "check_mode", "coalition_config", "evil_signs_"]
