"""Deterministic serve traffic: Poisson arrivals keyed by splitmix64
(``repro.serve.traffic``, copied: numpy only, so a schedule is bit-equal
to the reference's).

The generator is the serving twin of the Scenario Lab's host-side draw
discipline (DESIGN.md §12): every request-level quantity — inter-arrival
gap, prompt length, prompt tokens, generation budget — is a pure
function of ``(seed, tag, request id)`` through the splitmix64
finalizer, never of call order, host count, or library version. Two
calls with the same seed produce bit-identical schedules, so the bench
rows built from a schedule (goodput, latency percentiles) are exact,
gate-able numbers, and a traced run replays an untraced one exactly.

Arrival times are in *ticks* — the engine's virtual clock, one tick per
scheduler round (admissions + one decode step). Measuring load in ticks
keeps the offered-load comparison (continuous vs static batching)
deterministic; wall-clock rows are reported separately as ``*_ms``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

_SM64 = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xBF58476D1CE4E5B9),
         np.uint64(0x94D049BB133111EB))

#: one draw stream per request-level quantity
_TAG_GAP, _TAG_PLEN, _TAG_TOKENS, _TAG_GEN = 1, 2, 3, 4


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over a uint64 array (elementwise,
    vectorized, wrap-around arithmetic — same constants as sim.runner)."""
    with np.errstate(over="ignore"):   # wrap-around is the algorithm
        x = (np.asarray(x, np.uint64) + _SM64[0]).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(30))) * _SM64[1]).astype(np.uint64)
        x = ((x ^ (x >> np.uint64(27))) * _SM64[2]).astype(np.uint64)
        return x ^ (x >> np.uint64(31))


def _stream(seed: int, tag: int, rid: int) -> np.uint64:
    """A uint64 stream constant chaining (seed, tag, request id)."""
    h = np.zeros((), np.uint64)
    for v in (seed, tag, rid):
        h = _splitmix64(h ^ np.uint64(v))
    return h


def _uniform01(h: np.ndarray) -> np.ndarray:
    """uint64 hash -> float64 uniform in [0, 1) (53-bit mantissa)."""
    return (np.asarray(h, np.uint64) >> np.uint64(11)).astype(np.float64) \
        * (2.0 ** -53)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serve request: a prompt and a generation budget."""

    req_id: int
    arrival: float                 # tick the request enters the queue
    prompt: Tuple[int, ...]        # prompt token ids (length >= 1)
    max_gen: int                   # generation budget (sampled tokens)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def with_arrival(self, arrival: float) -> "Request":
        """The same request rebased to a new arrival tick (oracle replays
        admit post-swap requests against a fresh server at tick 0)."""
        return dataclasses.replace(self, arrival=arrival)


def poisson_requests(*, n_requests: int, rate: float, vocab_size: int,
                     prompt_lens: Sequence[int] = (8, 16, 32),
                     gen_range: Tuple[int, int] = (4, 16),
                     seed: int = 0, start_id: int = 0,
                     start_tick: float = 0.0) -> Tuple[Request, ...]:
    """A deterministic Poisson request schedule.

    ``rate`` is the offered load in requests per tick; inter-arrival
    gaps are Exp(rate) draws from the per-request splitmix64 stream, so
    request ``start_id + i`` always arrives at the same tick whatever
    the process (or recorder) state. Prompt lengths are drawn from the
    ``prompt_lens`` bucket ladder — the engine's batched-prefill compile
    ladder — and generation budgets uniformly from ``gen_range``
    (inclusive).
    """
    if n_requests < 0:
        raise ValueError(f"n_requests must be >= 0, got {n_requests}")
    if rate <= 0.0:
        raise ValueError(f"rate must be > 0 requests/tick, got {rate}")
    if not prompt_lens or any(p < 1 for p in prompt_lens):
        raise ValueError(f"prompt_lens must be >= 1, got {prompt_lens}")
    lo, hi = gen_range
    if not (1 <= lo <= hi):
        raise ValueError(f"gen_range must satisfy 1 <= lo <= hi, "
                         f"got {gen_range}")
    lens = tuple(int(p) for p in prompt_lens)
    reqs = []
    t = float(start_tick)
    for i in range(n_requests):
        rid = start_id + i
        u = float(_uniform01(_stream(seed, _TAG_GAP, rid)))
        t += -math.log(1.0 - u) / rate
        plen = lens[int(_stream(seed, _TAG_PLEN, rid) % np.uint64(len(lens)))]
        toks = _splitmix64(np.arange(plen, dtype=np.uint64)
                           ^ _stream(seed, _TAG_TOKENS, rid)) \
            % np.uint64(vocab_size)
        max_gen = lo + int(_stream(seed, _TAG_GEN, rid)
                           % np.uint64(hi - lo + 1))
        reqs.append(Request(req_id=rid, arrival=t,
                            prompt=tuple(int(x) for x in toks),
                            max_gen=max_gen))
    return tuple(reqs)
