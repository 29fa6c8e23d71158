"""Fault-tolerance machinery (``repro.distributed.fault_tolerance``):
stale-vote stragglers, the exact half-up coalition count, elastic
rescale and the watchdog.

Majority vote is the fault-tolerance mechanism (paper §3.4): a stale vote,
random bits, a crash or an adversary is one more bounded perturbation of
the vote. This module is the plumbing around that property:

* :func:`simulate_stragglers` — a voter that misses the deadline sends its
  previous signs instead;
* :func:`count_for_fraction` — voters a fraction maps to, half-up in exact
  rational arithmetic (0.5 of 16 is 8: the tie regime);
* :class:`ElasticPlan` / :func:`plan_rescale` — the survivor mesh after
  losing devices (Mode A state is refit by ``checkpoint.refit_leading_axis``);
* :class:`Watchdog` — a wall-clock timer around blocking work.

Over a ``distributed.mesh.ProcessMesh``, :func:`straggler_mask_for` says
whether this rank's voter is stale, :func:`make_mesh_from_plan` gives the
survivors' mesh, and the ``*_vote_with_failures`` shims (the reference's
deprecated entry points) build one ``core.vote_api.VoteRequest`` with a
``FailureSpec`` and execute it on ``MeshBackend``.
"""
from __future__ import annotations

import dataclasses
import threading
from fractions import Fraction
from typing import Callable, Optional, Tuple

import torch


def simulate_stragglers(signs: torch.Tensor, prev_signs: torch.Tensor,
                        straggler_mask: torch.Tensor) -> torch.Tensor:
    """Elementwise: where `straggler_mask` (broadcast, e.g. ``(M, 1)``
    bool) holds, the voter sends last step's signs."""
    return torch.where(straggler_mask, prev_signs.to(signs.dtype), signs)


def count_for_fraction(fraction: float, n_replicas: int) -> int:
    """Replicas a fraction maps to, half-up, with the product taken in exact
    rational arithmetic (the float value of `fraction` honoured bit for
    bit), capped at `n_replicas`."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction {fraction} outside [0, 1]")
    half_up = int(Fraction(fraction) * n_replicas + Fraction(1, 2))
    return min(n_replicas, half_up)


def straggler_mask_for(axis_names, n_stale: int, like=None) -> bool:
    """Whether this rank's voter is among the first `n_stale` along the
    bound vote axes (stale this step). `like` is accepted for the
    reference's signature."""
    from repro_torch.core.byzantine import replica_index
    return replica_index(axis_names) < n_stale


def _failure_request(engine, payload, prev_signs, n_stale, step,
                     server_state=None, plan=None):
    """The legacy (engine, stale, adversary) triple as one VoteRequest
    (without `prev_signs` nothing is substituted). `engine` carries
    ``axes``, ``strategy``, ``codec``, ``byz`` and ``salt``."""
    from repro_torch.core import vote_api as va
    return va.VoteRequest(
        payload=payload, form="leaf", strategy=engine.strategy,
        codec=engine.codec, plan=plan,
        failures=va.FailureSpec(
            n_stale=n_stale if prev_signs is not None else 0,
            byz=engine.byz),
        prev=prev_signs, step=step, salt=engine.salt,
        server_state=server_state)


def _execute(engine, request):
    from repro_torch.core import vote_api as va
    return va.MeshBackend(axes=engine.axes, device=getattr(
        request.payload, "device", None)).execute(request)


def vote_with_failures(engine, signs: torch.Tensor,
                       prev_signs: Optional[torch.Tensor] = None,
                       n_stale: int = 0, step=None) -> torch.Tensor:
    """One vote under failures (stale substitution, the engine's
    adversary, the wire) on the mesh backend, as a VoteRequest."""
    return _execute(engine, _failure_request(engine, signs, prev_signs,
                                             n_stale, step)).votes


def codec_vote_with_failures(engine, signs: torch.Tensor,
                             prev_signs: Optional[torch.Tensor] = None,
                             n_stale: int = 0, step=None,
                             server_state=None):
    """:func:`vote_with_failures` through the engine's codec; returns
    ``(vote, new_server_state)``."""
    out = _execute(engine, _failure_request(engine, signs, prev_signs,
                                            n_stale, step, server_state))
    return out.votes, out.server_state


def plan_vote_with_failures(engine, plan, values: torch.Tensor,
                            prev_signs: Optional[torch.Tensor] = None,
                            n_stale: int = 0, step=None, server_state=None):
    """:func:`vote_with_failures` through the bucket schedule of `plan`
    (the failures act once on the flat buffer); returns ``(vote,
    new_server_state)``."""
    out = _execute(engine, _failure_request(engine, values, prev_signs,
                                            n_stale, step, server_state,
                                            plan=plan))
    return out.votes, out.server_state


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Mapping from a failure event to the survivor configuration."""

    old_shape: Tuple[int, ...]
    old_axes: Tuple[str, ...]
    new_shape: Tuple[int, ...]
    new_axes: Tuple[str, ...]
    note: str

    @property
    def new_replicas(self) -> int:
        n = 1
        for a, s in zip(self.new_axes, self.new_shape):
            if a in ("pod", "data"):
                n *= s
        return n


def plan_rescale(old_shape: Tuple[int, ...], old_axes: Tuple[str, ...],
                 surviving_devices: int) -> ElasticPlan:
    """The survivor mesh after losing devices: the 'model' axis kept
    whole, 'data' (and 'pod', if a whole pod died) shrunk to the largest
    power of two that fits. The vote only sees the replica count."""
    sizes = dict(zip(old_axes, old_shape))
    model = sizes.get("model", 1)
    if surviving_devices < model:
        raise ValueError(
            f"cannot keep TP degree {model} with {surviving_devices} devices")
    avail_dp = surviving_devices // model
    new_dp = 1
    while new_dp * 2 <= avail_dp:
        new_dp *= 2
    if "pod" in sizes and new_dp >= sizes["data"]:
        pods = new_dp // sizes["data"]
        return ElasticPlan(old_shape, old_axes,
                           (pods, sizes["data"], model),
                           ("pod", "data", "model"),
                           f"kept {pods} pod(s), data={sizes['data']}")
    return ElasticPlan(old_shape, old_axes, (new_dp, model),
                       ("data", "model"),
                       f"flattened to data={new_dp}, model={model}")


def make_mesh_from_plan(plan: ElasticPlan):
    """The survivors' ``ProcessMesh``: the plan's new shape over the first
    ``new_replicas`` ranks of the world (build it on every rank)."""
    from repro_torch.distributed.mesh import ProcessMesh
    return ProcessMesh(plan.new_shape, plan.new_axes)


class Watchdog:
    """Detects a stuck step and invokes `on_timeout`; a context manager
    around blocking work."""

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.fired = False
        self._timer: Optional[threading.Timer] = None

    def _fire(self):
        self.fired = True
        if self.on_timeout is not None:
            self.on_timeout()

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


__all__ = ["ElasticPlan", "Watchdog", "codec_vote_with_failures",
           "count_for_fraction", "make_mesh_from_plan", "plan_rescale",
           "plan_vote_with_failures", "simulate_stragglers",
           "straggler_mask_for", "vote_with_failures"]
