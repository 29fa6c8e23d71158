"""The vote API (``repro.core.vote_api``; DESIGN.md §10): one declarative
entry point for a majority vote.

* :class:`VoteRequest` says what to vote on: the payload and its form,
  the wire (strategy, codec) and the failures in front of it.
* A :class:`VoteBackend` executes it; the port has
  :class:`VirtualBackend`, which runs the strategies' stages over a
  stacked voter dim with the exchange replaced by its exact equivalent.
* :class:`VoteOutcome` returns the decision, the server state and a
  :class:`WireReport` of what went on the wire.

    out = VirtualBackend(device="cuda").execute(VoteRequest(
        payload=x, form="stacked", strategy=VoteStrategy.ALLGATHER_1BIT))

The port runs the ``stacked`` form — an ``(M, n)`` payload of M voters'
values — on the three wires (``psum_int8``, ``allgather_1bit``,
``hierarchical``) with the four codecs (``sign1bit``, ``ef_sign``,
``ternary2bit``, ``weighted_vote``; each on the strategies it supports).
``VirtualBackend(use_kernels=True)`` votes ``sign1bit`` on
``allgather_1bit`` with the fused sign+pack+popcount kernel
(``fused_majority``) and decodes with ``bitunpack``; with
``use_kernels=False`` the strategy's and the codec's own stages run, and on
a CUDA tensor the packed ones are the hand-written kernels too: the 1-bit
stages (``core.vote_engine``), ``ternary2bit``'s 2-bit wire
(``ternary_pack`` -> ``ternary_majority`` -> ``ternary_unpack``) and
``weighted_vote``'s decode of the 1-bit words (``bitpack`` ->
``bitunpack``, then the weighted sum in torch ops). A request with a
``plan`` (``core.vote_plan.VotePlan``) votes the ``(M, n_params)`` payload
bucket by bucket through the plan's schedule, each group on its own codec
and strategy, in the synchronous or (``overlap=True``) double-buffered
issue order; both give the same bits.

Requests are validated on construction and raise ``ValueError`` where the
reference does (a wrong shape, an unknown form or codec, a codec that
cannot ride the strategy, a stateful codec without its server state).
A request's :class:`FailureSpec` composes failures in front of the wire,
in the reference's pinned order (DESIGN.md §7): sign extraction, then the
first ``n_stale`` voters' signs replaced by ``prev`` (stragglers), then the
Byzantine model (``core.byzantine``: ``sign_flip`` / ``zero`` in place,
``random`` / ``colluding`` / ``blind`` drawn as the reference draws them,
by the ``adversary`` kernel on a card). ``VoteOutcome.wire_signs`` is what
reached the wire. Under a plan the failures act once on the whole
``(M, n_params)`` buffer before the bucket walk.

``execute`` counts every request into the process-global
``obs.COUNTERS`` (``vote.requests``, ``vote.wire.bytes``,
``vote.wire.messages``, from the request's static wire report) and, when a
``TraceRecorder`` is active, times it in a ``vote.execute`` span.

What the port does not run yet raises ``NotImplementedError`` naming its
ROADMAP.md item: the ``leaf`` and ``tree`` forms and :class:`MeshBackend`
(Queue 1 item 5), the ``streamed`` form, ``voter_ids`` / ``weights`` and
adaptive adversaries (item 10).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional

import torch

import repro_torch
from repro_torch.configs.base import ByzantineConfig, VoteStrategy
from repro_torch.core import byzantine
from repro_torch.core import codecs as codecs_mod
from repro_torch.core import sign_compress as sc
from repro_torch.core import vote_engine as ve
from repro_torch.core import vote_plan
from repro_torch.core.codecs import weighted
from repro_torch.core.codecs.ternary import TERNARY_WIRE
from repro_torch.core.sign_compress import pad_last
from repro_torch.core.vote_engine import count_bytes, count_dtype
from repro_torch.distributed.fault_tolerance import simulate_stragglers
from repro_torch.kernels import ops
from repro_torch.obs import recorder as obs

FORMS = ("leaf", "stacked", "tree", "streamed")
#: the reference's adaptive adversaries (``attacks.ATTACK_MODES``), which
#: also read ``VoteRequest.attack_obs``
ATTACK_MODES = byzantine.ATTACK_MODES
#: every adversary mode the reference knows (``byzantine.MODES`` + those)
ADVERSARY_MODES = byzantine.MODES + ATTACK_MODES


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item {item}); the "
        "port votes stacked (M, n) payloads on VirtualBackend")


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """The failure composition in front of the wire, in the reference's
    pinned order: the first `n_stale` voters vote with the request's
    ``prev`` signs (stragglers), then the Byzantine model `byz` acts, so a
    straggling adversary corrupts its stale vector. A crashed or mute
    worker is the ``zero`` adversary."""

    n_stale: int = 0
    byz: Optional[ByzantineConfig] = None

    def __post_init__(self):
        if self.n_stale < 0:
            raise ValueError(f"n_stale must be >= 0, got {self.n_stale}")
        if self.byz is not None and self.byz.mode not in ADVERSARY_MODES:
            raise ValueError(f"unknown adversary mode {self.byz.mode!r}; "
                             f"have {ADVERSARY_MODES}")

    @property
    def active(self) -> bool:
        return self.n_stale > 0 or (self.byz is not None
                                    and self.byz.mode != "none")

    @property
    def adaptive(self) -> bool:
        return self.byz is not None and self.byz.mode in ATTACK_MODES


@dataclasses.dataclass(frozen=True)
class WireReport:
    """What one executed vote put on the wire. `payload_bytes` is one
    voter's outbound payload (the paper's "bits sent"); `n_messages`
    counts the wire rounds; `strategy` is the resolved wire."""

    n_voters: int
    payload_bytes: float
    n_messages: int
    strategy: Optional[VoteStrategy]


@dataclasses.dataclass(frozen=True)
class VoteOutcome:
    """votes (``(n,)`` int8, on the backend's device) + the server state +
    the wire report. ``wire_signs`` is the ``(M, n)`` int8 sign tensor
    that reached the wire (sign extraction -> stale substitution ->
    adversary), on the staged path; ``None`` on the fused kernel path,
    which consumes the raw values."""

    votes: Any
    server_state: Dict[str, Any]
    wire: WireReport
    wire_signs: Any = None


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class VoteRequest:
    """One declarative vote, validated on construction.

    `payload` is an ``(M, n)`` array (numpy or torch) of M voters' values
    with ``form="stacked"``; `strategy` is a concrete wire or AUTO;
    `codec` one of ``codecs.CODECS``; `plan` a ``VotePlan`` over n
    coordinates (its groups' codecs and strategies then supersede `codec`
    and `strategy`), `overlap` its double-buffered walk; `server_state`
    threads a stateful codec's decode memory (``weighted_vote``'s
    ``{"flip_ema": (M,)}``, numpy or torch). `failures` composes stale
    substitution (which needs `prev`, the ``(M, n)`` int8 signs of the
    previous step) and the Byzantine model; `step` (an int) and `salt`
    key the stochastic adversaries' draws. ``voter_ids``, ``weights``,
    ``attack_obs`` and ``diagnostics`` must stay at their defaults in the
    port (see the module doc)."""

    payload: Any
    form: str = "leaf"
    strategy: VoteStrategy = VoteStrategy.AUTO
    codec: str = "sign1bit"
    plan: Optional[Any] = None
    failures: FailureSpec = FailureSpec()
    prev: Any = None
    step: Any = None
    salt: int = 0
    server_state: Optional[Dict[str, Any]] = None
    diagnostics: bool = False
    overlap: bool = False
    voter_ids: Any = None
    weights: Any = None
    attack_obs: Any = None

    def __post_init__(self):
        if self.form not in FORMS:
            raise ValueError(f"unknown payload form {self.form!r}; "
                             f"have {FORMS}")
        if self.form in ("leaf", "tree"):
            raise _not_ported(f"the {self.form!r} form (it votes inside a "
                              "mesh region)", "5")
        if self.form == "streamed":
            raise _not_ported("the 'streamed' population form", "10")
        codec = codecs_mod.get_codec(self.codec)   # raises on unknown
        if not isinstance(self.strategy, VoteStrategy):
            raise ValueError(f"strategy must be a VoteStrategy, got "
                             f"{self.strategy!r}")
        if self.plan is None and self.strategy != VoteStrategy.AUTO:
            codec.validate_strategy(self.strategy)
        if not hasattr(self.payload, "shape"):
            raise ValueError(
                f"{self.form}-form payload must be an array, got "
                f"{type(self.payload).__name__}")
        if len(self.payload.shape) != 2:
            raise ValueError(
                "stacked-form payload must be (M, n) — M voters by n "
                f"coordinates — got shape {tuple(self.payload.shape)}")
        self._validate_plan()
        if self.failures.n_stale > 0 and self.prev is None:
            raise ValueError(
                f"failures.n_stale={self.failures.n_stale} substitutes "
                "stale votes but the request has no prev signs to "
                "substitute (set VoteRequest.prev)")
        # a stacked request always decodes through the codec (even M=1),
        # so missing server state is a build-time error, as in the
        # reference
        needs_state = (self.plan.has_server_state if self.plan is not None
                       else codec.server_state)
        if needs_state and not self.server_state:
            raise ValueError(
                f"codec {self.codec!r} (or the plan's codec map) keeps "
                "server-side decode state; "
                "thread it through "
                "VoteRequest.server_state (init_server_state for the "
                "uninformed prior)")
        if self.attack_obs is not None and not self.failures.adaptive:
            raise ValueError(
                "attack_obs carries an adaptive adversary's observation "
                "channel, but the request's adversary mode is oblivious "
                "or absent — drop attack_obs")
        if self.diagnostics:
            raise ValueError(
                "diagnostics (margin/agreement in the WireReport) are "
                "computed over a voted tree; leaf/stacked callers "
                f"measure their own quantities (form={self.form!r})")
        if self.overlap and self.plan is None:
            raise ValueError(
                "overlap=True double-buffers a plan's bucket schedule; "
                "attach a VotePlan (VoteRequest.plan / "
                "OptimizerConfig.bucket_bytes) or drop overlap")
        if self.failures.adaptive:
            raise _not_ported(f"adaptive adversary mode "
                              f"{self.failures.byz.mode!r}", "10")
        if self.voter_ids is not None or self.weights is not None:
            raise _not_ported("voter_ids / weights annotations", "10")

    def _validate_plan(self):
        if self.plan is None:
            return
        n = self.payload.shape[-1]
        if n != self.plan.n_params:
            raise ValueError(
                f"{self.form} payload has {n} coordinates, plan manifest "
                f"says {self.plan.n_params}")

    def __repr__(self):  # payloads are arrays — keep the repr readable
        return (f"VoteRequest(form={self.form!r}, strategy="
                f"{self.strategy.value!r}, codec={self.codec!r}, "
                f"plan={'yes' if self.plan is not None else None}, "
                f"failures={self.failures}, salt={self.salt})")


def _static_wire(plan, codec_name: str, resolved: Optional[VoteStrategy],
                 n_params: int, n_messages: int,
                 n_voters: int) -> WireReport:
    if plan is not None:
        # one message per bucket; a mixed map resolves no single strategy
        payload = sum(
            g.total * codecs_mod.get_codec(g.codec).wire_bits(g.strategy)
            / 8.0 for g in plan.groups)
        strategies = {g.strategy for g in plan.groups}
        return WireReport(
            n_voters=n_voters, payload_bytes=payload,
            n_messages=plan.n_buckets,
            strategy=strategies.pop() if len(strategies) == 1 else None)
    c = codecs_mod.get_codec(codec_name)
    return WireReport(n_voters=n_voters,
                      payload_bytes=n_params * c.wire_bits(resolved) / 8.0,
                      n_messages=n_messages, strategy=resolved)


def effective_stacked_signs(values: torch.Tensor, prev=None,
                            n_stale: int = 0,
                            byz: Optional[ByzantineConfig] = None,
                            step: Optional[int] = None, salt: int = 0,
                            ids=None) -> torch.Tensor:
    """The (M, n) int8 sign tensor that reaches the wire: sign extraction
    (a float32 / bf16 subnormal abstains, as in the reference) -> stale
    substitution (voters with index < `n_stale` send `prev`) -> the
    adversary `byz`, in the reference's pinned order. ``ids`` replaces the
    row positions as the voters' indices in both predicates and in the
    adversary's keys."""
    signs = sc.sign_ternary(values)
    m = signs.shape[0]
    idx = (torch.arange(m, device=signs.device) if ids is None
           else torch.as_tensor(ids, device=signs.device))
    if n_stale and prev is not None:
        mask = (idx < n_stale)[:, None]
        signs = simulate_stragglers(
            signs, torch.as_tensor(prev, device=signs.device), mask)
    if byz is not None:
        byzantine.apply_adversary_stacked(
            signs, byz, step=None if step is None else int(step),
            salt=salt, ids=None if ids is None else idx.tolist())
    return signs


def _virtual_wire_vote(signs: torch.Tensor,
                       strategy: VoteStrategy) -> torch.Tensor:
    """(M, n) stacked int8 signs -> (n,) int8 majority, through the
    strategy's own pack/tally/unpack stages (exchange virtualised)."""
    impl = ve.STRATEGIES[strategy]
    m, n = signs.shape

    if strategy == VoteStrategy.PSUM_INT8:
        wire = impl.pack(signs, m)                       # (M, n) counts
        # psum over the voters == sum over the voter dim, in the wire
        # dtype (safe: every partial sum is within ±M <= dtype max)
        arrived = torch.sum(wire, dim=0, dtype=wire.dtype)
        return impl.unpack(impl.tally(arrived, m), n, torch.int8)

    if strategy == VoteStrategy.ALLGATHER_1BIT:
        wire = impl.pack(signs, m)                       # (M, w) packed
        # the all-gather hands every voter the stacked wire, which is
        # what the virtual backend already holds
        return impl.unpack(impl.tally(wire, m), n, torch.int8)

    if strategy == VoteStrategy.HIERARCHICAL:
        # one virtual pod: the data axis is all M voters. Pad to 32*M so
        # the reduce-scatter shards stay word-aligned.
        padded, _ = pad_last(signs, sc.PACK * m)
        wire = impl.pack(padded, m)                      # (M, n_pad) counts
        # reduce-scatter (tiled): shard r of the summed counts
        summed = torch.sum(wire, dim=0, dtype=wire.dtype)
        decision = impl.tally(summed.view(m, -1), m)     # sign per shard
        return impl.unpack(decision, n, torch.int8)

    raise ValueError(f"virtual mesh cannot realise {strategy!r}")


def _virtual_codec_vote(signs: torch.Tensor, strategy: VoteStrategy,
                        codec: str, server_state):
    """(M, n) stacked int8 signs -> ((n,) int8 majority, new server state)
    through the codec's wire stages, exchange virtualised."""
    state = dict(server_state or {})
    m, n = signs.shape

    if codec in ("sign1bit", "ef_sign"):
        # the plain majority's wire: only the (caller-side) encode differs
        return _virtual_wire_vote(signs, strategy), state

    if codec == "ternary2bit":
        if strategy == VoteStrategy.PSUM_INT8:
            # ternary symbols ARE the counts psum already sums
            return _virtual_wire_vote(signs, strategy), state
        return TERNARY_WIRE.vote(signs), state

    if codec == "weighted_vote":
        wire = ve.STRATEGIES[VoteStrategy.ALLGATHER_1BIT].pack(signs, m)
        stacked = weighted.stacked_signs(wire, n)
        ema = torch.as_tensor(state["flip_ema"], dtype=torch.float32,
                              device=signs.device)
        vote, new_ema = weighted.decode_stacked(stacked, ema)
        return vote, {**state, "flip_ema": new_ema}

    raise ValueError(f"virtual mesh cannot realise codec {codec!r}")


def _virtual_plan_walk(signs: torch.Tensor, plan, server_state,
                       overlap: bool = False):
    """(M, n_params) stacked int8 signs -> ((n_params,) int8 votes, new
    server state) through the plan's bucket schedule, the exchange
    virtualised per bucket (``vote_plan.VirtualBucketWire``)."""
    m, n = signs.shape
    if n != plan.n_params:
        raise ValueError(f"stacked buffer has {n} coords, plan manifest "
                         f"says {plan.n_params}")
    return vote_plan.run_schedule(plan, signs,
                                  vote_plan.VirtualBucketWire(m),
                                  server_state, overlap=overlap)


class VoteBackend(abc.ABC):
    """Executes :class:`VoteRequest`\\ s."""

    name: str = "?"

    def supports(self, request: VoteRequest) -> bool:
        """Can this backend execute the (already-validated) request?"""
        return self.why_unsupported(request) is None

    @abc.abstractmethod
    def why_unsupported(self, request: VoteRequest) -> Optional[str]:
        """None if supported, else an actionable reason."""

    def execute(self, request: VoteRequest) -> VoteOutcome:
        """Run the vote; raises ValueError (with the
        :meth:`why_unsupported` reason) on unsupported requests. Then the
        telemetry: a ``vote.execute`` span when a recorder is active, and
        the exact wire counters (``vote.requests`` / ``vote.wire.bytes`` /
        ``vote.wire.messages``) from the outcome's wire report, always."""
        why = self.why_unsupported(request)
        if why is not None:
            raise ValueError(f"{self.name} backend cannot execute this "
                             f"request: {why}")
        with obs.get_recorder().span("vote.execute", backend=self.name,
                                     form=request.form,
                                     codec=request.codec):
            out = self._execute(request)
        c = obs.COUNTERS
        c.inc("vote.requests")
        c.inc("vote.wire.bytes", int(round(out.wire.payload_bytes)))
        c.inc("vote.wire.messages", out.wire.n_messages)
        return out

    @abc.abstractmethod
    def _execute(self, request: VoteRequest) -> VoteOutcome:
        """The backend's execution body (request already validated)."""


class MeshBackend:
    """The real collectives over ``torch.distributed``: not ported yet."""

    name = "mesh"

    def __init__(self, *args, **kwargs):
        raise _not_ported("MeshBackend (the multi-process wire)", "5")


class VirtualBackend(VoteBackend):
    """Stacked ``(M, n)`` payloads on one device, the exchange collectives
    replaced by their exact equivalents over the voter dim.

    `device` (``"cuda"`` unless told otherwise, through
    :func:`repro_torch.resolve_device`) is where the payload is moved and
    where the outcome's tensors live. On a CUDA device every 1-bit stage
    is a hand-written kernel; on the CPU the kernels' plain versions run.

    ``use_kernels=True`` votes ``sign1bit`` requests on
    ``allgather_1bit`` with the fused sign+pack+popcount kernel and rejects
    every other codec and strategy, and active failures, which the kernel
    does not realise."""

    name = "virtual"

    def __init__(self, use_kernels: bool = False,
                 device: repro_torch.DeviceLike = None):
        self.use_kernels = use_kernels
        self.device = repro_torch.resolve_device(device)

    def why_unsupported(self, request: VoteRequest) -> Optional[str]:
        if not self.use_kernels:
            return None
        if request.overlap:
            return ("the fused-kernel path runs one fused launch per "
                    "request and cannot double-buffer a bucket "
                    "schedule (overlap=True); use "
                    "VirtualBackend(use_kernels=False)")
        if request.plan is not None:
            return ("the fused-kernel path has no bucket walk; use "
                    "vote_plan.plan_vote_stacked or "
                    "VirtualBackend(use_kernels=False)")
        if request.codec != "sign1bit":
            return ("the fused kernel realises the raw 1-bit wire "
                    f"only, not codec {request.codec!r}")
        if request.strategy != VoteStrategy.ALLGATHER_1BIT:
            return ("the fused kernel's binary majority (ties -> +1) "
                    "is allgather_1bit's tie rule, not "
                    f"{request.strategy.value!r}'s")
        if request.failures.active:
            return ("the fused kernel consumes raw voter values; "
                    "compose failures via "
                    "VirtualBackend(use_kernels=False)")
        return None

    def _execute(self, request: VoteRequest) -> VoteOutcome:
        req = request
        x = torch.as_tensor(req.payload, device=self.device)
        if x.dtype == torch.float64:
            # what the reference's arrays hold with JAX's 64-bit mode off
            x = x.to(torch.float32)
        x = x.contiguous()
        m, n = x.shape
        eff = None
        if self.use_kernels:
            votes = ops.bitunpack(ops.fused_majority(x), n, torch.int8)
            state = dict(req.server_state or {})
            resolved = VoteStrategy.ALLGATHER_1BIT
        else:
            f = req.failures
            eff = effective_stacked_signs(x, req.prev, f.n_stale, f.byz,
                                          req.step, req.salt)
            if req.plan is not None:
                resolved = None
                votes, state = _virtual_plan_walk(
                    eff, req.plan, req.server_state, req.overlap)
            else:
                resolved = ve.resolve_strategy(req.strategy, n, m, 1,
                                               codec=req.codec)
                votes, state = _virtual_codec_vote(eff, resolved, req.codec,
                                                   req.server_state)
        wire = _static_wire(req.plan, req.codec, resolved, n, 1, m)
        return VoteOutcome(votes=votes, server_state=state, wire=wire,
                           wire_signs=eff)


__all__ = [
    "FailureSpec", "MeshBackend", "VirtualBackend", "VoteBackend",
    "VoteOutcome", "VoteRequest", "WireReport", "count_bytes",
    "count_dtype", "effective_stacked_signs", "pad_last",
]
