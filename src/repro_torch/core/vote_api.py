"""The vote API (``repro.core.vote_api``; DESIGN.md §10): one declarative
entry point for a majority vote.

* :class:`VoteRequest` says what to vote on: the payload and its form,
  the wire (strategy, codec) and the failures in front of it.
* A :class:`VoteBackend` executes it: :class:`VirtualBackend` runs the
  strategies' stages over a stacked voter dim with the exchange replaced
  by its exact equivalent; :class:`MeshBackend` runs the real collectives
  over ``torch.distributed`` process groups, one voter per rank
  (``distributed.mesh.ProcessMesh``).
* :class:`VoteOutcome` returns the decision, the server state and a
  :class:`WireReport` of what went on the wire.

    out = VirtualBackend(device="cuda").execute(VoteRequest(
        payload=x, form="stacked", strategy=VoteStrategy.ALLGATHER_1BIT))
    out = MeshBackend(axes=mesh.vote_axes, device="cuda").execute(
        VoteRequest(payload=tree, form="tree", diagnostics=True, ...))

The payload forms: ``leaf`` (this rank's tensor, voted over the mesh's
axes), ``tree`` (a dict of this rank's leaves; the trainer's form, with
the §7 diagnostics ``margin`` / ``agreement`` on request), ``stacked`` (an
``(M, n)`` payload of M voters' values; on ``MeshBackend`` every rank of
the world passes it, the first M ranks each vote their own row) and
``streamed``. The port runs them on the three wires (``psum_int8``,
``allgather_1bit``, ``hierarchical``) with the four codecs (``sign1bit``,
``ef_sign``, ``ternary2bit``, ``weighted_vote``; each on the strategies it
supports).
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
``(M, n_params)`` buffer before the bucket walk. Over a mesh with a
``"model"`` axis a leaf- or tree-form payload is the rank's shard of a
model-sharded tree and carries no leaf layout, so ``MeshBackend`` refuses a
stochastic adversary there: a draw would take the shard's local
coordinates, where the reference takes the global leaf's. The train step,
which knows each leaf's layout, draws it (``core.signum``). An adaptive
adversary never meets a shard: a leaf or tree request refuses it at
construction (it has no observation channel), and a stacked request
passes every voter's whole row, voted over a data-only mesh.

The adaptive adversaries (``adaptive_flip``, ``low_margin``,
``reputation``; ``core.attacks``) read ``VoteRequest.attack_obs``, their
channel's tensors of the previous round (``AttackState.observation``),
validated against the channel as in the reference.

The ``streamed`` form votes a :class:`PopulationStream`, a population
yielded a chunk of rows at a time, through ``core.population`` in chunks
of ``VirtualBackend(chunk_size=...)`` rows; ``voter_ids`` / ``weights``
annotate a stacked payload's rows with logical ids and integer
dataset-size weights, and such a request runs through the same engine in
one chunk (its ``wire_signs`` from one more pass). Both return
``VoteOutcome.counts``, the signed tally, and ``WireReport.margin``.

``execute`` counts every request into the process-global
``obs.COUNTERS`` (``vote.requests``, ``vote.wire.bytes``,
``vote.wire.messages``, from the request's static wire report) and, when a
``TraceRecorder`` is active, times it in a ``vote.execute`` span.

On ``MeshBackend`` a leaf (and each leaf of a tree) is voted as one flat
row: the vote of a coordinate does not depend on the layout, and the
adversary draws a leaf as one flat row, as JAX draws a shape. Empty vote
axes are the M = 1 case: the vote is the leaf's own ``sign_ternary``.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
from repro_torch.distributed import mesh as pm
from repro_torch.distributed.fault_tolerance import (simulate_stragglers,
                                                     straggler_mask_for)
from repro_torch.kernels import ops
from repro_torch.obs import recorder as obs

FORMS = ("leaf", "stacked", "tree", "streamed")
#: the reference's stacked mesh layouts; both run the same collectives here
MESH_STYLES = ("data_model", "data_only")
#: the reference's adaptive adversaries (``attacks.ATTACK_MODES``), which
#: also read ``VoteRequest.attack_obs``
ATTACK_MODES = byzantine.ATTACK_MODES
#: every adversary mode the reference knows (``byzantine.MODES`` + those)
ADVERSARY_MODES = byzantine.MODES + ATTACK_MODES


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
    #: mean |tally| over the total vote weight (the streamed and annotated
    #: forms fill it, and a tree request with diagnostics)
    margin: Optional[float] = None
    #: the fraction of coordinates where this voter's sign is the vote (a
    #: tree request with diagnostics)
    agreement: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class VoteOutcome:
    """votes (``(n,)`` int8, on the backend's device) + the server state +
    the wire report. ``wire_signs`` is the ``(M, n)`` int8 sign tensor
    that reached the wire (sign extraction -> stale substitution ->
    adversary), on the staged and the annotated paths; ``None`` on the
    fused kernel path, which consumes the raw values, and on the streamed
    path, which never holds it. ``counts`` is the per-coordinate signed
    tally ((n,) int64, at the wire's weight scale) of the streamed and
    annotated paths, the ``margin`` channel of an adaptive attacker."""

    votes: Any
    server_state: Dict[str, Any]
    wire: WireReport
    wire_signs: Any = None
    counts: Any = None


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class PopulationStream:
    """A voter population yielded in chunks instead of held as one ``(M,
    n)`` stack: the ``"streamed"`` request form (DESIGN.md §12).

    * ``values``  — callable, ``(k,)`` int32 CPU tensor of logical voter
      ids -> ``(k, n_coords)`` values (numpy or tensor; moved to the
      backend's device). A pure function of the ids, so chunking cannot
      change the vote.
    * ``ids``     — optional ``(n_voters,)`` strictly increasing
      non-negative logical ids (a sampled round); default ``arange``. The
      stale and adversary predicates and the adversary's keys use them.
    * ``prev``    — optional callable like ``values`` giving the
      ``(k, n_coords)`` int8 previous signs for stale substitution.
    * ``weights`` — optional ``(n_voters,)`` integer dataset sizes >= 1
      aligned to ``ids``: each voter casts weight-many votes.
    """

    n_voters: int
    n_coords: int
    values: Any
    ids: Any = None
    prev: Any = None
    weights: Any = None

    def __post_init__(self):
        if self.n_voters < 1:
            raise ValueError(f"n_voters must be >= 1, got {self.n_voters}")
        if self.n_coords < 1:
            raise ValueError(f"n_coords must be >= 1, got {self.n_coords}")
        if not callable(self.values):
            raise ValueError("values must be a callable (ids) -> (k, n) "
                             f"chunk producer, got "
                             f"{type(self.values).__name__}")
        if self.prev is not None and not callable(self.prev):
            raise ValueError("prev must be a callable (ids) -> (k, n) "
                             "int8 chunk producer (same contract as "
                             f"values), got {type(self.prev).__name__}")
        if self.ids is not None:
            ids = np.asarray(self.ids)
            if ids.shape != (self.n_voters,):
                raise ValueError(f"ids must have shape ({self.n_voters},) "
                                 f"aligned to the stream rows, got "
                                 f"{ids.shape}")
            if not np.issubdtype(ids.dtype, np.integer):
                raise ValueError(f"ids must be integer logical indices, "
                                 f"got dtype {ids.dtype}")
            _check_increasing(ids, "ids")
        if self.weights is not None:
            w = np.asarray(self.weights)
            if w.shape != (self.n_voters,):
                raise ValueError(f"weights must have shape "
                                 f"({self.n_voters},) aligned to the "
                                 f"stream rows, got {w.shape}")
            if not np.issubdtype(w.dtype, np.integer):
                raise ValueError("weights are integer vote counts "
                                 "(dataset sizes), got dtype "
                                 f"{w.dtype}")
            _check_weights(w)

    def row_ids(self) -> np.ndarray:
        """The logical id of every stream row ((M,) int32)."""
        if self.ids is None:
            return np.arange(self.n_voters, dtype=np.int32)
        return np.asarray(self.ids, dtype=np.int32)


def _check_increasing(ids: np.ndarray, name: str) -> None:
    if ids.size and (int(ids.min()) < 0 or np.any(np.diff(ids) <= 0)):
        raise ValueError(f"{name} must be strictly increasing non-negative "
                         "logical voter indices (sort the sampled set)")


def _check_weights(w: np.ndarray) -> None:
    if w.size and int(w.min()) < 1:
        raise ValueError("weights must be >= 1 (a zero-data client does not "
                         "vote; drop it from the sample instead)")


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class VoteRequest:
    """One declarative vote, validated on construction.

    `payload` is an ``(M, n)`` array (numpy or torch) of M voters' values
    with ``form="stacked"``, or a :class:`PopulationStream` with
    ``form="streamed"``; `strategy` is a concrete wire or AUTO; `codec`
    one of ``codecs.CODECS``; `plan` a ``VotePlan`` over n coordinates
    (its groups' codecs and strategies then supersede `codec` and
    `strategy`), `overlap` its double-buffered walk; `server_state`
    threads a stateful codec's decode memory (``weighted_vote``'s
    ``{"flip_ema": (M,)}``, numpy or torch; over the logical population
    for a streamed or annotated request). `failures` composes stale
    substitution (which needs `prev`, the ``(M, n)`` int8 signs of the
    previous step, or the stream's ``prev``) and the Byzantine model;
    `step` (an int) and `salt` key the stochastic adversaries' draws;
    `attack_obs` is an adaptive adversary's observation, exactly its
    channel's keys (``attacks.CHANNEL_KEYS``). `voter_ids` / `weights`
    annotate a stacked payload's rows with logical ids / integer dataset
    sizes. ``diagnostics`` (tree form only) asks for ``margin`` /
    ``agreement`` in the :class:`WireReport`. A ``tree`` payload is a
    non-empty dict of this rank's leaves, a ``leaf`` payload one tensor."""

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
        codec = codecs_mod.get_codec(self.codec)   # raises on unknown
        if not isinstance(self.strategy, VoteStrategy):
            raise ValueError(f"strategy must be a VoteStrategy, got "
                             f"{self.strategy!r}")
        if self.plan is None and self.strategy != VoteStrategy.AUTO:
            codec.validate_strategy(self.strategy)
        if self.form == "tree":
            if not isinstance(self.payload, dict) or not self.payload:
                raise ValueError(
                    "tree-form payload must be a non-empty dict of "
                    f"leaves, got {type(self.payload).__name__}")
        elif self.form == "streamed":
            self._validate_streamed()
        else:
            if not hasattr(self.payload, "shape"):
                raise ValueError(
                    f"{self.form}-form payload must be an array, got "
                    f"{type(self.payload).__name__}")
            if self.form == "stacked" and len(self.payload.shape) != 2:
                raise ValueError(
                    "stacked-form payload must be (M, n) — M voters by n "
                    f"coordinates — got shape {tuple(self.payload.shape)}")
        if self.failures.n_stale > 0:
            streamed = self.form == "streamed"
            has_prev = (self.payload.prev is not None if streamed
                        else self.prev is not None)
            if not has_prev:
                raise ValueError(
                    f"failures.n_stale={self.failures.n_stale} substitutes "
                    "stale votes but the request has no prev signs to "
                    "substitute (set VoteRequest.prev"
                    + (" / PopulationStream.prev" if streamed else "")
                    + ")")
        self._validate_voter_axes()
        self._validate_attack_obs()
        self._validate_plan()
        # a stacked or streamed request always decodes through the codec
        # (even M=1), so missing server state is a build-time error, as in
        # the reference; a leaf or tree request raises at execution where
        # it has vote axes (at M = 1 the vote is the local sign)
        needs_state = (self.plan.has_server_state if self.plan is not None
                       else codec.server_state)
        if (needs_state and not self.server_state
                and self.form in ("stacked", "streamed")):
            raise ValueError(
                f"codec {self.codec!r} (or the plan's codec map) keeps "
                "server-side decode state; "
                "thread it through "
                "VoteRequest.server_state (init_server_state for the "
                "uninformed prior)")
        if self.diagnostics and self.form != "tree":
            raise ValueError(
                "diagnostics (margin/agreement in the WireReport) are "
                "computed over a voted tree; leaf/stacked callers "
                f"measure their own quantities (form={self.form!r})")
        if self.overlap and self.plan is None:
            raise ValueError(
                "overlap=True double-buffers a plan's bucket schedule; "
                "attach a VotePlan (VoteRequest.plan / "
                "OptimizerConfig.bucket_bytes) or drop overlap")

    def _validate_streamed(self):
        if not isinstance(self.payload, PopulationStream):
            raise ValueError(
                "streamed-form payload must be a PopulationStream, got "
                f"{type(self.payload).__name__}")
        if self.plan is not None:
            raise ValueError(
                "the streamed population engine accumulates one flat "
                "coordinate buffer and has no bucket walk; drop the "
                "plan or use the stacked form")
        if self.overlap:
            raise ValueError(
                "overlap double-buffers a plan's bucket schedule; the "
                "streamed form has no plan to overlap")
        if self.prev is not None:
            raise ValueError(
                "a streamed request's prev signs are a chunk producer "
                "on the stream (PopulationStream.prev), not a dense "
                "VoteRequest.prev array")
        if self.voter_ids is not None or self.weights is not None:
            raise ValueError(
                "a streamed request carries voter ids and weights on "
                "the PopulationStream (ids=/weights=), not on the "
                "VoteRequest")

    def _validate_voter_axes(self):
        if self.voter_ids is None and self.weights is None:
            return
        if self.form != "stacked":
            raise ValueError(
                "voter_ids/weights annotate the rows of a stacked "
                f"(M, n) payload, not the {self.form!r} form (streamed "
                "requests carry them on the PopulationStream)")
        if self.plan is not None:
            raise ValueError(
                "voter_ids/weights do not compose with a bucketed plan "
                "yet; drop the plan (the population engine accumulates "
                "one flat buffer)")
        m = self.payload.shape[0]
        for name, arr in (("voter_ids", self.voter_ids),
                          ("weights", self.weights)):
            if arr is None:
                continue
            a = np.asarray(arr)
            if a.shape != (m,):
                raise ValueError(f"{name} must have shape ({m},) aligned "
                                 f"to the stacked rows, got {a.shape}")
            if not np.issubdtype(a.dtype, np.integer):
                raise ValueError(f"{name} must be an integer array, got "
                                 f"dtype {a.dtype}")
        if self.voter_ids is not None:
            _check_increasing(np.asarray(self.voter_ids), "voter_ids")
        if self.weights is not None:
            _check_weights(np.asarray(self.weights))

    def _validate_attack_obs(self):
        from repro_torch.core.attacks import engine as attacks
        if not self.failures.adaptive:
            if self.attack_obs is not None:
                raise ValueError(
                    "attack_obs carries an adaptive adversary's "
                    "observation channel, but the request's adversary "
                    "mode is oblivious or absent — drop attack_obs or "
                    f"use one of the adaptive modes {attacks.ATTACK_MODES}")
            return
        byz = self.failures.byz
        if self.form not in ("stacked", "streamed"):
            raise ValueError(
                f"adaptive adversary mode {byz.mode!r} observes the "
                "previous round's flat broadcast vote; the "
                f"{self.form!r} form has no such observation channel "
                "(use the stacked or streamed form)")
        channel = attacks.MODE_CHANNEL[byz.mode]
        keys = attacks.CHANNEL_KEYS[channel]
        if (not isinstance(self.attack_obs, dict)
                or set(self.attack_obs) != set(keys)):
            got = (sorted(self.attack_obs) if isinstance(self.attack_obs,
                                                         dict)
                   else type(self.attack_obs).__name__)
            raise ValueError(
                f"adaptive mode {byz.mode!r} observes the {channel!r} "
                f"channel: attack_obs must be a dict with exactly the "
                f"keys {sorted(keys)} (AttackState.observation builds "
                f"it), got {got}")
        n = (self.payload.n_coords if self.form == "streamed"
             else self.payload.shape[1])
        for k in ("prev_vote", "prev_abs_counts"):
            if k in self.attack_obs:
                shape = tuple(np.shape(self.attack_obs[k]))
                if shape != (n,):
                    raise ValueError(
                        f"attack_obs[{k!r}] must have shape ({n},) "
                        f"aligned to the vote coordinates, got {shape}")
        if "rep" in self.attack_obs:
            shape = tuple(np.shape(self.attack_obs["rep"]))
            if self.form == "streamed":
                ids = self.payload.row_ids()
            elif self.voter_ids is not None:
                ids = np.asarray(self.voter_ids)
            else:
                ids = None
            need = (self.payload.shape[0] if ids is None
                    else int(ids[-1]) + 1 if ids.size else 1)
            if len(shape) != 1 or shape[0] < need:
                raise ValueError(
                    "attack_obs['rep'] must be a 1-D per-voter array "
                    f"covering every logical voter id (need >= {need} "
                    f"entries, got shape {shape}) — refit it on "
                    "rescale/churn like the flip-EMA "
                    "(AttackState.refit)")

    def _validate_plan(self):
        if self.plan is None:
            return
        plan = self.plan
        if self.form == "tree":
            names = {s.name for s in plan.leaves}
            keys = set(self.payload)
            if names != keys:
                raise ValueError(
                    "plan manifest and tree payload disagree: plan has "
                    f"{sorted(names - keys)} extra / misses "
                    f"{sorted(keys - names)}")
            for slot in plan.leaves:
                got = tuple(self.payload[slot.name].shape)
                if got != slot.shape:
                    raise ValueError(
                        f"leaf {slot.name!r} has shape {got}, plan "
                        f"manifest says {slot.shape}")
            return
        n = self.payload.shape[-1]
        if n != plan.n_params:
            raise ValueError(
                f"{self.form} payload has {n} coordinates, plan manifest "
                f"says {plan.n_params}")
        if self.form == "leaf" and len(self.payload.shape) != 1:
            raise ValueError(
                "a planned leaf payload is the flat (n_params,) buffer "
                f"in manifest order, got shape {tuple(self.payload.shape)}")

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
    if resolved is None or resolved == VoteStrategy.AUTO:
        # M = 1 without vote axes: the vote is the local sign, no wire
        return WireReport(n_voters=n_voters, payload_bytes=0.0,
                          n_messages=0, strategy=None)
    c = codecs_mod.get_codec(codec_name)
    return WireReport(n_voters=n_voters,
                      payload_bytes=n_params * c.wire_bits(resolved) / 8.0,
                      n_messages=n_messages, strategy=resolved)


# ---------------------------------------------------------------------------
# execution over the mesh's vote axes (the reference's in-region path)
# ---------------------------------------------------------------------------


def global_numel(n: int, axes) -> int:
    """The coordinates AUTO prices: `n`, the rank's payload, or over a
    mesh with a ``"model"`` axis the sum of every model rank's payload (a
    request's payload there is the rank's shard of a model-sharded tree,
    as the reference's trace-time shapes are the global leaves')."""
    mesh = getattr(axes, "mesh", None)
    if mesh is None or mesh.model <= 1:
        return n
    return int(pm.model_sum(torch.tensor([n], dtype=torch.int64), mesh)[0])


def _region_sizes(axes) -> tuple:
    """(data, pod) sizes of the bound vote axes (1 for an absent axis)."""
    data = pm.axis_size(axes, "data") if "data" in axes else 1
    pod = pm.axis_size(axes, "pod") if "pod" in axes else 1
    return data, pod


def _wire_vote_signs(signs: torch.Tensor, axes, strategy: VoteStrategy,
                     codec_name: str, server_state):
    """This rank's flat int8 signs -> ((n,) int8 majority, new server
    state) over the vote `axes`, through the resolved strategy's stages
    and the codec's decode."""
    c = codecs_mod.get_codec(codec_name)
    state = dict(server_state) if server_state else {}
    if not axes:
        return signs, state
    data, pod = _region_sizes(axes)
    kind = ve.resolve_strategy(strategy, global_numel(signs.numel(), axes),
                               data, pod, codec=codec_name)
    c.validate_strategy(kind)
    if c.name == "ternary2bit" and kind == VoteStrategy.ALLGATHER_1BIT:
        return TERNARY_WIRE.vote(signs, axes), state
    if c.server_state:
        if not state:
            raise ValueError(
                f"codec {c.name!r} needs its server state threaded "
                "through the request (init_server_state)")
        impl = ve.STRATEGIES[VoteStrategy.ALLGATHER_1BIT]
        n = signs.numel()
        arrived = impl.exchange(impl.pack(signs.view(1, -1),
                                          ve.num_voters(axes)), axes)
        # the padding lanes are cropped before the decode
        ema = torch.as_tensor(state["flip_ema"], dtype=torch.float32,
                              device=signs.device)
        vote, new_ema = weighted.decode_stacked(
            weighted.stacked_signs(arrived, n), ema)
        return vote, {**state, "flip_ema": new_ema}
    return ve.STRATEGIES[kind].vote(signs, axes), state


def _plan_walk(plan, flat_signs: torch.Tensor, axes, server_state,
               overlap: bool = False):
    """The bucket walk over this rank's (n_params,) effective signs on the
    mesh wire -> ((n_params,) int8 votes, new server state)."""
    if not axes:                     # M = 1: the vote is the sign
        return flat_signs, dict(server_state) if server_state else {}
    return vote_plan.run_schedule(plan, flat_signs,
                                  vote_plan.MeshBucketWire(axes),
                                  server_state, overlap=overlap)


def _leaf_execute(values: torch.Tensor, axes, strategy: VoteStrategy,
                  codec_name: str, plan, byz: Optional[ByzantineConfig],
                  salt: int, n_stale: int, prev, step, server_state,
                  overlap: bool = False, obs=None):
    """One rank's vote with the failure composition in the reference's
    pinned order: stale substitution on the raw payload (a straggling
    adversary corrupts its stale vector), sign extraction, the adversary,
    then the wire (leaf-wise or the plan's bucket walk). Returns (votes
    in the payload's shape and dtype, new server state)."""
    shape, dtype = values.shape, values.dtype
    if n_stale and prev is not None and straggler_mask_for(axes, n_stale):
        values = torch.as_tensor(prev, device=values.device)
    signs = sc.sign_ternary(values.reshape(-1))
    if byz is not None and axes:
        byzantine.apply_adversary(signs, byz, axes,
                                  step=None if step is None else int(step),
                                  salt=salt, obs=obs)
    if plan is not None:
        vote, new_state = _plan_walk(plan, signs, axes, server_state,
                                     overlap)
    else:
        vote, new_state = _wire_vote_signs(signs, axes, strategy,
                                           codec_name, server_state)
    return vote.reshape(shape).to(dtype), new_state


#: elements one exact integer reduction reads at a time (PyTorch widens an
#: integer or bool tensor it sums to int64 first: 512 MB for a chunk)
SUM_CHUNK = 1 << 26


def abs_sum(t: torch.Tensor) -> int:
    """The exact sum of |t| of an integer tensor, a chunk at a time."""
    return sum(int(c.abs().sum(dtype=torch.int64))
               for c in t.reshape(-1).split(SUM_CHUNK))


def count_equal(a: torch.Tensor, b: torch.Tensor) -> int:
    """The number of coordinates where `a` equals `b`, a chunk at a time."""
    return sum(int((x == y).sum(dtype=torch.int64)) for x, y in zip(
        a.reshape(-1).split(SUM_CHUNK), b.reshape(-1).split(SUM_CHUNK)))


def int32_wrap(v: int) -> int:
    """`v` wrapped to int32, as the reference's int32 sums wrap."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def ratio_f32(num: int, den: int) -> float:
    """``num / den`` of two integers as JAX divides an int32 array by a
    Python int: both rounded to float32, then one float32 division."""
    return float(np.float32(num) / np.float32(den))


def margin_of(counts, n: int, m: int) -> float:
    """The §7 margin from the signed tallies `counts` (tensors, or their
    int64 sums of |count|): mean |count| / M over n coordinates, the
    numerator summed as the reference's int32 sums are (wrapping past
    2^31)."""
    num = sum(abs_sum(c) if torch.is_tensor(c) else int(c) for c in counts)
    return ratio_f32(int32_wrap(num), n * m)


def vote_diagnostics(agree: int, counts, n: int, m: int, axes=(),
                     reporter: Optional[int] = None, device=None
                     ) -> Tuple[float, float]:
    """The §7 diagnostics of a vote of `n` coordinates by `m` voters:
    (margin, agreement). `counts` are the signed tallies of the signs that
    reached the wire (see :func:`margin_of`); `agree` counts the
    coordinates where a voter's own signs equal the vote: this rank's, or
    with `reporter` the voter of that replica index's, broadcast over the
    mesh `axes` (a tensor on `device`) so that every rank reports it (the
    trainer's metrics, which the reference returns replicated: device
    0's). Both numerators wrap as the reference's int32 sums do."""
    if reporter is not None and axes:
        agree = int(pm.broadcast(torch.tensor(
            [agree], dtype=torch.int64, device=device), axes, reporter)[0])
    return margin_of(counts, n, m), ratio_f32(int32_wrap(agree), n)


def psum_counts(signs: torch.Tensor, axes) -> torch.Tensor:
    """This rank's int8 wire signs summed over the vote axes, in the count
    dtype of M voters (the reference sums them as int32; the sums are the
    same and int8 moves a quarter of the bytes)."""
    if not axes:
        return signs
    return pm.psum(signs.to(count_dtype(ve.num_voters(axes))), axes)


def _tree_diagnostics(tree: Dict, votes: Dict, axes,
                      byz: Optional[ByzantineConfig], step, salt: int):
    """(margin, agreement) of a leaf-wise tree vote: the margin over the
    signs that reached the wire (the adversary applied again under the
    same keys), the agreement of this rank's own signs with the vote."""
    m = ve.num_voters(axes) if axes else 1
    counts, agree = [], 0
    for k, leaf in tree.items():
        s = sc.sign_ternary(leaf.reshape(-1))
        agree += count_equal(s, sc.sign_ternary(votes[k]))
        if byz is not None and axes:
            byzantine.apply_adversary(s, byz, axes, step=step, salt=salt)
        counts.append(psum_counts(s, axes))
    n = sum(leaf.numel() for leaf in tree.values())
    return vote_diagnostics(agree, counts, n, m)


def _tree_execute(tree: Dict, axes, strategy: VoteStrategy,
                  codec_name: str, byz: Optional[ByzantineConfig], step,
                  salt: int, server_state, diagnostics: bool):
    """Leaf-wise tree vote. AUTO resolves once for the tree's total size; a
    server-stateful codec decodes every leaf under this step's weights and
    folds one EMA update over the whole tree."""
    c = codecs_mod.get_codec(codec_name)
    step = None if step is None else int(step)
    resolved = strategy
    if strategy == VoteStrategy.AUTO and axes:
        data, pod = _region_sizes(axes)
        resolved = ve.resolve_strategy(
            strategy, global_numel(sum(leaf.numel()
                                       for leaf in tree.values()), axes),
            data, pod, codec=codec_name)
    state = dict(server_state) if server_state else {}
    if not c.server_state or not axes:
        votes = {k: _leaf_execute(leaf, axes, resolved, codec_name, None,
                                  byz, salt, 0, None, step, None)[0]
                 for k, leaf in tree.items()}
        new_state = state
    else:
        c.validate_strategy(resolved)
        if not state:
            raise ValueError(
                f"codec {c.name!r} needs its server state threaded "
                "through the request (init_server_state)")
        impl = ve.STRATEGIES[VoteStrategy.ALLGATHER_1BIT]
        m = ve.num_voters(axes)
        ema = torch.as_tensor(state["flip_ema"], dtype=torch.float32,
                              device=next(iter(tree.values())).device)
        w = weighted.reliability_weights(ema).tolist()
        votes, mismatch, total_n = {}, None, 0
        for k, leaf in tree.items():
            s = sc.sign_ternary(leaf.reshape(-1))
            if byz is not None:
                byzantine.apply_adversary(s, byz, axes, step=step, salt=salt)
            arrived = impl.exchange(impl.pack(s.view(1, -1), m), axes)
            vote, mis = weighted.decode_leaf_fixed(
                weighted.stacked_signs(arrived, s.numel()), w)
            mismatch = mis if mismatch is None else mismatch + mis
            total_n += s.numel()
            votes[k] = vote.reshape(leaf.shape).to(leaf.dtype)
        new_state = {**state, "flip_ema": weighted.ema_update(
            ema, mismatch, total_n)}
    margin = agreement = None
    if diagnostics:
        margin, agreement = _tree_diagnostics(tree, votes, axes, byz, step,
                                              salt)
    return votes, new_state, margin, agreement, resolved


def _plan_tree_execute(plan, tree: Dict, axes,
                       byz: Optional[ByzantineConfig], step, salt: int,
                       server_state, diagnostics: bool,
                       overlap: bool = False):
    """The plan path of a tree: sign extraction per leaf into one flat
    buffer, the adversary once over it, then the bucket walk; the
    diagnostics over the flat buffer's true coordinates."""
    step = None if step is None else int(step)
    honest = vote_plan.flatten_signs(plan, tree)
    eff = honest
    if byz is not None and axes:
        eff = byzantine.apply_adversary(honest.clone(), byz, axes, step=step,
                                        salt=salt)
    flat_votes, new_state = _plan_walk(plan, eff, axes, server_state,
                                       overlap)
    margin = agreement = None
    if diagnostics:
        margin, agreement = vote_diagnostics(
            count_equal(honest, flat_votes), [psum_counts(eff, axes)],
            plan.n_params, ve.num_voters(axes) if axes else 1)
    return (vote_plan.unflatten_votes(plan, flat_votes, tree), new_state,
            margin, agreement)


def effective_stacked_signs(values: torch.Tensor, prev=None,
                            n_stale: int = 0,
                            byz: Optional[ByzantineConfig] = None,
                            step: Optional[int] = None, salt: int = 0,
                            ids=None, obs=None) -> torch.Tensor:
    """The (M, n) int8 sign tensor that reaches the wire: sign extraction
    (a float32 / bf16 subnormal abstains, as in the reference) -> stale
    substitution (voters with index < `n_stale` send `prev`) -> the
    adversary `byz` (an adaptive one reading the observation `obs`), in
    the reference's pinned order. ``ids`` (host integers) replaces the row
    positions as the voters' indices in both predicates and in the
    adversary's keys."""
    signs = sc.sign_ternary(values)
    m = signs.shape[0]
    idx = (None if ids is None
           else np.asarray(ids.cpu() if torch.is_tensor(ids) else ids,
                           dtype=np.int64))
    if n_stale and prev is not None:
        rows = np.arange(m) if idx is None else idx
        mask = torch.from_numpy(rows < n_stale).to(signs.device)[:, None]
        signs = simulate_stragglers(
            signs, torch.as_tensor(prev, device=signs.device), mask)
    if byz is not None:
        byzantine.apply_adversary_stacked(
            signs, byz, step=None if step is None else int(step),
            salt=salt, ids=None if idx is None else idx.tolist(), obs=obs)
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


class MeshBackend(VoteBackend):
    """The real collectives over ``torch.distributed``, one voter per rank.

    * ``leaf`` / ``tree`` requests vote this rank's payload over the bound
      vote `axes` (``ProcessMesh.vote_axes``; the trainer's form). Empty
      axes are the M = 1 case, the vote the local sign.
    * ``stacked`` requests are passed, the same ``(M, n)`` payload, by every
      rank of the initialised world (one rank needs none): the first M
      ranks each vote their own row over their data-only mesh
      (``mesh.first_ranks``) and every rank gets the same votes and server
      state back, broadcast from rank 0 to the ranks outside it.
      `mesh_style` takes the reference's two layouts, which run the same
      collectives here.

    `device` (``"cuda"`` unless told otherwise) is where a numpy payload is
    put; a tensor payload keeps its own device."""

    name = "mesh"

    def __init__(self, axes=None, mesh_style: str = "data_model",
                 device: repro_torch.DeviceLike = None):
        if mesh_style not in MESH_STYLES:
            raise ValueError(f"unknown mesh_style {mesh_style!r}; "
                             f"have {MESH_STYLES}")
        if axes is not None and not isinstance(axes, pm.VoteAxes):
            if tuple(axes):
                raise ValueError(
                    f"vote axes {tuple(axes)} must be bound to their "
                    "ProcessMesh (pass ProcessMesh.vote_axes)")
            axes = pm.VoteAxes()
        self.axes = axes
        self.mesh_style = mesh_style
        self.device = repro_torch.resolve_device(device)

    @staticmethod
    def world_size() -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    def why_unsupported(self, request: VoteRequest) -> Optional[str]:
        if request.form == "streamed":
            return ("the streamed population form virtualises more "
                    "voters than any physical mesh holds replicas; use "
                    "VirtualBackend")
        if request.voter_ids is not None or request.weights is not None:
            return ("logical voter ids / dataset-size vote weights "
                    "describe a virtual population; the mesh backend's "
                    "voters are physical replicas (use VirtualBackend)")
        if request.form == "stacked":
            m, have = request.payload.shape[0], self.world_size()
            if m > have:
                return (f"stacked execution needs {m} ranks for {m} "
                        f"voters, have {have} (use VirtualBackend, or "
                        "initialise a torch.distributed world of M ranks)")
            return None
        if self.axes is None:
            return (f"{request.form}-form requests run over a mesh's vote "
                    "axes; construct MeshBackend(axes=mesh.vote_axes)")
        mesh = getattr(self.axes, "mesh", None)
        byz = request.failures.byz
        if (mesh is not None and mesh.model > 1 and byz is not None
                and byz.num_adversaries
                and byz.mode in byzantine.STOCHASTIC_MODES):
            return (f"a {byz.mode!r} adversary over a 'model' axis of "
                    f"{mesh.model}: the {request.form}-form payload is this "
                    "rank's shard of a model-sharded tree and carries no "
                    "leaf layout, so it would pick coordinates by the "
                    "shard's local index where the reference picks them "
                    "by the global leaf's; vote through "
                    "make_train_step(mesh=), which maps each leaf's draws "
                    "to its global coordinates")
        return None

    def _execute(self, request: VoteRequest) -> VoteOutcome:
        if request.form == "stacked":
            return self._execute_stacked(request)
        if request.form == "tree":
            return self._execute_tree(request)
        return self._execute_leaf(request)

    def _tensor(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, device=None if torch.is_tensor(x)
                            else self.device)
        # what the reference's arrays hold with JAX's 64-bit mode off
        return t.to(torch.float32) if t.dtype == torch.float64 else t

    def _n_voters(self) -> int:
        return ve.num_voters(self.axes) if self.axes else 1

    def _execute_leaf(self, req: VoteRequest) -> VoteOutcome:
        f = req.failures
        payload = self._tensor(req.payload)
        votes, state = _leaf_execute(
            payload, self.axes, req.strategy, req.codec, req.plan, f.byz,
            req.salt, f.n_stale, req.prev, req.step, req.server_state,
            req.overlap)
        resolved = None
        if self.axes and req.plan is None:
            data, pod = _region_sizes(self.axes)
            resolved = ve.resolve_strategy(
                req.strategy, global_numel(payload.numel(), self.axes),
                data, pod, codec=req.codec)
        wire = _static_wire(req.plan, req.codec, resolved, payload.numel(),
                            1, self._n_voters())
        return VoteOutcome(votes=votes, server_state=state, wire=wire)

    def _execute_tree(self, req: VoteRequest) -> VoteOutcome:
        f = req.failures
        tree = {k: self._tensor(v) for k, v in req.payload.items()}
        if req.plan is not None:
            votes, state, margin, agreement = _plan_tree_execute(
                req.plan, tree, self.axes, f.byz, req.step, req.salt,
                req.server_state, req.diagnostics, req.overlap)
            resolved = None
        else:
            votes, state, margin, agreement, resolved = _tree_execute(
                tree, self.axes, req.strategy, req.codec, f.byz, req.step,
                req.salt, req.server_state, req.diagnostics)
        if not self.axes:
            resolved = None
        total = sum(v.numel() for v in tree.values())
        wire = _static_wire(req.plan, req.codec, resolved, total, len(tree),
                            self._n_voters())
        wire = dataclasses.replace(wire, margin=margin, agreement=agreement)
        return VoteOutcome(votes=votes, server_state=state, wire=wire)

    def _execute_stacked(self, req: VoteRequest) -> VoteOutcome:
        m, n = req.payload.shape
        f = req.failures
        sub = pm.first_ranks(m)
        world = self.world_size()
        state = {k: torch.as_tensor(v, device=self.device)
                 for k, v in (req.server_state or {}).items()}
        if sub.member:
            row = sub.replica_index()
            x = self._tensor(req.payload)[row].to(self.device)
            prev = (None if req.prev is None else
                    torch.as_tensor(req.prev, device=self.device)[row])
            votes, state = _leaf_execute(
                x, sub.vote_axes, req.strategy, req.codec, req.plan, f.byz,
                req.salt, f.n_stale, prev, req.step, req.server_state,
                req.overlap, obs=req.attack_obs)
            votes = votes.to(torch.int8)
        else:
            votes = torch.empty(n, dtype=torch.int8, device=self.device)
        if m < world:
            # the ranks outside the drill's mesh take rank 0's outcome
            everyone = pm.ProcessMesh((world,), ("data",)).vote_axes
            votes = pm.broadcast(votes, everyone)
            state = {k: pm.broadcast(torch.as_tensor(
                v, dtype=torch.float32, device=self.device), everyone)
                for k, v in state.items()}
        resolved = (None if req.plan is not None else
                    ve.resolve_strategy(req.strategy, n, m, 1,
                                        codec=req.codec))
        wire = _static_wire(req.plan, req.codec, resolved, n, 1, m)
        return VoteOutcome(votes=votes, server_state=state, wire=wire)


class VirtualBackend(VoteBackend):
    """Stacked ``(M, n)`` payloads on one device, the exchange collectives
    replaced by their exact equivalents over the voter dim, and streamed
    populations through ``core.population`` in chunks of `chunk_size`
    rows (peak rows O(chunk_size x n), bit-equal to the dense path).

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
                 device: repro_torch.DeviceLike = None,
                 chunk_size: int = 2048):
        self.use_kernels = use_kernels
        self.device = repro_torch.resolve_device(device)
        self.chunk_size = int(chunk_size)
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")

    def why_unsupported(self, request: VoteRequest) -> Optional[str]:
        if request.form not in ("stacked", "streamed"):
            return ("the virtual backend executes host-local stacked "
                    f"(M, n) payloads or streamed populations, not "
                    f"{request.form!r} (use MeshBackend over the mesh's "
                    "vote axes)")
        if request.form == "streamed":
            if self.use_kernels:
                return ("the fused-kernel path consumes one dense (M, n) "
                        "buffer; the streamed population engine exists "
                        "to never materialize it (use "
                        "VirtualBackend(use_kernels=False))")
            if request.strategy == VoteStrategy.HIERARCHICAL:
                return ("hierarchical's reduce-scatter wire pads to "
                        "PACK*M words — O(M) layout the streamed engine "
                        "exists to avoid; use psum_int8 or "
                        "allgather_1bit")
            return None
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
        if req.form == "streamed":
            return self._execute_stream_request(req, req.payload,
                                                self.chunk_size)
        if req.voter_ids is not None or req.weights is not None:
            return self._execute_annotated(req)
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
                                          req.step, req.salt,
                                          obs=req.attack_obs)
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

    def _execute_annotated(self, req: VoteRequest) -> VoteOutcome:
        """A stacked payload annotated with voter_ids / weights: the dense
        twin of a streamed request, run through the same population engine
        in one chunk of all M rows, as the reference runs it; its wire
        signs come from one more pass."""
        from repro_torch.core import population
        m, n = req.payload.shape
        payload = torch.as_tensor(req.payload, device=self.device)
        ids_np = (np.asarray(req.voter_ids, dtype=np.int32)
                  if req.voter_ids is not None
                  else np.arange(m, dtype=np.int32))

        def at(ids):    # logical ids -> row positions (ids_np sorted)
            pos = np.searchsorted(ids_np, ids.numpy())
            return None if np.array_equal(pos, np.arange(m)) else pos

        def rows(ids):
            pos = at(ids)
            return payload if pos is None else payload[torch.from_numpy(pos)
                                                       .to(self.device)]

        prev = None
        if req.prev is not None:
            prev_t = torch.as_tensor(req.prev, device=self.device)

            def prev(ids):
                pos = at(ids)
                return prev_t if pos is None else prev_t[
                    torch.from_numpy(pos).to(self.device)]

        stream = PopulationStream(
            n_voters=m, n_coords=n, values=rows,
            ids=ids_np if req.voter_ids is not None else None,
            prev=prev,
            weights=(None if req.weights is None
                     else np.asarray(req.weights)))
        out = self._execute_stream_request(req, stream, chunk_size=m)
        f = req.failures
        eff = population._chunk_signs(stream, ids_np, req.step, f.n_stale,
                                      f.byz, req.salt, obs=req.attack_obs,
                                      device=self.device)
        return dataclasses.replace(out, wire_signs=eff)

    def _execute_stream_request(self, req: VoteRequest, stream,
                                chunk_size: int) -> VoteOutcome:
        from repro_torch.core import population
        m, n = stream.n_voters, stream.n_coords
        resolved = ve.resolve_strategy(req.strategy, n, m, 1,
                                       codec=req.codec)
        f = req.failures
        votes, state, margin, counts = population.streamed_vote(
            stream, strategy=resolved, codec=req.codec,
            n_stale=f.n_stale, byz=f.byz, step=req.step, salt=req.salt,
            server_state=req.server_state, chunk_size=chunk_size,
            attack_obs=req.attack_obs, device=self.device)
        wire = dataclasses.replace(
            _static_wire(req.plan, req.codec, resolved, n, 1, m),
            margin=margin)
        return VoteOutcome(votes=votes, server_state=state, wire=wire,
                           counts=counts)


__all__ = [
    "FailureSpec", "MESH_STYLES", "MeshBackend", "PopulationStream",
    "VirtualBackend", "VoteBackend", "VoteOutcome", "VoteRequest",
    "WireReport", "abs_sum", "count_bytes", "count_dtype",
    "count_equal", "effective_stacked_signs", "int32_wrap", "margin_of",
    "pad_last", "psum_counts", "ratio_f32", "vote_diagnostics",
]
