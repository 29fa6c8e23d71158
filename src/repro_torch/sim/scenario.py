"""Scenario specifications for the failure-drill simulator
(``repro.sim.scenario``; DESIGN.md §7), the same specs, names and salts as
the reference's.

A :class:`ScenarioSpec` is a complete, serialisable description of one
failure drill: how many voters, which adversary model at what fraction,
what fraction of stragglers, an elastic schedule of voter-set rescales,
which VoteEngine wire strategy, and the tie-break policy the caller
expects. Specs are frozen dataclasses (hashable) and round-trip through
plain dicts / JSON, so an entire sweep —
the paper's Fig. 4 grid included — lives in one config file
(``benchmarks/configs/fig4_grid.json``).

Determinism: every PRNG draw a scenario makes (gradient noise, random /
blind / colluding adversaries) is keyed by ``(seed + salt(name), step,
replica index)`` — never by device placement — so a scenario replays
bit-identically on any device (:func:`scenario_salt`).

The port's runner (``sim.runner``) runs the dense drills; a spec with a
population (``PopulationSpec.n_clients > 0``) or an adaptive adversary
validates here as in the reference and raises there (ROADMAP.md Queue 1
item 10).
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ByzantineConfig, VoteStrategy
from repro_torch.core import byzantine

#: tie policies a spec may request; "auto" takes the wire format's own
#: convention (DESIGN.md §5: integer-count wires -> "zero", 1-bit wires
#: -> "plus_one")
TIE_POLICIES = ("auto", "zero", "plus_one")


def scenario_salt(name: str) -> int:
    """Stable 31-bit hash of a scenario id, folded into every PRNG key the
    scenario derives (adversary draws and gradient noise), so two
    scenarios in one sweep never share an adversary stream. 31 bits so the
    salt is a valid int32 for ``jax.random.fold_in`` on every version (the
    port keeps it: ``core.prng.fold_in`` draws the same bits)."""
    return zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class AdversarySpec:
    """Which adversary model, at what fraction of the current voter set.

    The §15 attack axes: ``mode`` may also be one of the adaptive
    ``repro.core.attacks`` modes, in which case ``observe`` MUST name
    the mode's observation channel (``attacks.MODE_CHANNEL``) — the
    spec states explicitly what the adversary is allowed to see, and a
    dangling or mismatched channel is a build error, not a silent
    no-op. ``schedule`` is the time-varying coalition
    (:class:`~repro_torch.core.attacks.AttackPhase` overrides, applied at
    their steps); all adaptive modes a schedule can reach must share
    one channel. ``target_fraction`` (low_margin) and ``strike_below``
    (reputation) are the adaptive modes' own knobs."""

    mode: str = "none"        # byzantine.MODES | attacks.ATTACK_MODES
    fraction: float = 0.0     # of the CURRENT voter count (elastic-aware)
    flip_prob: float = 0.5    # blind mode only
    observe: str = "none"     # attacks.OBSERVE_CHANNELS
    schedule: Tuple[Any, ...] = ()         # attacks.AttackPhase overrides
    target_fraction: float = 0.25          # low_margin mode only
    strike_below: float = 0.1              # reputation mode only

    def __post_init__(self):
        from repro_torch.core import attacks
        if (self.mode not in byzantine.MODES
                and self.mode not in attacks.ATTACK_MODES):
            raise ValueError(f"unknown adversary mode {self.mode!r}; "
                             f"have {byzantine.MODES} plus adaptive "
                             f"{attacks.ATTACK_MODES}")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"adversary fraction {self.fraction} not in "
                             "[0, 1]")
        if not 0.0 <= self.flip_prob <= 1.0:
            raise ValueError(f"flip_prob {self.flip_prob} not in [0, 1]")
        if not 0.0 < self.target_fraction <= 1.0:
            raise ValueError(f"target_fraction {self.target_fraction} "
                             "not in (0, 1]")
        if not 0.0 <= self.strike_below <= 1.0:
            raise ValueError(f"strike_below {self.strike_below} not in "
                             "[0, 1]")
        if self.observe not in attacks.OBSERVE_CHANNELS:
            raise ValueError(f"unknown observation channel "
                             f"{self.observe!r}; have "
                             f"{attacks.OBSERVE_CHANNELS}")
        attacks.validate_schedule(self.schedule)
        need = attacks.required_channel(
            attacks.modes_used(self.schedule, self.mode))
        if need == "none" and self.observe != "none":
            raise ValueError(
                f"observe={self.observe!r} grants an observation "
                "channel but no adaptive mode consumes it (mode/"
                "schedule are all oblivious) — drop observe or use an "
                f"adaptive mode {attacks.ATTACK_MODES}")
        if need != "none" and self.observe != need:
            raise ValueError(
                f"adaptive mode(s) here consume the {need!r} channel; "
                f"the spec says observe={self.observe!r} — state the "
                "channel the adversary actually sees (observe="
                f"{need!r})")

    @property
    def adaptive(self) -> bool:
        return self.observe != "none"

    def phase_at(self, step: int) -> Tuple[str, float]:
        """The (mode, fraction) in force at `step` under the schedule."""
        from repro_torch.core import attacks
        return attacks.phase_at(self.schedule, self.mode, self.fraction,
                                step)

    def byz_config(self, n_workers: int, seed: int) -> ByzantineConfig:
        """The core-layer config for a concrete voter count (the count is
        re-derived after every elastic event), ignoring the schedule —
        the pre-run coalition."""
        return self.byz_config_at(0, n_workers, seed)

    def byz_config_at(self, step: int, n_workers: int,
                      seed: int) -> ByzantineConfig:
        """The config in force at `step`: schedule resolution, then the
        exact-``Fraction`` coalition count, through the sanctioned
        ``repro.core.attacks`` factory."""
        from repro_torch.core import attacks
        mode, fraction = self.phase_at(step)
        return attacks.coalition_config(
            mode, fraction, n_workers, seed=seed,
            flip_prob=self.flip_prob,
            target_fraction=self.target_fraction,
            strike_below=self.strike_below)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AdversarySpec":
        from repro_torch.core.attacks import AttackPhase
        d = dict(d)
        d["schedule"] = tuple(
            p if isinstance(p, AttackPhase) else AttackPhase(**p)
            for p in d.get("schedule", ()))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """The scenario's VotePlan axis (DESIGN.md §9).

    ``bucket_bytes = 0`` (the default) keeps the legacy single-shot wire
    — the whole gradient voted in one pack/exchange/tally/unpack round.
    ``bucket_bytes > 0`` builds a :class:`~repro_torch.core.vote_plan.VotePlan`
    over the drill's flat buffer and BOTH backends (mesh and virtual)
    walk the same bucket schedule, so plan digests stay backend- and
    host-count-invariant like everything else in the lab.

    `leaves` names segments of the flat buffer (``(("embed", 48),
    ("body", 208))``; lengths must sum to ``dim``; empty = one segment
    ``"x"`` of the whole dim) purely so `codec_map` has names to glob
    against — e.g. ternary embeddings + sign1bit body. Worker-state
    codecs (``ef_sign``) cannot appear in the map (the drill keeps its
    EF residual whole-buffer at the spec level); they remain valid as
    the spec-level ``codec``.
    """

    bucket_bytes: int = 0
    codec_map: Tuple[Tuple[str, str], ...] = ()
    leaves: Tuple[Tuple[str, int], ...] = ()
    overlap: bool = False   # double-buffered bucket walk (DESIGN.md §11)

    def __post_init__(self):
        from repro_torch.core.vote_plan import AUTO_BUCKET_BYTES
        if self.bucket_bytes < 0 and self.bucket_bytes != AUTO_BUCKET_BYTES:
            raise ValueError(f"bucket_bytes {self.bucket_bytes} < 0 "
                             "(use -1 for the priced AUTO ladder)")
        if (self.codec_map or self.leaves) and not self.enabled:
            raise ValueError("codec_map/leaves need bucket_bytes > 0 "
                             "(or the -1 AUTO ladder)")
        if self.overlap and not self.enabled:
            raise ValueError("overlap=True double-buffers the bucket "
                             "schedule; it needs bucket_bytes != 0")

    @property
    def enabled(self) -> bool:
        return self.bucket_bytes != 0

    def leaf_shapes(self, dim: int) -> Dict[str, Tuple[int, ...]]:
        leaves = self.leaves or (("x", dim),)
        return {name: (int(length),) for name, length in leaves}


@dataclasses.dataclass(frozen=True)
class ElasticEvent:
    """At `step`, rescale the voter set to `n_workers` (shrink = node
    deaths, grow = nodes joining). Per-worker momentum is refit by the
    checkpoint rule (truncate / zero-pad, §6): joiners start with zero
    momentum and an all-zero stale vector — an abstention on the
    integer-count wire, +1 votes on the 1-bit wires (which cannot encode
    "abstain"; DESIGN.md §5)."""

    step: int
    n_workers: int
    note: str = ""

    def __post_init__(self):
        if self.step < 0 or self.n_workers < 1:
            raise ValueError(f"bad elastic event {self}")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """At `step`, `join` new clients enter the logical population and
    `leave` existing ones exit (DESIGN.md §12). The generalization of
    :class:`ElasticEvent` to federated populations: events are *deltas*
    on the client count, joiners take fresh logical ids at the top of
    the id range (their dataset sizes and PRNG streams follow the id,
    so a client that exists in two runs behaves identically), leavers
    drop from the top — per-client server state (the weighted vote's
    flip-rate EMA) refits by the checkpoint rule (truncate / zero-pad,
    §6), exactly like an elastic rescale."""

    step: int
    join: int = 0
    leave: int = 0
    note: str = ""

    def __post_init__(self):
        if self.step < 1 or self.join < 0 or self.leave < 0:
            raise ValueError(f"bad churn event {self} (step >= 1; "
                             "pre-run churn is just a different "
                             "n_clients)")
        if self.join == 0 and self.leave == 0:
            raise ValueError(f"churn event at step {self.step} neither "
                             "joins nor leaves anyone")


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """The scenario's federated-population axis (DESIGN.md §12).

    ``n_clients = 0`` (the default) keeps the classic dense drill —
    every voter materialized as a row of one stacked tensor.
    ``n_clients > 0`` switches the runner to the streamed population
    engine: the logical population holds `n_clients` voters (far more
    than any host stacks densely), each round samples
    ``sample_fraction`` of them (PRNG keyed by (scenario salt, step) —
    host-count-invariant replay), and the vote streams through
    :func:`repro.core.population.streamed_vote` in voter-chunks of
    ``chunk_size`` rows, so peak sign-buffer memory is O(chunk x dim)
    however large the population.

    ``weighting="dataset"`` gives every client an integer dataset size
    drawn once per *logical id* (uniform on [min_data, max_data]; PRNG
    follows the id, not the round) and counts its vote with that
    multiplicity — the federated dataset-weighted majority. ``churn``
    is the population's join/leave schedule (:class:`ChurnEvent`)."""

    n_clients: int = 0
    sample_fraction: float = 1.0
    churn: Tuple[ChurnEvent, ...] = ()
    weighting: str = "uniform"          # "uniform" | "dataset"
    min_data: int = 1
    max_data: int = 64
    chunk_size: int = 2048

    def __post_init__(self):
        if self.n_clients < 0:
            raise ValueError(f"n_clients {self.n_clients} < 0")
        if not self.enabled and (self.churn or self.sample_fraction != 1.0
                                 or self.weighting != "uniform"):
            raise ValueError("population axes (sampling/churn/weighting) "
                             "need n_clients > 0")
        if not 0.0 < self.sample_fraction <= 1.0:
            raise ValueError(f"sample_fraction {self.sample_fraction} "
                             "not in (0, 1]")
        if self.weighting not in ("uniform", "dataset"):
            raise ValueError(f"weighting {self.weighting!r} not in "
                             "('uniform', 'dataset')")
        if not 1 <= self.min_data <= self.max_data:
            raise ValueError(f"need 1 <= min_data <= max_data, got "
                             f"[{self.min_data}, {self.max_data}]")
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size {self.chunk_size} < 1")
        steps = [e.step for e in self.churn]
        if steps != sorted(steps) or len(set(steps)) != len(steps):
            raise ValueError("churn events must be strictly step-sorted")
        n = self.n_clients
        for ev in self.churn:
            n += ev.join - ev.leave
            if self.enabled and n < 1:
                raise ValueError(
                    f"churn at step {ev.step} empties the population "
                    f"({n} clients left); it must stay >= 1")

    @property
    def enabled(self) -> bool:
        return self.n_clients > 0

    def clients_at(self, step: int) -> int:
        """Logical population size in effect at `step`."""
        n = self.n_clients
        for ev in self.churn:
            if ev.step <= step:
                n += ev.join - ev.leave
        return n


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One deterministic failure drill through the production vote path."""

    name: str
    n_workers: int = 8
    n_steps: int = 20
    dim: int = 256                      # toy-quadratic dimensionality
    strategy: VoteStrategy = VoteStrategy.PSUM_INT8
    adversary: AdversarySpec = AdversarySpec()
    straggler_fraction: float = 0.0     # stale-vote substitution fraction
    elastic: Tuple[ElasticEvent, ...] = ()
    tie_break: str = "auto"             # TIE_POLICIES
    seed: int = 0
    noise_scale: float = 1.0            # grad noise sigma (0 = deterministic)
    learning_rate: float = 0.05
    momentum: float = 0.9               # per-worker (Mode A) beta; 0 = signSGD
    codec: str = "sign1bit"             # gradient codec (DESIGN.md §8)
    plan: PlanSpec = PlanSpec()         # bucketed wire schedule (§9)
    delayed_vote: bool = False          # apply step t's vote at t+1 (§11)
    population: PopulationSpec = PopulationSpec()   # federated axis (§12)

    def __post_init__(self):
        if self.strategy == VoteStrategy.AUTO:
            raise ValueError("scenarios pin a concrete wire strategy; "
                             "AUTO is a trainer-side selector")
        if self.tie_break not in TIE_POLICIES:
            raise ValueError(f"tie_break {self.tie_break!r} not in "
                             f"{TIE_POLICIES}")
        from repro_torch.core import codecs as codecs_mod
        c = codecs_mod.get_codec(self.codec)   # raises on unknown codec
        c.validate_strategy(self.strategy)
        # tie_break must be realisable by EVERY codec actually on the
        # wire — under a plan codec_map that is the mapped set, not just
        # the spec-level codec
        if self.tie_break != "auto":
            for name in self.wire_codecs():
                ties = codecs_mod.get_codec(name).ties(self.strategy)
                if self.tie_break != ties:
                    raise ValueError(
                        f"codec {name!r} over {self.strategy.value} "
                        f"resolves ties to {ties!r}; a "
                        f"{self.tie_break!r} tie policy would need a "
                        "different wire format (DESIGN.md §5/§8/§9)")
        if not 0.0 <= self.straggler_fraction <= 1.0:
            raise ValueError("straggler_fraction not in [0, 1]")
        if self.n_workers < 1 or self.n_steps < 1 or self.dim < 1:
            raise ValueError(f"bad scenario sizes in {self.name!r}")
        if self.plan.enabled:
            shapes = self.plan.leaf_shapes(self.dim)
            if len(shapes) != len(self.plan.leaves or ("x",)):
                raise ValueError(
                    f"duplicate plan leaf names in {self.name!r}")
            if sum(s[0] for s in shapes.values()) != self.dim or \
                    any(s[0] < 1 for s in shapes.values()):
                raise ValueError(
                    f"plan leaves of {self.name!r} must be positive and "
                    f"sum to dim={self.dim}")
            for _, codec_name in self.plan.codec_map:
                mc = codecs_mod.get_codec(codec_name)
                mc.validate_strategy(self.strategy)
                if mc.worker_state:
                    raise ValueError(
                        f"codec {codec_name!r} carries per-worker state "
                        "and cannot appear in a scenario codec_map (use "
                        "the spec-level codec field; the drill's EF "
                        "residual is whole-buffer)")
        steps = [e.step for e in self.elastic]
        if steps != sorted(steps) or len(set(steps)) != len(steps):
            raise ValueError("elastic events must be strictly step-sorted")
        if self.population.enabled:
            # the federated axis runs the streamed population engine
            # (core.population) — every incompatible knob is rejected
            # here, with the reason, instead of failing deep in the run
            if self.strategy == VoteStrategy.HIERARCHICAL:
                raise ValueError(
                    f"{self.name!r}: hierarchical's reduce-scatter wire "
                    "pads to PACK*M words — an O(M) layout the streamed "
                    "population engine exists to avoid; use psum_int8 "
                    "or allgather_1bit")
            if self.plan.enabled:
                raise ValueError(
                    f"{self.name!r}: the plan axis bucketizes a dense "
                    "stacked buffer; population mode streams the flat "
                    "buffer whole (set bucket_bytes=0)")
            if self.elastic:
                raise ValueError(
                    f"{self.name!r}: population mode replaces elastic "
                    "events with ChurnEvent deltas "
                    "(PopulationSpec.churn)")
            if self.momentum > 0:
                raise ValueError(
                    f"{self.name!r}: per-client momentum is O(population "
                    "x dim) state the streamed engine exists to avoid; "
                    "population drills run momentum=0 (pure signSGD)")
            if self.straggler_fraction > 0:
                raise ValueError(
                    f"{self.name!r}: stale-vote substitution needs an "
                    "O(population x dim) prev-signs buffer; in federated "
                    "mode partial participation IS the straggler model "
                    "(sample_fraction < 1)")
            if c.worker_state:
                raise ValueError(
                    f"{self.name!r}: codec {self.codec!r} keeps an "
                    "O(population x dim) per-client residual; population "
                    "drills need a worker-stateless codec")

    # ---- derived ----

    @property
    def salt(self) -> int:
        return scenario_salt(self.name)

    def wire_codecs(self) -> Tuple[str, ...]:
        """The codecs actually on the wire, resolved per leaf when a
        plan codec_map is set (sorted, deduplicated); just the
        spec-level codec otherwise."""
        if not (self.plan.enabled and self.plan.codec_map):
            return (self.codec,)
        from repro_torch.core.vote_plan import resolve_codec_map
        per_leaf = resolve_codec_map(
            sorted(self.plan.leaf_shapes(self.dim)),
            self.plan.codec_map, self.codec)
        return tuple(sorted(set(per_leaf.values())))

    @property
    def tie_policy(self) -> str:
        """The resolved tie convention ("zero" or "plus_one") — the
        codec's, which may override the wire strategy's (§8). A plan
        whose codec map mixes conventions reports "mixed": per-bucket
        codecs deliver per-segment tie semantics on one wire (§9)."""
        from repro_torch.core import codecs as codecs_mod
        ties = {codecs_mod.get_codec(n).ties(self.strategy)
                for n in self.wire_codecs()}
        return ties.pop() if len(ties) == 1 else "mixed"

    def workers_at(self, step: int) -> int:
        """Voter count in effect at `step` under the elastic schedule."""
        n = self.n_workers
        for ev in self.elastic:
            if ev.step <= step:
                n = ev.n_workers
        return n

    def runtime_plan(self, data_size: int):
        """The concrete :class:`~repro_torch.core.vote_plan.VotePlan` for a
        voter-set size (rebuilt at elastic boundaries: only the
        hierarchical wire's bucket alignment depends on it), or None
        when the plan axis is disabled."""
        if not self.plan.enabled:
            return None
        from repro_torch.core import vote_plan as vp
        return vp.build_plan(self.plan.leaf_shapes(self.dim),
                             bucket_bytes=self.plan.bucket_bytes,
                             codec_map=self.plan.codec_map,
                             default_codec=self.codec,
                             strategy=self.strategy,
                             data_size=data_size,
                             overlap=self.plan.overlap)

    # ---- (de)serialisation ----

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["strategy"] = self.strategy.value
        d["elastic"] = [dataclasses.asdict(e) for e in self.elastic]
        d["population"] = {
            **dataclasses.asdict(self.population),
            "churn": [dataclasses.asdict(e)
                      for e in self.population.churn]}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        d = dict(d)
        if "strategy" in d:
            d["strategy"] = VoteStrategy(d["strategy"])
        if "adversary" in d and isinstance(d["adversary"], dict):
            d["adversary"] = AdversarySpec.from_dict(d["adversary"])
        if "elastic" in d:
            d["elastic"] = tuple(
                e if isinstance(e, ElasticEvent) else ElasticEvent(**e)
                for e in d["elastic"])
        if "plan" in d and isinstance(d["plan"], dict):
            p = dict(d["plan"])
            # JSON turns the nested tuples into lists; re-freeze them
            p["codec_map"] = tuple(
                (str(g), str(c)) for g, c in p.get("codec_map", ()))
            p["leaves"] = tuple(
                (str(n), int(ln)) for n, ln in p.get("leaves", ()))
            d["plan"] = PlanSpec(**p)
        if "population" in d and isinstance(d["population"], dict):
            p = dict(d["population"])
            p["churn"] = tuple(
                e if isinstance(e, ChurnEvent) else ChurnEvent(**e)
                for e in p.get("churn", ()))
            d["population"] = PopulationSpec(**p)
        return cls(**d)


def load_scenarios(path: str) -> List[ScenarioSpec]:
    """Scenarios from a JSON config file.

    Accepts either a bare list of spec dicts or ``{"defaults": {...},
    "scenarios": [...]}`` where each scenario overlays the defaults, plus
    an optional ``"grid"`` block expanded by :func:`expand_grid`."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        specs = [ScenarioSpec.from_dict(d) for d in doc]
    else:
        defaults = doc.get("defaults", {})
        specs = [ScenarioSpec.from_dict({**defaults, **d})
                 for d in doc.get("scenarios", [])]
        if "grid" in doc:
            specs.extend(expand_grid(doc["grid"], defaults))
    names = [s.name for s in specs]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        # duplicate names would alias PRNG streams (crc32(name) salt) and
        # benchmark row keys — a config error, never a silent re-run
        raise ValueError(f"duplicate scenario names in {path}: {dupes}")
    return specs


def expand_grid(grid: Dict[str, Any],
                defaults: Optional[Dict[str, Any]] = None
                ) -> List[ScenarioSpec]:
    """Cross-product expansion of a Fig.-4-style sweep block:

    ``{"fractions": [...], "modes": [...], "strategies": [...],
    "base": {...}}`` -> one scenario per (fraction, mode, strategy) cell,
    named ``<prefix>/<mode>/<strategy>/f<pct>``. An optional ``"codecs"``
    list adds a codec axis (§8); its cells are named
    ``<prefix>/<codec>/<mode>/<strategy>/f<pct>`` so the codec-less grid
    keeps its historical names (and PRNG salts). An optional
    ``"delayed"`` list of booleans adds the delayed-vote axis (§11):
    true cells insert a ``delayed`` name segment after the codec; false
    cells keep the historical names, so adding the axis to an existing
    grid never perturbs its PRNG streams.
    """
    base = {**(defaults or {}), **grid.get("base", {})}
    prefix = grid.get("prefix", "grid")
    codecs_axis = grid.get("codecs")
    delayed_axis = grid.get("delayed")
    out, seen = [], set()
    for codec in (codecs_axis or [None]):
      for delayed in (delayed_axis if delayed_axis is not None else [None]):
        for mode in grid["modes"]:
            for strategy in grid["strategies"]:
                for frac in grid["fractions"]:
                    # fraction 0 is the same honest configuration whatever
                    # the mode, so it collapses to ONE anchor cell per
                    # (codec, strategy) — every mode's curve shares its
                    # origin (same name -> same PRNG salt -> same baseline
                    # trace). %g keeps distinct nonzero fractions distinct
                    # (a rounded-percent name would collide sub-percent
                    # cells and alias their PRNG streams).
                    eff_mode = mode if frac > 0 else "none"
                    cell = f"{eff_mode}/{strategy}/f{frac:g}"
                    parts = [prefix]
                    if codec:
                        parts.append(codec)
                    if delayed:
                        parts.append("delayed")
                    name = "/".join(parts + [cell])
                    if name in seen:
                        continue
                    seen.add(name)
                    adv = {"mode": eff_mode, "fraction": frac,
                           **grid.get("adversary_extra", {})}
                    from repro_torch.core import attacks
                    if eff_mode in attacks.MODE_CHANNEL:
                        # adaptive cells state their channel explicitly
                        # (AdversarySpec validation demands it)
                        adv.setdefault("observe",
                                       attacks.MODE_CHANNEL[eff_mode])
                    elif frac == 0:
                        # the honest anchor cell: adaptive-only knobs
                        # from adversary_extra would dangle
                        adv.pop("observe", None)
                        adv.pop("schedule", None)
                    doc = {
                        **base,
                        "name": name,
                        "strategy": strategy,
                        "adversary": adv,
                    }
                    if codec:
                        doc["codec"] = codec
                    if delayed is not None:
                        doc["delayed_vote"] = bool(delayed)
                    out.append(ScenarioSpec.from_dict(doc))
    return out


# ---------------------------------------------------------------------------
# preset library — the boundary regimes the follow-up papers study
# ---------------------------------------------------------------------------


def preset_scenarios() -> List[ScenarioSpec]:
    """Named drills covering the interesting boundary regimes: the paper's
    <50% guarantee, the exact-50% tie, >50% blind adversaries (vote
    rightly fails), colluding coalitions, straggler x adversary
    composition, a mid-run shrink/regrow, and the §15 adaptive
    attackers (margin-targeting, and a sleeper coalition waking into
    the defense-aware reputation mode against the weighted vote)."""
    from repro_torch.core.attacks import AttackPhase
    S = VoteStrategy
    return [
        ScenarioSpec("honest/baseline", n_workers=15, strategy=S.PSUM_INT8),
        ScenarioSpec("adv/sign_flip_25", n_workers=16,
                     strategy=S.ALLGATHER_1BIT,
                     adversary=AdversarySpec("sign_flip", 0.25)),
        ScenarioSpec("adv/tie_at_half", n_workers=16, strategy=S.PSUM_INT8,
                     noise_scale=0.0,
                     adversary=AdversarySpec("sign_flip", 0.5)),
        ScenarioSpec("adv/blind_majority", n_workers=15,
                     strategy=S.HIERARCHICAL,
                     adversary=AdversarySpec("blind", 0.6, flip_prob=0.9)),
        ScenarioSpec("adv/colluding_40", n_workers=15, strategy=S.PSUM_INT8,
                     adversary=AdversarySpec("colluding", 0.4)),
        ScenarioSpec("straggle/stale_adversary", n_workers=16,
                     strategy=S.ALLGATHER_1BIT, straggler_fraction=0.25,
                     adversary=AdversarySpec("sign_flip", 0.25)),
        ScenarioSpec("elastic/shrink_regrow", n_workers=8,
                     strategy=S.PSUM_INT8, n_steps=30,
                     adversary=AdversarySpec("random", 0.25),
                     elastic=(ElasticEvent(10, 4, "pod failure"),
                              ElasticEvent(20, 6, "partial rejoin"))),
        ScenarioSpec("adv/adaptive_low_margin", n_workers=15,
                     strategy=S.ALLGATHER_1BIT,
                     adversary=AdversarySpec("low_margin", 0.375,
                                             observe="margin")),
        ScenarioSpec("adv/sleeper_reputation", n_workers=15,
                     strategy=S.ALLGATHER_1BIT, codec="weighted_vote",
                     adversary=AdversarySpec(
                         "none", 0.0, observe="reputation",
                         schedule=(AttackPhase(step=5, mode="reputation",
                                               fraction=1 / 3),))),
    ]


def fig4_grid(n_workers: int = 16, n_steps: int = 25, dim: int = 512,
              fractions: Sequence[float] = (0.0, 0.125, 0.25, 0.375, 0.5),
              modes: Sequence[str] = ("sign_flip", "random", "zero",
                                      "colluding"),
              strategies: Sequence[str] = ("psum_int8", "allgather_1bit",
                                           "hierarchical"),
              ) -> List[ScenarioSpec]:
    """The paper's Fig. 4 robustness sweep as scenarios: adversary fraction
    0 -> 0.5 x adversary mode x wire strategy (DESIGN.md §7)."""
    return expand_grid({
        "prefix": "fig4",
        "fractions": list(fractions),
        "modes": list(modes),
        "strategies": list(strategies),
        "base": {"n_workers": n_workers, "n_steps": n_steps, "dim": dim},
    })
