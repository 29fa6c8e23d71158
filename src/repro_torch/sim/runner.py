"""ScenarioRunner: deterministic failure drills through the vote path
(``repro.sim.runner``; DESIGN.md §7).

Runs a :class:`~repro_torch.sim.scenario.ScenarioSpec` on the paper's toy
objective: every voter holds the true gradient ``x`` plus N(0, sigma^2)
noise, keeps per-worker SIGNUM momentum (Algorithm 1), and the update
applies the majority vote of the momenta's signs. Between the local sign
and the decision sit the failures: stale-vote stragglers, a Byzantine
coalition and elastic rescale of the voter set, all data on one
``VoteRequest`` a step, executed by ``VirtualBackend`` on `device` (the
hand-written kernels on a card).

Every step gives a :class:`StepTrace` (vote margin, the fraction of
coordinates where the vote differs from the honest-majority oracle, the
loss); the run's digest is sha256 over every step's raw vote bytes and
the final float32 iterate, as the reference's.

**Draws.** The runner takes its start point, per-step noise and
population rows from a ``draws`` object (``init_x(spec) -> (dim,)``,
``noise(spec, step, m) -> (m, dim)``, ``population_rows(spec, ids, x,
step) -> (k, dim)``, numpy arrays or tensors). The default,
:class:`PrngDraws`, keys them as the reference does (``PRNGKey(seed)``
folded with the salt, then 0 for the start point, 1 and the step for the
noise, and 1, the step and the client's logical id for a population row)
with JAX's exact threefry uniforms (``core.prng``), but takes the normal
as ``sqrt(2) * torch.erfinv(u)``, which is not XLA's float32 ``erfinv``:
the default draws are not JAX's bits, so a run's digest equals the
reference's only when the reference's draws are handed in (the parity
tests pass ``repro.sim.runner._init_x`` / ``_noise`` / ``_pop_rows``).
The default draws are made on the host, so a drill gives the same digest
on the CPU and on a card.

**Populations** (``spec.population.n_clients > 0``; DESIGN.md §12). Each
round samples ``sample_fraction`` of the logical population by a
splitmix64 hash of (seed, salt, step) in numpy (:func:`_sample_ids`, bit
for bit the reference's), draws dataset sizes per logical id
(:func:`_client_sizes`) for ``weighting="dataset"``, and votes the
sampled clients' rows as a ``PopulationStream`` through
``core.population`` in chunks of ``chunk_size``. Churn refits the
weighted vote's per-client EMA and the attacker's reputation mirror by the
checkpoint rule. With an adversary the failure-free oracle vote of the
same stream runs first; a reputation attacker's mirror is replayed chunk
by chunk from the round's wire signs.

**Adaptive adversaries.** The attacker's memory
(``attacks.AttackState``) rides beside the server state: the phase in
force sees its channel's observation, and the state is updated once a
round from the vote, its tally and the wire signs, and refit on elastic
rescale.

**Rounding.** The reference's ``prepare`` is jitted, and XLA on the CPU
contracts ``beta * v + (1 - beta) * g`` into ``fma(beta, v, (1 - beta) *
g)`` and ``x + sigma * noise`` into ``fma(sigma, noise, x)``; the port
rounds both as that single FMA (:func:`fma_f32`, exact, on any device).

**Backends.** ``backend="mesh"`` runs the same requests on
``vote_api.MeshBackend``: every rank of an initialised ``torch.distributed``
world runs the drill in lockstep (the same draws, the same stacked
payload), the first M ranks vote their rows over the cached subgroup of
those ranks (an elastic segment re-meshes to its survivors' ranks), and
every rank gets the votes back, so every rank ends with the same trace and
digest, equal to ``backend="virtual"``'s. The margin and the attacker's
observations are taken from the stacked wire signs
(``vote_api.effective_stacked_signs``), as the reference's ``prepare``
derives them; the mesh returns none.

Not ported: ``summary()``'s ``est_exchange_time_s`` is None (the α–β link
model, ROADMAP.md Queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.checkpoint import (refit_leading_axis,
                                               refit_tree_leading_axis)
from repro_torch.core import attacks, population, prng
from repro_torch.core import codecs as codecs_mod
from repro_torch.core import sign_compress as sc
from repro_torch.core import vote_api as va
from repro_torch.distributed.fault_tolerance import count_for_fraction
from repro_torch.obs import recorder as obs
from repro_torch.sim.scenario import ScenarioSpec

BACKENDS = ("virtual", "mesh")


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """One step's structured trace record (the reference's schema)."""

    step: int
    n_workers: int
    n_adversaries: int
    n_stale: int
    margin: float          # mean |vote count| / M  (1 = unanimous)
    flip_fraction: float   # coords where vote != honest-majority oracle
    loss: float            # convergence proxy: 0.5 * mean(x^2) after update
    n_population: int = 0  # logical client population (0 = dense)


@dataclasses.dataclass(frozen=True)
class ScenarioTrace:
    """Full run record: spec + per-step traces + bit-level digest."""

    spec: ScenarioSpec
    backend: str
    steps: Tuple[StepTrace, ...]
    digest: str            # sha256 over every step's raw vote bytes + x
    #: the codec server state after the last step (not in to_dict())
    final_server_state: Any = None

    def summary(self) -> Dict[str, Any]:
        codec = codecs_mod.get_codec(self.spec.codec)
        d = self.spec.dim
        n_buckets = (self.spec.runtime_plan(self.steps[0].n_workers)
                     .n_buckets if self.spec.plan.enabled else 0)
        return {
            "plan_buckets": n_buckets,
            "scenario": self.spec.name,
            "strategy": self.spec.strategy.value,
            "codec": self.spec.codec,
            "bits_per_param": codec.wire_bits(self.spec.strategy),
            "backend": self.backend,
            "tie_policy": self.spec.tie_policy,
            "first_loss": self.steps[0].loss,
            "final_loss": self.steps[-1].loss,
            "loss_drop": self.steps[0].loss - self.steps[-1].loss,
            "mean_margin": float(np.mean([s.margin for s in self.steps])),
            "mean_flip_fraction": float(
                np.mean([s.flip_fraction for s in self.steps])),
            "max_flip_fraction": float(
                np.max([s.flip_fraction for s in self.steps])),
            "wire_bytes_per_replica": d * codec.wire_bits(
                self.spec.strategy) / 8.0,
            # the α–β exchange time needs an H100 link model (item 15)
            "est_exchange_time_s": None,
            "digest": self.digest,
        }

    def to_dict(self) -> Dict[str, Any]:
        return {"spec": self.spec.to_dict(), "backend": self.backend,
                "digest": self.digest,
                "steps": [dataclasses.asdict(s) for s in self.steps],
                "summary": self.summary()}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)


# ---------------------------------------------------------------------------
# draws and rounding
# ---------------------------------------------------------------------------


def _root_key(spec: ScenarioSpec) -> prng.Key:
    return prng.fold_in(prng.prng_key(spec.seed), spec.salt)


#: JAX's normal draws uniforms on (nextafter(-1, 0), 1)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


class PrngDraws:
    """The default draws (see the module doc): JAX's keys and uniforms,
    ``sqrt(2) * torch.erfinv`` for the normal, made in float32 on the
    host."""

    @staticmethod
    def _normal_of(f: torch.Tensor) -> torch.Tensor:
        u = torch.clamp(f * (1.0 - _LO) + _LO, min=_LO)
        return math.sqrt(2.0) * torch.erfinv(u)

    def _normal(self, key: prng.Key, shape) -> torch.Tensor:
        return self._normal_of(prng.uniform(key, shape))

    def init_x(self, spec: ScenarioSpec) -> torch.Tensor:
        return self._normal(prng.fold_in(_root_key(spec), 0), (spec.dim,))

    def noise(self, spec: ScenarioSpec, step: int, m: int) -> torch.Tensor:
        key = prng.fold_in(prng.fold_in(_root_key(spec), 1), step)
        return self._normal(key, (m, spec.dim))

    def population_rows(self, spec: ScenarioSpec, ids: torch.Tensor,
                        x: torch.Tensor, step: int) -> torch.Tensor:
        """Client rows ``x + noise_scale * normal`` of the logical `ids`,
        each row under ``fold_in(fold_in(fold_in(root, 1), step), id)``,
        whatever chunk it lands in; the sum rounded once (:func:`fma_f32`,
        exact on any device)."""
        key = prng.fold_in(prng.fold_in(_root_key(spec), 1), step)
        cid = torch.as_tensor(ids, dtype=torch.int64).cpu() & prng.MASK32
        k0, k1 = prng.threefry2x32(key, torch.zeros_like(cid), cid)
        j = torch.arange(spec.dim, dtype=torch.int64)
        out0, out1 = prng.threefry2x32((k0[:, None], k1[:, None]),
                                       (j >> 32)[None], j[None])
        f = prng.bits_to_uniform(out0 ^ out1)
        return fma_f32(spec.noise_scale, self._normal_of(f),
                       x.detach().cpu().to(torch.float32)[None, :])


def fma_f32(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 ``a * x + y`` rounded once, as an FMA rounds it: the product
    is exact in float64, the sum is rounded to odd (its last bit set where
    it is inexact) and then to float32, which rounds correctly."""
    p = float(np.float32(a)) * x.double()
    yd = y.double()
    s = p + yd
    # TwoSum: the exact error of the float64 sum
    bb = s - p
    err = (p - (s - bb)) + (yd - bb)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    # one ulp toward the error: up in magnitude where it has s's sign
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(inexact_even, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def _recip(n: int) -> np.float32:
    return np.float32(1.0) / np.float32(n)


# population-mode keys (DESIGN.md §12): client sampling (tag 2) and dataset
# sizes (tag 3) are a stateless splitmix64 hash in numpy, keyed by logical
# id and step, never by chunk or device (the reference's, bit for bit)

_SM64 = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xBF58476D1CE4E5B9),
         np.uint64(0x94D049BB133111EB))


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over a uint64 array (wrap-around)."""
    x = (x + _SM64[0]).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * _SM64[1]).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * _SM64[2]).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


def _hash_stream(spec: ScenarioSpec, tag: int, step: int = 0) -> np.ndarray:
    """A (1,) uint64 stream constant chaining (seed, salt, tag, step)."""
    h = np.zeros(1, dtype=np.uint64)
    for v in (spec.seed, spec.salt, tag, step):
        h = _splitmix64(h ^ np.uint64(v))
    return h


def _sample_ids(spec: ScenarioSpec, step: int, pop: int, k: int
                ) -> np.ndarray:
    """The sorted logical ids of the k clients sampled into `step`'s round:
    the k smallest (salt, step)-keyed hash scores; all of them at full
    participation."""
    if k >= pop:
        return np.arange(pop, dtype=np.int32)
    score = _splitmix64(np.arange(pop, dtype=np.uint64)
                        ^ _hash_stream(spec, 2, step))
    sel = np.argpartition(score, k - 1)[:k]
    return np.sort(sel).astype(np.int32)


def _client_sizes(spec: ScenarioSpec, ids: np.ndarray) -> np.ndarray:
    """Dataset sizes of clients `ids`, uniform on [min_data, max_data],
    hashed once per logical id (stable across rounds and churn)."""
    pspec = spec.population
    r = _splitmix64(np.asarray(ids, dtype=np.uint64)
                    ^ _hash_stream(spec, 3))
    span = np.uint64(pspec.max_data - pspec.min_data + 1)
    return (pspec.min_data + (r % span)).astype(np.int32)


def _scaled_sum(counts: torch.Tensor, *divisors: int) -> float:
    """The mean of integer `counts`, divided by the further `divisors`, in
    float32 as the reference's jitted ``jnp.mean(...) / m`` rounds it: XLA
    folds the divisions into one product with the product of the float32
    reciprocals (the sum itself is exact below 2^24)."""
    scale = np.float32(1.0)
    for d in divisors:
        scale = np.float32(scale * _recip(d))
    return float(np.float32(counts.to(torch.int64).sum().item()) * scale)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


class ScenarioRunner:
    """Executes one spec; ``run()`` returns the :class:`ScenarioTrace`.

    `device` is where the drill runs (``"cuda"`` unless told otherwise);
    `draws` gives the start point and the noise (:class:`PrngDraws` by
    default). ``backend="mesh"`` needs every segment's voter count within
    the world's ranks (every rank runs the drill); `mesh_style` takes the
    reference's two layouts, which run the same collectives here."""

    def __init__(self, spec: ScenarioSpec, backend: str = "virtual",
                 device: DeviceLike = None, draws=None,
                 mesh_style: str = "data_model"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if mesh_style not in va.MESH_STYLES:
            raise ValueError(f"unknown mesh_style {mesh_style!r}")
        self.spec = spec
        self.backend = backend
        self.mesh_style = mesh_style
        self.device = resolve_device(device)
        self.draws = draws if draws is not None else PrngDraws()
        if spec.population.enabled and backend != "virtual":
            raise ValueError(
                f"population mode ({spec.name!r}) virtualises more "
                "voters than any physical mesh holds replicas; it runs "
                "on backend='virtual' only (the streamed engine, §12)")
        if backend == "mesh":
            need = max([spec.n_workers] + [e.n_workers for e in spec.elastic])
            have = va.MeshBackend.world_size()
            if need > have:
                raise ValueError(
                    f"mesh backend needs {need} devices for "
                    f"{spec.name!r}, have {have} (use backend='virtual', "
                    "or a torch.distributed world of that many ranks)")
            self._exec = va.MeshBackend(mesh_style=mesh_style,
                                        device=self.device)
        else:
            # population mode streams in the spec's voter chunks (the
            # default is core.population.DEFAULT_CHUNK, so dense drills are
            # unaffected)
            self._exec = va.VirtualBackend(
                device=self.device, chunk_size=spec.population.chunk_size)

    def _tensor(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, np.float32))
        return a.to(device=self.device, dtype=torch.float32)

    def _record_step(self, rec, trace: StepTrace, wire,
                     phase_s: Dict[str, float], n_chunks: int = 0) -> None:
        """One step record: the StepTrace fields joined with the wire report
        and the per-phase span times (the reference's fields)."""
        d = self.spec.dim
        payload = float(wire.payload_bytes)
        fields = dict(
            scenario=self.spec.name, backend=self.backend,
            step=trace.step, n_voters=trace.n_workers,
            n_population=trace.n_population,
            n_adversaries=trace.n_adversaries, n_stale=trace.n_stale,
            strategy=self.spec.strategy.value, codec=self.spec.codec,
            payload_bytes=payload, n_messages=int(wire.n_messages),
            n_coords=d, compression_vs_f32=payload / (4.0 * d),
            margin=trace.margin, flip_fraction=trace.flip_fraction,
            loss=trace.loss, phase_s=phase_s)
        if n_chunks:
            fields["n_chunks"] = n_chunks
        rec.step(**fields)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> ScenarioTrace:
        if self.spec.population.enabled:
            return self._run_population()
        spec, dev = self.spec, self.device
        codec = codecs_mod.get_codec(spec.codec)
        beta = spec.momentum
        lr = float(np.float32(spec.learning_rate))
        x = self._tensor(self.draws.init_x(spec))
        m = spec.workers_at(0)
        v = torch.zeros((m, spec.dim), dtype=torch.float32, device=dev)
        err = torch.zeros_like(v)       # the EF residual, stacked like v
        # last step's locally computed signs (pre-stale, pre-adversary):
        # what a straggler re-submits
        prev = torch.zeros((m, spec.dim), dtype=torch.int8, device=dev)
        pending = torch.zeros(spec.dim, dtype=torch.int8, device=dev)
        att = spec.adversary
        # the attacker's memory, beside the server state
        astate = (attacks.AttackState.init(spec.dim, m, dev) if att.adaptive
                  else None)
        plans: Dict[int, Any] = {}

        def plan_for(m_: int):
            if m_ not in plans:
                plans[m_] = spec.runtime_plan(m_)
            return plans[m_]

        plan = plan_for(m)
        if plan is not None:
            cstate = plan.init_server_state(m, dev)
        else:
            cstate = (codec.init_server_state(m, dev) if codec.server_state
                      else {})
        oracle_backend = va.VirtualBackend(device=dev)
        digest = hashlib.sha256()
        steps: List[StepTrace] = []
        rec = obs.get_recorder()
        for step in range(spec.n_steps):
            m_now = spec.workers_at(step)
            if m_now != m:
                # elastic rescale: per-worker state refits by the
                # checkpoint rule (truncate / zero-pad axis 0): joiners
                # start with zero momentum and residual, an abstaining
                # stale vector and the uninformed-prior weight
                v = refit_leading_axis(v, (m_now, spec.dim))
                err = refit_leading_axis(err, (m_now, spec.dim))
                prev = refit_leading_axis(prev, (m_now, spec.dim))
                cstate = refit_tree_leading_axis(
                    cstate, {k: (m_now,) + tuple(a.shape[1:])
                             for k, a in cstate.items()})
                m = m_now
                if astate is not None:
                    astate = astate.refit(m)
            byz_cfg = att.byz_config_at(step, m, spec.seed)
            byz = byz_cfg if byz_cfg.mode != "none" else None
            aobs = _observation_of(astate, att, byz_cfg)
            n_stale = count_for_fraction(spec.straggler_fraction, m)
            plan = plan_for(m)
            noise = self._tensor(self.draws.noise(spec, step, m))
            with rec.span("scenario.prepare", step=step) as sp_prep:
                g = fma_f32(spec.noise_scale, noise, x[None, :])
                v = (fma_f32(beta, v, sc.flush_subnormals(
                    float(np.float32(1.0 - beta)) * g)) if beta > 0 else g)
                t = err + v if codec.worker_state else v
                fresh = sc.sign_ternary(t)
                # the honest-majority oracle through the same codec decode
                # and plan; the server state is only read
                oracle = oracle_backend.execute(va.VoteRequest(
                    payload=fresh, form="stacked", strategy=spec.strategy,
                    codec=spec.codec, plan=plan,
                    server_state=cstate)).votes
                if rec.enabled:
                    self._sync()
            with rec.span("scenario.vote", step=step,
                          backend=self.backend) as sp_vote:
                out = self._exec.execute(va.VoteRequest(
                    payload=t, form="stacked", strategy=spec.strategy,
                    codec=spec.codec, plan=plan,
                    failures=va.FailureSpec(n_stale=n_stale, byz=byz),
                    prev=prev, step=step, salt=spec.salt,
                    server_state=cstate, overlap=spec.plan.overlap,
                    attack_obs=aobs))
                if rec.enabled:
                    self._sync()
            vote, cstate = out.votes, out.server_state
            eff = out.wire_signs
            if eff is None:   # the mesh holds no stack: derive it
                eff = va.effective_stacked_signs(
                    t, prev, n_stale, byz, step, spec.salt, obs=aobs)
            counts = eff.to(torch.int32).sum(dim=0)
            if astate is not None:
                # one observation a round, from published outputs only
                astate = attacks.update_attack_state(astate, vote, counts,
                                                     eff)
            margin = _scaled_sum(counts.abs(), spec.dim, m)
            if spec.delayed_vote:
                applied, pending = pending, vote
            else:
                applied = vote
            with rec.span("scenario.finish", step=step) as sp_fin:
                # the flip trace scores the FRESH vote against the oracle
                flip = _scaled_sum(vote != oracle, spec.dim)
                x = x - lr * applied.to(torch.float32)
                loss = 0.5 * (x * x).mean()
                if codec.worker_state:
                    # each voter's residual against the applied vote
                    scale = t.abs().mean(dim=1, keepdim=True)
                    err = t - scale * vote[None, :].to(t.dtype)
                if rec.enabled:
                    self._sync()
            prev = fresh
            digest.update(vote.cpu().numpy().tobytes())
            trace = StepTrace(
                step=step, n_workers=m,
                n_adversaries=byz_cfg.num_adversaries, n_stale=n_stale,
                margin=margin, flip_fraction=flip,
                loss=float(loss))
            steps.append(trace)
            if rec.enabled:
                self._record_step(rec, trace, out.wire, phase_s={
                    "prepare": sp_prep.dur_s, "vote": sp_vote.dur_s,
                    "finish": sp_fin.dur_s})
        digest.update(x.cpu().numpy().astype(np.float32).tobytes())
        return ScenarioTrace(spec=spec, backend=self.backend,
                             steps=tuple(steps), digest=digest.hexdigest(),
                             final_server_state=cstate)

    def _run_population(self) -> ScenarioTrace:
        """The federated drill: each round samples clients from the logical
        population, streams their rows through ``core.population`` in
        chunks and applies the (optionally dataset-weighted) majority."""
        spec, dev = self.spec, self.device
        pspec = spec.population
        codec = codecs_mod.get_codec(spec.codec)
        lr = float(np.float32(spec.learning_rate))
        x = self._tensor(self.draws.init_x(spec))
        pop = pspec.clients_at(0)
        # per-client server state and attacker memory over the LOGICAL
        # population (sampled into a round or not)
        cstate = (codec.init_server_state(pop, dev) if codec.server_state
                  else {})
        att = spec.adversary
        astate = (attacks.AttackState.init(spec.dim, pop, dev)
                  if att.adaptive else None)
        pending = torch.zeros(spec.dim, dtype=torch.int8, device=dev)
        digest = hashlib.sha256()
        steps: List[StepTrace] = []
        rec = obs.get_recorder()
        for step in range(spec.n_steps):
            pop_now = pspec.clients_at(step)
            if pop_now != pop:
                # churn: leavers truncate off the top of the id range,
                # joiners zero-pad in at the uninformed prior
                if cstate:
                    cstate = refit_tree_leading_axis(
                        cstate, {k: (pop_now,) + tuple(a.shape[1:])
                                 for k, a in cstate.items()})
                pop = pop_now
                if astate is not None:
                    astate = astate.refit(pop)
            # the coalition is counted over the LOGICAL population (ids
            # below num_adversaries act); a sampled round's share varies
            byz_cfg = att.byz_config_at(step, pop, spec.seed)
            byz = byz_cfg if byz_cfg.mode != "none" else None
            aobs = _observation_of(astate, att, byz_cfg)
            k = max(1, count_for_fraction(pspec.sample_fraction, pop))
            ids = _sample_ids(spec, step, pop, k)

            def values(cids, _x=x, _step=step):
                return self.draws.population_rows(spec, cids, _x, _step)

            stream = va.PopulationStream(
                n_voters=k, n_coords=spec.dim, values=values, ids=ids,
                weights=(_client_sizes(spec, ids)
                         if pspec.weighting == "dataset" else None))
            if byz is not None:
                # the failure-free oracle of the same stream, state only
                # read; first, so population.last.* describe the vote
                oracle = population.streamed_vote(
                    stream, strategy=spec.strategy, codec=spec.codec,
                    step=step, salt=spec.salt, server_state=cstate,
                    chunk_size=pspec.chunk_size, device=dev)[0]
            chunks_before = obs.COUNTERS.get("population.chunks")
            with rec.span("scenario.vote", step=step,
                          backend=self.backend) as sp_vote:
                out = self._exec.execute(va.VoteRequest(
                    payload=stream, form="streamed", strategy=spec.strategy,
                    codec=spec.codec, failures=va.FailureSpec(byz=byz),
                    step=step, salt=spec.salt, server_state=cstate,
                    attack_obs=aobs))
                if rec.enabled:
                    self._sync()
            vote, cstate = out.votes, out.server_state
            flip = (_scaled_sum(vote != oracle, spec.dim)
                    if byz is not None else 0.0)
            if spec.delayed_vote:
                applied, pending = pending, vote
            else:
                applied = vote
            x = x - lr * applied.to(torch.float32)
            loss = float(0.5 * (x * x).mean())
            if astate is not None:
                mis, mis_ids = np.zeros(0, np.float32), np.zeros(0, np.int32)
                if att.observe == "reputation":
                    # replay the codec's flip-EMA observation over the
                    # round's own wire signs, chunk by chunk
                    mis_ids = ids
                    mis = torch.cat([population._chunk_mismatch(
                        population._chunk_signs(
                            stream, ids_np, step, 0, byz, spec.salt,
                            obs=aobs, device=dev), vote)
                        for _, ids_np in population._chunks(
                            stream, pspec.chunk_size)]).cpu().numpy()
                    mis = mis.astype(np.float32) / spec.dim
                astate = attacks.update_attack_state_population(
                    astate, vote, out.counts, mis_ids, mis)
            digest.update(vote.cpu().numpy().tobytes())
            trace = StepTrace(
                step=step, n_workers=k,
                n_adversaries=byz_cfg.num_adversaries, n_stale=0,
                margin=float(out.wire.margin), flip_fraction=flip,
                loss=loss, n_population=pop)
            steps.append(trace)
            if rec.enabled:
                self._record_step(
                    rec, trace, out.wire, phase_s={"vote": sp_vote.dur_s},
                    n_chunks=obs.COUNTERS.get("population.chunks")
                    - chunks_before)
        digest.update(x.cpu().numpy().astype(np.float32).tobytes())
        return ScenarioTrace(spec=spec, backend=self.backend,
                             steps=tuple(steps), digest=digest.hexdigest(),
                             final_server_state=cstate)


def _observation_of(astate, att, byz_cfg):
    """The observation the phase in force may see: None unless its mode is
    adaptive."""
    if astate is None or byz_cfg.mode not in attacks.ATTACK_MODES:
        return None
    return astate.observation(att.observe)


def run_scenarios(specs, backend: str = "virtual", device: DeviceLike = None,
                  draws=None) -> List[ScenarioTrace]:
    return [ScenarioRunner(s, backend=backend, device=device,
                           draws=draws).run() for s in specs]


__all__ = ["BACKENDS", "PrngDraws", "ScenarioRunner", "ScenarioTrace",
           "StepTrace", "fma_f32", "run_scenarios"]
