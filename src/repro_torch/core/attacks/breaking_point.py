"""Measured against predicted breaking points (``repro.core.attacks.
breaking_point``; DESIGN.md §15).

Theorem 2 guarantees convergence while the per-coordinate vote failure
bound (``core.theory.vote_failure_bound``) stays below 1/2, and it is proved
for blind adversaries. :func:`sweep` runs one attack class over a grid of
adversary fractions through the Scenario Lab (the same drill and seeds,
only the coalition changing) and reports each fraction's loss drop beside
the predicted bound ``min(1, 1 / ((1 - 2a) sqrt(M) S))`` at the drill's
initial SNR. The measured breaking fraction is the smallest one whose loss
drop is at most 5 % of the honest drop; the predicted one the smallest at
which the bound reaches 1/2.

Every function takes ``device`` and ``draws``, handed to
``sim.ScenarioRunner`` (the drills run on the card unless told otherwise;
``draws`` defaults to the runner's own). :func:`identity_rows`'s first half
replays a drill on ``backend="mesh"``, which raises (ROADMAP.md Queue 1
item 5); its second half, :func:`population_identity_row`, runs.

Not imported by ``repro_torch.core.attacks`` (it imports the Scenario Lab,
and ``core.byzantine`` dispatches into that package from inside the vote):
``from repro_torch.core.attacks import breaking_point``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.core import theory
from repro_torch.distributed.fault_tolerance import count_for_fraction

#: the adversary-fraction grid every curve walks (0 anchors the honest
#: drop the breaking criterion is relative to; 0.5 is the theory wall)
FRACTIONS = (0.0, 0.25, 0.375, 0.5)

#: "no meaningful progress": loss drop <= this share of the honest drop
BREAK_REL_TOL = 0.05

#: the attack classes the bench sweeps; ``sleeper`` builds its coalition
#: as a mid-run schedule (the base spec is honest)
ATTACK_CLASSES: Tuple[Dict[str, Any], ...] = (
    dict(label="colluding", mode="colluding", observe="none"),
    dict(label="adaptive_flip", mode="adaptive_flip", observe="vote"),
    dict(label="low_margin", mode="low_margin", observe="margin"),
    dict(label="sleeper", mode="none", observe="none", sleeper=True),
    dict(label="reputation", mode="reputation", observe="reputation",
         codec="weighted_vote"),
)


def predicted_failure_bound(snr: float, m_workers: int, alpha: float
                            ) -> float:
    """``min(1, vote_failure_bound)``; 1.0 at and beyond ``alpha = 1/2``."""
    if alpha >= 0.5:
        return 1.0
    return float(min(1.0, theory.vote_failure_bound(
        np.asarray(snr), m_workers, alpha)))


def _make_spec(cls: Dict[str, Any], fraction: float, *, n_workers: int,
               dim: int, n_steps: int, seed: int):
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core.attacks import AttackPhase
    from repro_torch.sim.scenario import AdversarySpec, ScenarioSpec
    codec = cls.get("codec", "sign1bit")
    kw: Dict[str, Any] = dict(codec=codec)
    if codec == "weighted_vote":
        kw["strategy"] = VoteStrategy.ALLGATHER_1BIT
    if cls.get("sleeper") and fraction > 0:
        # honest base spec, the coalition wakes mid-run
        adv = AdversarySpec(
            mode="none", fraction=0.0,
            schedule=(AttackPhase(step=max(1, n_steps // 3),
                                  mode="sign_flip", fraction=fraction),))
    else:
        adv = AdversarySpec(mode=cls["mode"] if fraction > 0 else "none",
                            fraction=fraction,
                            observe=(cls["observe"] if fraction > 0
                                     else "none"))
    # one name (one salt, one start point and noise) per codec family:
    # every point of every curve replays the same drill
    return ScenarioSpec(
        name=f"bp/{codec}", n_workers=n_workers,
        dim=dim, n_steps=n_steps, seed=seed, **kw, adversary=adv)


def _runner(spec, backend: str, device: DeviceLike, draws):
    from repro_torch.sim.runner import ScenarioRunner
    return ScenarioRunner(spec, backend=backend, device=device, draws=draws)


def sweep(cls: Dict[str, Any], *, fractions: Sequence[float] = FRACTIONS,
          n_workers: int = 15, dim: int = 48, n_steps: int = 6,
          seed: int = 0, backend: str = "virtual",
          device: DeviceLike = None, draws=None,
          _anchors: Optional[Dict[str, Dict[str, Any]]] = None
          ) -> Dict[str, Any]:
    """One attack class's measured-vs-predicted breaking-point curve
    (``_anchors``, codec -> f=0 summary, shares the honest anchor run
    across classes)."""
    from repro_torch.sim.runner import PrngDraws
    draws = draws if draws is not None else PrngDraws()
    points: List[Dict[str, Any]] = []
    snr = None
    for f in fractions:
        spec = _make_spec(cls, f, n_workers=n_workers, dim=dim,
                          n_steps=n_steps, seed=seed)
        if snr is None:
            # the drill's gradient is x + noise_scale * N(0, 1): the mean
            # initial per-coordinate SNR is mean|x0| / sigma
            x0 = np.asarray(draws.init_x(spec), dtype=np.float32)
            snr = float(np.mean(np.abs(x0))
                        / max(spec.noise_scale, 1e-30))
        codec = spec.codec
        if f == 0 and _anchors is not None and codec in _anchors:
            s = _anchors[codec]
        else:
            s = _runner(spec, backend, device, draws).run().summary()
            if f == 0 and _anchors is not None:
                _anchors[codec] = s
        alpha = count_for_fraction(f, n_workers) / n_workers
        points.append(dict(
            fraction=f, alpha=alpha,
            loss_drop=s["loss_drop"], final_loss=s["final_loss"],
            mean_flip=s["mean_flip_fraction"],
            predicted_bound=predicted_failure_bound(snr, n_workers, alpha)))
    honest_drop = points[0]["loss_drop"]
    measured = next((p["fraction"] for p in points
                     if p["loss_drop"] <= BREAK_REL_TOL * honest_drop), 1.0)
    predicted = next((p["fraction"] for p in points
                      if p["predicted_bound"] >= 0.5), 1.0)
    return dict(label=cls["label"], snr=snr, n_workers=n_workers,
                points=points, measured_breaking_fraction=measured,
                predicted_breaking_fraction=predicted)


def curve_rows(curve: Dict[str, Any]) -> List[Tuple[str, float, str]]:
    """A sweep result as ``(name, value, derived)`` bench rows."""
    label = curve["label"]
    out = []
    for p in curve["points"]:
        out.append((
            f"breaking/{label}/loss_drop_f{p['fraction']:g}",
            p["loss_drop"],
            f"final={p['final_loss']:.4f} flip={p['mean_flip']:.3f} "
            f"alpha={p['alpha']:.3f} "
            f"pred_bound={p['predicted_bound']:.3f}"))
    out.append((
        f"breaking/{label}/measured_breaking_fraction",
        curve["measured_breaking_fraction"],
        f"theory(oblivious)={curve['predicted_breaking_fraction']:g} "
        f"snr={curve['snr']:.3f} M={curve['n_workers']} "
        f"(measured < theory means the observation channel beats the "
        f"blind-adversary analysis)"))
    return out


def defense_degradation(*, fraction: float = 0.3, n_workers: int = 15,
                        dim: int = 48, n_steps: int = 10, seed: int = 0,
                        backend: str = "virtual", device: DeviceLike = None,
                        draws=None) -> Tuple[str, float, str]:
    """How much a defense-aware attacker degrades the weighted vote against
    an oblivious colluding coalition of the same size: the mean reliability
    weight the defense gives the adversaries at the end of the run (aware
    minus oblivious; positive = the aware attacker keeps the weight the
    flip-EMA strips from the oblivious one)."""
    from repro_torch.core.codecs.weighted import reliability_weights
    n_adv = count_for_fraction(fraction, n_workers)
    weights, flips = {}, {}
    for label, cls in (("oblivious", dict(label="obl", mode="colluding",
                                          observe="none",
                                          codec="weighted_vote")),
                       ("aware", dict(label="aware", mode="reputation",
                                      observe="reputation",
                                      codec="weighted_vote"))):
        spec = _make_spec(cls, fraction, n_workers=n_workers, dim=dim,
                          n_steps=n_steps, seed=seed)
        trace = _runner(spec, backend, device, draws).run()
        ema = trace.final_server_state["flip_ema"]
        weights[label] = float(np.mean(
            reliability_weights(ema).cpu().numpy()[:n_adv]))
        # the damage still done late in the run
        flips[label] = float(np.mean(
            [s.flip_fraction for s in trace.steps[n_steps // 2:]]))
    return ("breaking/defense_aware_degradation",
            weights["aware"] - weights["oblivious"],
            f"weighted_vote f={fraction:g}: mean adversary weight "
            f"aware={weights['aware']:.3f} vs oblivious"
            f"={weights['oblivious']:.3f}; late-run flip fraction "
            f"aware={flips['aware']:.3f} vs oblivious"
            f"={flips['oblivious']:.3f} (positive = the aware attacker "
            f"keeps the weight the flip-EMA strips from the oblivious "
            f"one)")


def population_identity_row(*, dim: int = 32, n_steps: int = 5,
                            seed: int = 0, device: DeviceLike = None,
                            draws=None) -> Tuple[str, float, str]:
    """A streamed adaptive population (``low_margin``) gives one digest at
    chunk sizes 3, 7 and 24 (asserted)."""
    from repro_torch.sim.scenario import (AdversarySpec, PopulationSpec,
                                          ScenarioSpec)
    digests = []
    for chunk in (3, 7, 24):
        spec = ScenarioSpec(
            name="bp-id/pop", n_workers=8, dim=dim, n_steps=n_steps,
            seed=seed, momentum=0.0,
            population=PopulationSpec(n_clients=24, sample_fraction=0.5,
                                      chunk_size=chunk),
            adversary=AdversarySpec("low_margin", 0.375,
                                    observe="margin"))
        digests.append(_runner(spec, "virtual", device, draws).run().digest)
    if len(set(digests)) != 1:
        raise AssertionError(
            f"adaptive population vote depends on chunk size: {digests}")
    return ("breaking/identity/population_chunk_invariant", 1.0,
            f"chunks (3,7,24) digest {digests[0][:12]}")


def identity_rows(*, dim: int = 32, n_steps: int = 5, seed: int = 0,
                  device: DeviceLike = None, draws=None
                  ) -> List[Tuple[str, float, str]]:
    """The §15 equivalence gates as asserted rows: an adaptive drill
    replays bit-identically on ``backend="mesh"`` and ``"virtual"`` (the
    mesh backend raises: ROADMAP.md Queue 1 item 5), and a streamed
    adaptive population is chunk-invariant."""
    from repro_torch.configs.base import VoteStrategy
    from repro_torch.core.attacks import AttackPhase
    from repro_torch.sim.scenario import AdversarySpec, ScenarioSpec
    out: List[Tuple[str, float, str]] = []
    spec = ScenarioSpec(
        name="bp-id/scheduled_reputation", n_workers=8, dim=dim,
        n_steps=n_steps, seed=seed,
        adversary=AdversarySpec(
            "none", 0.0, observe="reputation",
            schedule=(AttackPhase(step=2, mode="reputation",
                                  fraction=0.375),)),
        codec="weighted_vote", strategy=VoteStrategy.ALLGATHER_1BIT)
    mesh = _runner(spec, "mesh", device, draws)
    tv = _runner(spec, "virtual", device, draws).run()
    tm = mesh.run()
    if tv.digest != tm.digest:
        raise AssertionError(
            f"scheduled_reputation: adaptive attack diverged across "
            f"backends ({tv.digest[:12]} != {tm.digest[:12]})")
    out.append(("breaking/identity/scheduled_reputation_mesh_eq_virtual",
                1.0, f"digest {tv.digest[:12]}"))
    out.append(population_identity_row(dim=dim, n_steps=n_steps, seed=seed,
                                       device=device, draws=draws))
    return out


def breaking_point_rows(*, fractions: Sequence[float] = FRACTIONS,
                        n_workers: int = 15, dim: int = 48,
                        n_steps: int = 6, seed: int = 0,
                        backend: str = "virtual",
                        with_identity: bool = True,
                        device: DeviceLike = None, draws=None
                        ) -> List[Tuple[str, float, str]]:
    """Every attack class's curve, the defense-aware degradation row, and
    (``with_identity``) :func:`identity_rows`."""
    rows: List[Tuple[str, float, str]] = []
    anchors: Dict[str, Dict[str, Any]] = {}
    for cls in ATTACK_CLASSES:
        rows.extend(curve_rows(sweep(
            cls, fractions=fractions, n_workers=n_workers, dim=dim,
            n_steps=n_steps, seed=seed, backend=backend, device=device,
            draws=draws, _anchors=anchors)))
    rows.append(defense_degradation(n_workers=n_workers, dim=dim,
                                    seed=seed, backend=backend,
                                    device=device, draws=draws))
    if with_identity:
        rows.extend(identity_rows(seed=seed, device=device, draws=draws))
    return rows


__all__ = ["ATTACK_CLASSES", "BREAK_REL_TOL", "FRACTIONS",
           "breaking_point_rows", "curve_rows", "defense_degradation",
           "identity_rows", "population_identity_row",
           "predicted_failure_bound", "sweep"]
