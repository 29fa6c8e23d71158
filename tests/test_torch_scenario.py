"""Parity tests of the port's Scenario Lab (``repro_torch.sim``) against the
JAX package's (``repro.sim``): the specs, their names and salts, the grid
expansion, the pinned golden digest and the non-adaptive presets' digests,
bit for bit. The runner's draws are handed over from the reference
(``repro.sim.runner._init_x`` / ``_noise``, as numpy): JAX's normals go
through XLA's float32 ``erfinv``, which ``torch.erfinv`` does not
reproduce, so the port's own draws (``PrngDraws``) are held to the
reference's within a stated tolerance instead. The presets' ``n_steps`` is
cut to PRESET_STEPS for both packages alike.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro import sim as jsim  # noqa: E402
from repro.sim import runner as jrunner  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.configs.base import VoteStrategy as TS  # noqa: E402
from repro_torch.sim import runner as trunner  # noqa: E402

#: tests/tier2/test_scenario_lab.py:159-170
GOLDEN = {"name": "golden/fixed", "n_workers": 16, "n_steps": 10, "dim": 64,
          "strategy": "allgather_1bit",
          "adversary": {"mode": "sign_flip", "fraction": 0.25},
          "straggler_fraction": 0.125, "noise_scale": 0.0}
GOLDEN_DIGEST = \
    "99ff4debfe023768e6391a8eeb976187d8dd3d5f748ba86c33e2a4690bbe32b1"
#: steps of each preset drill, the same cut in both packages
PRESET_STEPS = 8
#: |port normal - JAX normal|: torch.erfinv against XLA's float32 erfinv
#: (~2e-5 at most on 2^20 uniforms, ROADMAP.md item 6's probe), times
#: sqrt(2), with room for the tails
NORMAL_ATOL = 1e-4


class ReferenceDraws:
    """The reference's own start point, noise and population rows, as
    numpy."""

    def init_x(self, spec):
        return np.asarray(jrunner._init_x(_jspec(spec)))

    def noise(self, spec, step, m):
        return np.asarray(jrunner._noise(_jspec(spec), step, m))

    def population_rows(self, spec, ids, x, step):
        return np.asarray(jrunner._population_rows(_jspec(spec))(
            jnp.asarray(ids.numpy()), jnp.asarray(x.cpu().numpy()),
            jnp.int32(step)))


def _jspec(spec):
    return jsim.ScenarioSpec.from_dict(spec.to_dict())


def _both(spec, steps_equal=True):
    port = tsim.ScenarioRunner(spec, device="cpu",
                               draws=ReferenceDraws()).run()
    ref = jsim.ScenarioRunner(_jspec(spec)).run()
    assert port.digest == ref.digest, spec.name
    if steps_equal:
        for a, b in zip(port.steps, ref.steps):
            assert (a.step, a.n_workers, a.n_adversaries, a.n_stale,
                    a.margin, a.flip_fraction) == (
                b.step, b.n_workers, b.n_adversaries, b.n_stale, b.margin,
                b.flip_fraction)
            # the loss is a float32 mean, summed in another order
            assert a.loss == pytest.approx(b.loss, rel=1e-6)
    return port, ref


def test_golden_digest_with_the_references_draws():
    spec = tsim.ScenarioSpec.from_dict(GOLDEN)
    trace = tsim.ScenarioRunner(spec, device="cpu",
                                draws=ReferenceDraws()).run()
    assert trace.digest == GOLDEN_DIGEST
    s = trace.summary()
    assert s["est_exchange_time_s"] is None        # ROADMAP.md item 15
    assert s["scenario"] == "golden/fixed" and s["tie_policy"] == "plus_one"


PRESETS = [s for s in jsim.preset_scenarios() if not s.adversary.adaptive]


@pytest.mark.parametrize("name", [s.name for s in PRESETS])
def test_non_adaptive_presets_digest_as_the_reference(name):
    spec = next(s for s in tsim.preset_scenarios() if s.name == name)
    _both(dataclasses.replace(spec, n_steps=min(spec.n_steps,
                                                PRESET_STEPS)))


@pytest.mark.parametrize("case", ["plan_elastic", "delayed_hier",
                                  "signsgd_blind", "scheduled"])
def test_composed_drills_digest_as_the_reference(case):
    """A plan (ternary embeddings, weighted body) under stragglers, a random
    coalition and an elastic regrow; delayed_vote on hierarchical at a dim
    that is no power of two; signSGD against a blind majority; a coalition
    whose mode and fraction change at steps 2 and 4 (an attack schedule)."""
    S = TS
    spec = {
        "plan_elastic": tsim.ScenarioSpec(
            "t/plan_elastic", n_workers=6, n_steps=6, dim=96,
            strategy=S.ALLGATHER_1BIT,
            adversary=tsim.AdversarySpec("random", 1 / 3),
            straggler_fraction=0.2,
            elastic=(tsim.ElasticEvent(3, 9),),
            plan=tsim.PlanSpec(bucket_bytes=8, overlap=True,
                               codec_map=(("embed", "ternary2bit"),
                                          ("body", "weighted_vote")),
                               leaves=(("embed", 32), ("body", 64)))),
        "delayed_hier": tsim.ScenarioSpec(
            "t/delayed", n_workers=7, n_steps=6, dim=100,
            strategy=S.HIERARCHICAL, delayed_vote=True,
            adversary=tsim.AdversarySpec("colluding", 0.3)),
        "signsgd_blind": tsim.ScenarioSpec(
            "t/blind", n_workers=5, n_steps=6, dim=77, momentum=0.0,
            strategy=S.PSUM_INT8,
            adversary=tsim.AdversarySpec("blind", 0.6, flip_prob=0.7)),
        "scheduled": tsim.ScenarioSpec(
            "t/scheduled", n_workers=8, n_steps=6, dim=64,
            strategy=S.ALLGATHER_1BIT,
            adversary=tsim.AdversarySpec(
                "sign_flip", 0.125, schedule=(
                    tsim.AttackPhase(step=2, mode="random"),
                    tsim.AttackPhase(step=4, fraction=0.5,
                                     mode="colluding")))),
    }[case]
    _both(spec)


def test_specs_names_and_salts_equal_the_references():
    tp = tsim.preset_scenarios()
    jp = jsim.preset_scenarios()
    assert [s.to_dict() for s in tp] == [s.to_dict() for s in jp]
    tg, jg = tsim.fig4_grid(), jsim.fig4_grid()
    assert len(tg) == 51
    assert [(s.name, s.salt) for s in tg] == [(s.name, s.salt) for s in jg]
    path = str(Path(__file__).resolve().parents[1] / "benchmarks" / "configs"
               / "fig4_grid.json")
    assert [s.to_dict() for s in tsim.load_scenarios(path)] == \
        [s.to_dict() for s in jsim.load_scenarios(path)]
    spec = tsim.ScenarioSpec(
        "io/x", n_workers=9, n_steps=7, dim=33, strategy=TS.HIERARCHICAL,
        adversary=tsim.AdversarySpec("blind", 0.3, flip_prob=0.9),
        straggler_fraction=0.25, elastic=(tsim.ElasticEvent(3, 5, "died"),))
    assert tsim.ScenarioSpec.from_dict(json.loads(json.dumps(
        spec.to_dict()))) == spec
    assert tsim.scenario_salt("a/b") == jsim.scenario_salt("a/b")


@pytest.mark.parametrize("bad", [
    dict(strategy=TS.AUTO), dict(adversary=dict(mode="voldemort")),
    dict(adversary=dict(mode="random", fraction=1.5)),
    dict(elastic=[dict(step=5, n_workers=2), dict(step=3, n_workers=4)]),
    dict(strategy=TS.ALLGATHER_1BIT, tie_break="zero"),
    dict(adversary=dict(mode="random", fraction=0.1, observe="margin"))])
def test_spec_validation_as_the_reference(bad):
    doc = {"name": "bad", **bad}
    if "strategy" in doc:
        doc["strategy"] = doc["strategy"].value
    with pytest.raises(ValueError):
        jsim.ScenarioSpec.from_dict(doc)
    with pytest.raises(ValueError):
        tsim.ScenarioSpec.from_dict(doc)


@pytest.mark.parametrize("case,item", [("mesh", "5")])
def test_what_still_raises(case, item):
    """The mesh backend runs since the multi-process wire's slice (item 5);
    in one process it refuses a drill of more voters than the world has
    ranks, with the reference's reason."""
    with pytest.raises(ValueError, match="mesh backend needs 8 devices"):
        tsim.ScenarioRunner(tsim.ScenarioSpec("m", n_workers=8),
                            backend="mesh", device="cpu")


@pytest.mark.parametrize("case", ["population", "adaptive",
                                  "scheduled_adaptive"])
def test_item10_drills_digest_as_the_reference(case):
    """A full-participation population of 100 clients and the two
    adaptive presets (uncut) equal to the reference under its draws."""
    spec = {"population": tsim.ScenarioSpec(
                "p", momentum=0.0, n_steps=6, population=tsim.PopulationSpec(
                    n_clients=100)),
            "adaptive": next(s for s in tsim.preset_scenarios()
                             if s.adversary.mode == "low_margin"),
            "scheduled_adaptive": next(
                s for s in tsim.preset_scenarios()
                if s.adversary.schedule)}[case]
    _both(spec)


def test_port_draws_match_the_references_up_to_erfinv():
    """PrngDraws keys and uniforms are JAX's; only erfinv differs."""
    spec = tsim.ScenarioSpec("draws/x", n_workers=5, dim=300, seed=2)
    d = trunner.PrngDraws()
    ref = ReferenceDraws()
    np.testing.assert_allclose(d.init_x(spec).numpy(), ref.init_x(spec),
                               rtol=0, atol=NORMAL_ATOL)
    np.testing.assert_allclose(d.noise(spec, 3, 5).numpy(),
                               ref.noise(spec, 3, 5), rtol=0,
                               atol=NORMAL_ATOL)


def test_default_draws_run_and_replay():
    spec = dataclasses.replace(tsim.preset_scenarios()[1], n_steps=4)
    a = tsim.ScenarioRunner(spec, device="cpu").run()
    b = tsim.ScenarioRunner(spec, device="cpu").run()
    assert a.digest == b.digest
    assert all(np.isfinite(s.loss) for s in a.steps)


def test_fma_f32_is_xlas_contraction():
    """``fma_f32(beta, v, c * g)`` is bit-equal to the reference's jitted
    ``beta * v + (1 - beta) * g`` (XLA contracts it into an FMA), on random
    values and on sums that cancel."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 1024)).astype(np.float32)
    g = rng.normal(size=(64, 1024)).astype(np.float32)
    g[0] = -np.float32(9.0) * v[0]             # 0.9 v + 0.1 g cancels
    g[1] = v[1] * np.float32(1 + 2 ** -20)
    beta = 0.9
    want = np.asarray(jax.jit(lambda v, g: beta * v + (1.0 - beta) * g)(
        jnp.asarray(v), jnp.asarray(g)))
    c = float(np.float32(1.0 - beta))
    got = trunner.fma_f32(beta, torch.from_numpy(v),
                          c * torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_attack_schedule_as_the_reference():
    from repro.core import attacks as jatt
    from repro_torch.core import attacks as tatt
    sched = (tatt.AttackPhase(2, mode="random"),
             tatt.AttackPhase(5, fraction=0.5),
             tatt.AttackPhase(7, mode="blind", fraction=0.25))
    jsched = tuple(jatt.AttackPhase(p.step, p.fraction, p.mode)
                   for p in sched)
    tatt.validate_schedule(sched)
    for step in range(9):
        assert tatt.phase_at(sched, "sign_flip", 0.125, step) == \
            jatt.phase_at(jsched, "sign_flip", 0.125, step)
    assert tatt.modes_used(sched, "none") == jatt.modes_used(jsched, "none")
    assert tatt.required_channel(["low_margin", "random"]) == "margin"
    for bad in (lambda m: m.AttackPhase(0, mode="random"),
                lambda m: m.AttackPhase(3),
                lambda m: m.AttackPhase(3, fraction=2.0),
                lambda m: m.validate_schedule((m.AttackPhase(3, 0.1),
                                               m.AttackPhase(3, 0.2))),
                lambda m: m.required_channel(["low_margin",
                                              "adaptive_flip"])):
        for mod in (jatt, tatt):
            with pytest.raises(ValueError):
                bad(mod)
    spec = tsim.AdversarySpec("sign_flip", 0.125, schedule=sched)
    jspec = jsim.AdversarySpec.from_dict(dataclasses.asdict(spec))
    for step in range(9):
        assert dataclasses.asdict(spec.byz_config_at(step, 16, 3)) == \
            dataclasses.asdict(jspec.byz_config_at(step, 16, 3))
