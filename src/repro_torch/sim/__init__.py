"""Scenario Lab (``repro.sim``): deterministic failure drills through the
port's vote path (DESIGN.md §7).

    from repro_torch.sim import ScenarioSpec, AdversarySpec, ScenarioRunner

    spec = ScenarioSpec("demo", n_workers=15,
                        adversary=AdversarySpec("colluding", 0.4))
    trace = ScenarioRunner(spec, device="cuda").run()
    print(trace.summary())
"""
from repro_torch.core.attacks import AttackPhase
from repro_torch.sim.scenario import (AdversarySpec, ChurnEvent, ElasticEvent,
                                      PlanSpec, PopulationSpec, ScenarioSpec,
                                      expand_grid, fig4_grid, load_scenarios,
                                      preset_scenarios, scenario_salt)
from repro_torch.sim.runner import (BACKENDS, PrngDraws, ScenarioRunner,
                                    ScenarioTrace, StepTrace, run_scenarios)
from repro_torch.sim.virtual_mesh import (VirtualVoteEngine,
                                          virtual_plan_vote, virtual_vote,
                                          virtual_vote_codec)

__all__ = [
    "AdversarySpec", "AttackPhase", "BACKENDS", "ChurnEvent",
    "ElasticEvent", "PlanSpec", "PopulationSpec", "PrngDraws",
    "ScenarioRunner", "ScenarioSpec", "ScenarioTrace", "StepTrace",
    "VirtualVoteEngine", "expand_grid", "fig4_grid", "load_scenarios",
    "preset_scenarios", "run_scenarios", "scenario_salt",
    "virtual_plan_vote", "virtual_vote", "virtual_vote_codec",
]
