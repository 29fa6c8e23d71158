"""Parity of the port's adaptive adversaries (``repro_torch.core.attacks``:
the engine, ``AttackState``, both update rules, ``breaking_point``),
``core.theory`` and the trainer's handling of an adaptive mode with the
JAX package's, on the CPU.

Signs, votes, tallies, digests and the float32 reputation EMA are compared
bit for bit. The drills take the reference's draws through the runner's
``draws`` hook; a drill's loss is a float32 mean summed in another order
than XLA's, so the breaking-point rows' loss drops (differences of two such
losses, which are O(1)) are held to within an absolute 1e-6, and every
other row value (the breaking fractions, the defense-degradation weight
difference, the identity digest) exactly. ``breaking_point_rows`` is cut
to one adversary fraction per attack class (0.375 beside the shared
honest anchor), the same cut for both packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro import sim as jsim  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import byzantine as jbyz  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core.attacks import breaking_point as jbp  # noqa: E402
from repro.core.attacks import engine as jeng  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.sim import runner as jrunner  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import byzantine as tbyz  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402
from repro_torch.core.attacks import breaking_point as tbp  # noqa: E402
from repro_torch.core.attacks import engine as teng  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMPipeline as TPipe  # noqa
from repro_torch.train import train_step as tTS  # noqa: E402

TS = tbase.VoteStrategy


# ---------------------------------------------------------------------------
# core.theory
# ---------------------------------------------------------------------------


def test_theory_equals_the_references():
    snr = np.concatenate([np.linspace(0.0, 3.0, 61), [2 / np.sqrt(3.0),
                                                      1e-40, 50.0]])
    for fn in ("lemma1_failure_prob", "gauss_tail_bound"):
        assert np.array_equal(getattr(ttheory, fn)(snr),
                              getattr(jtheory, fn)(snr))
    for m, a in ((1, 0.0), (15, 0.2), (1000, 0.45)):
        assert np.array_equal(ttheory.vote_failure_bound(snr, m, a),
                              jtheory.vote_failure_bound(snr, m, a))
        assert ttheory.theorem2_bound(3.0, 2.0, 1.5, m, a, 400) == \
            jtheory.theorem2_bound(3.0, 2.0, 1.5, m, a, 400)
    assert ttheory.theorem1_bound(2.0, 1.5, 100) == \
        jtheory.theorem1_bound(2.0, 1.5, 100)
    assert ttheory.theorem1_lr(2.0, 1.5, 100) == \
        jtheory.theorem1_lr(2.0, 1.5, 100)
    tf, tg, tx = ttheory.quadratic_problem(dim=50, seed=3)
    jf, jg, jx = jtheory.quadratic_problem(dim=50, seed=3)
    assert np.array_equal(tx, jx) and tf(tx) == jf(jx)
    assert np.array_equal(tg(tx, np.random.default_rng(1)),
                          jg(jx, np.random.default_rng(1)))


# ---------------------------------------------------------------------------
# the adaptive sign transforms
# ---------------------------------------------------------------------------


def _obs(n, m, seed, counts_hi=4):
    rng = np.random.default_rng([5, n, seed])
    return dict(prev_vote=rng.integers(-1, 2, size=n).astype(np.int8),
                prev_abs_counts=rng.integers(0, counts_hi, size=n)
                .astype(np.int32),
                rep=np.float32(0.1) * rng.integers(0, 3, size=m).astype(
                    np.float32) + np.where(rng.random(m) < 0.3,
                                           np.float32(-1e-8), 0)
                .astype(np.float32))


@pytest.mark.parametrize("mode,n,knob", [
    ("adaptive_flip", 37, None),
    # k = round(tf * n) lands on .5: half to even gives 2 and 4
    ("low_margin", 12, 0.125), ("low_margin", 12, 0.375),
    # tf * n = 0.5 rounds to 0, clamped to k = 1
    ("low_margin", 20, 0.025), ("low_margin", 64, 0.25),
    ("low_margin", 33, 1.0),
    # strike_below exactly at a reputation value (no strike there)
    ("reputation", 40, 0.1), ("reputation", 40, 0.2)])
def test_adaptive_signs_match_the_reference(mode, n, knob):
    m = 9
    obs = _obs(n, 30, n)
    rng = np.random.default_rng([6, n])
    signs = rng.integers(-1, 2, size=(m, n)).astype(np.int8)
    ids = np.sort(rng.choice(30, m, replace=False)).astype(np.int32)
    kw = {}
    if mode == "low_margin":
        kw["target_fraction"] = knob
    if mode == "reputation":
        kw["strike_below"] = knob
    want = jbyz.apply_adversary_stacked(
        jnp.asarray(signs), jbase.ByzantineConfig(mode, 20, **kw),
        ids=jnp.asarray(ids), obs={k: jnp.asarray(v) for k, v in
                                   obs.items()})
    got = tbyz.apply_adversary_stacked(
        torch.from_numpy(signs.copy()), tbase.ByzantineConfig(mode, 20, **kw),
        ids=ids.tolist(), obs={k: torch.from_numpy(v) for k, v in
                               obs.items()})
    assert np.array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# AttackState and its updates
# ---------------------------------------------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(j, t):
    for k in ("prev_vote", "prev_abs_counts", "rep"):
        a, b = np.asarray(getattr(j, k)), _np(getattr(t, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_attack_state_init_observation_refit():
    j, t = jeng.AttackState.init(7, 5), teng.AttackState.init(7, 5)
    _same_state(j, t)
    for ch in teng.OBSERVE_CHANNELS:
        jo, to = j.observation(ch), t.observation(ch)
        assert (jo is None) == (to is None)
        if jo is not None:
            assert sorted(jo) == sorted(to)
    with pytest.raises(ValueError):
        t.observation("loud")
    rep = np.arange(5, dtype=np.float32) / 10
    j = dataclasses.replace(j, rep=jnp.asarray(rep))
    t = dataclasses.replace(t, rep=torch.from_numpy(rep))
    for m in (3, 8):
        _same_state(j.refit(m), t.refit(m))
    assert teng.CHANNEL_KEYS == jeng.CHANNEL_KEYS
    assert teng.MODE_CHANNEL == jeng.MODE_CHANNEL
    assert teng.required_channel(["low_margin", "sign_flip"]) == "margin"
    with pytest.raises(ValueError):
        teng.required_channel(["low_margin", "adaptive_flip"])


@pytest.mark.parametrize("n", [1, 48, 333, 1000])
def test_update_attack_state_matches_the_reference(n):
    """The dense update: the mismatch mean is XLA's jitted mean (the count
    times the float32 reciprocal of n), the EMA's one rounding the sum's."""
    rng = np.random.default_rng([7, n])
    m = 6
    eff = rng.integers(-1, 2, size=(m, n)).astype(np.int8)
    vote = rng.choice([-1, 0, 1], size=n).astype(np.int8)
    counts = rng.integers(-m, m + 1, size=n).astype(np.int32)
    rep = rng.random(m).astype(np.float32)
    j = jeng.update_attack_state(
        dataclasses.replace(jeng.AttackState.init(n, m), rep=jnp.asarray(rep)),
        vote, counts, eff)
    t = teng.update_attack_state(
        dataclasses.replace(teng.AttackState.init(n, m),
                            rep=torch.from_numpy(rep)),
        torch.from_numpy(vote), torch.from_numpy(counts),
        torch.from_numpy(eff))
    _same_state(j, t)


def test_update_attack_state_population_matches_the_reference():
    """Only the sampled ids move; int64 counts past int32 wrap as JAX
    narrows them."""
    rng = np.random.default_rng(8)
    n, pop = 50, 40
    ids = np.sort(rng.choice(pop, 12, replace=False)).astype(np.int32)
    mis = (rng.integers(0, n, size=12) / np.float32(n)).astype(np.float32)
    counts = rng.integers(-2 ** 33, 2 ** 33, size=n).astype(np.int64)
    vote = rng.choice([-1, 1], size=n).astype(np.int8)
    rep = (rng.random(pop) * 0.5).astype(np.float32)
    j = jeng.update_attack_state_population(
        dataclasses.replace(jeng.AttackState.init(n, pop),
                            rep=jnp.asarray(rep)), vote, counts, ids, mis)
    t = teng.update_attack_state_population(
        dataclasses.replace(teng.AttackState.init(n, pop),
                            rep=torch.from_numpy(rep)),
        torch.from_numpy(vote), torch.from_numpy(counts), ids, mis)
    _same_state(j, t)


# ---------------------------------------------------------------------------
# the adaptive drills
# ---------------------------------------------------------------------------


class ReferenceDraws:
    """The reference's own start point, noise and population rows."""

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


DRILLS = {
    # low_margin through a plan (a ternary and a weighted bucket group)
    # under stragglers, shrinking then regrowing: the rep mirror refits
    "plan_elastic": tsim.ScenarioSpec(
        "a/plan_elastic", n_workers=7, n_steps=6, dim=96,
        strategy=TS.ALLGATHER_1BIT, straggler_fraction=0.2,
        adversary=tsim.AdversarySpec("low_margin", 0.3, observe="margin",
                                     target_fraction=0.4),
        elastic=(tsim.ElasticEvent(2, 5), tsim.ElasticEvent(4, 9)),
        plan=tsim.PlanSpec(bucket_bytes=8, codec_map=(
            ("embed", "ternary2bit"), ("body", "weighted_vote")),
            leaves=(("embed", 32), ("body", 64)))),
    # adaptive_flip on the count wire, delayed vote, a mid-run schedule
    "flip_delayed": tsim.ScenarioSpec(
        "a/flip_delayed", n_workers=9, n_steps=6, dim=77,
        strategy=TS.PSUM_INT8, delayed_vote=True,
        adversary=tsim.AdversarySpec(
            "adaptive_flip", 0.2, observe="vote",
            schedule=(tsim.AttackPhase(step=3, fraction=0.45),))),
    # reputation against the weighted vote through an elastic shrink
    "reputation_elastic": tsim.ScenarioSpec(
        "a/reputation", n_workers=10, n_steps=7, dim=64,
        strategy=TS.ALLGATHER_1BIT, codec="weighted_vote",
        adversary=tsim.AdversarySpec("reputation", 0.3,
                                     observe="reputation",
                                     strike_below=0.2),
        elastic=(tsim.ElasticEvent(3, 6),)),
}


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_adaptive_drills_digest_as_the_reference(name):
    spec = DRILLS[name]
    port = tsim.ScenarioRunner(spec, device="cpu",
                               draws=ReferenceDraws()).run()
    ref = jsim.ScenarioRunner(_jspec(spec)).run()
    assert port.digest == ref.digest
    for a, b in zip(port.steps, ref.steps):
        assert (a.n_workers, a.n_adversaries, a.margin, a.flip_fraction) \
            == (b.n_workers, b.n_adversaries, b.margin, b.flip_fraction)
    if spec.codec == "weighted_vote":
        assert np.array_equal(
            port.final_server_state["flip_ema"].numpy(),
            np.asarray(ref.final_server_state["flip_ema"]))


# ---------------------------------------------------------------------------
# breaking_point
# ---------------------------------------------------------------------------

#: the cut: the honest anchor and one fraction per class
BP_FRACTIONS = (0.0, 0.375)
_J_ANCHORS, _T_ANCHORS = {}, {}


def _same_rows(jrows, trows):
    assert [r[0] for r in jrows] == [r[0] for r in trows]
    for (name, jv, _), (_, tv, _) in zip(jrows, trows):
        if "/loss_drop_" in name:
            assert abs(tv - jv) <= 1e-6, name
        else:
            assert tv == jv, name


@pytest.mark.parametrize("label", [c["label"] for c in jbp.ATTACK_CLASSES])
def test_breaking_point_curves_match_the_reference(label):
    cls = next(c for c in jbp.ATTACK_CLASSES if c["label"] == label)
    jc = jbp.sweep(cls, fractions=BP_FRACTIONS, _anchors=_J_ANCHORS)
    tc = tbp.sweep(cls, fractions=BP_FRACTIONS, device="cpu",
                   draws=ReferenceDraws(), _anchors=_T_ANCHORS)
    assert tc["snr"] == jc["snr"]
    assert [p["predicted_bound"] for p in tc["points"]] == \
        [p["predicted_bound"] for p in jc["points"]]
    assert [p["mean_flip"] for p in tc["points"]] == \
        [p["mean_flip"] for p in jc["points"]]
    _same_rows(jbp.curve_rows(jc), tbp.curve_rows(tc))


def test_defense_degradation_matches_the_reference():
    j = jbp.defense_degradation()
    t = tbp.defense_degradation(device="cpu", draws=ReferenceDraws())
    assert t == j


def test_identity_rows_mesh_half_raises_population_half_runs():
    """The mesh half needs a world of 8 ranks (tests/test_torch_mesh.py
    runs it); in one process it raises the runner's reason."""
    with pytest.raises(ValueError, match="mesh backend needs 8 devices"):
        tbp.identity_rows(device="cpu", draws=ReferenceDraws())
    name, value, derived = tbp.population_identity_row(
        device="cpu", draws=ReferenceDraws())
    assert (name, value) == ("breaking/identity/population_chunk_invariant",
                             1.0)
    spec = tsim.ScenarioSpec(
        "bp-id/pop", n_workers=8, dim=32, n_steps=5, momentum=0.0,
        population=tsim.PopulationSpec(n_clients=24, sample_fraction=0.5,
                                       chunk_size=7),
        adversary=tsim.AdversarySpec("low_margin", 0.375, observe="margin"))
    assert derived.endswith(jsim.ScenarioRunner(_jspec(spec)).run()
                            .digest[:12])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _trainer_cfgs(pkg, kind, mode):
    base = jbase if pkg == "j" else tbase
    cfg = dataclasses.replace(base.reduced_config(base.get_config(
        "glm4-9b")), dtype="float32")
    tcfg = base.TrainConfig(
        global_batch=4, seq_len=16, optimizer=base.OptimizerConfig(
            kind=kind, learning_rate=1e-3,
            momentum=0.0 if kind == "sgd" else 0.9,
            vote_strategy=base.VoteStrategy.ALLGATHER_1BIT),
        byzantine=base.ByzantineConfig(mode=mode, num_adversaries=1))
    return cfg, tcfg


@functools.lru_cache(maxsize=None)
def _reference_step_error(kind, mode):
    """The reference trainer's first step (mesh-free) with the mode: the
    ValueError's message, or None when it trains."""
    cfg, tcfg = _trainer_cfgs("j", kind, mode)
    art = jTS.make_train_step(cfg, tcfg, mesh=None)
    params, opt = jTS.materialize_state(cfg, tcfg, art,
                                        jax.random.PRNGKey(0))
    tokens = SyntheticLMPipeline(cfg, 4, 16, seed=0).global_batch_at(0)[
        "tokens"]
    try:
        art.step_fn(params, opt, {"tokens": jnp.asarray(tokens)},
                    jnp.int32(0))
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("mode", ["adaptive_flip", "low_margin",
                                  "reputation"])
def test_trainer_with_an_adaptive_mode_raises_as_the_reference(mode, m):
    """A sign-family trainer with an adaptive mode: the reference's
    tree-form vote raises ValueError when its step runs (the reference's
    message at M = 1; a mesh gives the same VoteRequest), and so does the
    port's, at M = 1 and over 4 voters."""
    want = _reference_step_error("signum_vote", "low_margin").replace(
        "'low_margin'", repr(mode))
    cfg, tcfg = _trainer_cfgs("t", "signum_vote", mode)
    art = tTS.make_train_step(cfg, tcfg, m, device="cpu")
    params, state = tTS.materialize_state(cfg, tcfg, art,
                                          torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as got:
        art.step_fn(params, state, {"tokens": torch.zeros(
            (4, 16), dtype=torch.int64)}, 0)
    assert str(got.value) == want


def test_dense_trainer_ignores_an_adaptive_mode_as_the_reference():
    """sgd trains with an adaptive mode in the reference; the port's step
    is bit-equal to its step without an adversary."""
    assert _reference_step_error("sgd", "reputation") is None
    out = []
    for mode in ("reputation", "none"):
        cfg, tcfg = _trainer_cfgs("t", "sgd", mode)
        art = tTS.make_train_step(cfg, tcfg, 2, device="cpu")
        params, state = tTS.materialize_state(
            cfg, tcfg, art, torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(TPipe(cfg, 4, 16, seed=0)
                                  .global_batch_at(0)["tokens"])
        params, _, met = art.step_fn(params, state, {"tokens": tokens}, 0)
        out.append((float(met["loss"]), params))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k])
