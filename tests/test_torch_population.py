"""Parity of the port's streamed population engine (``repro_torch.core.
population``, the vote API's ``streamed`` form and its ``voter_ids`` /
``weights`` annotations) and the Scenario Lab's population drills with the
JAX package's, on the CPU (the kernels' plain versions).

The same numpy rows, logical ids and dataset weights go to both packages.
Votes, tallies and ``weighted_vote``'s float32 flip-EMA are compared bit
for bit, and so is the margin (the reference's float64 ``mean(|tally|) /
weight``, which the port computes from the exact int64 sum): there is no
tolerance. Each engine case runs the reference once at a ragged chunk size
(7 rows) and the port at chunk sizes 1, 7 and M, so the port's chunk
invariance is held against the reference's result. The drills take the
reference's population rows through the runner's ``draws`` hook (JAX's
normals cannot be reproduced, see ``test_torch_scenario.py``); their
losses are float32 means summed in another order and are held to rtol
1e-6, everything else (digest, margins, flip fractions) exactly.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sim as jsim  # noqa: E402
from repro.configs.base import ByzantineConfig as JByz  # noqa: E402
from repro.configs.base import VoteStrategy as JS  # noqa: E402
from repro.core import population as jpop  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core.attacks import AttackState as JState  # noqa: E402
from repro.sim import runner as jrunner  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.configs.base import ByzantineConfig as TByz  # noqa: E402
from repro_torch.configs.base import VoteStrategy as TS  # noqa: E402
from repro_torch.core import population as tpop  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core.attacks import AttackState as TState  # noqa: E402
from repro_torch.obs import COUNTERS  # noqa: E402
from repro_torch.sim import runner as trunner  # noqa: E402

#: sampled voters of a round, coordinates, logical population
M, N, POP = 37, 70, 60
#: the reference's chunk size (ragged: 37 = 5 * 7 + 2)
REF_CHUNK = 7
#: every codec on the strategies it rides in the streamed engine
CODEC_WIRES = [("sign1bit", "psum_int8"), ("sign1bit", "allgather_1bit"),
               ("ef_sign", "psum_int8"), ("ef_sign", "allgather_1bit"),
               ("ternary2bit", "psum_int8"),
               ("ternary2bit", "allgather_1bit"),
               ("weighted_vote", "allgather_1bit")]
#: honest, two stochastic coalitions, the three adaptive modes
ADVERSARIES = [None, ("colluding", 10), ("blind", 12), ("adaptive_flip", 9),
               ("low_margin", 20), ("reputation", 15)]
_CHANNEL = {"adaptive_flip": "vote", "low_margin": "margin",
            "reputation": "reputation"}


@functools.lru_cache(maxsize=None)
def _population(seed: int = 0):
    """Rows of the logical population (zeros planted), the round's sorted
    ids, its dataset weights and an observation of each channel."""
    rng = np.random.default_rng([31, seed])
    x = rng.normal(size=(POP, N)).astype(np.float32)
    x[:, :3] = 0.0
    x[::4, 5] = -0.0
    ids = np.sort(rng.choice(POP, M, replace=False)).astype(np.int32)
    w = rng.integers(1, 40, size=M).astype(np.int64)
    obs = dict(prev_vote=rng.integers(-1, 2, size=N).astype(np.int8),
               # small counts: ties at the low_margin threshold
               prev_abs_counts=rng.integers(0, 5, size=N).astype(np.int32),
               rep=(rng.random(POP) * 0.2).astype(np.float32))
    ema = (rng.random(POP) * 0.3).astype(np.float32)
    return x, ids, w, obs, ema


def _args(pkg, codec, wire, weighted, adv):
    """(stream, kwargs) of one engine call in package `pkg` ("j" / "t")."""
    x, ids, w, obs, ema = _population()
    j = pkg == "j"
    values = ((lambda c: jnp.asarray(x)[c]) if j
              else (lambda c: x[c.numpy()]))
    va = jva if j else tva
    stream = va.PopulationStream(n_voters=M, n_coords=N, values=values,
                                 ids=ids, weights=w if weighted else None)
    S = JS if j else TS
    kw = dict(strategy=getattr(S, wire.upper()), codec=codec, step=2,
              salt=5)
    if adv is not None:
        kw["byz"] = (JByz if j else TByz)(mode=adv[0],
                                          num_adversaries=adv[1], seed=3)
        if adv[0] in _CHANNEL:
            state = (JState(*(jnp.asarray(obs[k]) for k in
                              ("prev_vote", "prev_abs_counts", "rep")))
                     if j else
                     TState(*(torch.from_numpy(obs[k]) for k in
                              ("prev_vote", "prev_abs_counts", "rep"))))
            kw["attack_obs"] = state.observation(_CHANNEL[adv[0]])
    if codec == "weighted_vote":
        kw["server_state"] = {"flip_ema": jnp.asarray(ema) if j
                              else torch.from_numpy(ema)}
    return stream, kw


@pytest.mark.parametrize("adv", ADVERSARIES,
                         ids=lambda a: "honest" if a is None else a[0])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["uniform", "dataset"])
@pytest.mark.parametrize("codec,wire", CODEC_WIRES)
def test_streamed_vote_matches_reference(codec, wire, weighted, adv):
    stream, kw = _args("j", codec, wire, weighted, adv)
    jv, jstate, jmargin, jcounts = jpop.streamed_vote(
        stream, chunk_size=REF_CHUNK, **kw)
    for chunk in (1, REF_CHUNK, M):
        stream, kw = _args("t", codec, wire, weighted, adv)
        tv, tstate, tmargin, tcounts = tpop.streamed_vote(
            stream, chunk_size=chunk, device="cpu", **kw)
        assert tv.dtype == torch.int8 and tcounts.dtype == torch.int64
        assert np.array_equal(np.asarray(jv), tv.numpy()), chunk
        assert np.array_equal(np.asarray(jcounts), tcounts.numpy()), chunk
        assert tmargin == jmargin, chunk
        if codec == "weighted_vote":
            assert np.array_equal(np.asarray(jstate["flip_ema"]),
                                  tstate["flip_ema"].numpy()), chunk


def test_weighted_vote_touches_only_the_sampled_ids_and_counts_passes():
    stream, kw = _args("t", "weighted_vote", "allgather_1bit", True, None)
    before = COUNTERS.snapshot("population.")
    _, state, _, _ = tpop.streamed_vote(stream, chunk_size=10,
                                        device="cpu", **kw)
    d = COUNTERS.delta_since(before, "population.")
    # two passes over four chunks (10, 10, 10, 7)
    assert (d["population.chunks"], d["population.passes"],
            d["population.votes"]) == (8, 2, 1)
    assert COUNTERS.get("population.last.peak_rows") == 10
    assert COUNTERS.get("population.last.n_voters") == M
    _, ids, _, _, ema = _population()
    out = np.ones(POP, bool)
    out[ids] = False
    assert np.array_equal(state["flip_ema"].numpy()[out], ema[out])


@pytest.mark.parametrize("annot", ["voter_ids", "weights", "both"])
@pytest.mark.parametrize("codec,wire", [("sign1bit", "allgather_1bit"),
                                        ("ternary2bit", "psum_int8"),
                                        ("weighted_vote", "allgather_1bit")])
def test_annotated_stacked_form_matches_reference(codec, wire, annot):
    """A stacked payload annotated with logical ids / dataset weights
    (one chunk of the population engine, wire signs from one more pass)
    under a straggler and a colluding coalition, against the reference's
    VirtualBackend: votes, tally, margin, wire signs and the flip-EMA."""
    x, ids, w, _, ema = _population()
    rows = x[ids]
    prev = np.sign(x[::-1][:M]).astype(np.int8)

    def request(va, S, Byz, state):
        return va.VoteRequest(
            payload=rows, form="stacked", strategy=getattr(S, wire.upper()),
            codec=codec, step=1, salt=9, prev=prev,
            failures=va.FailureSpec(n_stale=4, byz=Byz(
                mode="colluding", num_adversaries=20, seed=1)),
            voter_ids=None if annot == "weights" else ids,
            weights=None if annot == "voter_ids" else w,
            server_state=state)

    state = codec == "weighted_vote"
    j = jva.VirtualBackend().execute(request(
        jva, JS, JByz, {"flip_ema": jnp.asarray(ema)} if state else None))
    t = tva.VirtualBackend(device="cpu").execute(request(
        tva, TS, TByz, {"flip_ema": torch.from_numpy(ema)} if state
        else None))
    assert np.array_equal(np.asarray(j.votes), t.votes.numpy())
    assert np.array_equal(np.asarray(j.counts), t.counts.numpy())
    assert np.array_equal(np.asarray(j.wire_signs), t.wire_signs.numpy())
    assert j.wire.margin == t.wire.margin
    assert (j.wire.n_voters, j.wire.payload_bytes, j.wire.n_messages) == (
        t.wire.n_voters, t.wire.payload_bytes, t.wire.n_messages)
    if state:
        assert np.array_equal(np.asarray(j.server_state["flip_ema"]),
                              t.server_state["flip_ema"].numpy())


def test_streamed_equals_annotated_dense_at_1024_voters():
    """The reference's streamed_eq_dense gate on the port alone: 1024
    sampled ids with dataset weights and a colluding coalition, a ragged
    chunk of 43 against the dense annotated request, votes and state."""
    m, n = 1024, 48
    rng = np.random.default_rng(m)
    vals = rng.normal(size=(m, n)).astype(np.float32)
    ids = np.sort(rng.choice(4 * m, size=m, replace=False)).astype(np.int32)
    w = rng.integers(1, 64, size=m).astype(np.int32)
    be = tva.VirtualBackend(device="cpu", chunk_size=43)
    byz = TByz(mode="colluding", num_adversaries=5, seed=5)
    for strategy, codec in [(TS.PSUM_INT8, "sign1bit"),
                            (TS.ALLGATHER_1BIT, "weighted_vote")]:
        state = ({"flip_ema": torch.zeros(4 * m)}
                 if codec == "weighted_vote" else None)
        dense = be.execute(tva.VoteRequest(
            payload=vals, form="stacked", strategy=strategy, codec=codec,
            voter_ids=ids, weights=w, failures=tva.FailureSpec(byz=byz),
            step=3, salt=11, server_state=state))
        stream = tva.PopulationStream(
            n_voters=m, n_coords=n, ids=ids, weights=w,
            values=lambda want: vals[np.searchsorted(ids, want.numpy())])
        streamed = be.execute(tva.VoteRequest(
            payload=stream, form="streamed", strategy=strategy, codec=codec,
            failures=tva.FailureSpec(byz=byz), step=3, salt=11,
            server_state=state))
        assert torch.equal(dense.votes, streamed.votes)
        assert torch.equal(dense.counts, streamed.counts)
        for k in dense.server_state:
            assert torch.equal(dense.server_state[k],
                               streamed.server_state[k])


def _reject_cases(va, S, Byz):
    """Requests / engine calls both packages refuse with ValueError."""
    x, ids, w, obs, _ = _population()
    rows = x[ids]

    def stream(**kw):
        return va.PopulationStream(n_voters=M, n_coords=N,
                                   values=lambda c: x[np.asarray(c)], **kw)

    low = Byz(mode="low_margin", num_adversaries=1)
    engine = jpop if va is jva else tpop
    return {
        "hierarchical": lambda: engine.streamed_vote(
            stream(), strategy=S.HIERARCHICAL, codec="sign1bit"),
        "int32_headroom": lambda: engine.streamed_vote(
            stream(weights=np.full(M, 3_000_000)),
            strategy=S.ALLGATHER_1BIT, codec="weighted_vote",
            server_state={"flip_ema": np.zeros(POP, np.float32)},
            chunk_size=1),
        "flip_ema_short": lambda: engine.streamed_vote(
            stream(ids=ids), strategy=S.ALLGATHER_1BIT,
            codec="weighted_vote",
            server_state={"flip_ema": np.zeros(int(ids[-1]), np.float32)}),
        "attack_obs_channel": lambda: va.VoteRequest(
            payload=stream(), form="streamed", strategy=S.PSUM_INT8,
            failures=va.FailureSpec(byz=low),
            attack_obs={"rep": obs["rep"]}),
        "attack_obs_shape": lambda: va.VoteRequest(
            payload=rows, form="stacked", strategy=S.PSUM_INT8,
            failures=va.FailureSpec(byz=low),
            attack_obs={"prev_vote": obs["prev_vote"][:5],
                        "prev_abs_counts": obs["prev_abs_counts"]}),
        "rep_too_short": lambda: va.VoteRequest(
            payload=rows, form="stacked", strategy=S.PSUM_INT8,
            voter_ids=ids, failures=va.FailureSpec(byz=Byz(
                mode="reputation", num_adversaries=1)),
            attack_obs={"rep": obs["rep"][:int(ids[-1])]}),
        "obs_without_adaptive": lambda: va.VoteRequest(
            payload=rows, form="stacked", strategy=S.PSUM_INT8,
            attack_obs={"rep": obs["rep"]}),
        "voter_ids_not_increasing": lambda: va.VoteRequest(
            payload=rows, form="stacked", strategy=S.PSUM_INT8,
            voter_ids=ids[::-1].copy()),
        "stream_ids_not_increasing": lambda: stream(ids=ids[::-1].copy()),
        "weights_below_one": lambda: va.VoteRequest(
            payload=rows, form="stacked", strategy=S.PSUM_INT8,
            weights=np.zeros(M, np.int64)),
        "streamed_payload": lambda: va.VoteRequest(
            payload=rows, form="streamed", strategy=S.PSUM_INT8),
        "streamed_prev_array": lambda: va.VoteRequest(
            payload=stream(), form="streamed", strategy=S.PSUM_INT8,
            prev=np.zeros((M, N), np.int8)),
        "streamed_voter_ids": lambda: va.VoteRequest(
            payload=stream(), form="streamed", strategy=S.PSUM_INT8,
            voter_ids=ids),
        "stale_without_prev": lambda: va.VoteRequest(
            payload=stream(), form="streamed", strategy=S.PSUM_INT8,
            failures=va.FailureSpec(n_stale=2)),
    }


@pytest.mark.parametrize("case", sorted(_reject_cases(tva, TS, TByz)))
def test_validation_errors_as_the_reference(case):
    with pytest.raises(ValueError) as want:
        _reject_cases(jva, JS, JByz)[case]()
    with pytest.raises(ValueError) as got:
        _reject_cases(tva, TS, TByz)[case]()
    assert str(got.value) == str(want.value)


def test_streamed_hierarchical_is_unsupported_by_the_backend():
    x = _population()[0]
    stream = tva.PopulationStream(n_voters=M, n_coords=N,
                                  values=lambda c: x[c.numpy()])
    req = tva.VoteRequest(payload=stream, form="streamed",
                          strategy=TS.HIERARCHICAL)
    assert not tva.VirtualBackend(device="cpu").supports(req)
    assert not tva.VirtualBackend(device="cpu", use_kernels=True).supports(
        tva.VoteRequest(payload=stream, form="streamed",
                        strategy=TS.PSUM_INT8))


def test_tally_narrows_to_int32_as_the_reference():
    """A dataset-weighted count tally past 2^31: the reference narrows its
    int64 accumulator to int32 with JAX's 64-bit mode off before the sign,
    and the port wraps the same way (the chunk's own int32 partial stays in
    range, so the engine accepts it)."""
    n, m = 8, 4
    x = np.tile(np.array([1.0, -1.0, 1.0, 0.5, -2.0, 1.0, -1.0, 3.0],
                         np.float32), (m, 1))
    w = np.full(m, 900_000_000, np.int64)
    votes = []
    for va, engine, S in ((jva, jpop, JS), (tva, tpop, TS)):
        stream = va.PopulationStream(
            n_voters=m, n_coords=n, weights=w,
            values=(lambda c: jnp.asarray(x)[c]) if va is jva
            else (lambda c: x[c.numpy()]))
        kw = {} if va is jva else {"device": "cpu"}
        v, _, margin, counts = engine.streamed_vote(
            stream, strategy=S.PSUM_INT8, codec="sign1bit", chunk_size=1,
            **kw)
        votes.append((np.asarray(v), np.asarray(counts), margin))
    assert np.array_equal(votes[0][0], votes[1][0])
    assert np.array_equal(votes[0][1], votes[1][1])
    assert votes[0][2] == votes[1][2]
    # 3.6e9 wraps negative: the vote of a unanimous +1 coordinate is -1
    assert votes[1][0][0] == -1


# ---------------------------------------------------------------------------
# the population drills
# ---------------------------------------------------------------------------


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


@functools.lru_cache(maxsize=None)
def _reference_trace(spec):
    return jsim.ScenarioRunner(_jspec(spec)).run()


def _both(spec):
    port = tsim.ScenarioRunner(spec, device="cpu",
                               draws=ReferenceDraws()).run()
    ref = _reference_trace(spec)
    assert port.digest == ref.digest, spec.name
    for a, b in zip(port.steps, ref.steps):
        assert (a.step, a.n_workers, a.n_adversaries, a.n_stale, a.margin,
                a.flip_fraction, a.n_population) == (
            b.step, b.n_workers, b.n_adversaries, b.n_stale, b.margin,
            b.flip_fraction, b.n_population)
        assert a.loss == pytest.approx(b.loss, rel=1e-6)
    return port, ref


#: benchmarks/bench_federated.py's fed-smoke drills (the same specs)
FED_SMOKE = {
    "uniform": tsim.ScenarioSpec(
        "fed-smoke/uniform", n_steps=3, dim=64, momentum=0.0,
        strategy=TS.PSUM_INT8,
        adversary=tsim.AdversarySpec("sign_flip", 0.2),
        population=tsim.PopulationSpec(n_clients=200, sample_fraction=0.12,
                                       chunk_size=6)),
    "dataset": tsim.ScenarioSpec(
        "fed-smoke/dataset", n_steps=3, dim=64, momentum=0.0,
        strategy=TS.ALLGATHER_1BIT,
        adversary=tsim.AdversarySpec("colluding", 0.3),
        population=tsim.PopulationSpec(n_clients=120, sample_fraction=0.3,
                                       weighting="dataset", max_data=50,
                                       chunk_size=6)),
    "weighted": tsim.ScenarioSpec(
        "fed-smoke/weighted", n_steps=5, dim=64, momentum=0.0,
        strategy=TS.ALLGATHER_1BIT, codec="weighted_vote",
        adversary=tsim.AdversarySpec("blind", 0.25, flip_prob=0.8),
        population=tsim.PopulationSpec(
            n_clients=90, sample_fraction=0.4, weighting="dataset",
            churn=(tsim.ChurnEvent(2, leave=30, note="dropout"),
                   tsim.ChurnEvent(4, join=15, note="rejoin")),
            chunk_size=6)),
}
#: BENCH_federated.json's committed digest prefixes of the three drills
FED_SMOKE_DIGESTS = {"uniform": "7e14d1603ff9", "dataset": "d5f04e71c939",
                     "weighted": "0f1cc821a694"}


@pytest.mark.parametrize("name", sorted(FED_SMOKE))
def test_fed_smoke_drills_digest_as_the_reference(name):
    port, _ = _both(FED_SMOKE[name])
    assert port.digest[:12] == FED_SMOKE_DIGESTS[name]


def test_fed_smoke_chunk_invariance_and_port_draws():
    """The bench's gate on the port's own draws: one chunk of the whole
    population gives the chunk-6 digest; the rows of a chunk do not depend
    on the chunk they land in."""
    spec = FED_SMOKE["uniform"]
    one = dataclasses.replace(spec, population=dataclasses.replace(
        spec.population, chunk_size=spec.population.n_clients))
    a = tsim.ScenarioRunner(spec, device="cpu").run()
    b = tsim.ScenarioRunner(one, device="cpu").run()
    assert a.digest == b.digest
    d = tsim.PrngDraws()
    x = torch.linspace(-1, 1, spec.dim)
    ids = torch.tensor([3, 8, 40, 199], dtype=torch.int32)
    whole = d.population_rows(spec, ids, x, 2)
    assert torch.equal(whole[2:], d.population_rows(spec, ids[2:], x, 2))
    assert not torch.equal(whole, d.population_rows(spec, ids, x, 1))


def test_scale_drill_is_bounded_by_the_chunk():
    """The M = 100,000 drill of bench_federated._scale_row (10% sampled,
    one churn event to 120,000 clients, chunk 2000) under the reference's
    draws: its digest, and peak rows bounded by the chunk, not by M."""
    spec = tsim.ScenarioSpec(
        "fed-smoke/scale-100k", n_steps=2, dim=64, momentum=0.0,
        strategy=TS.PSUM_INT8,
        population=tsim.PopulationSpec(
            n_clients=100_000, sample_fraction=0.1,
            churn=(tsim.ChurnEvent(1, join=25_000, leave=5_000,
                                   note="scale churn"),),
            chunk_size=2000))
    port, _ = _both(spec)
    assert COUNTERS.get("population.last.peak_rows") == 2000
    assert COUNTERS.get("population.last.n_voters") == 12_000
    assert port.steps[-1].n_population == 120_000


def test_sampling_and_dataset_sizes_are_the_references():
    spec = FED_SMOKE["weighted"]
    for step, pop, k in ((0, 90, 36), (3, 60, 24), (7, 1000, 999)):
        ids = trunner._sample_ids(spec, step, pop, k)
        assert np.array_equal(ids, jrunner._sample_ids(_jspec(spec), step,
                                                       pop, k))
        assert np.array_equal(trunner._client_sizes(spec, ids),
                              jrunner._client_sizes(_jspec(spec), ids))
