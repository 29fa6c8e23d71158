"""Parity of the port's gradient codecs (``repro_torch.core.codecs``) with
the JAX package's (``repro.core.codecs``) on the CPU: the registry and
each codec's wire, the worker side (``encode_leaf`` / ``feedback_leaf``),
the server side (``reliability_weights``, ``decode_stacked``,
``init_server_state``) and the 2-bit ternary wire's stages, on the same
numpy inputs. Votes, packed words, mismatch-driven states and weights are
compared for equality; the EF residual, whose ``mean|t|`` is a float32
sum taken in another order, within 1e-6 of max|t|. The reference's own codec
properties (``tests/test_codecs.py``) are asserted of the port too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs.base import VoteStrategy as JStrategy  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.core.codecs import weighted as jwv  # noqa: E402
from repro_torch.configs.base import VoteStrategy as TStrategy  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import vote_engine as tve  # noqa: E402
from repro_torch.core.codecs import ef_sign as tef  # noqa: E402
from repro_torch.core.codecs import weighted as twv  # noqa: E402
from repro_torch.core.codecs.ternary import TERNARY_WIRE  # noqa: E402
from torch_comm_common import use_reference_constants  # noqa: E402

NAMES = ("ef_sign", "sign1bit", "ternary2bit", "weighted_vote")
WIRES = ("psum_int8", "allgather_1bit", "hierarchical")


def _rng(*salt):
    return np.random.default_rng([47, *salt])


def _pm1(m, n, *salt):
    return np.where(_rng(m, n, *salt).integers(0, 2, size=(m, n)) == 1,
                    1, -1).astype(np.int8)


# ---------------------------------------------------------------------------
# registry and wire
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    assert tcodecs.list_codecs() == jcodecs.list_codecs() == NAMES
    assert tcodecs.DEFAULT_CODEC == jcodecs.DEFAULT_CODEC == "sign1bit"
    assert sorted(tcodecs.CODECS) == sorted(jcodecs.CODECS)


@pytest.mark.parametrize("strategy", WIRES)
@pytest.mark.parametrize("name", NAMES)
def test_codec_wire_matches_jax(name, strategy):
    j, t = jcodecs.get_codec(name), tcodecs.get_codec(name)
    assert t.name == j.name == name
    assert (t.bits_per_param, t.worker_state, t.server_state) \
        == (j.bits_per_param, j.worker_state, j.server_state)
    assert [s.value for s in t.supported_strategies] \
        == [s.value for s in j.supported_strategies]
    assert t.wire_bits(TStrategy(strategy)) == j.wire_bits(JStrategy(strategy))
    assert t.ties(TStrategy(strategy)) == j.ties(JStrategy(strategy))
    if JStrategy(strategy) in j.supported_strategies:
        t.validate_strategy(TStrategy(strategy))
    else:
        with pytest.raises(ValueError, match="cannot ride") as te:
            t.validate_strategy(TStrategy(strategy))
        with pytest.raises(ValueError, match="cannot ride") as je:
            j.validate_strategy(JStrategy(strategy))
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", NAMES)
def test_auto_resolves_within_the_codec(name, monkeypatch):
    """AUTO over one voter picks psum_int8 where the codec rides it, else
    the codec's first strategy — the reference's choice; over more voters,
    under the reference's link constants, the reference's priced choice,
    always one of the codec's strategies."""
    from repro.core import vote_engine as jve
    got = tve.resolve_strategy(TStrategy.AUTO, 1 << 20, 1, codec=name)
    assert got.value == jve.resolve_strategy(JStrategy.AUTO, 1 << 20, 1,
                                             codec=name).value
    assert got in tcodecs.get_codec(name).supported_strategies
    use_reference_constants(monkeypatch)
    for n, m, pod in ((1 << 20, 4, 1), (1 << 10, 64, 1), (1 << 30, 8, 4)):
        got = tve.resolve_strategy(TStrategy.AUTO, n, m, pod, codec=name)
        assert got.value == jve.resolve_strategy(
            JStrategy.AUTO, n, m, pod, codec=name).value
        assert got in tcodecs.get_codec(name).supported_strategies


# ---------------------------------------------------------------------------
# ef_sign: the worker side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 100, 4099])
def test_ef_encode_feedback_match_jax(n):
    """encode_leaf / feedback_leaf / init_state of ef_sign against the
    reference's on the same values, residual and ±1/0 vote. encode is one
    float32 add (equal). feedback prices the vote at mean|t|, a float32
    sum in another order: the scale within rtol 1e-6, and so each residual
    t - scale*vote within 1e-6 * max|t| (the scale's error plus one
    rounding of the difference)."""
    rng = _rng(n)
    v = rng.normal(size=n).astype(np.float32)
    e = (0.1 * rng.normal(size=n)).astype(np.float32)
    vote = rng.integers(-1, 2, size=n).astype(np.int8)
    j, t = jcodecs.get_codec("ef_sign"), tcodecs.get_codec("ef_sign")
    assert torch.equal(t.init_state(torch.from_numpy(v)),
                       torch.zeros(n))
    jt = j.encode_leaf(jnp.asarray(v), jnp.asarray(e))
    te = torch.from_numpy(e.copy())
    tt = t.encode_leaf(torch.from_numpy(v), te)
    assert torch.equal(te, torch.from_numpy(e))     # out of place
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert t.encode_leaf(torch.from_numpy(v), None) is not None
    jf = j.feedback_leaf(jt, jnp.asarray(vote), jnp.asarray(e))
    tf = t.feedback_leaf(tt, torch.from_numpy(vote), te)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-6 * float(np.abs(jt).max()))
    np.testing.assert_allclose(float(tef.scale_of(tt)),
                               float(jnp.mean(jnp.abs(jt))), rtol=1e-6)


def test_ef_in_place_helpers_equal_the_codec():
    """The trainer's in-place arithmetic (encode_, scale_of, feedback_ with
    a float32 vote) gives the codec methods' bits."""
    rng = _rng(9)
    v = torch.from_numpy(rng.normal(size=333).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=333).astype(np.float32))
    vote = torch.from_numpy(rng.integers(-1, 2, size=333).astype(np.int8))
    c = tcodecs.get_codec("ef_sign")
    t_ref = c.encode_leaf(v, e)
    want = c.feedback_leaf(t_ref, vote, e)
    t = tef.encode_(e.clone(), v)
    assert torch.equal(t, t_ref)
    got = tef.feedback_(t, vote.to(torch.float32), tef.scale_of(t_ref))
    assert got.data_ptr() == t.data_ptr() and torch.equal(got, want)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 26])
def test_ef_scale_over_chunks_matches_jax(monkeypatch, chunk):
    """scale_of sums |t| a SCALE_CHUNK at a time; with the chunk cut below
    the leaf (many chunks, a ragged last one) its mean|t| is still the
    reference's ``jnp.mean(jnp.abs(t))`` within rtol 1e-6 (float32 sums
    in other orders)."""
    monkeypatch.setattr(tef, "SCALE_CHUNK", chunk)
    t = _rng(chunk).normal(size=(3, 1001)).astype(np.float32)
    got = tef.scale_of(torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(jnp.mean(jnp.abs(t))),
                               rtol=1e-6)


def test_ef_encode_feedback_roundtrip():
    """``tests/test_codecs.py``'s EF round trip: feedback returns
    t - scale*vote, so the next encode rebuilds t + v_next - scale*vote."""
    c = tcodecs.get_codec("ef_sign")
    v = torch.tensor([0.1, -0.2, 0.3, -0.4])
    e0 = c.init_state(v)
    t = c.encode_leaf(v, e0)
    assert torch.equal(t, v)
    e1 = c.feedback_leaf(t, torch.sign(t), e0)
    want = v.numpy() - np.mean(np.abs(v.numpy())) * np.sign(v.numpy())
    np.testing.assert_allclose(e1.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(c.encode_leaf(v, e1).numpy(),
                               want + v.numpy(), rtol=1e-6)


def test_ef_memory_accumulates_suppressed_coordinate():
    """A coordinate the vote keeps overruling grows its residual every
    round instead of losing it (the EF guarantee)."""
    c = tcodecs.get_codec("ef_sign")
    v = torch.tensor([1e-3, 1.0, -1.0, 1.0])
    e = c.init_state(v)
    hostile = torch.tensor([-1.0, 1.0, -1.0, 1.0])
    mags = []
    for _ in range(5):
        e = c.feedback_leaf(c.encode_leaf(v, e), hostile, e)
        mags.append(float(e[0]))
    assert all(b > a for a, b in zip(mags, mags[1:])), mags


# ---------------------------------------------------------------------------
# weighted_vote: the server side
# ---------------------------------------------------------------------------

#: flip-rate states of the reference's cases (tests/test_codecs.py): the
#: zero prior, equal priors, learned honest / adversarial rates, the clip
#: edges, and a drawn state
EMAS = [np.zeros(8), np.full(8, 0.3), [0.95] * 5 + [0.05] * 3,
        [0.9, 0.8, 0.1, 0.2, 0.5, 0.45, 0.55, 0.049],
        [0.0, 1.0, 0.05, 0.95, 0.5, 0.25, 0.75, 0.125],
        _rng(1).uniform(0, 1, 8)]


@pytest.mark.parametrize("case", range(len(EMAS)))
def test_reliability_weights_equal_jax(case):
    ema = np.asarray(EMAS[case], np.float32)
    got = twv.reliability_weights(torch.from_numpy(ema))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jwv.reliability_weights(jnp.asarray(ema))))
    assert (got.numpy() * 256 == np.round(got.numpy() * 256)).all()


def test_reliability_weights_equal_jax_on_a_grid():
    """Every float32 state on a fine grid of [0, 1]: the quantised weights
    are equal, so torch's and XLA's log never land on opposite sides of a
    rounding edge here."""
    ema = np.linspace(0, 1, 20_001, dtype=np.float32)
    np.testing.assert_array_equal(
        twv.reliability_weights(torch.from_numpy(ema)).numpy(),
        np.asarray(jwv.reliability_weights(jnp.asarray(ema))))


@pytest.mark.parametrize("m,n", [(1, 5), (4, 100), (8, 200), (13, 1001)])
def test_decode_stacked_matches_jax(m, n):
    """decode_stacked / decode_leaf_fixed on ±1 stacks with exact ties
    (equal weights, even M) and on drawn states: votes, mismatch counts
    and new states equal. The reference runs them under jit, as its vote
    API and trainer do (there XLA divides by the constant n as a product
    with its float32 reciprocal, which the port reproduces)."""
    s = _pm1(m, n, 2)
    if m % 2 == 0:
        s[: m // 2, :8], s[m // 2:, :8] = 1, -1
    for ema in (np.zeros(m, np.float32),
                _rng(m, n, 3).uniform(0, 1, m).astype(np.float32)):
        jv, jema = jax.jit(jwv.decode_stacked)(jnp.asarray(s),
                                               jnp.asarray(ema))
        tv, tema = twv.decode_stacked(torch.from_numpy(s),
                                      torch.from_numpy(ema))
        assert tv.dtype == torch.int8 and tema.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tema.numpy(), np.asarray(jema))
        w = jwv.reliability_weights(jnp.asarray(ema))
        jv2, jmis = jwv.decode_leaf_fixed(jnp.asarray(s), w)
        tv2, tmis = twv.decode_leaf_fixed(torch.from_numpy(s),
                                          np.asarray(w).tolist())
        assert tmis.dtype == torch.int64
        np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
        np.testing.assert_array_equal(tmis.numpy(), np.asarray(jmis))


def test_ema_update_over_leaves_matches_jax():
    """The trainer's one EMA update per step from mismatch counts summed
    over leaves (``vote_api.py:817-845``): equal to the reference's
    float32 expression, jitted with the coordinate count a constant as in
    the reference's step."""
    mismatch = np.array([0, 1, 17, 4095, 65_535, 1 << 20, 3, 9], np.int64)
    ema = _rng(4).uniform(0, 1, 8).astype(np.float32)
    for total in (1, 1000, 65_536 + 3, 1 << 22):
        want = jax.jit(lambda e, m: (1.0 - jwv.RHO) * e + jwv.RHO * m / total)(
            jnp.asarray(ema), jnp.asarray(mismatch, jnp.float32))
        got = twv.ema_update(torch.from_numpy(ema),
                             torch.from_numpy(mismatch), total)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_server_state_matches_jax():
    t = tcodecs.get_codec("weighted_vote").init_server_state(5)
    j = jcodecs.get_codec("weighted_vote").init_server_state(5)
    assert sorted(t) == sorted(j) == ["flip_ema"]
    assert t["flip_ema"].dtype == torch.float32
    np.testing.assert_array_equal(t["flip_ema"].numpy(),
                                  np.asarray(j["flip_ema"]))
    for name in ("sign1bit", "ef_sign", "ternary2bit"):
        assert tcodecs.get_codec(name).init_server_state(5) == {}


def test_weighted_equal_state_is_unweighted_majority():
    """Any equal state gives equal weights, and the decode is the 1-bit
    wire's majority bit for bit, exact ties (sum 0) -> +1
    (``tests/test_codecs.py:285``)."""
    s = _pm1(8, 200, 5)
    s[:4, :8], s[4:, :8] = 1, -1
    want = np.where(2 * (s >= 0).sum(axis=0) >= 8, 1, -1)
    for prior in (0.0, 0.3):
        vote, new = twv.decode_stacked(torch.from_numpy(s),
                                       torch.full((8,), prior))
        np.testing.assert_array_equal(vote.numpy(), want)
    assert new.shape == (8,)


def test_weighted_decode_survives_learned_adversarial_majority():
    """With learned flip rates, 5 flippers out of 8 are decoded through."""
    truth = _pm1(1, 64, 6)[0]
    s = np.tile(truth, (8, 1))
    s[:5] *= -1
    ema = torch.tensor([0.95] * 5 + [0.05] * 3)
    vote, _ = twv.decode_stacked(torch.from_numpy(s), ema)
    np.testing.assert_array_equal(vote.numpy(), truth)


# ---------------------------------------------------------------------------
# ternary2bit: the 2-bit wire's stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(1, 16), (4, 100), (9, 5000), (6, 33)])
def test_ternary_wire_stages_match_jax(m, n):
    """TernaryWire pack (per-row padded 2-bit words), tally (kept packed
    here, decoded in the reference) and unpack, against the reference's
    stages; the vote is the sign of the symbol sum."""
    s = _rng(m, n, 7).integers(-1, 2, size=(m, n)).astype(np.int8)
    if m >= 2:
        s[: m // 2, :5], s[m // 2: 2 * (m // 2), :5] = 1, -1
    from repro.core.codecs.ternary import TERNARY_WIRE as J
    jwire = J.pack(jnp.asarray(s), m)
    twire = TERNARY_WIRE.pack(torch.from_numpy(s), m)
    np.testing.assert_array_equal(twire.numpy().view(np.uint32),
                                  np.asarray(jwire))
    tdec = TERNARY_WIRE.tally(twire, m)
    jdec = J.tally(jwire, m)
    np.testing.assert_array_equal(
        jsc.unpack_ternary(jnp.asarray(tdec.numpy().view(np.uint32))),
        np.asarray(jdec))
    votes = TERNARY_WIRE.unpack(tdec, n, torch.int8)
    np.testing.assert_array_equal(votes.numpy(),
                                  np.asarray(J.unpack(jdec, n, jnp.int8)))
    np.testing.assert_array_equal(votes.numpy(),
                                  np.sign(s.astype(np.int32).sum(axis=0)))
    assert torch.equal(TERNARY_WIRE.vote(torch.from_numpy(s)), votes)
    assert (TERNARY_WIRE.wire_bits_per_param, TERNARY_WIRE.ties) \
        == (J.wire_bits_per_param, J.ties)
