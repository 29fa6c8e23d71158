"""Parity of the port's stacked vote API (``repro_torch.core.vote_api``,
CPU, plain kernel versions) with the JAX package's (``repro.core.
vote_api``): the same numpy payloads through ``VirtualBackend.execute`` on
both sides. Votes, wire signs and every ``WireReport`` field must be
equal; there is no tolerance, since every compared output is an integer
or a bit pattern, and ``weighted_vote``'s float32 flip-rate state must be
equal too. Requests outside the port's slice must raise
``NotImplementedError`` naming their ROADMAP.md item; the streamed form,
the voter annotations and the adaptive modes have their own tests in
``test_torch_population.py`` and ``test_torch_attacks.py``."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs.base import ByzantineConfig as JByz  # noqa: E402
from repro.configs.base import VoteStrategy as JStrategy  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core import vote_engine as jve  # noqa: E402
from repro_torch.configs.base import ByzantineConfig as TByz  # noqa: E402
from repro_torch.configs.base import VoteStrategy as TStrategy  # noqa: E402
from repro_torch.core import byzantine as tbyz  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core import vote_engine as tve  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from torch_comm_common import use_reference_constants  # noqa: E402

WIRES = ("psum_int8", "allgather_1bit", "hierarchical")
#: (strategy, use_kernels) pairs the virtual backend executes
COMBOS = [("psum_int8", False), ("allgather_1bit", False),
          ("hierarchical", False), ("allgather_1bit", True)]
VOTERS = [1, 2, 3, 4, 5, 8, 15, 16]
COORDS = [1, 31, 37, 64, 200, 1000]
#: every codec on every strategy it supports
CODEC_WIRES = [("sign1bit", s) for s in WIRES] + [
    ("ef_sign", s) for s in WIRES] + [
    ("ternary2bit", "psum_int8"), ("ternary2bit", "allgather_1bit"),
    ("weighted_vote", "allgather_1bit")]


def _payload(m, n, dtype, seed):
    """(m, n) values with planted zeros and -0.0, as (numpy, JAX array,
    torch tensor). bf16 values are bf16-exact so both sides start from the
    same numbers."""
    rng = np.random.default_rng([23, m, n, seed])
    if dtype == "int8":
        x = rng.integers(-2, 3, size=(m, n)).astype(np.int8)
        return x, jnp.asarray(x), torch.from_numpy(x)
    x = rng.normal(size=(m, n)).astype(np.float32)
    x[:, ::5] = 0.0
    x[:, 2::5] = -0.0
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    return (x, jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _ternary(m, n, seed, tie_cols=8):
    """(m, n) int8 in {-1, 0, +1} with engineered tie / abstain columns
    (``tests/test_vote_engine.py``'s matrix)."""
    s = np.random.default_rng([29, m, n, seed]).integers(
        -1, 2, size=(m, n)).astype(np.int8)
    k = min(tie_cols, n // 3)
    if k and m >= 2:
        half = m // 2
        s[:half, :k] = 1
        s[half:, :k] = -1          # exact tie (even m) / +1 majority (odd)
        s[:, k:2 * k] = 0          # unanimous abstention
    return s


def _execute_both(jpayload, tpayload, strategy, use_kernels=False,
                  codec="sign1bit", flip_ema=None):
    """The same request on both packages; `flip_ema` (numpy) is the
    weighted codec's server state."""
    jstate = tstate = None
    if flip_ema is not None:
        jstate = {"flip_ema": jnp.asarray(flip_ema)}
        tstate = {"flip_ema": flip_ema}
    jout = jva.VirtualBackend(use_kernels=use_kernels).execute(
        jva.VoteRequest(payload=jpayload, form="stacked",
                        strategy=JStrategy(strategy), codec=codec,
                        server_state=jstate))
    tout = tva.VirtualBackend(use_kernels=use_kernels, device="cpu").execute(
        tva.VoteRequest(payload=tpayload, form="stacked",
                        strategy=TStrategy(strategy), codec=codec,
                        server_state=tstate))
    return jout, tout


def _assert_same_state(jout, tout):
    assert sorted(tout.server_state) == sorted(jout.server_state)
    for k, v in jout.server_state.items():
        got = tout.server_state[k]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)


def _assert_same_outcome(jout, tout, stateless=True):
    assert tout.votes.dtype == torch.int8
    np.testing.assert_array_equal(tout.votes.numpy(), np.asarray(jout.votes))
    if jout.wire_signs is None:
        assert tout.wire_signs is None
    else:
        assert tout.wire_signs.dtype == torch.int8
        np.testing.assert_array_equal(tout.wire_signs.numpy(),
                                      np.asarray(jout.wire_signs))
    jw, tw = jout.wire, tout.wire
    assert jw.margin is None and jw.agreement is None
    assert (tw.n_voters, tw.payload_bytes, tw.n_messages, tw.strategy.value) \
        == (jw.n_voters, jw.payload_bytes, jw.n_messages, jw.strategy.value)
    if stateless:
        assert tout.server_state == jout.server_state == {}
    else:
        _assert_same_state(jout, tout)


@pytest.mark.parametrize("m", [1, 2, 4, 5, 16])
@pytest.mark.parametrize("codec,strategy", CODEC_WIRES)
def test_codec_vote_matches_jax(codec, strategy, m):
    """Each codec on each strategy it supports: votes, wire signs,
    WireReport and server state equal to the JAX package's, on ternary
    signs with exact-tie and all-abstain columns and on float32 values
    with planted zeros. ``weighted_vote`` starts from a drawn flip-rate
    state (unequal weights) and from the zero prior."""
    for n in (17, 37, 1000):
        s = _ternary(m, n, seed=3)
        _, jx, tx = _payload(m, n, "float32", seed=4)
        for jp, tp in ((jnp.asarray(s), torch.from_numpy(s)), (jx, tx)):
            emas = [None]
            if codec == "weighted_vote":
                emas = [np.zeros(m, np.float32), np.random.default_rng(
                    [37, m, n]).uniform(0, 1, m).astype(np.float32)]
            for ema in emas:
                jout, tout = _execute_both(jp, tp, strategy, codec=codec,
                                           flip_ema=ema)
                _assert_same_outcome(jout, tout, stateless=ema is None)


def test_weighted_state_threads_through_calls():
    """weighted_vote's flip_ema threaded through three calls on each side
    (each call's new state is the next call's input): equal after every
    call, and the flippers' estimates rise."""
    m, n = 7, 300
    truth = np.where(np.random.default_rng(41).integers(0, 2, n) == 1,
                     1, -1).astype(np.int8)
    jstate = {"flip_ema": jnp.zeros(m, jnp.float32)}
    tstate = {"flip_ema": torch.zeros(m)}
    for call in range(3):
        s = np.tile(truth, (m, 1))
        s[:2] *= -1                         # two constant flippers
        s[3, call::3] *= -1                 # one noisy voter
        jout = jva.VirtualBackend().execute(jva.VoteRequest(
            payload=jnp.asarray(s), form="stacked", codec="weighted_vote",
            strategy=JStrategy.ALLGATHER_1BIT, server_state=jstate))
        tout = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
            payload=torch.from_numpy(s), form="stacked",
            codec="weighted_vote", strategy=TStrategy.ALLGATHER_1BIT,
            server_state=tstate))
        _assert_same_outcome(jout, tout, stateless=False)
        jstate, tstate = jout.server_state, tout.server_state
    ema = tstate["flip_ema"].numpy()
    assert ema[:2].min() > ema[2:].max()


def test_ternary_allgather_runs_the_ternary_wire():
    """ternary2bit on allgather_1bit packs 2 bits per coordinate and keeps
    abstention (an all-zero stack votes 0), where sign1bit's 1-bit wire
    votes +1; on psum_int8 the two codecs vote alike
    (``tests/test_codecs.py:186-207``)."""
    zeros = torch.zeros((4, 32), dtype=torch.int8)
    vb = tva.VirtualBackend(device="cpu")
    votes = {c: vb.execute(tva.VoteRequest(
        payload=zeros, form="stacked", codec=c,
        strategy=TStrategy.ALLGATHER_1BIT)) for c in ("sign1bit",
                                                      "ternary2bit")}
    assert votes["sign1bit"].votes.tolist() == [1] * 32
    assert votes["ternary2bit"].votes.tolist() == [0] * 32
    assert votes["ternary2bit"].wire.payload_bytes == 32 * 2 / 8
    s = torch.from_numpy(_ternary(8, 100, seed=5))
    psum = [vb.execute(tva.VoteRequest(payload=s, form="stacked", codec=c,
                                       strategy=TStrategy.PSUM_INT8)).votes
            for c in ("sign1bit", "ternary2bit")]
    assert torch.equal(psum[0], psum[1])


def test_quickstart_vote():
    """examples/quickstart.py's 5 x 8 vote. The port takes the float64
    numpy payload as it is; the reference holds it as float32."""
    g = np.random.default_rng(0).normal(size=(5, 8))
    jout, tout = _execute_both(jnp.asarray(g, jnp.float32), g,
                               "allgather_1bit")
    _assert_same_outcome(jout, tout)
    assert tout.wire.payload_bytes == 1.0 and tout.wire.n_messages == 1


@pytest.mark.parametrize("m", VOTERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("strategy,use_kernels", COMBOS)
def test_stacked_vote_matches_jax(strategy, use_kernels, dtype, m):
    # every n for float32; bf16 and int8 take a ragged, a word-aligned and
    # the widest n (the suite's time)
    coords = COORDS if dtype == "float32" else [37, 64, 1000]
    for n in coords:
        _, jx, tx = _payload(m, n, dtype, seed=len(strategy))
        jout, tout = _execute_both(jx, tx, strategy, use_kernels)
        _assert_same_outcome(jout, tout)


@pytest.mark.parametrize("strategy", WIRES)
@pytest.mark.parametrize("m,n", [(2, 64), (3, 37), (16, 200), (15, 1000)])
def test_tie_and_abstain_matrix(strategy, m, n):
    """Each wire's tie convention on ternary inputs with exact-tie and
    all-abstain columns (``tests/test_vote_engine.py:68-106``)."""
    signs = _ternary(m, n, seed=1)
    jout, tout = _execute_both(jnp.asarray(signs), torch.from_numpy(signs),
                               strategy)
    _assert_same_outcome(jout, tout)
    counts = signs.astype(np.int32).sum(axis=0)
    if strategy == "psum_int8":
        expect = np.sign(counts)                   # ties / abstain -> 0
    elif strategy == "hierarchical":
        expect = np.where(counts >= 0, 1, -1)      # 1-bit rebroadcast
    else:   # the 1-bit wire binarises at pack time (0 -> +1)
        expect = np.where(2 * (signs >= 0).sum(axis=0) >= m, 1, -1)
    np.testing.assert_array_equal(tout.votes.numpy(), expect)


@pytest.mark.parametrize("m,n", [(3, 100), (5, 321), (15, 64)])
def test_odd_m_all_wires_agree(m, n):
    """±1 inputs and odd M: no coordinate can tie, so every wire gives
    the same majority (``tests/test_vote_engine.py:109-124``)."""
    signs = np.where(np.random.default_rng([31, m, n]).integers(
        0, 2, size=(m, n)) == 1, 1, -1).astype(np.int8)
    expect = np.where(signs.astype(np.int32).sum(axis=0) > 0, 1, -1)
    for strategy in WIRES:
        jout, tout = _execute_both(jnp.asarray(signs),
                                   torch.from_numpy(signs), strategy)
        _assert_same_outcome(jout, tout)
        np.testing.assert_array_equal(tout.votes.numpy(), expect)


@pytest.mark.parametrize("m", [1, 2, 5, 15, 16])
def test_fused_path_equals_staged_path(m):
    """use_kernels=True (fused kernel) == use_kernels=False (bitpack +
    majority + bitunpack) on ternary inputs with tie columns
    (``tests/test_vote_engine.py:127-141``)."""
    x = torch.from_numpy(_ternary(m, 500, seed=2).astype(np.float32))
    req = tva.VoteRequest(payload=x, form="stacked",
                          strategy=TStrategy.ALLGATHER_1BIT)
    fused = tva.VirtualBackend(use_kernels=True, device="cpu").execute(req)
    staged = tva.VirtualBackend(device="cpu").execute(req)
    assert torch.equal(fused.votes, staged.votes)
    assert fused.wire == staged.wire


def test_payload_forms_agree_and_cpu_counts_nothing():
    """numpy, float64, non-contiguous torch and int8 sign payloads of the
    same signs vote alike; CPU calls launch no kernel."""
    tops.reset_launch_counts()
    x = np.random.default_rng(7).normal(size=(40, 7)).T   # (7, 40) view
    votes = []
    for payload in (x, np.ascontiguousarray(x, np.float32),
                    torch.from_numpy(x), np.sign(x).astype(np.int8)):
        for use_kernels in (True, False):
            votes.append(tva.VirtualBackend(
                use_kernels=use_kernels, device="cpu").execute(
                    tva.VoteRequest(payload=payload, form="stacked",
                                    strategy=TStrategy.ALLGATHER_1BIT)).votes)
    assert all(torch.equal(v, votes[0]) for v in votes)
    assert set(tops.launch_counts().values()) == {0}


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert tva.VirtualBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tva.VirtualBackend()


# ---------------------------------------------------------------------------
# wire accounting, strategies and codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", WIRES)
def test_strategy_accounting_matches_jax(strategy):
    j, t = jve.STRATEGIES[JStrategy(strategy)], tve.STRATEGIES[
        TStrategy(strategy)]
    assert (t.wire_bits_per_param, t.ties) == (j.wire_bits_per_param, j.ties)
    for n in (1, 1000, 1 << 20, 1 << 30):
        assert t.payload_bytes(n) == j.payload_bytes(n)
        for data, pod in ((1, 1), (4, 1), (16, 2), (8, 4)):
            assert t.ring_bytes(n, data, pod) == j.ring_bytes(n, data, pod)


@pytest.mark.parametrize("m", [1, 16, 127, 128, 32_767, 40_000])
def test_count_dtype_matches_jax(m):
    assert str(tva.count_dtype(m)).split(".")[-1] \
        == jnp.dtype(jva.count_dtype(m)).name
    assert tva.count_bytes(m) == jva.count_bytes(m)


@pytest.mark.parametrize("strategy", WIRES)
def test_sign1bit_codec_matches_jax(strategy):
    j, t = jcodecs.get_codec("sign1bit"), tcodecs.get_codec("sign1bit")
    assert t.bits_per_param == j.bits_per_param
    assert [s.value for s in t.supported_strategies] \
        == [s.value for s in j.supported_strategies]
    assert t.wire_bits(TStrategy(strategy)) == j.wire_bits(JStrategy(strategy))
    assert t.ties(TStrategy(strategy)) == j.ties(JStrategy(strategy))


def test_resolve_strategy(monkeypatch):
    """A named wire stays; AUTO over one voter is psum_int8 (no wire at
    all), as the reference resolves it; over more voters, under the
    reference's link constants, the reference's choice, and a stacked
    request with the default strategy (AUTO) votes as the reference's on
    its resolved wire, WireReport included."""
    for s in WIRES:
        assert tve.resolve_strategy(TStrategy(s), 100, 8) == TStrategy(s)
    assert tve.resolve_strategy(TStrategy.AUTO, 1 << 30, 1).value \
        == jve.resolve_strategy(JStrategy.AUTO, 1 << 30, 1).value \
        == "psum_int8"
    out = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
        payload=np.ones((1, 40)), form="stacked"))
    assert out.wire.strategy == TStrategy.PSUM_INT8
    use_reference_constants(monkeypatch)
    for n in (100, 1 << 20, 1 << 30):
        for m in (2, 4, 16, 64):
            assert tve.resolve_strategy(TStrategy.AUTO, n, m).value \
                == jve.resolve_strategy(JStrategy.AUTO, n, m).value
    for m, n in ((4, 1000), (5, 37), (16, 200)):
        _, jx, tx = _payload(m, n, "float32", seed=9)
        jout = jva.VirtualBackend().execute(jva.VoteRequest(
            payload=jx, form="stacked"))
        tout = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
            payload=tx, form="stacked"))
        _assert_same_outcome(jout, tout)


# ---------------------------------------------------------------------------
# request validation and capability
# ---------------------------------------------------------------------------


def _reject_cases(va, Strategy, Byz, codecs):
    """Requests both packages reject with ValueError, built from one
    package's own classes."""
    x = np.zeros((5, 70), np.int8)
    return {
        "unknown_codec": lambda: va.VoteRequest(payload=x, form="stacked",
                                                codec="nope"),
        "unknown_form": lambda: va.VoteRequest(payload=x, form="flat"),
        "not_2d": lambda: va.VoteRequest(payload=np.zeros(8, np.int8),
                                         form="stacked"),
        "no_shape": lambda: va.VoteRequest(payload=[[1, 2]], form="stacked"),
        "strategy_str": lambda: va.VoteRequest(payload=x, form="stacked",
                                               strategy="psum_int8"),
        "stale_without_prev": lambda: va.VoteRequest(
            payload=x, form="stacked", failures=va.FailureSpec(n_stale=2)),
        "diagnostics": lambda: va.VoteRequest(payload=x, form="stacked",
                                              diagnostics=True),
        "overlap_without_plan": lambda: va.VoteRequest(
            payload=x, form="stacked", overlap=True),
        "attack_obs_without_adaptive": lambda: va.VoteRequest(
            payload=x, form="stacked", attack_obs={"prev_vote": x[0]}),
        "negative_stale": lambda: va.FailureSpec(n_stale=-1),
        "unknown_adversary": lambda: va.FailureSpec(byz=Byz(mode="martian")),
        "weighted_without_state": lambda: va.VoteRequest(
            payload=x, form="stacked", codec="weighted_vote",
            strategy=Strategy.ALLGATHER_1BIT),
        "weighted_on_psum": lambda: va.VoteRequest(
            payload=x, form="stacked", codec="weighted_vote",
            strategy=Strategy.PSUM_INT8),
        "ternary_on_hierarchical": lambda: va.VoteRequest(
            payload=x, form="stacked", codec="ternary2bit",
            strategy=Strategy.HIERARCHICAL),
    }


@pytest.mark.parametrize("case", sorted(_reject_cases(tva, TStrategy, TByz,
                                                      tcodecs)))
def test_both_packages_reject_with_value_error(case):
    with pytest.raises(ValueError):
        _reject_cases(jva, JStrategy, JByz, jcodecs)[case]()
    with pytest.raises(ValueError):
        _reject_cases(tva, TStrategy, TByz, tcodecs)[case]()


def _one_rank():
    """The vote axes of a one-rank mesh (no process group needed)."""
    from repro_torch.distributed.mesh import ProcessMesh
    return ProcessMesh((1,), ("data",)).vote_axes


def _not_ported_cases():
    """Each case's ROADMAP.md Queue 1 item and the call that raises citing
    it; item None marks a path the multi-process wire's slice ported,
    which now runs (on a one-rank mesh)."""
    x = np.zeros((5, 70), np.int8)
    stacked = dict(payload=x, form="stacked")

    def mesh_vote(**req):
        return tva.MeshBackend(axes=_one_rank(), device="cpu").execute(
            tva.VoteRequest(**req)).votes

    engine = types.SimpleNamespace(
        axes=_one_rank(), strategy=TStrategy.ALLGATHER_1BIT,
        codec="ternary2bit", byz=None, salt=0)
    return {
        "leaf_form": (None, lambda: mesh_vote(payload=torch.from_numpy(
            x[0]))),
        "tree_form": (None, lambda: mesh_vote(
            payload={"a": torch.from_numpy(x[0])}, form="tree")),
        "mesh_backend": (None, lambda: tva.MeshBackend(axes=_one_rank(),
                                                       device="cpu")),
        # the adversary's and the stragglers' mesh path: the replica index
        # from the vote axes
        "adversary": (None, lambda: tbyz.apply_adversary(
            torch.from_numpy(x[0].copy()),
            TByz(mode="sign_flip", num_adversaries=1), _one_rank())),
        "stragglers": (None, lambda: tft.straggler_mask_for(_one_rank(),
                                                            1)),
        # a plan runs since item 7; the H100 link model prices AUTO over
        # voters and the bucket ladder since the fifteenth slice
        "plan": (None, lambda: tvp.build_plan(
            {"a": (70,)}, bucket_bytes=8, data_size=5)),
        "overlap": (None, lambda: tvp.build_plan(
            {"a": (70,)}, bucket_bytes=tvp.AUTO_BUCKET_BYTES,
            strategy=TStrategy.ALLGATHER_1BIT, overlap=True)),
        # every codec runs on the stacked form; these requests combine
        # one with what is still unported
        "ef_sign": (None, lambda: mesh_vote(payload=torch.from_numpy(x[0]),
                                            codec="ef_sign")),
        "ternary2bit": (None, lambda: tft.plan_vote_with_failures(
            engine, tvp.build_plan({"a": (70,)}, bucket_bytes=8,
                                   default_codec="ternary2bit",
                                   strategy=TStrategy.ALLGATHER_1BIT),
            torch.from_numpy(x[0]), prev_signs=x[0], n_stale=1)),
        "auto_over_voters": (None, lambda: tva.VirtualBackend(
            device="cpu").execute(tva.VoteRequest(**stacked))),
    }


@pytest.mark.parametrize("case", sorted(_not_ported_cases()))
def test_out_of_slice_raises_not_implemented(case):
    item, build = _not_ported_cases()[case]
    if item is None:    # ported by the multi-process wire: it runs
        assert build() is not None
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 item {item}\\b"):
        build()


def _item10_cases(va, S, Byz):
    """Requests of the streamed form, the voter annotations and the
    adaptive adversaries, built the same way in either package."""
    x = np.random.default_rng(3).integers(-2, 3, size=(5, 70)).astype(
        np.int8)
    stacked = dict(payload=x, form="stacked", strategy=S.ALLGATHER_1BIT)
    return {
        # an adaptive attacker whose observation lacks its channel's keys
        "weighted_vote": lambda: va.VoteRequest(
            **stacked, codec="weighted_vote",
            server_state={"flip_ema": np.zeros(5, np.float32)},
            failures=va.FailureSpec(byz=Byz(mode="reputation",
                                            num_adversaries=1)),
            attack_obs={}),
        # a streamed request whose payload is no PopulationStream
        "streamed_form": lambda: va.VoteRequest(payload=x, form="streamed"),
        "voter_ids": lambda: va.VoteRequest(
            **stacked, voter_ids=np.array([0, 2, 3, 7, 9])),
        "weights": lambda: va.VoteRequest(
            **stacked, weights=np.array([1, 4, 2, 7, 3])),
        "adaptive_adversary": lambda: va.VoteRequest(
            **stacked, failures=va.FailureSpec(
                byz=Byz(mode="low_margin", num_adversaries=1)),
            attack_obs={}),
    }


@pytest.mark.parametrize("case", sorted(_item10_cases(tva, TStrategy,
                                                      TByz)))
def test_item10_requests_do_what_the_reference_does(case):
    """Each request raises the reference's ValueError (same message) or
    executes to the reference's votes, tally, margin and wire signs."""
    try:
        jreq = _item10_cases(jva, JStrategy, JByz)[case]()
    except ValueError as want:
        with pytest.raises(ValueError) as got:
            _item10_cases(tva, TStrategy, TByz)[case]()
        assert str(got.value) == str(want)
        return
    treq = _item10_cases(tva, TStrategy, TByz)[case]()
    j = jva.VirtualBackend().execute(jreq)
    t = tva.VirtualBackend(device="cpu").execute(treq)
    assert np.array_equal(np.asarray(j.votes), t.votes.numpy())
    assert np.array_equal(np.asarray(j.counts), t.counts.numpy())
    assert np.array_equal(np.asarray(j.wire_signs), t.wire_signs.numpy())
    assert j.wire.margin == t.wire.margin


def test_unknown_codec_names_every_codec():
    with pytest.raises(ValueError, match="unknown codec") as t:
        tcodecs.get_codec("nope")
    with pytest.raises(ValueError, match="unknown codec") as j:
        jcodecs.get_codec("nope")
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("strategy", ["psum_int8", "hierarchical", "auto"])
def test_kernel_backend_rejects_count_wires(strategy):
    """The fused kernel realises allgather_1bit's tie rule only; the
    reason is the reference's, word for word
    (``tests/test_vote_api.py:169-183``)."""
    x = np.random.default_rng(3).normal(size=(5, 70)).astype(np.float32)
    jreq = jva.VoteRequest(payload=jnp.asarray(x), form="stacked",
                           strategy=JStrategy(strategy))
    treq = tva.VoteRequest(payload=x, form="stacked",
                           strategy=TStrategy(strategy))
    jvb = jva.VirtualBackend(use_kernels=True)
    tvb = tva.VirtualBackend(use_kernels=True, device="cpu")
    assert not tvb.supports(treq) and not jvb.supports(jreq)
    assert tvb.why_unsupported(treq) == jvb.why_unsupported(jreq)
    with pytest.raises(ValueError, match="tie rule"):
        tvb.execute(treq)
    ok = dataclasses.replace(treq, strategy=TStrategy.ALLGATHER_1BIT)
    assert tvb.supports(ok) and tva.VirtualBackend(device="cpu").supports(treq)


@pytest.mark.parametrize("codec", ["ef_sign", "ternary2bit", "weighted_vote"])
def test_kernel_backend_rejects_codecs(codec):
    """The fused kernel realises the raw 1-bit wire only; the reason is
    the reference's, word for word."""
    x = np.random.default_rng(4).normal(size=(5, 70)).astype(np.float32)
    state = {"flip_ema": np.zeros(5, np.float32)}
    jreq = jva.VoteRequest(
        payload=jnp.asarray(x), form="stacked", codec=codec,
        strategy=JStrategy.ALLGATHER_1BIT,
        server_state={"flip_ema": jnp.zeros(5, jnp.float32)})
    treq = tva.VoteRequest(payload=x, form="stacked", codec=codec,
                           strategy=TStrategy.ALLGATHER_1BIT,
                           server_state=state)
    jvb = jva.VirtualBackend(use_kernels=True)
    tvb = tva.VirtualBackend(use_kernels=True, device="cpu")
    assert tvb.why_unsupported(treq) == jvb.why_unsupported(jreq)
    with pytest.raises(ValueError, match="raw 1-bit wire"):
        tvb.execute(treq)
    assert tva.VirtualBackend(device="cpu").supports(treq)
