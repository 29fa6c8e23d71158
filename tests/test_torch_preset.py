"""The glm4-9b preset's pieces in the port against the JAX package, on the
CPU: the presets themselves, and the trainer's count wire (``psum_int8``)
with float32 and bf16 momentum.

(a) ``repro_torch.configs.presets`` returns the reference's optimizer and
    train configs field by field, for every arch of the reference's
    registry, every shape cell, both optimizer kinds and every vote
    strategy. Tolerance: none (equal values).
(b) The count wire: M = 1..5 voters, each with a gradient and a momentum
    row (float32 or bf16) whose new momentum m' has planted exact zeros,
    columns where every voter is 0 and, at even M, exact ties. The port's
    optimizer (``make_sign_optimizer`` on ``psum_int8``: encode per voter,
    then update) against the reference's own pieces: its jnp momentum
    update ``beta * m + (1 - beta) * g.astype(dtype)``, its codec's
    ``encode_leaf`` / ``feedback_leaf`` (ef_sign), ``_wire_vote_signs`` on
    ``psum_int8`` over a named axis of M voters (``jax.vmap`` with
    ``axis_name``: the psum is the sum over the voters) and its update
    rule ``p - eta * (vote + wd * p)`` in float32. m', the vote, the
    parameters and ef_sign's residual are bit-equal (tolerance: none;
    but ef_sign's float32 mean|t| is a float32 sum in another order, held
    within rtol 1e-6 of the reference's, and the float32 residual is then
    bit-equal to t - mean|t| * vote with the port's own mean|t|, and to the
    reference's where the vote is 0; in bf16, where mean|t| is rounded to
    bf16, the residual is bit-equal to the reference's).
    ``weighted_vote`` on ``psum_int8`` raises, as in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs import base as jbase  # noqa: E402
from repro.configs import presets as jpresets  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import presets as tpresets  # noqa: E402
from repro_torch.core import signum as tsignum  # noqa: E402
from repro_torch.core.codecs import ef_sign  # noqa: E402

# ---------------------------------------------------------------------------
# (a) the presets
# ---------------------------------------------------------------------------

#: None (the preset's own default) and every concrete strategy
STRATEGIES = [None, "psum_int8", "allgather_1bit", "hierarchical"]


def _fields(obj):
    """A config dataclass as plain values (enums by their value)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", jbase.list_archs())
def test_presets_match_reference(arch):
    """default_optimizer and default_train_config equal the reference's for
    every shape cell x kind x vote strategy (the arch need not be one the
    port's registry has: the presets only read its name)."""
    for cell in jbase.SHAPES.values():
        tcell = tbase.SHAPES[cell.name]
        assert _fields(tcell) == _fields(cell)
        for kind in ("signum_vote", "sgd"):
            for strat in STRATEGIES:
                js = None if strat is None else jbase.VoteStrategy(strat)
                ts = None if strat is None else tbase.VoteStrategy(strat)
                want_opt = jpresets.default_optimizer(arch, kind=kind,
                                                      vote_strategy=js)
                got_opt = tpresets.default_optimizer(arch, kind=kind,
                                                     vote_strategy=ts)
                assert _fields(got_opt) == _fields(want_opt)
                want = jpresets.default_train_config(arch, cell, kind=kind,
                                                     vote_strategy=js)
                got = tpresets.default_train_config(arch, tcell, kind=kind,
                                                    vote_strategy=ts)
                assert _fields(got) == _fields(want), (cell.name, kind,
                                                        strat)


def test_preset_tables_match_reference():
    assert tpresets.MODE_B_ARCHS == jpresets.MODE_B_ARCHS
    assert tpresets.BF16_MOMENTUM_ARCHS == jpresets.BF16_MOMENTUM_ARCHS
    assert tpresets.MICROBATCHES == jpresets.MICROBATCHES


def test_glm4_preset_is_the_sixth_slice_path():
    """The glm4-9b preset the port trains: bf16 per-worker momentum on
    psum_int8, lr 1e-4, beta 0.9, 8 microbatches, full remat, no FSDP."""
    tcfg = tpresets.default_train_config("glm4-9b",
                                         tbase.SHAPES["train_4k"])
    opt = tcfg.optimizer
    assert (opt.kind, opt.momentum_mode, opt.momentum_dtype,
            opt.vote_strategy, opt.learning_rate, opt.momentum) == (
        "signum_vote", tbase.MomentumMode.PER_WORKER, "bfloat16",
        tbase.VoteStrategy.PSUM_INT8, 1e-4, 0.9)
    assert (tcfg.microbatches, tcfg.remat, tcfg.fsdp) == (8, "full", False)
    assert (tcfg.global_batch, tcfg.seq_len) == (256, 4096)


# ---------------------------------------------------------------------------
# (b) the count wire in the trainer
# ---------------------------------------------------------------------------

BETA, LR, WD = 0.9, 1e-3, 0.0
#: coordinates of the test leaf: past two 2-bit words' worth of ragged edge
N = 4133
COUNT_CODECS = ["sign1bit", "ternary2bit", "ef_sign"]
MOM_DTYPES = ["float32", "bfloat16"]


def _inputs(m_voters, mom_dtype, salt):
    """(g (M, N) f32, m (M, N) f32 holding mom_dtype values, e (M, N) the
    same, p (N,) f32). Planted: every 9th column all-zero in g and m
    (every voter abstains), every 13th zero for voter 0 only, and at even
    M every 5th column an exact tie (half the voters +g, half -g with m
    = 0, and their residuals 0)."""
    rng = np.random.default_rng([29, m_voters, len(mom_dtype), salt])
    g = rng.normal(size=(m_voters, N)).astype(np.float32)
    m = (rng.normal(size=(m_voters, N)) * 0.5).astype(np.float32)
    e = (rng.normal(size=(m_voters, N)) * 0.05).astype(np.float32)
    g[:, ::9] = 0.0
    m[:, ::9] = 0.0
    e[:, ::9] = 0.0
    g[0, ::13] = 0.0
    m[0, ::13] = -0.0
    e[0, ::13] = 0.0
    if m_voters % 2 == 0:
        half = m_voters // 2
        g[:half, 2::5] = np.abs(g[:half, 2::5]) + 0.25
        g[half:, 2::5] = -g[:half, 2::5]
        m[:, 2::5] = 0.0
        e[:, 2::5] = 0.0
    if mom_dtype == "bfloat16":
        m, e = (np.array(jnp.asarray(x).astype(jnp.bfloat16)
                         .astype(jnp.float32)) for x in (m, e))
    p = rng.normal(size=N).astype(np.float32)
    return g, m, e, p


def _torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def _port(codec, mom_dtype, g, m, e, p):
    """One step of the port's optimizer on the single leaf "w"."""
    m_voters = g.shape[0]
    cfg = tbase.OptimizerConfig(kind="signum_vote", learning_rate=LR,
                                momentum=BETA, weight_decay=WD,
                                vote_strategy=tbase.VoteStrategy.PSUM_INT8,
                                momentum_dtype=mom_dtype, codec=codec)
    opt = tsignum.make_sign_optimizer(cfg, m_voters)
    params = {"w": torch.from_numpy(p.copy())}
    state = opt.init(params)
    state["momentum"]["w"].copy_(_torch(m, mom_dtype))
    if "error" in state:
        state["error"]["w"].copy_(_torch(e, mom_dtype))
    wire = opt.wire(params)
    for r in range(m_voters):
        opt.encode(r, {"w": torch.from_numpy(g[r].copy())}, state, wire)
    opt.update(wire, state, params, 0)
    out = {"p": params["w"].numpy(),
           "m": state["momentum"]["w"].float().numpy()}
    if "error" in state:
        out["e"] = state["error"]["w"].float().numpy()
    return out


def _reference(codec, mom_dtype, g, m, e, p):
    """The same step from the reference's functions (see the module doc);
    also returns the vote and each voter's mean|t| (ef_sign)."""
    dt = jnp.dtype(mom_dtype)
    c = jcodecs.get_codec(codec)
    jm = jnp.asarray(m).astype(dt)
    v = BETA * jm + (1 - BETA) * jnp.asarray(g).astype(dt)
    new_m = v
    if c.worker_state:
        v = jax.vmap(c.encode_leaf)(v, jnp.asarray(e).astype(dt))
    signs = jsc.sign_ternary(v)
    vote = jax.vmap(lambda s: jva._wire_vote_signs(
        s, ("data",), jbase.VoteStrategy.PSUM_INT8, codec, None)[0],
        axis_name="data")(signs)
    # every voter holds the same decision
    np.testing.assert_array_equal(np.asarray(vote), np.asarray(vote[:1]).repeat(
        vote.shape[0], axis=0))
    vt = vote[0].astype(v.dtype)
    p32 = jnp.asarray(p)
    out = {"p": np.asarray((p32 - LR * (vt.astype(jnp.float32) + WD * p32))
                           .astype(jnp.float32)),
           "m": np.asarray(new_m.astype(jnp.float32)),
           "vote": np.asarray(vote[0])}
    if c.worker_state:
        out["e"] = np.asarray(jax.vmap(lambda t: c.feedback_leaf(
            t, vt, None))(v).astype(jnp.float32))
        out["scale"] = np.asarray(jax.vmap(lambda t: jnp.mean(jnp.abs(t)))(v)
                                  .astype(jnp.float32))
        out["t"] = np.asarray(v.astype(jnp.float32))
    return out


@pytest.mark.parametrize("m_voters", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("mom_dtype", MOM_DTYPES)
@pytest.mark.parametrize("codec", COUNT_CODECS)
def test_count_wire_vote_matches_reference(codec, mom_dtype, m_voters):
    g, m, e, p = _inputs(m_voters, mom_dtype, COUNT_CODECS.index(codec))
    ref = _reference(codec, mom_dtype, g, m, e, p)
    got = _port(codec, mom_dtype, g, m, e, p)
    np.testing.assert_array_equal(got["m"], ref["m"])
    np.testing.assert_array_equal(got["p"], ref["p"])
    vote = ref["vote"]
    # the planted columns: all-abstain and (even M) ties vote 0 and stay
    assert (vote[::9] == 0).all()
    if m_voters % 2 == 0:
        assert (vote[2::5][(np.arange(N)[2::5] % 9) != 0] == 0).all()
    assert (vote != 0).any()
    np.testing.assert_array_equal(got["p"][vote == 0], p[vote == 0])
    if codec != "ef_sign":
        return
    if mom_dtype == "bfloat16":
        np.testing.assert_array_equal(got["e"], ref["e"])
        return
    # float32 mean|t|: the two sums of 4133 terms run in other orders, so
    # the scales may differ in their last few bits (rtol 1e-6, ~8 ulps);
    # the residual is t - scale * vote bit for bit with the port's own
    # scale, and equal to the reference's where the vote is 0
    scale = np.array([float(ef_sign.scale_of(torch.from_numpy(t.copy())))
                      for t in ref["t"]], np.float32)
    np.testing.assert_allclose(scale, ref["scale"], rtol=1e-6, atol=0)
    want = ref["t"] - scale[:, None] * vote[None, :].astype(np.float32)
    np.testing.assert_array_equal(got["e"], want)
    np.testing.assert_array_equal(got["e"][:, vote == 0],
                                  ref["e"][:, vote == 0])


def test_weighted_vote_refuses_psum_int8():
    """As the reference's codec does (weighting needs the individual
    votes, which a psum destroys)."""
    cfg = tbase.OptimizerConfig(kind="signum_vote", codec="weighted_vote",
                                vote_strategy=tbase.VoteStrategy.PSUM_INT8)
    with pytest.raises(ValueError, match="cannot ride"):
        tsignum.make_sign_optimizer(cfg, 4)
    with pytest.raises(ValueError, match="cannot ride"):
        jcodecs.get_codec("weighted_vote").validate_strategy(
            jbase.VoteStrategy.PSUM_INT8)


def test_count_wire_launches_nothing_on_the_cpu_and_keeps_the_state_typed():
    """bf16 momentum stays bf16 (and ef_sign's residual with it); the count
    wire's words are 2-bit words; CPU calls count no launch."""
    from repro_torch.kernels import ops as tops
    g, m, e, p = _inputs(4, "bfloat16", 7)
    cfg = tbase.OptimizerConfig(kind="signum_vote", codec="ef_sign",
                                vote_strategy=tbase.VoteStrategy.PSUM_INT8,
                                momentum_dtype="bfloat16")
    opt = tsignum.make_sign_optimizer(cfg, 4)
    assert opt.strategy == tbase.VoteStrategy.PSUM_INT8
    params = {"w": torch.from_numpy(p.copy())}
    state = opt.init(params)
    assert state["momentum"]["w"].dtype == torch.bfloat16
    assert state["error"]["w"].dtype == torch.bfloat16
    wire = opt.wire(params)
    assert wire["words"]["w"].shape == (4, -(-N // 16))
    tops.reset_launch_counts()
    for r in range(4):
        opt.encode(r, {"w": torch.from_numpy(g[r].copy())}, state, wire)
    opt.update(wire, state, params, 0)
    assert set(tops.launch_counts().values()) == {0}
    assert state["momentum"]["w"].dtype == torch.bfloat16
    assert state["error"]["w"].dtype == torch.bfloat16
