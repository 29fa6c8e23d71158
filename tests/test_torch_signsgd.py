"""signSGD (beta = 0), Mode B (global momentum on the vote) and the
hierarchical trainer wire of the port, against the JAX package on the CPU.

(a) The hierarchical wire's tie policy. ``ternary_majority(ties=
    "plus_one")``'s plain version against ``sign_binary`` of the
    reference's counts (the sum of the voters' ternary symbols) and
    against the reference's ``VirtualBackend`` ``hierarchical`` vote of
    the same symbols, at M = 1 to 127 with planted ties and all-abstain
    columns; ``ternary_unpack``'s float outputs. Tolerance: none.
(b) The optimizer (``core.signum.make_sign_optimizer``) on small random
    leaves, teacher-forced: before each of 2 steps the port takes the
    reference's state, then both make one step from the same gradients.
    - M = 1 against the reference's own ``build_optimizer(cfg, ())``,
      eager: it votes ``sign_ternary`` with no wire, so the leaves carry
      no exact zero (the wires' zero rules are held in (c) and below).
    - M = 4 against a step composed eagerly from the reference's pieces:
      the codec's ``encode_leaf`` / ``feedback_leaf``, the vote of
      ``VirtualBackend().execute(VoteRequest(form="stacked"))`` over the
      concatenated leaves (through the plan when there is one), Mode B's
      ``beta * u + (1 - beta) * vote`` and ``sign(u)``, and the update
      rule. Gradients carry planted exact zeros: every voter 0 in some
      columns (all-abstain), some voters 0 in others, ties at even M.
    Every codec the reference allows at beta = 0 on each strategy it
    rides, Mode B (beta 0.9, float32 and bf16 momentum, and beta 0) on
    the three wires with and without a plan, Mode A with beta > 0 on the
    leaf-wise hierarchical wire, delayed_vote at beta = 0. Bit-equal:
    parameters, momentum (eager JAX rounds each operation, as the port
    does), the delayed vote. Within a tolerance, for reasons of the
    reference's: ef_sign's residual (mean|t| is a float32 sum in each
    package's order: rtol 1e-6, atol 1e-5 * mean|t|) and weighted_vote's
    flip-rate state (the jitted vote fuses its EMA into an FMA: rtol 1e-6).
(c) The trainer (``make_train_step``) on the reduced glm4-9b in float32
    (vocabulary 512, more than a batch's tokens, so embedding rows whose
    gradient is exactly 0 exist) and on a narrow MHA qwen1.5-32b (4 heads
    of 4 kv heads: GQA group 1, qkv bias) under its Mode B preset
    (``signsgd_vote``, global float32 momentum, hierarchical, 2
    microbatches, nested remat; fsdp off):
    - M = 1 against the reference trainer ``make_train_step(cfg, tcfg,
      mesh=None)``, which votes ``sign_ternary`` of its vote input with
      no wire;
    - M = 4 against the step of (b) composed around the reference's
      gradients.
    Each package's gradients are recomputed (the port's by its own
    ``voter_grads``), and each package's applied vote must be, on every
    coordinate, the decision of its own vote inputs under its wire's rule
    (1-bit: an exact 0 votes +1; count: the sign of the symbol sum;
    hierarchical: +1 where the sum is >= 0). The two decisions may differ
    where rounding gave a voter another symbol, on at most 0.1 % of the
    coordinates, and at M = 1 where the reference's ``sign_ternary``
    abstains on an exactly-zero input and the port's 1-bit or
    hierarchical wire votes +1 (asserted exactly, and present).
    Mode B's momentum is bit-equal to beta * u + (1 - beta) * vote
    rounded twice, as the port's kernel computes it; the reference's
    jitted step may contract it into an FMA, so its momentum is held to
    its own vote within rtol 1e-6 with every sign equal. Parameters are
    bit-equal to p - lr * applied in each package. Free-running from the
    same init, the losses agree within rtol 1e-3.
(d) The optimizer state against the reference's ``abstract_state``, key
    for key, shape for shape and dtype for dtype, and the refusals.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs import base as jbase  # noqa: E402
from repro.configs.base import MomentumMode as JMode  # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt  # noqa: E402
from repro.configs.base import VoteStrategy as JS  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core import vote_plan as jvp  # noqa: E402
from repro.core.signum import build_optimizer, lr_at  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import sign_compress as tsc  # noqa: E402
from repro_torch.core import signum as tsignum  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

A, P, H = "allgather_1bit", "psum_int8", "hierarchical"
#: each codec the reference allows, with the strategies it rides
CODEC_WIRES = [("sign1bit", A), ("sign1bit", P), ("sign1bit", H),
               ("ternary2bit", A), ("ternary2bit", P), ("ef_sign", A),
               ("ef_sign", P), ("ef_sign", H), ("weighted_vote", A)]


def _rng(*salt):
    """A numpy generator seeded from `salt` (anything but an int by the
    crc32 of its repr)."""
    return np.random.default_rng(
        [23, *(s if isinstance(s, int) else zlib.crc32(repr(s).encode())
              for s in salt)])


# ---------------------------------------------------------------------------
# (a) the tie policy
# ---------------------------------------------------------------------------

TALLY_VOTERS = [1, 2, 3, 4, 7, 8, 64, 127]


def _symbols(m, n, salt):
    """(m, n) int8 ternary symbols: random, column 0 all-abstain, column 1
    an exact tie (even m) or one more +1 than -1, column 2 all -1 but one
    abstention."""
    s = _rng("symbols", m, salt).integers(-1, 2, size=(m, n)).astype(np.int8)
    s[:, 0] = 0
    half = m // 2
    s[:, 1] = [1] * half + [-1] * half + [0] * (m % 2)
    s[:, 2] = -1
    s[0, 2] = 0
    return s


@pytest.mark.parametrize("m", TALLY_VOTERS)
def test_plus_one_tally_is_sign_binary_of_the_reference_counts(m):
    """The plain ``ternary_majority(ties="plus_one")`` (through the
    ``ops`` wrapper, ragged n) equals ``sign_binary`` of the reference's
    count and the reference's hierarchical vote of the same symbols, bit
    for bit; ties and all-abstain columns give +1."""
    n = 1000 + m
    s = _symbols(m, n, "tally")
    counts = jnp.sum(jnp.asarray(s, jnp.int32), axis=0)
    want = np.asarray(jsc.sign_binary(counts))
    words = tops.ternary_pack(torch.from_numpy(s))
    got = tops.ternary_majority(words, ties="plus_one")
    votes = tops.ternary_unpack(got, n).numpy()
    np.testing.assert_array_equal(votes, want)
    assert votes[0] == 1 and votes[1] == 1
    assert votes[2] == (-1 if m > 1 else 1)   # M = 1: its one voter abstains
    hier = jva.VirtualBackend().execute(jva.VoteRequest(
        payload=jnp.asarray(s, jnp.float32), form="stacked",
        strategy=JS.HIERARCHICAL))
    np.testing.assert_array_equal(votes, np.asarray(hier.votes))
    # the count wire's rule on the same words: ties and all-abstain 0
    zero = tops.ternary_unpack(tops.ternary_majority(words), n).numpy()
    np.testing.assert_array_equal(zero, np.sign(np.asarray(counts)))


def test_plus_one_tally_plain_version_matches_field_by_field():
    """ref.ternary_majority(ties="plus_one") on words with the unused 0b10
    pattern (counts nothing) against the count of 0b01 minus 0b11 fields."""
    rng = _rng("words")
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(5, 64),
                                          dtype=np.int64).astype(np.int32))
    got = tsc.unpack_ternary(tref.ternary_majority(words, "plus_one")[None]
                             )[0].numpy()
    fields = (words.numpy().astype(np.int64)[..., None] >> (
        2 * np.arange(16))) & 3
    count = ((fields == 1).sum(0) - (fields == 3).sum(0)).reshape(-1)
    np.testing.assert_array_equal(got, np.where(count >= 0, 1, -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_ternary_unpack_float_outputs(dtype):
    """ternary_unpack in int8, float32 and bf16: the same ±1 / 0 (0 as
    +0.0; 0b10 reads 0), the first n of the words' symbols."""
    s = _symbols(1, 37, "unpack")[0]
    words = tops.ternary_pack(torch.from_numpy(s)[None])[0]
    words[1] |= 2   # field 16 becomes 0b10 (it was 0b00 or 0b01 -> 0b11)
    want = tsc.unpack_ternary(words[None])[0, :37]
    got = tops.ternary_unpack(words, 37, dtype)
    assert got.dtype == dtype and got.shape == (37,)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    if dtype != torch.int8:
        zero = got[want == 0]
        assert not torch.signbit(zero).any()


@pytest.mark.parametrize("case", ["bad_ties", "bad_dtype"])
def test_tie_and_dtype_arguments_are_checked(case):
    words = torch.zeros((2, 3), dtype=torch.int32)
    if case == "bad_ties":
        with pytest.raises(ValueError, match="ties"):
            tops.ternary_majority(words, ties="minus_one")
    else:
        with pytest.raises(TypeError, match="dtype"):
            tops.ternary_unpack(words[0], 40, torch.int32)


# ---------------------------------------------------------------------------
# (b) the optimizer, teacher-forced step by step
# ---------------------------------------------------------------------------

SHAPES = {"embed.table": (7, 9), "layers.w_gate": (5, 11),
          "layers.norm": (3,), "unembed.table": (6, 4)}
LR, BETA = 0.05, 0.9


def _opts(**kw):
    """The same OptimizerConfig in both packages (strategies, modes by
    value)."""
    out = []
    for pkg, mode_t, strat_t in ((JOpt, JMode, JS),
                                 (tbase.OptimizerConfig,
                                  tbase.MomentumMode, tbase.VoteStrategy)):
        args = dict(kind="signsgd_vote", learning_rate=LR, momentum=BETA)
        args.update(kw)
        if "vote_strategy" in args:
            args["vote_strategy"] = strat_t(args["vote_strategy"])
        if "momentum_mode" in args:
            args["momentum_mode"] = mode_t(args["momentum_mode"])
        out.append(pkg(**args))
    return out


def _grads(m, salt, zeros=True, dtype=np.float32):
    """m voters' gradient trees (numpy). With `zeros`: column 0 of each
    leaf's last axis 0 for every voter, column 1 0 for voter 0 only, and at
    even m column 2 an exact tie (half the voters +1, half -1)."""
    rng = _rng("grads", m, salt)
    out = []
    for r in range(m):
        tree = {}
        for k, s in SHAPES.items():
            g = rng.normal(size=s).astype(np.float32)
            if zeros:
                g[..., 0] = 0.0
                if r == 0 and s[-1] > 1:
                    g[..., 1] = -0.0
                if m % 2 == 0 and s[-1] > 2:
                    g[..., 2] = 1.0 if r < m // 2 else -1.0
            tree[k] = g.astype(dtype)
        out.append(tree)
    return out


def _params(salt, dtype=np.float32):
    rng = _rng("params", salt)
    return {k: rng.normal(size=s).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


def _plans(jo, to, m, bucket_bytes):
    if not bucket_bytes:
        return None, None
    kw = dict(bucket_bytes=bucket_bytes, default_codec=jo.resolved_codec,
              data_size=m)
    return (jvp.build_plan(SHAPES, strategy=jo.vote_strategy, **kw),
            tvp.build_plan(SHAPES, strategy=to.vote_strategy, **kw))


def _zero_state(jo, m, params):
    """The reference trainer's state layout (numpy), with the M voter rows
    of Mode A's momentum and residual stacked."""
    mode_a = jo.momentum_mode == JMode.PER_WORKER
    dt = jnp.dtype(jo.momentum_dtype)
    lead = (m,) if mode_a else ()
    state = {}
    if jo.momentum > 0:
        state["momentum"] = {k: np.zeros(lead + p.shape, dt)
                             for k, p in params.items()}
    if jcodecs.get_codec(jo.resolved_codec).worker_state:
        state["error"] = {k: np.zeros((m,) + p.shape, dt)
                          for k, p in params.items()}
    if jcodecs.get_codec(jo.resolved_codec).server_state:
        state["flip_ema"] = np.zeros((m,), np.float32)
    if jo.delayed_vote:
        state["delayed"] = {k: np.zeros(p.shape, np.int8)
                            for k, p in params.items()}
    return state


def _composed_step(jo, m, params, state, grads, step, jplan=None):
    """One step composed eagerly from the reference's pieces (see the module
    doc): (new params, new state, the applied int8 vote per leaf) as numpy.
    `grads`: m trees; `state`: see `_zero_state`."""
    codec = jcodecs.get_codec(jo.resolved_codec)
    beta, dt = jo.momentum, jnp.dtype(jo.momentum_dtype)
    mode_b = jo.momentum_mode == JMode.GLOBAL
    names = ([s.name for s in jplan.leaves] if jplan is not None
             else list(params))
    per_worker = not mode_b and beta > 0
    new = {k: dict(v) if isinstance(v, dict) else v
           for k, v in state.items()}
    inputs = {k: [] for k in names}
    moms = {k: [] for k in names}
    for r in range(m):
        for k in names:
            x = jnp.asarray(grads[r][k])
            if per_worker:
                x = beta * jnp.asarray(state["momentum"][k][r]) \
                    + (1 - beta) * x.astype(dt)
                moms[k].append(np.asarray(x))
            if codec.worker_state:
                x = codec.encode_leaf(x, jnp.asarray(state["error"][k][r]))
            inputs[k].append(x)
    if per_worker:
        new["momentum"] = {k: np.stack(v) for k, v in moms.items()}
    stacked = jnp.concatenate(
        [jnp.stack([x.reshape(-1) for x in inputs[k]]).astype(jnp.float32)
         for k in names], axis=1)
    cstate = ({"flip_ema": jnp.asarray(state["flip_ema"])}
              if "flip_ema" in state else None)
    out = jva.VirtualBackend().execute(jva.VoteRequest(
        payload=stacked, form="stacked", strategy=jo.vote_strategy,
        codec=jo.resolved_codec, plan=jplan, server_state=cstate))
    flat = np.asarray(out.votes)
    if cstate is not None:
        new["flip_ema"] = np.asarray(out.server_state["flip_ema"])
    votes, start = {}, 0
    for k in names:
        size = params[k].size
        votes[k] = flat[start:start + size].reshape(params[k].shape)
        start += size
    if codec.worker_state:
        new["error"] = {k: np.stack([np.asarray(codec.feedback_leaf(
            t, jnp.asarray(votes[k]).astype(t.dtype),
            jnp.asarray(state["error"][k][r])))
            for r, t in enumerate(inputs[k])]) for k in names}
    applied = votes
    if mode_b and beta > 0:
        u = {k: beta * jnp.asarray(state["momentum"][k])
             + (1 - beta) * jnp.asarray(votes[k]).astype(dt) for k in names}
        new["momentum"] = {k: np.asarray(v) for k, v in u.items()}
        applied = {k: np.asarray(jnp.sign(v)) for k, v in u.items()}
    if jo.delayed_vote:
        applied = state["delayed"]
        new["delayed"] = {k: v.astype(np.int8) for k, v in votes.items()}
    eta = lr_at(jo, jnp.int32(step))
    new_params = {}
    for k, p in params.items():
        p32 = jnp.asarray(p).astype(jnp.float32)
        upd = jnp.asarray(applied[k]).astype(jnp.float32) \
            + jo.weight_decay * p32
        new_params[k] = np.asarray((p32 - eta * upd).astype(p.dtype))
    return new_params, new, applied


def _to_port(params, state, to, m):
    """numpy params and state (see `_zero_state`) -> the port's."""
    tp = tM.params_from_numpy(params, device="cpu")
    ts = {"count": 0}
    for key in ("momentum", "error", "delayed"):
        if key in state:
            ts[key] = tM.params_from_numpy(state[key], device="cpu")
    if "flip_ema" in state:
        ts["codec"] = {"flip_ema": torch.from_numpy(
            state["flip_ema"].copy())}
    return tp, ts


def _port_step(to, tplan, m, params, state, grads, step):
    opt = tsignum.make_sign_optimizer(to, m, tplan)
    tp, ts = _to_port(params, state, to, m)
    fresh = opt.init(tp)
    assert sorted(fresh) == sorted(ts), (sorted(fresh), sorted(ts))
    for key in ("momentum", "error", "delayed"):
        for k, v in fresh.get(key, {}).items():
            assert v.shape == ts[key][k].shape and v.dtype == ts[key][k].dtype
    wire = opt.wire(tp)
    for r in range(m):
        opt.encode(r, tM.params_from_numpy(grads[r], device="cpu"), ts, wire)
    opt.update(wire, ts, tp, step)
    assert ts["count"] == 1
    return tp, ts


def _bits(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _np(t):
    """A tensor as numpy, bf16 kept (as an ml_dtypes bf16 array)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _assert_step(tp, ts, params, state, ef_scale=None):
    """The port's new state against the reference's (numpy): see the
    module doc for what is exact."""
    for k, p in params.items():
        np.testing.assert_array_equal(_bits(_np(tp[k])), _bits(p),
                                      err_msg=k)
    for k, u in state.get("momentum", {}).items():
        np.testing.assert_array_equal(_bits(_np(ts["momentum"][k])),
                                      _bits(u), err_msg=k)
    for k, d in state.get("delayed", {}).items():
        np.testing.assert_array_equal(ts["delayed"][k].numpy(), d)
    for k, e in state.get("error", {}).items():
        np.testing.assert_allclose(ts["error"][k].float().numpy(),
                                   np.asarray(e, np.float32), rtol=1e-6,
                                   atol=1e-5 * ef_scale[k], err_msg=k)
    if "flip_ema" in state:
        np.testing.assert_allclose(ts["codec"]["flip_ema"].numpy(),
                                   state["flip_ema"], rtol=1e-6)


def _run_composed(kw, m, steps=2, bucket_bytes=0, pdtype=np.float32,
                  zeros=True):
    """`steps` teacher-forced steps of the port against `_composed_step`."""
    jo, to = _opts(**kw)
    jplan, tplan = _plans(jo, to, m, bucket_bytes)
    params = _params(str(kw), pdtype)
    state = _zero_state(jo, m, params)
    for step in range(steps):
        grads = _grads(m, (str(kw), step), zeros, pdtype)
        tp, ts = _port_step(to, tplan, m, params, state, grads, step)
        new_params, new_state, applied = _composed_step(
            jo, m, params, state, grads, step, jplan)
        # mean|t| bounds the residual's rounding: |e'| <= |t| + mean|t|
        scale = {k: float(np.abs(np.asarray(e, np.float32)).max())
                 for k, e in new_state.get("error", {}).items()}
        _assert_step(tp, ts, new_params, new_state, scale)
        params, state = new_params, new_state
    return applied


@pytest.mark.parametrize("kind,codec,strategy",
                         [("signsgd_vote",) + cw for cw in CODEC_WIRES]
                         + [("signum_vote", "sign1bit", s) for s in (A, H)])
def test_m4_beta0_optimizer_matches_composed_reference(kind, codec,
                                                       strategy):
    """signSGD (beta = 0, Mode A) with every codec on every wire it rides:
    each voter sends the signs of its gradient (ef_sign: of e + g). Kind
    signum_vote at beta = 0 is the same optimizer, as in the reference."""
    _run_composed(dict(kind=kind, momentum=0.0, codec=codec,
                       vote_strategy=strategy), 4)


@pytest.mark.parametrize("strategy", [A, P, H])
@pytest.mark.parametrize("variant", ["f32", "bf16_momentum", "beta0",
                                     "plan", "bf16_params"])
def test_m4_mode_b_optimizer_matches_composed_reference(strategy, variant):
    """Mode B on the three wires: the vote goes into one leaf-shaped
    momentum, sign(u) is applied (at beta = 0 the vote itself); with bf16
    momentum, through a plan of 64-byte buckets, and on bf16 parameters
    and gradients (the 1-bit wire's bitpack and the 2-bit wires'
    ternary_pack of bf16 rows)."""
    kw = dict(momentum_mode="global", vote_strategy=strategy)
    if variant == "bf16_momentum":
        kw["momentum_dtype"] = "bfloat16"
    if variant == "beta0":
        kw["momentum"] = 0.0
    _run_composed(kw, 4, bucket_bytes=64 if variant == "plan" else 0,
                  pdtype=jnp.bfloat16 if variant == "bf16_params"
                  else np.float32)


@pytest.mark.parametrize("codec,strategy", [("ternary2bit", A),
                                            ("ternary2bit", P),
                                            ("weighted_vote", A)])
def test_m4_mode_b_codecs_match_composed_reference(codec, strategy):
    """Mode B with the codecs it allows: ternary symbols keep abstention on
    the 1-bit strategy's exchange; weighted_vote keeps its server state."""
    _run_composed(dict(momentum_mode="global", vote_strategy=strategy,
                       codec=codec), 4)


@pytest.mark.parametrize("case", ["beta0_plan", "beta0_ef_plan",
                                  "beta0_delayed", "beta0_delayed_plan",
                                  "mode_a_hierarchical",
                                  "mode_a_hierarchical_ef"])
def test_m4_other_paths_match_composed_reference(case):
    """beta = 0 through a plan (ef_sign's residual too) and with
    delayed_vote; Mode A with beta > 0 on the leaf-wise hierarchical wire
    (the momentum kernel, ternary_pack of m', the ties-+1 tally)."""
    kw = {"beta0_plan": dict(momentum=0.0, vote_strategy=H),
          "beta0_ef_plan": dict(momentum=0.0, vote_strategy=P,
                                codec="ef_sign"),
          "beta0_delayed": dict(momentum=0.0, vote_strategy=A,
                                delayed_vote=True),
          "beta0_delayed_plan": dict(momentum=0.0, vote_strategy=H,
                                     delayed_vote=True),
          "mode_a_hierarchical": dict(kind="signum_vote",
                                      vote_strategy=H),
          "mode_a_hierarchical_ef": dict(kind="signum_vote",
                                         vote_strategy=H,
                                         codec="ef_sign")}[case]
    _run_composed(kw, 4, bucket_bytes=64 if "plan" in case else 0)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_hierarchical_ties_and_abstentions_vote_plus_one(m):
    """Mode A at beta = 0 on hierarchical: every coordinate moves by -lr or
    +lr (ties and all-abstain +1), where the count wire leaves the
    all-abstain columns still."""
    applied = _run_composed(dict(momentum=0.0, vote_strategy=H), m,
                            steps=1)
    for k, v in applied.items():
        assert set(np.unique(v)) <= {-1, 1}, k
        assert (v[..., 0] == 1).all(), k     # every voter abstains there
    count = _run_composed(dict(momentum=0.0, vote_strategy=P), m, steps=1)
    assert all((v[..., 0] == 0).all() for v in count.values())


@pytest.mark.parametrize("kw", [
    dict(momentum_mode="global", vote_strategy=H),
    dict(momentum_mode="global", vote_strategy=P, momentum_dtype="bfloat16"),
    dict(momentum_mode="global", vote_strategy=A, momentum=0.0),
    dict(momentum=0.0, vote_strategy=A),
    dict(momentum=0.0, vote_strategy=H, codec="ef_sign"),
    dict(momentum=0.0, vote_strategy=A, codec="weighted_vote"),
], ids=["mode_b_hier", "mode_b_psum_bf16", "mode_b_beta0", "beta0",
        "beta0_ef", "beta0_weighted"])
def test_m1_optimizer_matches_reference_build_optimizer(kw):
    """M = 1 against the reference's own ``build_optimizer(cfg, ())``
    (eager): two steps bit-equal on leaves without an exact zero (the
    reference votes sign_ternary with no wire: an exact 0 abstains there
    and reads +1 on the port's 1-bit and hierarchical wires)."""
    jo, to = _opts(**kw)
    j = build_optimizer(jo, ())
    jparams = {k: jnp.asarray(v) for k, v in _params("m1").items()}
    js = j.init(jparams)
    topt = tsignum.make_sign_optimizer(to, 1)
    tp = tM.params_from_numpy(_params("m1"), device="cpu")
    ts = topt.init(tp)
    if jo.momentum_mode == JMode.GLOBAL and jo.momentum == 0:
        # the reference's init allocates a momentum its update never reads;
        # its trainer's state (abstract_state) has none, nor has the port's
        js.pop("momentum")
    assert sorted(ts) == sorted(js)
    for step in range(2):
        g = _grads(1, ("m1", step), zeros=False)[0]
        jparams, js, _ = j.update({k: jnp.asarray(v) for k, v in g.items()},
                                  js, jparams, jnp.int32(step))
        wire = topt.wire(tp)
        topt.encode(0, tM.params_from_numpy(g, device="cpu"), ts, wire)
        topt.update(wire, ts, tp, step)
        for k in jparams:
            np.testing.assert_array_equal(_bits(tp[k].numpy()),
                                          _bits(jparams[k]), err_msg=k)
        for k in js.get("momentum", {}):
            np.testing.assert_array_equal(_bits(_np(ts["momentum"][k])),
                                          _bits(js["momentum"][k]))
        for k in js.get("error", {}):
            np.testing.assert_allclose(ts["error"][k][0].numpy(),
                                       np.asarray(js["error"][k]),
                                       rtol=1e-6, atol=1e-6)


def test_m1_count_wire_abstains_as_the_reference():
    """At M = 1 the count wire agrees with the reference's sign_ternary on
    exact zeros too (both abstain): Mode B on psum_int8, bit-equal."""
    jo, to = _opts(momentum_mode="global", vote_strategy=P)
    j = build_optimizer(jo, ())
    jparams = {k: jnp.asarray(v) for k, v in _params("zeros").items()}
    js = j.init(jparams)
    topt = tsignum.make_sign_optimizer(to, 1)
    tp = tM.params_from_numpy(_params("zeros"), device="cpu")
    ts = topt.init(tp)
    g = _grads(1, "zeros")[0]
    jparams, js, _ = j.update({k: jnp.asarray(v) for k, v in g.items()},
                              js, jparams, jnp.int32(0))
    wire = topt.wire(tp)
    topt.encode(0, tM.params_from_numpy(g, device="cpu"), ts, wire)
    topt.update(wire, ts, tp, 0)
    for k in jparams:
        np.testing.assert_array_equal(_bits(tp[k].numpy()),
                                      _bits(jparams[k]), err_msg=k)
        np.testing.assert_array_equal(ts["momentum"][k].numpy(),
                                      np.asarray(js["momentum"][k]))
        assert (ts["momentum"][k][..., 0] == 0).all()


# ---------------------------------------------------------------------------
# (c) the trainer
# ---------------------------------------------------------------------------

GB, SEQ, TLR = 8, 64, 1e-3
M4 = 4
MAX_EXCLUDED = 1e-3
#: |input| at most this share of its leaf's largest, and not 0: a
#: coordinate whose sign the reference's recomputed gradient (jitted alone,
#: not inside its train step) may give otherwise than the step did
AMBIGUOUS = 1e-5


def _glm_cfgs():
    j = dataclasses.replace(jbase.reduced_config(jbase.get_config("glm4-9b")),
                            dtype="float32")
    t = dataclasses.replace(tbase.reduced_config(tbase.get_config("glm4-9b")),
                            dtype="float32")
    return j, t


def _qwen_cfgs():
    """qwen1.5-32b at a narrow width: 2 layers, d_model 128, 4 heads of 4
    kv heads (GQA group 1, as the full model's 40 of 40), qkv bias."""
    out = []
    for pkg in (jbase, tbase):
        full = pkg.get_config("qwen1.5-32b")
        out.append(dataclasses.replace(pkg.reduced_config(
            full, num_kv_heads=4), dtype="float32"))
    assert out[1].num_heads == out[1].num_kv_heads == 4
    assert out[1].qkv_bias and out[1].act_seq_shard
    return tuple(out)


def _train_cfgs(**kw):
    jo, to = _opts(learning_rate=TLR, **kw)
    return (jbase.TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=jo),
            tbase.TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=to))


def _qwen_preset_cfgs():
    """The qwen1.5-32b preset (Mode B: signsgd_vote, global momentum,
    hierarchical, beta 0.9, 8 microbatches, nested remat, fsdp) at the
    test's size: 2 microbatches, fsdp off, lr 1e-3 (the preset's 1e-4 is
    below a float32 ulp of some parameters)."""
    from repro.configs.presets import default_train_config as jdefault
    from repro_torch.configs.presets import default_train_config as tdefault
    j = jdefault("qwen1.5-32b", jbase.ShapeCell("test", SEQ, GB, "train"))
    t = tdefault("qwen1.5-32b", tbase.ShapeCell("test", SEQ, GB, "train"))
    assert (t.optimizer.kind, t.optimizer.momentum_mode.value,
            t.optimizer.vote_strategy.value, t.optimizer.momentum_dtype,
            t.remat, t.fsdp, t.microbatches) == (
        "signsgd_vote", "global", "hierarchical", "float32", "nested", True,
        8)
    return tuple(dataclasses.replace(
        c, microbatches=2, fsdp=False, optimizer=dataclasses.replace(
            c.optimizer, learning_rate=TLR)) for c in (j, t))


_GRAD_FNS = {}


def _jgrads(cfg, tcfg, params, tokens, m):
    """The reference's per-voter gradients (numpy, (M, ...) per leaf) and
    the mean loss, accumulated over microbatches as its ``acc_body`` scan
    does (a bf16 accumulator for the sign family)."""
    key = (cfg, tcfg.remat)
    if key not in _GRAD_FNS:
        _GRAD_FNS[key] = jax.jit(jax.value_and_grad(
            lambda p, t: jM.loss_fn(cfg, p, {"tokens": t},
                                    remat=tcfg.remat), has_aux=True))
    fn = _GRAD_FNS[key]
    per, micro = tokens.shape[0] // m, tcfg.microbatches
    rows = per // micro
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out, losses = {k: [] for k in params}, []
    for r in range(m):
        acc = None
        for i in range(micro):
            start = r * per + i * rows
            (loss, _), g = fn(jp, jnp.asarray(tokens[start:start + rows]))
            losses.append(float(loss))
            if micro == 1:
                acc = g
                continue
            if acc is None:
                acc = {k: jnp.zeros(v.shape, jnp.bfloat16)
                       for k, v in g.items()}
            acc = {k: acc[k] + g[k].astype(jnp.bfloat16) for k in g}
        if micro > 1:
            acc = {k: v / micro for k, v in acc.items()}
        for k in params:
            out[k].append(np.asarray(acc[k].astype(jnp.float32)))
    return {k: np.stack(v) for k, v in out.items()}, float(np.mean(losses))


def _tgrads(cfg, tcfg, params, tokens, m):
    """The port's per-voter gradients, by the trainer's own voter_grads."""
    tp = tM.params_from_numpy(params, device="cpu")
    per = tokens.shape[0] // m
    out = {k: [] for k in params}
    for r in range(m):
        g, _ = tTS.voter_grads(cfg, tcfg, tp, torch.as_tensor(
            tokens[r * per:(r + 1) * per]))
        for k in params:
            out[k].append(g[k].float().numpy())
    return {k: np.stack(v) for k, v in out.items()}


def _decide(x, rule, w=None):
    """The vote of each coordinate of the (M, ...) inputs `x` under `rule`:
    "sign" (the reference's M = 1 step: sign_ternary, no wire), "1bit" (an
    exact 0 votes +1; a weighted sum >= 0 gives +1), "count" (the sign of
    the symbol sum) or "hier" (+1 where the symbol sum is >= 0)."""
    if rule == "sign":
        return np.sign(x[0]).astype(np.int8)
    w = np.ones(x.shape[0]) if w is None else np.asarray(w, np.float64)
    w = w.reshape((-1,) + (1,) * (x.ndim - 1))
    if rule == "1bit":
        total = (w * np.where(x >= 0, 1.0, -1.0)).sum(axis=0)
        return np.where(total >= 0, 1, -1).astype(np.int8)
    total = np.sign(x).sum(axis=0)
    if rule == "count":
        return np.sign(total).astype(np.int8)
    return np.where(total >= 0, 1, -1).astype(np.int8)


def _rule(codec, strategy):
    """The port's (and a wire's) decision rule of a codec on a strategy."""
    if codec == "ternary2bit" or strategy == P:
        return "count"
    return "hier" if strategy == H else "1bit"


def _mode_b_momentum(u0, v, beta):
    """beta * u + (1 - beta) * v in float32, each product and the sum
    rounded on its own (the port's momentum kernel)."""
    return (np.float32(beta) * u0) + (np.float32(1 - beta)
                                      * v.astype(np.float32))


def _check_trainer_step(state, ref, port, rin, pin, *, rule_ref, rule_port,
                        mode_b, beta, m1=False):
    """One teacher-forced trainer step of each package (see the module
    doc). `state`: the common start (numpy: params, momentum, error);
    `ref` / `port`: each package's new state with "loss"; `rin` / `pin`:
    each package's vote inputs (M, ...) per leaf. Returns the coordinates
    that rounding decided otherwise and those that the M = 1 zero rule
    did."""
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    lr = np.float32(TLR)
    rounding = ambiguous = rule_zeros = total = 0
    for k, p0 in state["params"].items():
        vr = _decide(rin[k], rule_ref)
        vp = _decide(pin[k], rule_port)
        vx = _decide(rin[k], rule_port)
        rounding += int((vp != vx).sum())
        total += vp.size
        rule = vx != vr
        if rule.any():   # the M = 1 reference abstains on exact zeros
            assert m1 and rule_ref == "sign", k
            assert (rin[k][:, rule] == 0).all() and (vr[rule] == 0).all()
            assert (vx[rule] == 1).all(), k
            rule_zeros += int(rule.sum())
        big = np.abs(rin[k]).max()
        sure = ~((np.abs(rin[k]) <= AMBIGUOUS * big)
                 & (rin[k] != 0)).any(axis=0)
        ambiguous += int((~sure).sum())
        for who, v, new in (("port", vp, port), ("ref", vr, ref)):
            keep = np.ones_like(sure) if who == "port" else sure
            applied = v
            if mode_b and beta > 0:
                want = _mode_b_momentum(state["momentum"][k], v, beta)
                got = np.asarray(new["momentum"][k], np.float32)
                if who == "port":
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:   # XLA may contract it into an FMA
                    np.testing.assert_allclose(got[keep], want[keep],
                                               rtol=1e-6, err_msg=k)
                    np.testing.assert_array_equal(np.sign(got[keep]),
                                                  np.sign(want[keep]),
                                                  err_msg=k)
                applied = np.sign(got)
            want_p = (p0 - lr * applied.astype(np.float32)).astype(
                np.float32)
            np.testing.assert_array_equal(new["params"][k][keep],
                                          want_p[keep], err_msg=(who, k))
            if "error" not in new:
                continue
            x = pin if who == "port" else rin
            err = np.reshape(new["error"][k], x[k].shape)
            for r in range(x[k].shape[0]):
                t = x[k][r]
                scale = np.float32(np.mean(np.abs(t), dtype=np.float64))
                np.testing.assert_allclose(
                    err[r][keep], (t - scale * v)[keep], rtol=1e-5,
                    atol=1e-6 * scale + 1e-7, err_msg=(who, k))
    assert rounding <= MAX_EXCLUDED * total, (rounding, total)
    assert ambiguous <= MAX_EXCLUDED * total, (ambiguous, total)
    if m1 and rule_port in ("1bit", "hier"):
        assert rule_zeros > 0   # the hazard is exercised
    if "ema" in port:
        np.testing.assert_allclose(port["ema"], ref["ema"], rtol=1e-6,
                                   atol=1e-7 * (rounding + 1))
    return rounding, rule_zeros


def _snap(params, opt):
    """A state as numpy float32 (and the ema): params, momentum, error,
    of the reference trainer or of the port."""
    def np_(t):
        if isinstance(t, torch.Tensor):
            return t.float().numpy().copy()
        return np.asarray(np.asarray(t), np.float32)
    out = {"params": {k: np_(v) for k, v in params.items()}}
    for key in ("momentum", "error"):
        if key in opt:
            out[key] = {k: np_(v) for k, v in opt[key].items()}
    if "codec" in opt:
        out["ema"] = np_(opt["codec"]["flip_ema"])
    return out


def _port_from(state, m, mom_dtype=torch.float32):
    """A numpy state (see `_snap`) as the port's (params, opt_state); the
    M = 1 reference's leaf-shaped residual gets its voter axis."""
    tp = tM.params_from_numpy(state["params"], device="cpu")
    ts = {"count": 0}
    if "momentum" in state:
        ts["momentum"] = {k: v.to(mom_dtype) for k, v in tM.params_from_numpy(
            state["momentum"], device="cpu").items()}
    if "error" in state:
        ts["error"] = tM.params_from_numpy(
            {k: v.reshape((m,) + state["params"][k].shape)
             for k, v in state["error"].items()}, device="cpu")
    if "ema" in state:
        ts["codec"] = {"flip_ema": torch.from_numpy(
            np.array(state["ema"], np.float32).reshape(m))}
    return tp, ts


def _reference_run(cfg, tcfg, steps):
    art = jTS.make_train_step(cfg, tcfg, mesh=None)
    params, opt = jTS.materialize_state(cfg, tcfg, art, jax.random.PRNGKey(0))
    pipe = SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
    states, losses, batches = [], [], []
    for step in range(steps):
        tokens = pipe.global_batch_at(step)["tokens"]
        states.append(_snap(params, opt))
        params, opt, met = art.step_fn(params, opt,
                                       {"tokens": jnp.asarray(tokens)},
                                       jnp.int32(step))
        losses.append(float(met["loss"]))
        batches.append(tokens)
    states.append(_snap(params, opt))
    return states, losses, batches


def _port_trainer_step(cfg, tcfg, m, state, tokens, step):
    art = tTS.make_train_step(cfg, tcfg, m, device="cpu")
    tp, ts = _port_from(state, m)
    tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
    return {"loss": float(met["loss"]), **_snap(tp, ts)}


def _vote_inputs(grads, state, codec):
    """The vote inputs from the gradients: g, or ef_sign's t = e + g."""
    if codec != "ef_sign":
        return grads
    return {k: state["error"][k].reshape(g.shape) + g
            for k, g in grads.items()}


@pytest.fixture(scope="module")
def ref_beta0():
    return _reference_run(_glm_cfgs()[0], _train_cfgs(
        momentum=0.0, vote_strategy=A)[0], 3)


@pytest.fixture(scope="module")
def ref_beta0_ef():
    return _reference_run(_glm_cfgs()[0], _train_cfgs(
        momentum=0.0, vote_strategy=A, codec="ef_sign")[0], 3)


@pytest.fixture(scope="module")
def ref_mode_b():
    return _reference_run(_glm_cfgs()[0], _train_cfgs(
        momentum_mode="global", vote_strategy=H)[0], 3)


@pytest.fixture(scope="module")
def ref_qwen():
    return _reference_run(_qwen_cfgs()[0], _qwen_preset_cfgs()[0], 3)


def _m1_case(run, cfgs, jt, tt, step, port=None):
    """Step `step` of the port at M = 1 teacher-forced from the reference
    trainer's `run` (or the caller's `port` result of that step), checked
    by `_check_trainer_step`."""
    states, losses, batches = run
    j, t = cfgs
    opt = tt.optimizer
    codec, state = opt.resolved_codec, states[step]
    if port is None:
        port = _port_trainer_step(t, tt, 1, state, batches[step], step)
    ref = {"loss": losses[step], **states[step + 1]}
    rg, _ = _jgrads(j, jt, state["params"], batches[step], 1)
    pg = _tgrads(t, tt, state["params"], batches[step], 1)
    return _check_trainer_step(
        state, ref, port, _vote_inputs(rg, state, codec),
        _vote_inputs(pg, state, codec), rule_ref="sign",
        rule_port=_rule(codec, opt.vote_strategy.value),
        mode_b=opt.momentum_mode.value == "global", beta=opt.momentum,
        m1=True)


@pytest.mark.parametrize("codec,strategy,step", [
    ("sign1bit", A, 0), ("sign1bit", A, 2), ("sign1bit", P, 2),
    ("sign1bit", H, 2), ("ternary2bit", A, 2), ("weighted_vote", A, 2)])
def test_m1_beta0_trainer_matches_reference(ref_beta0, codec, strategy,
                                            step):
    """signSGD at M = 1 against the reference trainer, whose single voter
    votes sign_ternary(g) on every strategy and codec (so one reference
    run serves them all; its weighted_vote state would stay 0, as the
    port's: one voter agrees with itself). Without momentum a step's only
    state is the parameters, so step 2 alone stands for the later steps."""
    jt, tt = _train_cfgs(momentum=0.0, vote_strategy=strategy, codec=codec)
    states, losses, batches = ref_beta0
    if codec == "weighted_vote":
        states = [{**s, "ema": np.zeros((1,), np.float32)} for s in states]
    _m1_case((states, losses, batches), _glm_cfgs(), jt, tt, step)


@pytest.mark.parametrize("strategy", [A, H])
def test_m1_beta0_ef_sign_trainer_matches_reference(ref_beta0_ef, strategy):
    """ef_sign at beta = 0 (t = e + g) at M = 1, teacher-forced from the
    reference's step 2 (its leaf-shaped residual is the port's one voter
    row)."""
    jt, tt = _train_cfgs(momentum=0.0, vote_strategy=strategy,
                         codec="ef_sign")
    _m1_case(ref_beta0_ef, _glm_cfgs(), jt, tt, 2)


@pytest.mark.parametrize("strategy,planned,step", [
    (H, False, 0), (A, False, 2), (P, False, 2), (H, False, 2),
    (H, True, 2)])
def test_m1_mode_b_trainer_matches_reference(ref_mode_b, strategy, planned,
                                             step):
    """Mode B (signsgd_vote, global float32 momentum, beta 0.9) at M = 1
    on the three wires and through a plan, against the reference trainer
    on hierarchical (at M = 1 it votes without a wire on every strategy);
    from the zero momentum (step 0) and from the reference's momentum of
    step 2."""
    jt, tt = _train_cfgs(momentum_mode="global", vote_strategy=strategy,
                         bucket_bytes=4096 if planned else 0)
    _m1_case(ref_mode_b, _glm_cfgs(), jt, tt, step)


@pytest.mark.parametrize("step", [2])
def test_m1_qwen_mode_b_preset_matches_reference(ref_qwen, step):
    """The qwen1.5-32b Mode B preset end to end at M = 1 on the narrow MHA
    config: 2 microbatches (bf16 accumulator), nested remat, the global
    momentum on hierarchical, from the reference's state of step 2."""
    jt, tt = _qwen_preset_cfgs()
    _m1_case(ref_qwen, _qwen_cfgs(), jt, tt, step)


def test_m1_free_running_losses_match_reference(ref_beta0, ref_mode_b,
                                                ref_qwen):
    """Three steps from the same init: signSGD on allgather_1bit, Mode B on
    hierarchical (glm4-9b) and the qwen Mode B preset."""
    cases = [(ref_beta0, _glm_cfgs()[1],
              _train_cfgs(momentum=0.0, vote_strategy=A)[1]),
             (ref_mode_b, _glm_cfgs()[1],
              _train_cfgs(momentum_mode="global", vote_strategy=H)[1]),
             (ref_qwen, _qwen_cfgs()[1], _qwen_preset_cfgs()[1])]
    for (states, losses, batches), t, tt in cases:
        art = tTS.make_train_step(t, tt, 1, device="cpu")
        tp, ts = _port_from(states[0], 1)
        got = []
        for step, tokens in enumerate(batches):
            tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
            got.append(float(met["loss"]))
        np.testing.assert_allclose(got, losses, rtol=1e-3)


def _composed_trainer_run(cfg, jt, steps, jplan=None):
    """`steps` M = 4 trainer steps composed around the reference's
    gradients (`_jgrads`) with `_composed_step`; per step (state, loss,
    tokens, the reference's vote inputs), and the final state."""
    jo = jt.optimizer
    params = {k: np.asarray(v) for k, v in jM.init_params(
        cfg, jax.random.PRNGKey(0)).items()}
    state = _zero_state(jo, M4, params)
    pipe = SyntheticLMPipeline(cfg, jt.global_batch, SEQ, seed=0)
    out = []
    for step in range(steps):
        tokens = pipe.global_batch_at(step)["tokens"]
        rg, loss = _jgrads(cfg, jt, params, tokens, M4)
        snap = _as_snap(params, state)
        out.append((snap, loss, tokens,
                    _vote_inputs(rg, snap, jo.resolved_codec)))
        grads = [{k: v[r] for k, v in rg.items()} for r in range(M4)]
        params, state, _ = _composed_step(jo, M4, params, state, grads,
                                          step, jplan)
    out.append((_as_snap(params, state), None, None, None))
    return out


def _as_snap(params, state):
    out = {"params": dict(params)}
    for key in ("momentum", "error"):
        if key in state:
            out[key] = {k: np.asarray(v, np.float32)
                        for k, v in state[key].items()}
    return out


M4_CASES = {
    "beta0_ef_allgather": dict(momentum=0.0, vote_strategy=A,
                               codec="ef_sign"),
    "mode_b_psum": dict(momentum_mode="global", vote_strategy=P),
    "mode_b_hier_plan": dict(momentum_mode="global", vote_strategy=H,
                             bucket_bytes=4096),
}


@pytest.mark.parametrize("case", sorted(M4_CASES))
def test_m4_trainer_matches_composed_reference(case):
    """M = 4 trainer steps (teacher-forced at steps 0 and 1) against the
    composed reference: signSGD with ef_sign on allgather_1bit; Mode B on
    psum_int8 and, through the plan the reference's trainer builds
    (4096-byte buckets), hierarchical (the other wires and codecs: at
    M = 1 above and in the optimizer's M = 4 tests)."""
    j, t = _glm_cfgs()
    jt, tt = _train_cfgs(**M4_CASES[case])
    opt = tt.optimizer
    jplan = None
    if opt.bucket_bytes:
        # the reference trainer's plan over a mesh whose data axis is the
        # M = 4 stacked voters (train_step.py:161-187)
        jplan = jvp.build_plan(
            j.param_shapes(), bucket_bytes=opt.bucket_bytes,
            strategy=JS.HIERARCHICAL, data_size=M4,
            dtypes={k: j.dtype for k in j.param_shapes()})
        art = tTS.make_train_step(t, tt, M4, device="cpu")
        assert art.plan.n_buckets == jplan.n_buckets > 1
    run = _composed_trainer_run(j, jt, 2, jplan)
    codec, rule = opt.resolved_codec, _rule(opt.resolved_codec,
                                            opt.vote_strategy.value)
    for step in range(2):
        state, loss, tokens, rin = run[step]
        port = _port_trainer_step(t, tt, M4, state, tokens, step)
        pg = _tgrads(t, tt, state["params"], tokens, M4)
        _check_trainer_step(state, {"loss": loss, **run[step + 1][0]}, port,
                            rin, _vote_inputs(pg, state, codec),
                            rule_ref=rule, rule_port=rule,
                            mode_b=opt.momentum_mode.value == "global",
                            beta=opt.momentum)


# ---------------------------------------------------------------------------
# (d) the state layout and the refusals
# ---------------------------------------------------------------------------

LAYOUTS = {
    "beta0": dict(momentum=0.0, vote_strategy=A),
    "beta0_ef": dict(momentum=0.0, vote_strategy=H, codec="ef_sign"),
    "beta0_weighted": dict(momentum=0.0, vote_strategy=A,
                           codec="weighted_vote"),
    "beta0_delayed": dict(momentum=0.0, vote_strategy=P, delayed_vote=True),
    "mode_b": dict(momentum_mode="global", vote_strategy=H),
    "mode_b_bf16": dict(momentum_mode="global", vote_strategy=P,
                        momentum_dtype="bfloat16"),
    "mode_b_beta0": dict(momentum_mode="global", momentum=0.0,
                         vote_strategy=H),
    "mode_b_weighted": dict(momentum_mode="global", vote_strategy=A,
                            codec="weighted_vote"),
    "mode_a_hierarchical": dict(kind="signum_vote", vote_strategy=H),
}


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_state_layout_matches_abstract_state(case, m):
    """materialize_state against the reference's ``abstract_state`` (M = 1
    without a mesh: its ``n_vote_replicas`` is 1), key for key, shape for
    shape, dtype for dtype; the voter axis is M. The one difference: at
    beta = 0 ef_sign's residual is leaf-shaped in the reference (each
    device holds its own voter's) and (M, *leaf) in the port. Mode B at
    beta = 0 keeps no momentum, as the reference's trainer."""
    j, t = _glm_cfgs()
    jt, tt = _train_cfgs(**LAYOUTS[case])
    _, jstate = jTS.abstract_state(j, jt, jTS.make_train_step(j, jt,
                                                              mesh=None))
    art = tTS.make_train_step(t, tt, m, device="cpu")
    _, state = tTS.materialize_state(t, tt, art,
                                     torch.Generator().manual_seed(0))
    assert sorted(state) == sorted(jstate)
    assert state["count"] == 0
    beta0_ef = case == "beta0_ef"
    for key, tree in jstate.items():
        if key == "count":
            continue
        for k, s in tree.items():
            got = state[key][k]
            shape = tuple(s.shape)
            if key == "momentum" and tt.optimizer.momentum_mode.value \
                    == "per_worker" or key == "error" and not beta0_ef:
                shape = (m,) + shape[1:]
            elif key == "error":
                shape = (m,) + shape
            elif key == "flip_ema":
                shape = (m,)
            if key == "codec":
                shape = (m,)
            assert tuple(got.shape) == shape, (key, k)
            assert str(got.dtype).replace("torch.", "") == str(s.dtype), k
            assert not got.any()


def test_ef_sign_with_mode_b_raises_as_the_reference():
    for strategy in (A, H):
        jo, to = _opts(momentum_mode="global", vote_strategy=strategy,
                       codec="ef_sign")
        with pytest.raises(ValueError, match="per_worker") as want:
            build_optimizer(jo, ())
        with pytest.raises(ValueError, match="per_worker") as got:
            tsignum.make_sign_optimizer(to, 4)
        assert str(got.value) == str(want.value)
    # under a plan whose map sends a leaf to ef_sign
    jo, to = _opts(momentum_mode="global", vote_strategy=A, bucket_bytes=64,
                   codec_map=(("embed*", "ef_sign"),))
    tplan = tvp.build_plan(SHAPES, bucket_bytes=64,
                           codec_map=to.codec_map, strategy=to.vote_strategy,
                           data_size=4)
    with pytest.raises(ValueError, match="per_worker"):
        tsignum.make_sign_optimizer(to, 4, tplan)


def test_delayed_vote_with_mode_b_raises_as_the_reference():
    for pkg, mode in ((JOpt, JMode), (tbase.OptimizerConfig,
                                      tbase.MomentumMode)):
        with pytest.raises(ValueError, match="per_worker"):
            pkg(kind="signsgd_vote", momentum_mode=mode.GLOBAL,
                delayed_vote=True)


@pytest.mark.parametrize("change,item", [
    # the preset's fsdp (the fused ZeRO backward) and remat="dots" run
    # since the thirteenth slice
    ({"fsdp": True}, None),
    ({"remat": "dots"}, None),
    # the vote diagnostics run since the multi-process wire's slice
    ({"diagnostics": True}, None),
    # the reference's tree-form vote refuses an adaptive mode when the step
    # runs: ValueError, at any M
    ({"byzantine": tbase.ByzantineConfig(mode="adaptive_flip",
                                         num_adversaries=1)},
     "'tree' form has no such observation channel"),
    ({"optimizer": {"vote_strategy": tbase.VoteStrategy.AUTO}},
     "Queue 1 item 15"),
], ids=["fsdp", "remat_dots", "diagnostics", "byzantine", "auto_m4"])
def test_mode_b_preset_still_refuses(change, item):
    """What the trainer still refuses around the qwen1.5-32b Mode B preset
    at M = 4, each naming its ROADMAP.md item, or, for an adaptive
    adversary, the reference's ValueError from the step; what it runs
    (item None) builds, and fsdp and remat="dots" train a finite step
    (fsdp with the layers' matrices fused)."""
    _, tcfg = _qwen_preset_cfgs()
    opt = change.pop("optimizer", None)
    if opt:
        change["optimizer"] = dataclasses.replace(tcfg.optimizer, **opt)
    tcfg = dataclasses.replace(tcfg, **change)
    cfg = _qwen_cfgs()[1]
    if item is None:
        art = tTS.make_train_step(cfg, tcfg, M4, device="cpu")
        assert bool(art.fused_leaves) == tcfg.fsdp
        if "diagnostics" in change:
            return
        params, state = tTS.materialize_state(
            cfg, tcfg, art, torch.Generator().manual_seed(0))
        _, _, met = art.step_fn(params, state, {"tokens": torch.zeros(
            (GB, SEQ), dtype=torch.int64)}, 0)
        assert np.isfinite(float(met["loss"]))
        return
    if "byzantine" in change:
        art = tTS.make_train_step(cfg, tcfg, M4, device="cpu")
        params, state = tTS.materialize_state(
            cfg, tcfg, art, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match=item):
            art.step_fn(params, state, {"tokens": torch.zeros(
                (GB, SEQ), dtype=torch.int64)}, 0)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tTS.make_train_step(cfg, tcfg, M4, device="cpu")


def test_mode_b_preset_loss_dtype_is_ignored(ref_qwen):
    """``loss_dtype="bfloat16"`` (declared by the reference, read nowhere)
    on the qwen1.5-32b Mode B preset at M = 1: the port's step is bit-equal
    to its "float32" step, and it equals the reference's step (whose
    "bfloat16" run is bit-equal to its "float32" one,
    test_torch_train_step.py::test_loss_dtype_is_ignored_as_the_reference)
    as test_m1_qwen_mode_b_preset_matches_reference holds it."""
    jt, tt = _qwen_preset_cfgs()
    jt16 = dataclasses.replace(jt, loss_dtype="bfloat16")
    tt16 = dataclasses.replace(tt, loss_dtype="bfloat16")
    states, _, batches = ref_qwen
    got = [_port_trainer_step(_qwen_cfgs()[1], t, 1, states[2], batches[2],
                              2) for t in (tt16, tt)]
    assert got[0]["loss"] == got[1]["loss"]
    for part in ("params", "momentum"):
        for k, v in got[0][part].items():
            assert np.array_equal(v, got[1][part][k], equal_nan=True)
    _m1_case(ref_qwen, _qwen_cfgs(), jt16, tt16, 2, port=got[0])
