"""The port's Algorithm 1 train step against the JAX package, in float32
on the CPU (reduced glm4-9b, global batch 8, seq 64, lr 1e-3, beta 0.9,
allgather_1bit), with each gradient codec: sign1bit (5 steps),
ternary2bit, ef_sign and weighted_vote (3 steps each).

(a) M = 1 against the reference trainer itself
    (``repro.train.train_step.make_train_step(cfg, tcfg, mesh=None)``).
    It votes ``sign_ternary`` of its vote input with no wire, for every
    codec: an exactly-zero input (an embedding row whose token is absent
    from the batch) abstains and its parameter stays. The port's
    ternary2bit wire abstains there too, so it must agree exactly; the
    port's 1-bit wire (sign1bit, ef_sign, weighted_vote) votes +1 and
    moves the parameter by -lr, which is asserted exactly (ROADMAP.md
    Queue 3).
(b) M = 4 against a step composed here from JAX functions only: per-voter
    ``jax.value_and_grad(repro.models.model.loss_fn)`` on
    ``replica_batch`` rows, then per leaf the JAX package's own oracles
    (``repro.kernels.ref.momentum_sign_pack`` / ``majority`` /
    ``apply_vote`` / ``ternary_pack`` / ``ternary_majority``), its codecs'
    ``encode_leaf`` / ``feedback_leaf`` (ef_sign) and
    ``reliability_weights`` / ``decode_leaf_fixed`` with one EMA update
    per step over all leaves (weighted_vote, as ``vote_api._tree_
    execute``), and its update rule; the votes (and weighted_vote's new
    state) cross-checked against ``VirtualBackend().execute(VoteRequest(
    form="stacked", codec=...))`` over the concatenated leaves.
(c) Options the port does not run yet raise.

Criteria, (a) and (b) alike. Teacher-forced (both packages take one step
from identical params, momentum and codec state): the loss within rtol
1e-5, the momentum within rtol 1e-5 and atol 1e-7 (m' carries (1-beta) =
0.1 of the gradient, whose two float32 versions tests/test_torch_model.py
holds to atol 1e-6: they are summed in other orders, and tiny entries
differ in relative terms far more than rtol); each package's vote, on every
coordinate, the decision of its own vote inputs; the two votes and the
updated params equal wherever those decisions agree. They may disagree
only where rounding gave a voter another sign, on at most 0.1% of the
coordinates; on the 1-bit wire the coordinates whose vote a voter with
0 < |input| <= 1e-7 could change stay below 0.1% too (see
`_check_votes`). ef_sign's residual e' = t - mean|t| * vote within rtol 1e-5
and atol 1e-7 + 2e-5 * mean|t| on those coordinates (t carries the
momentum's tolerance, rtol 1e-5 and atol 1e-7; mean|t|, a float32 sum in
another order, is within rtol 1e-5 with it); weighted_vote's
flip-rate state within RHO * (its voter's rounding-decided coordinates +
the left-out ones) / n plus two float32 ulps, and equal where that count
is 0. Free-running from the
same init, the per-step losses agree within rtol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import (MomentumMode, OptimizerConfig,  # noqa: E402
                                TrainConfig, VoteStrategy, get_config,
                                reduced_config)
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.core import vote_api as va  # noqa: E402
from repro.core.codecs import weighted as jwv  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import sign_compress as tsc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

GB, SEQ, LR, BETA = 8, 64, 1e-3, 0.9
STEPS = 5
#: steps of each codec's runs
CODEC_STEPS = 3
CODECS = ("ternary2bit", "ef_sign", "weighted_vote")
#: m' tolerance's atol. Above it the asserted momentum bound fixes the
#: sign, so the votes are compared on every coordinate with |m'| > 1e-7
#: (a superset of the |m'| > 1e-6 coordinates)
NEAR_ZERO = 1e-7
MAX_EXCLUDED = 1e-3


def _jcfgs(codec="sign1bit"):
    cfg = dataclasses.replace(reduced_config(get_config("glm4-9b")),
                              dtype="float32")
    tcfg = TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=OptimizerConfig(
        kind="signum_vote", learning_rate=LR, momentum=BETA,
        vote_strategy=VoteStrategy.ALLGATHER_1BIT, codec=codec))
    return cfg, tcfg


def _tcfgs(**opt):
    cfg = dataclasses.replace(
        tbase.reduced_config(tbase.get_config("glm4-9b")), dtype="float32")
    tcfg = tbase.TrainConfig(global_batch=GB, seq_len=SEQ,
                             optimizer=tbase.OptimizerConfig(
                                 kind="signum_vote", learning_rate=LR,
                                 momentum=BETA,
                                 vote_strategy=tbase.VoteStrategy.ALLGATHER_1BIT,
                                 **opt))
    return cfg, tcfg


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _snapshot(params, opt):
    """A reference state as numpy: params, momentum and the codec's state
    ("error" (M, ...) for ef_sign, "ema" (M,) for weighted_vote)."""
    state = {"params": _np(params), "momentum": _np(opt["momentum"])}
    if "error" in opt:
        state["error"] = _np(opt["error"])
    if "codec" in opt:
        state["ema"] = np.array(opt["codec"]["flip_ema"])
    return state


def _port_state(state):
    """A numpy state (see `_snapshot`) -> the port's (params, opt_state)
    on the CPU."""
    opt = {"count": 0,
           "momentum": tM.params_from_numpy(state["momentum"], device="cpu")}
    if "error" in state:
        opt["error"] = tM.params_from_numpy(state["error"], device="cpu")
    if "ema" in state:
        opt["codec"] = {"flip_ema": torch.from_numpy(state["ema"].copy())}
    return tM.params_from_numpy(state["params"], device="cpu"), opt


def _port_step(n_voters, state, tokens, step, codec="sign1bit", tcfg=None):
    """One port step from the numpy `state`; the new state with "loss"
    (momentum and residual as float32)."""
    cfg, own = _tcfgs(codec=codec)
    art = tTS.make_train_step(cfg, tcfg or own, n_voters, device="cpu")
    assert art.codec == codec
    tp, ts = _port_state(state)
    tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
    out = {"loss": float(met["loss"]),
           "params": {k: v.numpy() for k, v in tp.items()},
           "momentum": {k: v.float().numpy()
                        for k, v in ts["momentum"].items()}}
    if "error" in ts:
        out["error"] = {k: v.float().numpy() for k, v in ts["error"].items()}
    if "codec" in ts:
        out["ema"] = ts["codec"]["flip_ema"].numpy()
    return out


def _free_running_losses(n_voters, state, batches, codec="sign1bit",
                         tcfg=None):
    cfg, own = _tcfgs(codec=codec)
    art = tTS.make_train_step(cfg, tcfg or own, n_voters, device="cpu")
    tp, ts = _port_state(state)
    assert all(v.shape[0] == n_voters for v in ts["momentum"].values())
    got = []
    for step, tokens in enumerate(batches):
        tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
        got.append(float(met["loss"]))
    assert ts["count"] == len(batches)
    return got


def _vote_inputs(state, new, codec):
    """What each voter's signs are taken of, per leaf, (M, ...): the new
    momentum, or for ef_sign t = e + m' (the float32 add both packages
    make)."""
    if codec != "ef_sign":
        return new["momentum"]
    return {k: state["error"][k] + m for k, m in new["momentum"].items()}


def _symbols(inputs, zero_votes_plus):
    """Each voter's symbol: the sign of its input; an input of 0 (or -0.0)
    votes +1 on the 1-bit wire (`zero_votes_plus`) and abstains on the
    2-bit wire and in the reference's ``sign_ternary``."""
    return np.where(inputs > 0, 1.0, np.where(inputs < 0, -1.0,
                                              float(zero_votes_plus)))


def _decide(sym, binary, w):
    """The vote of each coordinate from the voters' symbols (M, ...) and
    decode weights `w` (exact multiples of 1/256, so the sums are exact):
    on the 1-bit wire (`binary`) a (weighted) sum >= 0 votes +1, otherwise
    the vote is the sign of the sum."""
    total = (w.reshape((-1,) + (1,) * (sym.ndim - 1)) * sym).sum(axis=0)
    return np.where(total >= 0, 1, -1) if binary else np.sign(total)


def _check_votes(p0, ref, port, rin, pin, *, binary, ref_abstains_on_zero,
                 weights=None):
    """The votes and updated params of one teacher-forced step, leaf by
    leaf; returns (excluded, total, zeros, symbol disagreements per voter,
    agree masks).

    Each package's applied vote must be, on every coordinate, the decision
    its own vote inputs `rin` / `pin` (M, ...) give. The two decisions
    differ only where rounding gave some voter another symbol (those
    coordinates are counted, and may not exceed MAX_EXCLUDED; on the 1-bit
    wire neither may the coordinates whose vote some voter with 0 <
    |input| <= NEAR_ZERO could change), or where
    the reference votes 0 on an input that is exactly 0 and the port's
    1-bit wire votes +1 (the reference's single-process M = 1 step,
    `ref_abstains_on_zero`): there the reference leaves the parameter
    still and the port moves it by -lr, asserted exactly. Elsewhere the
    updated params are equal."""
    excluded = total = zeros = undecided = 0
    flips, agree = 0, {}
    for k in ref["params"]:
        r, q = rin[k], pin[k]
        w = (np.ones(r.shape[0]) if weights is None
             else np.asarray(weights, np.float64))
        if binary:   # votes a near-zero voter could change either way
            zero = (r == 0) & (q == 0)
            amb = (np.abs(r) <= NEAR_ZERO) & ~zero
            sure = _symbols(np.where(amb, 0.0, r), True) * ~amb
            wb = w.reshape((-1,) + (1,) * (r.ndim - 1))
            base = (wb * sure).sum(axis=0)
            spread = (np.abs(wb) * amb).sum(axis=0)
            undecided += int((~((base - spread >= 0)
                                | (base + spread < 0))).sum())
        rsym = _symbols(r, binary and not ref_abstains_on_zero)
        psym = _symbols(q, binary)
        pvote = _decide(psym, binary, w)
        rvote = _decide(rsym, binary and not ref_abstains_on_zero, w)
        # wd = 0: the applied vote is the sign of the parameter's move
        v = np.sign(p0[k] - port["params"][k])
        rv = np.sign(p0[k] - ref["params"][k])
        np.testing.assert_array_equal(v, pvote, err_msg=k)
        np.testing.assert_array_equal(rv, rvote, err_msg=k)
        if binary:
            assert (np.abs(v) == 1).all(), k
        # every voter exactly 0 in both: the two zero rules differ there
        held = (pvote != rvote) & ((r == 0) & (q == 0)).all(axis=0)
        np.testing.assert_array_equal(ref["params"][k][held], p0[k][held])
        np.testing.assert_array_equal(
            port["params"][k][held], p0[k][held] - np.float32(LR), err_msg=k)
        zeros += int(held.sum())
        differ = (pvote != rvote) & ~held
        excluded += int(differ.sum())
        total += differ.size
        # a rounding-decided symbol: the inputs' signs differ
        flips = flips + (np.sign(r) != np.sign(q)).reshape(
            r.shape[0], -1).sum(axis=1)
        np.testing.assert_array_equal(port["params"][k][~differ & ~held],
                                      ref["params"][k][~differ & ~held],
                                      err_msg=k)
        agree[k] = ~differ
    print(f"{excluded} of {total} coordinates voted otherwise because "
          f"rounding gave some voter another sign ({excluded / total:.4%}; "
          f"symbols that differ, per voter: {np.asarray(flips).tolist()}); "
          f"{zeros} exact-zero coordinates held still by the reference, "
          f"moved -lr by the port's 1-bit wire; {undecided} coordinates "
          f"whose vote rests on some 0 < |input| <= {NEAR_ZERO}")
    assert excluded <= MAX_EXCLUDED * total
    assert undecided <= MAX_EXCLUDED * total
    return excluded, total, zeros, flips, agree


def _check_teacher_forced(state, ref, port, *, codec="sign1bit",
                          ref_abstains_on_zero=False, count_wire=False,
                          bf16_rounded=False):
    """ref/port: the new states (with "loss") after one step from the
    same numpy `state`; see the module doc for the criteria. `count_wire`:
    the step voted on psum_int8 (ternary symbols, ties and abstentions
    0). `bf16_rounded`: the gradient or the momentum went through bf16, so
    the momentum is held as section (d) says."""
    p0 = state["params"]
    ref = {**ref, "momentum": {k: np.asarray(v, np.float32)
                               for k, v in ref["momentum"].items()}}
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    outside = total = 0
    for k in p0:
        if not bf16_rounded:
            np.testing.assert_allclose(port["momentum"][k],
                                       ref["momentum"][k], rtol=1e-5,
                                       atol=NEAR_ZERO, err_msg=k)
            continue
        far = ~np.isclose(port["momentum"][k], ref["momentum"][k],
                          rtol=BF16_RTOL, atol=NEAR_ZERO)
        outside += int(far.sum())
        total += far.size
    assert outside <= MAX_EXCLUDED * total, (outside, total)
    weights = None
    if codec == "weighted_vote":
        weights = np.asarray(jwv.reliability_weights(
            jnp.asarray(state["ema"])))
    rin, pin = _vote_inputs(state, ref, codec), _vote_inputs(state, port,
                                                              codec)
    two_bit = count_wire or codec == "ternary2bit"
    excluded, total, zeros, flips, agree = _check_votes(
        p0, ref, port, rin, pin, binary=not two_bit,
        ref_abstains_on_zero=ref_abstains_on_zero, weights=weights)
    if two_bit:
        assert zeros == 0
        # untouched embedding rows abstain in both and stay still; on the
        # count wire a rounding-decided coordinate may also be a 0 vote in
        # one package only
        still = sum(int((ref["params"][k] == p0[k]).sum()) for k in p0)
        moved = still - sum(int((port["params"][k] == p0[k]).sum())
                            for k in p0)
        assert abs(moved) <= (excluded if count_wire else 0)
        if ref_abstains_on_zero or count_wire:
            assert still > 0
    if codec == "ef_sign":
        for k in p0:
            for r in range(rin[k].shape[0]):
                scale = float(np.mean(np.abs(rin[k][r]), dtype=np.float64))
                keep = agree[k] & (np.sign(rin[k][r]) == np.sign(pin[k][r]))
                zero = (rin[k][r] == 0) & (pin[k][r] == 0) & keep
                if ref_abstains_on_zero:
                    # reference: 0 - scale * 0; port: 0 - scale * (+1)
                    np.testing.assert_array_equal(
                        ref["error"][k][r][zero], 0.0)
                    np.testing.assert_allclose(
                        port["error"][k][r][zero], -scale, rtol=1e-5)
                    keep = keep & ~zero
                np.testing.assert_allclose(
                    port["error"][k][r][keep], ref["error"][k][r][keep],
                    rtol=1e-5, atol=NEAR_ZERO + 2e-5 * scale, err_msg=k)
    if codec == "weighted_vote":
        n_total = sum(v.size for v in p0.values())
        # each changed count moves the state by RHO / n; the float32 sums
        # round on top of that (two ulps)
        moved = jwv.RHO * (flips + excluded) / n_total
        diff = np.abs(port["ema"].astype(np.float64) - ref["ema"])
        bound = moved + 2 * np.spacing(ref["ema"])
        assert (diff <= bound).all(), (diff, bound)
        np.testing.assert_array_equal(port["ema"][moved == 0],
                                      ref["ema"][moved == 0])


# ---------------------------------------------------------------------------
# (a) M = 1 against the reference trainer
# ---------------------------------------------------------------------------


def _reference_trainer_run(codec, steps, tcfg=None):
    """The reference trainer's states and losses over `steps` steps."""
    cfg, own = _jcfgs(codec)
    tcfg = tcfg or own
    art = jTS.make_train_step(cfg, tcfg, mesh=None)
    params, opt = jTS.materialize_state(cfg, tcfg, art, jax.random.PRNGKey(0))
    pipe = SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
    states, losses, batches = [], [], []
    for step in range(steps):
        tokens = pipe.global_batch_at(step)["tokens"]
        states.append(_snapshot(params, opt))
        params, opt, met = art.step_fn(params, opt,
                                       {"tokens": jnp.asarray(tokens)},
                                       jnp.int32(step))
        losses.append(float(met["loss"]))
        batches.append(tokens)
    states.append(_snapshot(params, opt))
    return states, losses, batches


@pytest.fixture(scope="module")
def ref_m1():
    return _reference_trainer_run("sign1bit", STEPS)


@pytest.fixture(scope="module", params=CODECS)
def ref_m1_codec(request):
    return request.param, _reference_trainer_run(request.param, CODEC_STEPS)


def test_m1_step0_loss_is_the_reference_value(ref_m1):
    _, losses, batches = ref_m1
    assert losses[0] == pytest.approx(6.4072, abs=1e-4)
    assert batches[0].shape == (GB, SEQ)


@pytest.mark.parametrize("step", [0, 2])
def test_m1_teacher_forced_step_matches_reference(ref_m1, step):
    states, losses, batches = ref_m1
    port = _port_step(1, states[step], batches[step], step)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, ref_abstains_on_zero=True)


def test_m1_free_running_losses_match_reference(ref_m1):
    states, losses, batches = ref_m1
    got = _free_running_losses(1, states[0], batches)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


@pytest.mark.parametrize("step", [0, 2])
def test_m1_codec_teacher_forced_step_matches_reference(ref_m1_codec, step):
    """Each codec at M = 1 against the reference trainer: ternary2bit
    agrees on every coordinate, untouched embedding rows included (both
    abstain); ef_sign and weighted_vote differ exactly where the vote
    input is exactly 0 (see the module doc)."""
    codec, (states, losses, batches) = ref_m1_codec
    port = _port_step(1, states[step], batches[step], step, codec)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, codec=codec,
                          ref_abstains_on_zero=True)
    if codec == "weighted_vote":   # one voter always agrees with itself
        assert port["ema"].tolist() == ref["ema"].tolist() == [0.0]


def test_m1_codec_free_running_losses_match_reference(ref_m1_codec):
    codec, (states, losses, batches) = ref_m1_codec
    got = _free_running_losses(1, states[0], batches, codec)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


# ---------------------------------------------------------------------------
# (b) M = 4 against a step composed from JAX functions
# ---------------------------------------------------------------------------

M4 = 4


def _pad(x, multiple=32):
    flat = x.reshape(-1)
    return jnp.pad(flat, (0, (-flat.shape[0]) % multiple))[None]


def _composed_run(codec, steps):
    """`steps` M = 4 steps composed from the JAX package's functions (see
    the module doc); returns (states, losses, batches)."""
    cfg, tcfg = _jcfgs(codec)
    c = jcodecs.get_codec(codec)
    params = jM.init_params(cfg, jax.random.PRNGKey(0))
    opt = {"momentum": {k: jnp.zeros((M4,) + v.shape, jnp.float32)
                        for k, v in params.items()}}
    if c.worker_state:
        opt["error"] = dict(opt["momentum"])
    if c.server_state:
        opt["codec"] = c.init_server_state(M4)
    n_total = sum(v.size for v in params.values())
    pipe = SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t: jM.loss_fn(cfg, p, {"tokens": t}), has_aux=True))
    msp = jax.jit(jref.momentum_sign_pack, static_argnums=2)
    bitpack = jax.jit(jref.bitpack)
    majority = jax.jit(jref.majority)
    apply = jax.jit(jref.apply_vote, static_argnums=(2, 3))
    unpack = jax.jit(jref.bitunpack, static_argnums=1)
    tpack = jax.jit(jref.ternary_pack)
    tmajority = jax.jit(jref.ternary_majority)
    encode = jax.jit(c.encode_leaf)
    feedback = jax.jit(c.feedback_leaf)
    decode = jax.jit(jwv.decode_leaf_fixed)
    # as in the reference's jitted step, n_total is a constant there
    ema_update = jax.jit(lambda e, mis: (1.0 - jwv.RHO) * e
                         + jwv.RHO * mis / n_total)

    @jax.jit
    def apply_ternary(p, v):
        # the reference's update rule (core/signum.py:232-238), wd = 0
        p32 = p.astype(jnp.float32)
        return (p32 - LR * (v.astype(jnp.float32) + 0.0 * p32)).astype(
            p.dtype)

    states, losses, batches = [], [], []
    for step in range(steps):
        states.append(_snapshot(params, opt))
        batches.append(pipe.global_batch_at(step)["tokens"])
        step_losses, new_m = [], {k: [] for k in params}
        for r in range(M4):
            rows = pipe.replica_batch(step, r, M4)["tokens"]
            (loss, _), grads = grad_fn(params, jnp.asarray(rows))
            step_losses.append(float(loss))
            for k, g in grads.items():
                m_r, _ = msp(_pad(g), _pad(opt["momentum"][k][r]), BETA)
                new_m[k].append(m_r[0, :g.size].reshape(g.shape))
        if c.server_state:
            w = jwv.reliability_weights(opt["codec"]["flip_ema"])
            mismatch = jnp.zeros((M4,), jnp.float32)
        new_params, new_err, flat_votes, flat_inputs = {}, {}, [], []
        for k, p in params.items():
            n = p.size
            inputs = new_m[k]
            if c.worker_state:
                inputs = [encode(m, e) for m, e in zip(inputs,
                                                       opt["error"][k])]
            flat_inputs.append(jnp.stack([x.reshape(-1) for x in inputs]))
            if codec == "ternary2bit":
                words = jnp.stack([tpack(_pad(jsc.sign_ternary(x), 16))[0]
                                   for x in inputs])
                v = jsc.unpack_ternary(tmajority(words))[:n]
                new_params[k] = apply_ternary(p, v.reshape(p.shape))
                flat_votes.append(v)
                continue
            words = jnp.stack([bitpack(_pad(x))[0] for x in inputs])
            if c.server_state:
                stacked = jsc.unpack_signs(words)[:, :n]
                vote, mis = decode(stacked, w)
                mismatch = mismatch + mis
                votes = jsc.pack_signs(_pad(vote)[0])
            else:
                votes = majority(words)
            vote = np.asarray(unpack(votes[None], jnp.int8))[0, :n]
            flat_votes.append(vote)
            new_params[k] = apply(_pad(p), votes[None], LR,
                                  0.0)[0, :n].reshape(p.shape)
            if c.worker_state:
                new_err[k] = jnp.stack([
                    feedback(t, jnp.asarray(vote).reshape(p.shape), e)
                    for t, e in zip(inputs, opt["error"][k])])
        # the vote API over every leaf at once: the same votes (and, for
        # weighted_vote, the same one EMA update over all coordinates)
        cross = va.VirtualBackend().execute(va.VoteRequest(
            payload=jnp.concatenate(flat_inputs, axis=1), form="stacked",
            strategy=VoteStrategy.ALLGATHER_1BIT, codec=codec,
            server_state=opt.get("codec")))
        np.testing.assert_array_equal(np.concatenate(flat_votes),
                                      np.asarray(cross.votes))
        params = new_params
        opt = {**opt, "momentum": {k: jnp.stack(v) for k, v in new_m.items()}}
        if c.worker_state:
            opt["error"] = new_err
        if c.server_state:
            opt["codec"] = {"flip_ema": ema_update(opt["codec"]["flip_ema"],
                                                   mismatch)}
            np.testing.assert_array_equal(
                np.asarray(opt["codec"]["flip_ema"]),
                np.asarray(cross.server_state["flip_ema"]))
        losses.append(float(np.mean(step_losses)))
    states.append(_snapshot(params, opt))
    return states, losses, batches


@pytest.fixture(scope="module")
def ref_m4():
    return _composed_run("sign1bit", STEPS)


@pytest.fixture(scope="module", params=CODECS)
def ref_m4_codec(request):
    return request.param, _composed_run(request.param, CODEC_STEPS)


@pytest.mark.parametrize("step", [0, 2])
def test_m4_teacher_forced_step_matches_composed_reference(ref_m4, step):
    states, losses, batches = ref_m4
    port = _port_step(M4, states[step], batches[step], step)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port)


def test_m4_free_running_losses_match_composed_reference(ref_m4):
    states, losses, batches = ref_m4
    got = _free_running_losses(M4, states[0], batches)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


@pytest.mark.parametrize("step", [0, 2])
def test_m4_codec_teacher_forced_step_matches_composed_reference(
        ref_m4_codec, step):
    codec, (states, losses, batches) = ref_m4_codec
    port = _port_step(M4, states[step], batches[step], step, codec)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, codec=codec)


def test_m4_codec_free_running_losses_match_composed_reference(ref_m4_codec):
    codec, (states, losses, batches) = ref_m4_codec
    got = _free_running_losses(M4, states[0], batches, codec)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


_NO_LAUNCHES = {"momentum_sign_pack": 0, "majority": 0, "apply_vote": 0,
                "bitpack": 0, "bitunpack": 0, "fused_majority": 0,
                "ternary_pack": 0, "ternary_majority": 0,
                "ternary_majority_plus_one": 0, "ternary_unpack": 0,
                "apply_ternary_vote": 0, "adversary": 0}


def test_step_updates_state_in_place_without_kernel_launches():
    cfg, tcfg = _tcfgs()
    art = tTS.make_train_step(cfg, tcfg, 2, device="cpu")
    params, state = tTS.materialize_state(
        cfg, tcfg, art, torch.Generator().manual_seed(0))
    assert state["momentum"]["embed.table"].shape == (2, 512, 128)
    ptrs = {k: v.data_ptr() for k, v in params.items()}
    mptrs = {k: v.data_ptr() for k, v in state["momentum"].items()}
    before = {k: v.clone() for k, v in params.items()}
    tokens = SyntheticLMPipeline(_jcfgs()[0], GB, SEQ).global_batch_at(0)
    tops.reset_launch_counts()
    new_p, new_s, met = art.step_fn(params, state, tokens, 0)
    assert new_p is params and new_s is state
    assert {k: v.data_ptr() for k, v in params.items()} == ptrs
    assert {k: v.data_ptr() for k, v in state["momentum"].items()} == mptrs
    assert np.isfinite(float(met["loss"]))
    # every coordinate moved by +-lr (weight decay 0)
    for k, p in params.items():
        moved = (before[k] - p).abs()
        assert torch.allclose(moved, torch.full_like(moved, LR), rtol=1e-2)
    assert tops.launch_counts() == _NO_LAUNCHES
    words = tsc.words_for(params["embed.table"].numel())
    assert words == 512 * 128 // 32


@pytest.mark.parametrize("codec", CODECS)
def test_codec_state_layout_and_in_place(codec):
    """materialize_state lays the codec's state out as the reference's
    abstract_state does (with the leading voter axis): ef_sign's residual
    shaped like the momentum, weighted_vote's (M,) flip_ema; a step updates
    every piece in place and launches no kernel on the CPU."""
    cfg, tcfg = _tcfgs(codec=codec)
    art = tTS.make_train_step(cfg, tcfg, 2, device="cpu")
    assert art.codec == codec
    params, state = tTS.materialize_state(
        cfg, tcfg, art, torch.Generator().manual_seed(0))
    jcfg, jtcfg = _jcfgs(codec)
    _, jstate = jTS.abstract_state(jcfg, jtcfg, jTS.make_train_step(
        jcfg, jtcfg, mesh=None))
    assert sorted(state) == sorted(jstate)
    if "error" in state:
        for k, e in state["error"].items():
            assert e.shape == state["momentum"][k].shape
            assert e.shape[1:] == jstate["error"][k].shape[1:]
            assert not e.any()
    if "codec" in state:
        assert state["codec"]["flip_ema"].dtype == torch.float32
        assert state["codec"]["flip_ema"].tolist() == [0.0, 0.0]
    ptrs = {(part, k): v.data_ptr() for part in ("momentum", "error")
            for k, v in state.get(part, {}).items()}
    ema = state.get("codec", {}).get("flip_ema")
    tokens = SyntheticLMPipeline(jcfg, GB, SEQ).global_batch_at(0)
    tops.reset_launch_counts()
    for step in range(2):
        _, state, met = art.step_fn(params, state, tokens, step)
        assert np.isfinite(float(met["loss"]))
    assert state["count"] == 2
    assert {(part, k): v.data_ptr() for part in ("momentum", "error")
            for k, v in state.get(part, {}).items()} == ptrs
    if ema is not None:
        assert state["codec"]["flip_ema"] is ema
    if "error" in state:
        assert any(e.any() for e in state["error"].values())
    assert tops.launch_counts() == _NO_LAUNCHES


# ---------------------------------------------------------------------------
# (c) what the port does not run yet
# ---------------------------------------------------------------------------


#: TrainConfig fields among the cases below (the rest are the optimizer's)
_TRAIN_FIELDS = ("fsdp", "byzantine", "remat", "diagnostics", "loss_dtype")


@pytest.mark.parametrize("opt", [
    # leaf-wise hierarchical runs (since the ninth slice); the fused ZeRO
    # backward's vote does not (Queue 4 item 4)
    {"vote_strategy": tbase.VoteStrategy.HIERARCHICAL, "fsdp": True},
    # Mode B runs; its presets' fsdp does not
    {"momentum_mode": tbase.MomentumMode.GLOBAL, "fsdp": True},
    # the priced AUTO ladder of bucket sizes (Queue 1 item 15)
    {"bucket_bytes": -1},
    # beta = 0 runs with an adversary; an adaptive one does not (Queue 1
    # item 10)
    {"momentum": 0.0, "byzantine": tbase.ByzantineConfig(
        mode="low_margin", num_adversaries=1)},
    {"bucket_bytes": -1, "overlap": True},
    # signsgd_vote runs; remat="dots" does not (Queue 4 item 4)
    {"kind": "signsgd_vote", "remat": "dots"},
])
def test_unported_options_raise(opt):
    cfg, tcfg = _tcfgs()
    train = {k: v for k, v in opt.items() if k in _TRAIN_FIELDS}
    opt = {k: v for k, v in opt.items() if k not in _TRAIN_FIELDS}
    tcfg = dataclasses.replace(
        tcfg, optimizer=dataclasses.replace(tcfg.optimizer, **opt), **train)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tTS.make_train_step(cfg, tcfg, 1, device="cpu")


def test_default_strategy_is_psum_int8_and_raises():
    """OptimizerConfig's default strategy is PSUM_INT8, which the trainer
    runs (on its 2-bit count wire); AUTO resolves to it at M = 1, as in the
    reference, and raises over more voters (no H100 link model to price
    the wires: ROADMAP.md Queue 1 item 15)."""
    cfg, _ = _tcfgs()
    tcfg = tbase.TrainConfig(global_batch=GB, seq_len=SEQ)
    assert tcfg.optimizer.vote_strategy == tbase.VoteStrategy.PSUM_INT8
    for m in (1, 4):
        art = tTS.make_train_step(cfg, tcfg, m, device="cpu")
        assert art.vote_strategy == tbase.VoteStrategy.PSUM_INT8
    auto = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, vote_strategy=tbase.VoteStrategy.AUTO))
    art = tTS.make_train_step(cfg, auto, 1, device="cpu")
    assert art.vote_strategy == tbase.VoteStrategy.PSUM_INT8
    with pytest.raises(NotImplementedError, match="item 15"):
        tTS.make_train_step(cfg, auto, 4, device="cpu")


def test_make_train_step_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, tcfg = _tcfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tTS.make_train_step(cfg, tcfg, 1)


def test_batch_must_split_over_voters():
    cfg, tcfg = _tcfgs()
    with pytest.raises(ValueError, match="split evenly"):
        tTS.make_train_step(cfg, tcfg, 3, device="cpu")
    assert MomentumMode.PER_WORKER.value == tbase.MomentumMode.PER_WORKER.value


# ---------------------------------------------------------------------------
# (d) the glm4-9b preset's trainer options: psum_int8 (the count wire),
#     microbatches, remat and bf16 momentum
# ---------------------------------------------------------------------------
#
# psum_int8 votes the sign of the voters' ternary symbols (ties and
# abstentions 0); the port carries it on its 2-bit wire. The criteria are
# those of the module doc with the count wire's zero rule, as for
# ternary2bit, but for the momentum when microbatches or bf16 momentum
# round it through bf16 (the accumulator is bf16, as the reference's):
# there the two packages round float32 values that differ as the module
# doc says, so m' is held within rtol 2^-7 (two bf16 ulps) and atol 1e-7
# on all but at most 0.1 % of the coordinates. Those are where the
# microbatches' gradients nearly cancel: one bf16 ulp of each is then a
# large share of their sum.

MICRO = [2, 4]
BF16_RTOL = 2.0 ** -7


def _count_cfgs(micro, global_batch=GB):
    """The reference's and the port's train configs on psum_int8 with
    `micro` microbatches (lr 1e-3, beta 0.9, float32 momentum, sign1bit,
    seq 64)."""
    out = []
    for tcfg in (_jcfgs()[1], _tcfgs()[1]):
        strat = type(tcfg.optimizer.vote_strategy).PSUM_INT8
        out.append(dataclasses.replace(
            tcfg, microbatches=micro, global_batch=global_batch,
            optimizer=dataclasses.replace(tcfg.optimizer,
                                          vote_strategy=strat)))
    return tuple(out)


def _preset_cfgs():
    """The glm4-9b preset (``default_train_config``) at the test's size:
    bf16 momentum on psum_int8, lr 1e-4, beta 0.9, full remat; 2
    microbatches (the preset's 8 do not divide a voter's 2 rows)."""
    from repro.configs import base as jbase
    from repro.configs.presets import default_train_config as jdefault
    from repro_torch.configs.presets import default_train_config as tdefault
    j = jdefault("glm4-9b", jbase.ShapeCell("test", SEQ, GB, "train"))
    t = tdefault("glm4-9b", tbase.ShapeCell("test", SEQ, GB, "train"))
    return (dataclasses.replace(j, microbatches=2),
            dataclasses.replace(t, microbatches=2))


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("micro", [2, 4, 8])
def test_microbatch_accumulator_matches_reference_scan(micro, gdtype):
    """The port's accumulator against the reference's ``acc_body`` scan
    (bf16 zeros, ``a + g.astype(a.dtype)`` per microbatch, then ``/
    microbatches``) on the same per-microbatch gradients, with planted
    -0.0, values that cancel and values past bf16's precision. Tolerance:
    none (bit-equal bf16)."""
    rng = np.random.default_rng([17, micro, len(gdtype)])
    gs = (rng.normal(size=(micro, 3, 1000)) * 10.0 ** rng.uniform(
        -6, 1, size=(micro, 3, 1000))).astype(np.float32)
    gs[:, :, ::11] = -0.0
    gs[1, :, 5::13] = -gs[0, :, 5::13]
    gs = np.asarray(jnp.asarray(gs).astype(gdtype).astype(jnp.float32))

    def body(acc, g):
        return acc + g.astype(acc.dtype), None
    want, _ = jax.lax.scan(body, jnp.zeros((3, 1000), jnp.bfloat16),
                           jnp.asarray(gs).astype(gdtype))
    want = np.asarray((want / micro).astype(jnp.float32))
    acc = None
    for i in range(micro):
        acc = tTS.accumulate_(acc, [torch.from_numpy(gs[i].copy()).to(
            getattr(torch, gdtype))])
    got = acc[0].div_(micro)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.array_equal(np.signbit(got.float().numpy()), np.signbit(want))


@pytest.fixture(scope="module", params=MICRO)
def ref_m1_micro(request):
    jt, _ = _count_cfgs(request.param)
    return request.param, _reference_trainer_run("sign1bit", 3, tcfg=jt)


@pytest.mark.parametrize("step", [0, 2])
def test_m1_microbatched_count_wire_step_matches_reference(ref_m1_micro,
                                                           step):
    """M = 1 on psum_int8 with 2 and 4 microbatches against the reference
    trainer itself: the count wire abstains where the reference's vote is
    0, so the two agree on every coordinate but rounding-decided ones."""
    micro, (states, losses, batches) = ref_m1_micro
    _, tt = _count_cfgs(micro)
    port = _port_step(1, states[step], batches[step], step, tcfg=tt)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, count_wire=True,
                          bf16_rounded=True)


def test_m1_microbatched_free_running_losses_match_reference(ref_m1_micro):
    micro, (states, losses, batches) = ref_m1_micro
    _, tt = _count_cfgs(micro)
    got = _free_running_losses(1, states[0], batches, tcfg=tt)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


def _composed_count_run(jtcfg, steps):
    """`steps` M = 4 steps of sign1bit on psum_int8 composed from the JAX
    package's functions: per voter and microbatch
    ``jax.value_and_grad(loss_fn(..., remat=))``, the gradients summed in
    bf16 and divided as the reference's ``acc_body`` scan does (in
    float32 with one microbatch), the trainer's jnp momentum update in
    ``momentum_dtype``, ``_wire_vote_signs`` on psum_int8 over a named
    axis of the 4 voters (``jax.vmap``), and the update rule."""
    cfg, _ = _jcfgs()
    micro, dt = jtcfg.microbatches, jnp.dtype(jtcfg.optimizer.momentum_dtype)
    lr, beta = jtcfg.optimizer.learning_rate, jtcfg.optimizer.momentum
    params = jM.init_params(cfg, jax.random.PRNGKey(0))
    opt = {"momentum": {k: jnp.zeros((M4,) + v.shape, dt)
                        for k, v in params.items()}}
    pipe = SyntheticLMPipeline(cfg, jtcfg.global_batch, SEQ, seed=0)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t: jM.loss_fn(cfg, p, {"tokens": t}, remat=jtcfg.remat),
        has_aux=True))
    momentum = jax.jit(lambda m, g: beta * m + (1 - beta) * g.astype(dt))
    vote = jax.jit(jax.vmap(lambda s: va._wire_vote_signs(
        s, ("data",), VoteStrategy.PSUM_INT8, "sign1bit", None)[0],
        axis_name="data"))

    @jax.jit
    def apply(p, v):
        p32 = p.astype(jnp.float32)
        return (p32 - lr * (v.astype(jnp.float32) + 0.0 * p32)).astype(
            p.dtype)

    states, losses, batches = [], [], []
    for step in range(steps):
        states.append(_snapshot(params, opt))
        batches.append(pipe.global_batch_at(step)["tokens"])
        step_losses, new_m = [], {k: [] for k in params}
        for r in range(M4):
            rows = pipe.replica_batch(step, r, M4)["tokens"]
            per = rows.shape[0] // micro
            acc, mb_losses = None, []
            for i in range(micro):
                (loss, _), g = grad_fn(params, jnp.asarray(
                    rows[i * per:(i + 1) * per]))
                mb_losses.append(loss)
                if micro == 1:
                    acc = g
                    continue
                if acc is None:
                    acc = {k: jnp.zeros(v.shape, jnp.bfloat16)
                           for k, v in g.items()}
                acc = {k: acc[k] + g[k].astype(jnp.bfloat16) for k in g}
            if micro > 1:
                acc = {k: v / micro for k, v in acc.items()}
            step_losses.append(float(jnp.mean(jnp.stack(mb_losses))))
            for k, g in acc.items():
                new_m[k].append(momentum(opt["momentum"][k][r], g))
        new_params = {}
        for k, p in params.items():
            m_new = jnp.stack(new_m[k])
            v = vote(jsc.sign_ternary(m_new.reshape(M4, -1)))[0]
            new_params[k] = apply(p, v.reshape(p.shape).astype(dt))
        params = new_params
        opt = {"momentum": {k: jnp.stack(v) for k, v in new_m.items()}}
        losses.append(float(np.mean(step_losses)))
    states.append(_snapshot(params, opt))
    return states, losses, batches


def _m4_count_cfgs(micro):
    """At M = 4 the global batch is 4 * micro (one row per microbatch)."""
    return _count_cfgs(micro, global_batch=M4 * micro)


@pytest.fixture(scope="module", params=MICRO)
def ref_m4_micro(request):
    jt, _ = _m4_count_cfgs(request.param)
    return request.param, _composed_count_run(jt, 3)


@pytest.mark.parametrize("step", [0, 2])
def test_m4_microbatched_count_wire_step_matches_composed_reference(
        ref_m4_micro, step):
    micro, (states, losses, batches) = ref_m4_micro
    _, tt = _m4_count_cfgs(micro)
    port = _port_step(M4, states[step], batches[step], step, tcfg=tt)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, count_wire=True,
                          bf16_rounded=True)


def test_m4_microbatched_free_running_losses_match_composed_reference(
        ref_m4_micro):
    micro, (states, losses, batches) = ref_m4_micro
    _, tt = _m4_count_cfgs(micro)
    got = _free_running_losses(M4, states[0], batches, tcfg=tt)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


@pytest.mark.parametrize("remat,layers", [("full", 2), ("nested", 2),
                                          ("nested", 4)])
def test_remat_gradients_equal_no_remat(remat, layers):
    """Checkpointed blocks (one a checkpoint, or at 4 layers "nested"'s
    two groups of two) recompute the same forward on the CPU, so every
    gradient is bit-equal to the one without remat (tolerance: none)."""
    cfg = dataclasses.replace(_jcfgs()[0], num_layers=layers)
    tcfg = dataclasses.replace(_tcfgs()[0], num_layers=layers)
    params = tM.params_from_numpy(_np(jM.init_params(cfg, jax.random.PRNGKey(
        1))), device="cpu")
    tokens = torch.as_tensor(SyntheticLMPipeline(cfg, 2, SEQ).global_batch_at(
        0)["tokens"])
    grads = {}
    for mode in ("none", remat):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss, _ = tM.loss_fn(tcfg, leaves, {"tokens": tokens}, remat=mode)
        grads[mode] = torch.autograd.grad(loss, list(leaves.values()))
    for a, b in zip(grads["none"], grads[remat]):
        assert torch.equal(a, b)


def test_remat_loss_matches_reference():
    """The loss with remat="full" against the reference's ``loss_fn(...,
    remat="full")`` on the same parameters and tokens (rtol 1e-5, the
    model tests' loss tolerance)."""
    cfg, _ = _jcfgs()
    params = jM.init_params(cfg, jax.random.PRNGKey(2))
    tokens = SyntheticLMPipeline(cfg, 4, SEQ).global_batch_at(1)["tokens"]
    want, _ = jM.loss_fn(cfg, params, {"tokens": jnp.asarray(tokens)},
                         remat="full")
    got, _ = tM.loss_fn(_tcfgs()[0], tM.params_from_numpy(_np(params),
                                                          device="cpu"),
                        {"tokens": torch.as_tensor(tokens)}, remat="full")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.fixture(scope="module")
def ref_preset():
    jt, _ = _preset_cfgs()
    return _composed_count_run(jt, 3)


@pytest.mark.parametrize("step", [0, 2])
def test_preset_step_matches_composed_reference(ref_preset, step):
    """The glm4-9b preset end to end at M = 4 (bf16 momentum, psum_int8,
    2 microbatches, full remat, lr 1e-4) against the composed JAX step."""
    states, losses, batches = ref_preset
    _, tt = _preset_cfgs()
    port = _port_step(M4, states[step], batches[step], step, tcfg=tt)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, count_wire=True,
                          bf16_rounded=True)


def test_preset_free_running_losses_match_composed_reference(ref_preset):
    states, losses, batches = ref_preset
    _, tt = _preset_cfgs()
    got = _free_running_losses(M4, states[0], batches, tcfg=tt)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


@pytest.mark.parametrize("step", [0, 2])
def test_m1_preset_step_matches_reference_trainer(step):
    """The preset at M = 1 against the reference trainer itself (its
    mesh-free step: bf16 momentum, 2 microbatches, full remat)."""
    jt, tt = _preset_cfgs()
    states, losses, batches = _reference_trainer_run("sign1bit", step + 1,
                                                     tcfg=jt)
    port = _port_step(1, states[step], batches[step], step, tcfg=tt)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, count_wire=True,
                          bf16_rounded=True)


@pytest.mark.parametrize("change,item", [
    # hierarchical runs since the ninth slice; under fsdp it still raises
    ({"optimizer": {"vote_strategy": tbase.VoteStrategy.HIERARCHICAL},
      "fsdp": True}, "Queue 4 item 4"),
    ({"optimizer": {"vote_strategy": tbase.VoteStrategy.AUTO}},
     "Queue 1 item 15"),
    ({"remat": "dots"}, "Queue 4 item 4"),
    ({"fsdp": True}, "Queue 4 item 4"),
    ({"diagnostics": True}, "Queue 4 item 4"),
    ({"loss_dtype": "bfloat16"}, "Queue 4 item 4"),
], ids=["hierarchical", "auto_m4", "remat_dots", "fsdp", "diagnostics",
        "loss_dtype"])
def test_preset_trainer_still_refuses(change, item):
    """What the trainer still refuses on top of the preset, at M = 4, each
    naming its ROADMAP.md item."""
    _, tcfg = _preset_cfgs()
    opt = change.pop("optimizer", None)
    if opt:
        change["optimizer"] = dataclasses.replace(tcfg.optimizer, **opt)
    tcfg = dataclasses.replace(tcfg, **change)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tTS.make_train_step(_tcfgs()[0], tcfg, M4, device="cpu")
