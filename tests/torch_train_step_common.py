"""Shared helpers of the port's train-step parity tests
(``tests/test_torch_train_step.py``, ``tests/test_torch_train_step_m4.py``;
their module docs state the criteria these helpers check): the configs on
both packages, the state round trips, the reference's trainer run and the
M = 4 steps composed from JAX functions, the teacher-forced checks, and
the port's free-running runs, computed once per configuration and start
state and shared by the teacher-forced step 0 and the free-running losses;
and the numpy parameter draws of ``tests/test_torch_zoo.py`` and
``tests/test_torch_moe.py``. Not collected itself."""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import (  # noqa: E402
    OptimizerConfig,
    TrainConfig,
    VoteStrategy,
    get_config,
    reduced_config,
)
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro.core import vote_api as va  # noqa: E402
from repro.core.codecs import weighted as jwv  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
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


def numpy_params(cfg, seed):
    """Float32 parameters of `cfg` by the reference's init rules
    (``repro.models.model.init_params``: ones for scales, zeros for
    biases, normal / sqrt(fan_in) for the rest), drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(cfg.param_shapes().items()):
        if name.endswith("_scale") or ".scale" in name:
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("_b", "_bq", "_bk", "_bv")):
            out[name] = np.zeros(shape, np.float32)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            out[name] = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
    return out


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


def _port_step(n_voters, state, tokens, step, codec="sign1bit", tcfg=None,
               batches=None):
    """One port step from the numpy `state`; the new state with "loss"
    (momentum and residual as float32). At step 0 with the run's
    `batches`, the first step of the cached free-running run."""
    if step == 0 and batches is not None:
        np.testing.assert_array_equal(tokens, batches[0])
        return _port_run(n_voters, state, batches, codec, tcfg)[0]
    cfg, own = _tcfgs(codec=codec)
    art = tTS.make_train_step(cfg, tcfg or own, n_voters, device="cpu")
    assert art.codec == codec
    tp, ts = _port_state(state)
    tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
    return _port_out(met, tp, ts)


def _free_running_losses(n_voters, state, batches, codec="sign1bit",
                         tcfg=None):
    return [o["loss"] for o in _port_run(n_voters, state, batches, codec,
                                         tcfg)]


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

#: the port's free-running runs, by voters, start state, batches and config
_RUNS = {}


def _port_out(met, tp, ts):
    """A copy of a port state as numpy (momentum and residual as float32)
    with "loss" (the step updates the tensors in place)."""
    out = {"loss": float(met["loss"]),
           "params": {k: v.numpy().copy() for k, v in tp.items()},
           "momentum": {k: v.float().numpy().copy()
                        for k, v in ts["momentum"].items()}}
    if "error" in ts:
        out["error"] = {k: v.float().numpy().copy()
                        for k, v in ts["error"].items()}
    if "codec" in ts:
        out["ema"] = ts["codec"]["flip_ema"].numpy().copy()
    return out


def _port_run(n_voters, state, batches, codec="sign1bit", tcfg=None):
    """The port's free-running steps from the numpy `state` over
    `batches`, one new state (with "loss") a step; computed once per
    configuration and start state (every array of `state`: parameters,
    momentum, residual, EMA), so a teacher-forced step 0 (the same
    computation) and the free-running losses share it."""
    h = hashlib.sha256()
    for part in sorted(state):
        arrays = state[part]
        for k in (sorted(arrays) if isinstance(arrays, dict) else [None]):
            a = arrays if k is None else arrays[k]
            h.update(f"{part}/{k}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    for t in batches:
        h.update(np.ascontiguousarray(t).tobytes())
    key = (n_voters, h.hexdigest(), codec, repr(tcfg))
    if key not in _RUNS:
        cfg, own = _tcfgs(codec=codec)
        art = tTS.make_train_step(cfg, tcfg or own, n_voters, device="cpu")
        assert art.codec == codec
        tp, ts = _port_state(state)
        assert all(v.shape[0] == n_voters for v in ts["momentum"].values())
        out = []
        for step, tokens in enumerate(batches):
            tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
            out.append(_port_out(met, tp, ts))
        assert ts["count"] == len(batches)
        _RUNS[key] = out
    return _RUNS[key]
