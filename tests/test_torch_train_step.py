"""The port's Algorithm 1 train step against the JAX package, in float32
on the CPU (reduced glm4-9b, global batch 8, seq 64, lr 1e-3, beta 0.9,
allgather_1bit).

(a) M = 1 against the reference trainer itself
    (``repro.train.train_step.make_train_step(cfg, tcfg, mesh=None)``).
(b) M = 4 against a step composed here from JAX functions only: per-voter
    ``jax.value_and_grad(repro.models.model.loss_fn)`` on
    ``replica_batch`` rows, then per leaf the JAX package's own oracles
    ``repro.kernels.ref.momentum_sign_pack`` / ``majority`` /
    ``apply_vote``, with the majority cross-checked against
    ``VirtualBackend().execute(VoteRequest(form="stacked"))``.
(c) Options the port does not run yet raise.

Criteria, (a) and (b) alike. Teacher-forced (both packages take one step
from identical params and momentum): the loss within rtol 1e-5, the
momentum within rtol 1e-5 and atol 1e-7 (m' carries (1-beta) = 0.1 of
the gradient, whose two float32 versions tests/test_torch_model.py holds
to atol 1e-6: they are summed in other orders, and tiny entries differ in
relative terms far more than rtol), and the votes and updated params
equal on every coordinate whose sign is not a matter of rounding (see
`_check_teacher_forced`). The coordinates left out are counted and may
not exceed 0.1%. Free-running for 5 steps from the same init,
the per-step losses agree within rtol 1e-3.
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
from repro.core import vote_api as va  # noqa: E402
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
#: m' tolerance's atol. Above it the asserted momentum bound fixes the
#: sign, so the votes are compared on every coordinate with |m'| > 1e-7
#: (a superset of the |m'| > 1e-6 coordinates)
NEAR_ZERO = 1e-7
MAX_EXCLUDED = 1e-3


def _jcfgs():
    cfg = dataclasses.replace(reduced_config(get_config("glm4-9b")),
                              dtype="float32")
    tcfg = TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=OptimizerConfig(
        kind="signum_vote", learning_rate=LR, momentum=BETA,
        vote_strategy=VoteStrategy.ALLGATHER_1BIT))
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


def _port_state(params, momentum):
    """numpy params + (M, ...) momentum -> the port's state on the CPU."""
    return (tM.params_from_numpy(params, device="cpu"),
            {"count": 0, "momentum": tM.params_from_numpy(momentum,
                                                          device="cpu")})


def _port_step(n_voters, params, momentum, tokens, step):
    cfg, tcfg = _tcfgs()
    art = tTS.make_train_step(cfg, tcfg, n_voters, device="cpu")
    tp, ts = _port_state(params, momentum)
    tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
    return (float(met["loss"]), {k: v.numpy() for k, v in tp.items()},
            {k: v.numpy() for k, v in ts["momentum"].items()})


def _check_teacher_forced(p0, ref, port, *, ref_abstains_on_zero=False):
    """ref/port: (loss, params, momentum (M, ...)) after one step from the
    same params p0.

    A voter's sign is a matter of rounding where its reference |m'| <=
    1e-7 and the two packages' m' differ; a coordinate is left out when
    such signs could change its majority. Where a voter's m' is exactly 0 in both (an embedding row
    whose token is absent from that voter's rows), both must count it as
    +1 (sign(0) = +1 on the 1-bit wire) — except that the reference's
    single-process M = 1 step (`ref_abstains_on_zero`) votes
    sign_ternary(0) = 0 there and leaves the parameter still, while the
    port's 1-bit wire moves it by -lr; that difference is asserted
    exactly (ROADMAP.md Queue 3)."""
    (rloss, rparams, rmom), (loss, params, mom) = ref, port
    np.testing.assert_allclose(loss, rloss, rtol=1e-5)
    excluded = total = zeros = 0
    for k in rparams:
        np.testing.assert_allclose(mom[k], rmom[k], rtol=1e-5, atol=NEAR_ZERO,
                                   err_msg=k)
        exact0 = (rmom[k] == 0) & (mom[k] == 0)
        # per voter: a sure +1 (above the tolerance, or 0 in both), a sure
        # -1, or a sign decided by rounding; the coordinate is left out
        # only when the rounded signs could change the majority
        pos = ((rmom[k] > NEAR_ZERO) | exact0).sum(axis=0)
        amb = ((np.abs(rmom[k]) <= NEAR_ZERO) & ~exact0).sum(axis=0)
        n_voters = rmom[k].shape[0]
        keep = (2 * pos >= n_voters) | (2 * (pos + amb) < n_voters)
        excluded += int((~keep).sum())
        total += keep.size
        if ref_abstains_on_zero:
            held = exact0.all(axis=0)
            zeros += int(held.sum())
            np.testing.assert_array_equal(rparams[k][held], p0[k][held])
            np.testing.assert_array_equal(
                params[k][held], p0[k][held] - np.float32(LR), err_msg=k)
            keep &= ~held
        # wd = 0: the applied vote is the sign of the parameter's move
        rvote = np.sign(p0[k] - rparams[k])
        vote = np.sign(p0[k] - params[k])
        assert (np.abs(vote) == 1).all(), k
        np.testing.assert_array_equal(vote[keep], rvote[keep], err_msg=k)
        np.testing.assert_array_equal(params[k][keep], rparams[k][keep],
                                      err_msg=k)
    print(f"excluded {excluded} of {total} coordinates whose vote rests on "
          f"some 0 < |m'| <= {NEAR_ZERO} ({excluded / total:.4%}); {zeros} "
          "exact-zero "
          "coordinates held still by the reference, moved -lr by the port")
    assert excluded <= MAX_EXCLUDED * total


# ---------------------------------------------------------------------------
# (a) M = 1 against the reference trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_m1():
    """The reference trainer's state and losses over STEPS steps."""
    cfg, tcfg = _jcfgs()
    art = jTS.make_train_step(cfg, tcfg, mesh=None)
    params, opt = jTS.materialize_state(cfg, tcfg, art, jax.random.PRNGKey(0))
    pipe = SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
    states, losses, batches = [], [], []
    for step in range(STEPS):
        tokens = pipe.global_batch_at(step)["tokens"]
        states.append((_np(params), _np(opt["momentum"])))
        params, opt, met = art.step_fn(params, opt,
                                       {"tokens": jnp.asarray(tokens)},
                                       jnp.int32(step))
        losses.append(float(met["loss"]))
        batches.append(tokens)
    states.append((_np(params), _np(opt["momentum"])))
    return states, losses, batches


def test_m1_step0_loss_is_the_reference_value(ref_m1):
    _, losses, batches = ref_m1
    assert losses[0] == pytest.approx(6.4072, abs=1e-4)
    assert batches[0].shape == (GB, SEQ)


@pytest.mark.parametrize("step", [0, 2])
def test_m1_teacher_forced_step_matches_reference(ref_m1, step):
    states, losses, batches = ref_m1
    p0, m0 = states[step]
    port = _port_step(1, p0, m0, batches[step], step)
    ref = (losses[step],) + states[step + 1]
    _check_teacher_forced(p0, ref, port, ref_abstains_on_zero=True)


def test_m1_free_running_losses_match_reference(ref_m1):
    states, losses, batches = ref_m1
    cfg, tcfg = _tcfgs()
    art = tTS.make_train_step(cfg, tcfg, 1, device="cpu")
    tp, ts = _port_state(*states[0])
    got = []
    for step in range(STEPS):
        tp, ts, met = art.step_fn(tp, ts, {"tokens": batches[step]}, step)
        got.append(float(met["loss"]))
    assert ts["count"] == STEPS
    np.testing.assert_allclose(got, losses, rtol=1e-3)


# ---------------------------------------------------------------------------
# (b) M = 4 against a step composed from JAX functions
# ---------------------------------------------------------------------------

M4 = 4


def _pad32(x):
    flat = x.reshape(-1)
    return jnp.pad(flat, (0, (-flat.shape[0]) % 32))[None]


@pytest.fixture(scope="module")
def ref_m4():
    cfg, tcfg = _jcfgs()
    params = jM.init_params(cfg, jax.random.PRNGKey(0))
    momentum = {k: jnp.zeros((M4,) + v.shape, jnp.float32)
                for k, v in params.items()}
    pipe = SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t: jM.loss_fn(cfg, p, {"tokens": t}), has_aux=True))
    msp = jax.jit(jref.momentum_sign_pack, static_argnums=2)
    majority = jax.jit(jref.majority)
    apply = jax.jit(jref.apply_vote, static_argnums=(2, 3))
    unpack = jax.jit(jref.bitunpack, static_argnums=1)
    states, losses, batches = [], [], []
    for step in range(STEPS):
        states.append((_np(params), _np(momentum)))
        batches.append(pipe.global_batch_at(step)["tokens"])
        step_losses, new_m, packed = [], {k: [] for k in params}, \
            {k: [] for k in params}
        for r in range(M4):
            rows = pipe.replica_batch(step, r, M4)["tokens"]
            (loss, _), grads = grad_fn(params, jnp.asarray(rows))
            step_losses.append(float(loss))
            for k, g in grads.items():
                m_r, words = msp(
                    _pad32(g), _pad32(momentum[k][r]), BETA)
                new_m[k].append(m_r[0, :g.size].reshape(g.shape))
                packed[k].append(words[0])
        new_params, unpacked = {}, []
        for k, p in params.items():
            votes = majority(jnp.stack(packed[k]))
            unpacked.append(
                np.asarray(unpack(votes[None], jnp.int8))[0, :p.size])
            new_params[k] = apply(_pad32(p), votes[None], LR,
                                  0.0)[0, :p.size].reshape(p.shape)
        # one stacked (M, n_total) request over every leaf: one compile
        stacked = jnp.concatenate(
            [jnp.stack([m.reshape(-1) for m in new_m[k]]) for k in params],
            axis=1)
        cross = va.VirtualBackend().execute(va.VoteRequest(
            payload=stacked, form="stacked",
            strategy=VoteStrategy.ALLGATHER_1BIT)).votes
        np.testing.assert_array_equal(np.concatenate(unpacked),
                                      np.asarray(cross))
        params = new_params
        momentum = {k: jnp.stack(v) for k, v in new_m.items()}
        losses.append(float(np.mean(step_losses)))
    states.append((_np(params), _np(momentum)))
    return states, losses, batches


@pytest.mark.parametrize("step", [0, 2])
def test_m4_teacher_forced_step_matches_composed_reference(ref_m4, step):
    states, losses, batches = ref_m4
    p0, m0 = states[step]
    port = _port_step(M4, p0, m0, batches[step], step)
    ref = (losses[step],) + states[step + 1]
    _check_teacher_forced(p0, ref, port)


def test_m4_free_running_losses_match_composed_reference(ref_m4):
    states, losses, batches = ref_m4
    cfg, tcfg = _tcfgs()
    art = tTS.make_train_step(cfg, tcfg, M4, device="cpu")
    tp, ts = _port_state(*states[0])
    assert all(v.shape[0] == M4 for v in ts["momentum"].values())
    got = []
    for step in range(STEPS):
        tp, ts, met = art.step_fn(tp, ts, {"tokens": batches[step]}, step)
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, losses, rtol=1e-3)


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
    assert tops.launch_counts() == {"momentum_sign_pack": 0, "majority": 0,
                                    "apply_vote": 0, "bitpack": 0,
                                    "bitunpack": 0, "fused_majority": 0}
    words = tsc.words_for(params["embed.table"].numel())
    assert words == 512 * 128 // 32


# ---------------------------------------------------------------------------
# (c) what the port does not run yet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", [
    {"vote_strategy": tbase.VoteStrategy.PSUM_INT8},
    {"momentum_mode": tbase.MomentumMode.GLOBAL},
    {"delayed_vote": True},
    {"momentum": 0.0},
    {"codec": "ternary2bit"},
    {"momentum_dtype": "bfloat16"},
])
def test_unported_options_raise(opt):
    cfg, tcfg = _tcfgs()
    tcfg = dataclasses.replace(
        tcfg, optimizer=dataclasses.replace(tcfg.optimizer, **opt))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tTS.make_train_step(cfg, tcfg, 1, device="cpu")


def test_default_strategy_is_psum_int8_and_raises():
    """OptimizerConfig's default strategy is PSUM_INT8, which the port has
    no kernel path for yet."""
    cfg, _ = _tcfgs()
    tcfg = tbase.TrainConfig(global_batch=GB, seq_len=SEQ)
    assert tcfg.optimizer.vote_strategy == tbase.VoteStrategy.PSUM_INT8
    with pytest.raises(NotImplementedError, match="psum_int8"):
        tTS.make_train_step(cfg, tcfg, 1, device="cpu")


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
