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
(b) M = 4 against a step composed here from JAX functions only
    (``tests/test_torch_train_step_m4.py``, with section (d)'s M = 4
    microbatched runs; its helpers and this file's are in
    ``tests/torch_train_step_common.py``): per-voter
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
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro.configs.base import MomentumMode  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import sign_compress as tsc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402
from repro.configs.base import VoteStrategy as JVoteStrategy  # noqa: E402
from repro_torch.core.vote_engine import resolve_strategy  # noqa: E402
from torch_comm_common import use_reference_constants  # noqa: E402

from torch_train_step_common import (  # noqa: E402
    GB,
    SEQ,
    LR,
    STEPS,
    CODEC_STEPS,
    CODECS,
    _jcfgs,
    _tcfgs,
    _np,
    _port_step,
    _free_running_losses,
    _check_teacher_forced,
    _reference_trainer_run,
    M4,
    MICRO,
    _count_cfgs,
    _preset_cfgs,
    _composed_count_run,
)


# ---------------------------------------------------------------------------
# (a) M = 1 against the reference trainer
# ---------------------------------------------------------------------------


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
    port = _port_step(1, states[step], batches[step], step,
                      batches=batches)
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
    port = _port_step(1, states[step], batches[step], step, codec,
                      batches=batches)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, codec=codec,
                          ref_abstains_on_zero=True)
    if codec == "weighted_vote":   # one voter always agrees with itself
        assert port["ema"].tolist() == ref["ema"].tolist() == [0.0]


def test_m1_codec_free_running_losses_match_reference(ref_m1_codec):
    codec, (states, losses, batches) = ref_m1_codec
    got = _free_running_losses(1, states[0], batches, codec)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


_NO_LAUNCHES = {"momentum_sign_pack": 0, "majority": 0, "apply_vote": 0,
                "bitpack": 0, "bitunpack": 0, "fused_majority": 0,
                "ternary_pack": 0, "ternary_majority": 0,
                "ternary_majority_plus_one": 0, "ternary_unpack": 0,
                "apply_ternary_vote": 0, "adversary": 0,
                "adversary_map": 0}


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
    # leaf-wise hierarchical runs (since the ninth slice), and under fsdp
    # (since the thirteenth: at M = 1 without a mesh fsdp is ignored, as
    # in the reference)
    {"vote_strategy": tbase.VoteStrategy.HIERARCHICAL, "fsdp": True},
    # Mode B runs, and its presets' fsdp
    {"momentum_mode": tbase.MomentumMode.GLOBAL, "fsdp": True},
    # the priced AUTO ladder of bucket sizes runs (since the fifteenth
    # slice), synchronous and overlapped
    {"bucket_bytes": -1},
    # beta = 0 runs with an adversary; an adaptive one raises the
    # reference's ValueError when the step is called (its tree-form vote
    # has no observation channel), even at M = 1
    {"momentum": 0.0, "byzantine": tbase.ByzantineConfig(
        mode="low_margin", num_adversaries=1)},
    {"bucket_bytes": -1, "overlap": True},
    # signsgd_vote runs, and remat="dots" (since the thirteenth slice)
    {"kind": "signsgd_vote", "remat": "dots"},
])
def test_unported_options_raise(opt):
    """Each option raises naming its ROADMAP.md item, or (an adaptive
    adversary) the reference's ValueError when the step is called; the
    options this port runs since (fsdp, remat="dots") train a step at M =
    1 bit-equal to the step without them, and bucket_bytes = -1 (the
    priced ladder) bit-equal to the step whose plan names the size the
    ladder chose."""
    cfg, tcfg = _tcfgs()
    train = {k: v for k, v in opt.items() if k in _TRAIN_FIELDS}
    opt = {k: v for k, v in opt.items() if k not in _TRAIN_FIELDS}
    tcfg = dataclasses.replace(
        tcfg, optimizer=dataclasses.replace(tcfg.optimizer, **opt), **train)
    if "fsdp" in train or train.get("remat") == "dots":
        plain = dataclasses.replace(tcfg, fsdp=False, remat="none")
        tokens = torch.from_numpy(SyntheticLMPipeline(
            _jcfgs()[0], GB, SEQ, seed=0).global_batch_at(0)["tokens"])
        got = []
        for t in (tcfg, plain):
            art = tTS.make_train_step(cfg, t, 1, device="cpu")
            assert art.fused_leaves == ()
            params, state = tTS.materialize_state(
                cfg, t, art, torch.Generator().manual_seed(0))
            params, state, met = art.step_fn(params, state,
                                             {"tokens": tokens}, 0)
            got.append((float(met["loss"]), params))
        assert got[0][0] == got[1][0]
        for k, v in got[0][1].items():
            assert torch.equal(v, got[1][1][k]), k
        return
    if opt.get("bucket_bytes") == -1:
        tokens = torch.from_numpy(SyntheticLMPipeline(
            _jcfgs()[0], GB, SEQ, seed=0).global_batch_at(0)["tokens"])
        art = tTS.make_train_step(cfg, tcfg, 1, device="cpu")
        (group,) = art.plan.groups
        named = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
            tcfg.optimizer, bucket_bytes=group.bucket_bytes))
        art2 = tTS.make_train_step(cfg, named, 1, device="cpu")
        assert art2.plan.buckets == art.plan.buckets
        got = []
        for a, t in ((art, tcfg), (art2, named)):
            params, state = tTS.materialize_state(
                cfg, t, a, torch.Generator().manual_seed(0))
            params, state, met = a.step_fn(params, state,
                                           {"tokens": tokens}, 0)
            got.append((float(met["loss"]), params))
        assert got[0][0] == got[1][0]
        for k, v in got[0][1].items():
            assert torch.equal(v, got[1][1][k]), k
        return
    if "byzantine" in train:
        art = tTS.make_train_step(cfg, tcfg, 1, device="cpu")
        params, state = tTS.materialize_state(
            cfg, tcfg, art, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="'tree' form has no such "
                                             "observation channel"):
            art.step_fn(params, state, {"tokens": torch.zeros(
                (GB, SEQ), dtype=torch.int64)}, 0)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tTS.make_train_step(cfg, tcfg, 1, device="cpu")


def test_default_strategy_is_psum_int8_and_raises(monkeypatch):
    """OptimizerConfig's default strategy is PSUM_INT8, which the trainer
    runs (on its 2-bit count wire); AUTO resolves to it at M = 1, as in the
    reference, and over more voters to the link model's choice on the
    model's parameter count: under the reference's constants the
    reference's choice."""
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
    use_reference_constants(monkeypatch)
    from repro.core import vote_engine as jve
    for m in (2, 4, 8):
        art = tTS.make_train_step(cfg, auto, m, device="cpu")
        assert art.vote_strategy.value == jve.resolve_strategy(
            JVoteStrategy.AUTO, cfg.param_count(), m).value


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
    port = _port_step(1, states[step], batches[step], step, tcfg=tt,
                      batches=batches)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, count_wire=True,
                          bf16_rounded=True)


def test_m1_microbatched_free_running_losses_match_reference(ref_m1_micro):
    micro, (states, losses, batches) = ref_m1_micro
    _, tt = _count_cfgs(micro)
    got = _free_running_losses(1, states[0], batches, tcfg=tt)
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
    port = _port_step(M4, states[step], batches[step], step, tcfg=tt,
                      batches=batches)
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
    port = _port_step(1, states[step], batches[step], step, tcfg=tt,
                      batches=batches)
    ref = {"loss": losses[step], **states[step + 1]}
    _check_teacher_forced(states[step], ref, port, count_wire=True,
                          bf16_rounded=True)


@pytest.mark.parametrize("change,item", [
    # hierarchical runs since the ninth slice; under fsdp since the
    # thirteenth, as remat="dots" and fsdp
    ({"optimizer": {"vote_strategy": tbase.VoteStrategy.HIERARCHICAL},
      "fsdp": True}, None),
    # AUTO over 4 voters resolves under the H100 link model since the
    # fifteenth slice
    ({"optimizer": {"vote_strategy": tbase.VoteStrategy.AUTO}}, None),
    ({"remat": "dots"}, None),
    ({"fsdp": True}, None),
    # the vote diagnostics run since the multi-process wire's slice
    ({"diagnostics": True}, None),
], ids=["hierarchical", "auto_m4", "remat_dots", "fsdp", "diagnostics"])
def test_preset_trainer_still_refuses(change, item):
    """What the trainer still refuses on top of the preset, at M = 4, each
    naming its ROADMAP.md item (item None: accepted now). Mode A with
    momentum under fsdp builds, and refuses at ``materialize_state`` with
    the reference's ``DuplicateSpecError`` (its per-worker momentum would
    be sharded over "data" twice); remat="dots" trains a finite step, and
    so does AUTO, on the wire the link model picks for the model's
    parameter count."""
    _, tcfg = _preset_cfgs()
    auto = change.get("optimizer", {}).get("vote_strategy") \
        == tbase.VoteStrategy.AUTO
    opt = change.pop("optimizer", None)
    if opt:
        change["optimizer"] = dataclasses.replace(tcfg.optimizer, **opt)
    tcfg = dataclasses.replace(tcfg, **change)
    if item is None:
        cfg = _tcfgs()[0]
        art = tTS.make_train_step(cfg, tcfg, M4, device="cpu")
        if tcfg.fsdp:
            assert art.fused_leaves
            from repro_torch.distributed import sharding as tshd
            with pytest.raises(tshd.DuplicateSpecError, match="`data`"):
                tTS.materialize_state(cfg, tcfg, art,
                                      torch.Generator().manual_seed(0))
        elif tcfg.remat == "dots" or auto:
            if auto:
                assert art.vote_strategy == resolve_strategy(
                    tbase.VoteStrategy.AUTO, cfg.param_count(), M4)
            params, state = tTS.materialize_state(
                cfg, tcfg, art, torch.Generator().manual_seed(0))
            _, _, met = art.step_fn(params, state, {"tokens": torch.zeros(
                (GB, SEQ), dtype=torch.int64)}, 0)
            assert np.isfinite(float(met["loss"]))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tTS.make_train_step(_tcfgs()[0], tcfg, M4, device="cpu")


def test_loss_dtype_is_ignored_as_the_reference():
    """``loss_dtype`` is declared by the reference's TrainConfig and read
    nowhere: on the preset at M = 1 the port's "bfloat16" step is bit-equal
    to its "float32" step, and it equals the reference's "bfloat16" step as
    test_m1_preset_step_matches_reference_trainer holds the "float32"
    one."""
    jt, tt = _preset_cfgs()
    jt16 = dataclasses.replace(jt, loss_dtype="bfloat16")
    tt16 = dataclasses.replace(tt, loss_dtype="bfloat16")
    states, losses, batches = _reference_trainer_run("sign1bit", 1,
                                                     tcfg=jt16)
    port = _port_step(1, states[0], batches[0], 0, tcfg=tt16)
    port32 = _port_step(1, states[0], batches[0], 0, tcfg=tt)
    assert port["loss"] == port32["loss"]
    for part in ("params", "momentum"):
        for k, v in port[part].items():
            assert np.array_equal(v, port32[part][k], equal_nan=True)
    _check_teacher_forced(states[0], {"loss": losses[0], **states[1]}, port,
                          count_wire=True, bf16_rounded=True)
