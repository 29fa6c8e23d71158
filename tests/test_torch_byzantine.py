"""Parity tests of the port's failure composition against the JAX package
(the reference): ``core/prng.py`` against ``jax.random`` bit for bit,
``core/byzantine.py`` against ``repro.core.byzantine``, the vote API's
stale votes and adversaries on every wire and through a plan, and the
trainer with a Byzantine model. Every comparison is exact: the port draws
JAX's own threefry bits (``jax_threefry_partitionable``, the default), so
the random, colluding and blind adversaries send the reference's vectors.
Inputs are made with numpy from fixed seeds and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ByzantineConfig as JByz  # noqa: E402
from repro.configs.base import VoteStrategy as JS  # noqa: E402
from repro.core import byzantine as jbyz  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core import vote_plan as jvp  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.base import ByzantineConfig as TByz  # noqa: E402
from repro_torch.configs.base import VoteStrategy as TS  # noqa: E402
from repro_torch.core import byzantine as tbyz  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

MODES = ("sign_flip", "zero", "random", "colluding", "blind")
#: seeds below and past 2^31 (a config seed plus a 31-bit scenario salt
#: exceeds it), and past 2^32 (JAX keeps the low 32 bits)
SEEDS = (0, 7, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 + 3)


def _key(k):
    return tuple(int(w) for w in np.asarray(k))


# ---------------------------------------------------------------------------
# core/prng.py against jax.random
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_chain(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert _key(jk) == tk
    for data in (0, 1, 12345, 2 ** 31 - 1, 2 ** 31 + 9, 2 ** 32 - 1):
        jk, tk = jax.random.fold_in(jk, data), prng.fold_in(tk, data)
        assert _key(jk) == tk


@pytest.mark.parametrize("shape", [(1,), (1000,), (4, 6)])
def test_random_bits_and_uniform(shape):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11), 3),
                            2 ** 31 + 4)
    tk = prng.fold_in(prng.fold_in(prng.prng_key(11), 3), 2 ** 31 + 4)
    bits = prng.random_bits(tk, shape).numpy().astype(np.uint32)
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(jk,
                                                                   shape)))
    u = prng.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(
        u.view(np.uint32), np.asarray(jax.random.uniform(jk, shape))
        .view(np.uint32))


@pytest.mark.parametrize("p", [0.0, 0.1, 1 / 3, 0.5, 0.9, 1.0])
def test_bernoulli_and_the_kernels_integer_threshold(p):
    """``bernoulli`` equals JAX's, and the kernel's integer compare
    ``bits >> 9 < draw_threshold(p)`` (``csrc/byzantine.cu``) equals it."""
    jk = jax.random.PRNGKey(2 ** 31 + 5)
    tk = prng.prng_key(2 ** 31 + 5)
    shape = (4096,)
    want = np.asarray(jax.random.bernoulli(jk, p, shape))
    np.testing.assert_array_equal(prng.bernoulli(tk, p, shape).numpy(), want)
    bits = prng.random_bits(tk, shape)
    np.testing.assert_array_equal(
        ((bits >> 9) < tops.draw_threshold(p)).numpy(), want)


def test_random_bits_offset_is_a_window_of_the_row():
    tk = prng.prng_key(5)
    row = prng.random_bits(tk, (5000,))
    for start in (0, 1, 1234, 4900):
        np.testing.assert_array_equal(
            prng.random_bits(tk, (100,), offset=start).numpy(),
            row[start:start + 100].numpy())


def test_counter_high_word():
    """Counters past 2^32 carry the high word as the first counter input,
    as JAX's iota split does."""
    tk = prng.prng_key(9)
    i = 2 ** 32 + 17
    out0, out1 = prng.threefry2x32(tk, i >> 32, i & prng.MASK32)
    assert int(prng.random_bits(tk, (1,), offset=i)[0]) == out0 ^ out1
    assert (out0, out1) != prng.threefry2x32(tk, 0, i & prng.MASK32)


# ---------------------------------------------------------------------------
# core/byzantine.py against repro.core.byzantine
# ---------------------------------------------------------------------------


def _signs(m=6, n=1000, seed=0):
    return np.random.default_rng(seed).integers(-1, 2, (m, n)).astype(np.int8)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("step,salt", [(None, 0), (2 ** 31 + 2, 2 ** 31 - 1)])
def test_apply_adversary_stacked(mode, step, salt):
    s = _signs()
    kw = dict(mode=mode, num_adversaries=3, seed=2 ** 31 - 5, flip_prob=0.9)
    jstep = None if step is None else jnp.asarray(step, jnp.uint32).astype(
        jnp.int32)
    want = np.asarray(jbyz.apply_adversary_stacked(
        jnp.asarray(s), JByz(**kw), step=jstep, salt=salt))
    got = tbyz.apply_adversary_stacked(torch.from_numpy(s.copy()), TByz(**kw),
                                       step=step, salt=salt)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["random", "blind", "sign_flip"])
def test_apply_adversary_stacked_with_ids(mode):
    """Logical ids decide the predicate and the keys (adversarial rows apart
    from each other), and a 3-D stack draws its trailing dims flat."""
    s = _signs(6, 60).reshape(6, 5, 12)
    ids = [5, 0, 2, 1, 7, 3]
    kw = dict(mode=mode, num_adversaries=3, seed=1, flip_prob=0.3)
    want = np.asarray(jbyz.apply_adversary_stacked(
        jnp.asarray(s), JByz(**kw), step=jnp.int32(4),
        ids=jnp.asarray(ids)))
    got = tbyz.apply_adversary_stacked(torch.from_numpy(s.copy()), TByz(**kw),
                                       step=4, ids=ids)
    np.testing.assert_array_equal(got.numpy(), want)


def test_adversary_plain_version_on_windows_and_strided_rows():
    """``ops.adversary_`` on a window of a row draws what the whole row
    draws there, and reads a view whose rows are apart."""
    s = torch.from_numpy(_signs(3, 400, seed=1))
    keys = [prng.fold_in(prng.prng_key(3), r) for r in range(3)]
    whole = tops.adversary_(s.clone(), keys, 0.9, True)
    part = tops.adversary_(s[:, 100:300].clone(), keys, 0.9, True,
                           offset=100)
    np.testing.assert_array_equal(part.numpy(), whole[:, 100:300].numpy())
    buf = torch.zeros((3, 417), dtype=torch.int8)
    view = buf[:, 1:401]
    view.copy_(s)
    tops.adversary_(view, keys, 0.9, True)
    np.testing.assert_array_equal(view.numpy(), whole.numpy())
    assert not buf[:, 0].any() and not buf[:, 401:].any()
    assert torch.equal(tref.adversary(s, keys, 0.9, True), whole)


def test_config_factories_and_count_for_fraction():
    from repro.core import attacks as jatt
    from repro.distributed import fault_tolerance as jft
    for frac in (0.0, 0.125, 0.25, 1 / 3, 0.375, 0.5, 7 / 15, 0.6, 1.0):
        for n in (1, 4, 7, 15, 16, 1001):
            assert tft.count_for_fraction(frac, n) == \
                jft.count_for_fraction(frac, n)
            assert dataclasses.asdict(tbyz.coalition_config(
                "random", frac, n, seed=3)) == dataclasses.asdict(
                jatt.coalition_config("random", frac, n, seed=3))
    assert tbyz.build_config("blind", 0).mode == "none"
    with pytest.raises(ValueError, match="unknown adversary mode"):
        tbyz.build_config("martian", 1)
    with pytest.raises(ValueError):
        tft.count_for_fraction(1.5, 4)


def test_mesh_and_adaptive_paths_raise():
    """The mesh path raises (item 5); an adaptive mode without its
    observation raises the reference's ValueError."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tbyz.apply_adversary(np.zeros(4, np.int8), TByz("sign_flip", 1),
                             ("data",))
    with pytest.raises(ValueError) as want:
        jbyz.apply_adversary_stacked(jnp.zeros((2, 4), jnp.int8),
                                     JByz("low_margin", 1))
    with pytest.raises(ValueError) as got:
        tbyz.apply_adversary_stacked(torch.zeros(2, 4, dtype=torch.int8),
                                     TByz("low_margin", 1))
    assert str(got.value) == str(want.value)
    for shim in (lambda: tft.straggler_mask_for(("data",), 1),
                 lambda: tft.vote_with_failures(None, None),
                 lambda: tft.codec_vote_with_failures(None, None),
                 lambda: tft.make_mesh_from_plan(None)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            shim()


# ---------------------------------------------------------------------------
# the vote API: every adversary mode on every wire, stale x adversary
# ---------------------------------------------------------------------------

#: (strategy, codec) of every wire the stacked form runs
WIRES = (("psum_int8", "sign1bit"), ("allgather_1bit", "sign1bit"),
         ("hierarchical", "sign1bit"), ("allgather_1bit", "ternary2bit"),
         ("psum_int8", "ternary2bit"), ("allgather_1bit", "weighted_vote"))
M, N = 7, 300


def _payload(seed=0):
    x = np.random.default_rng(seed).normal(size=(M, N)).astype(np.float32)
    x[:, ::11] = 0.0                      # abstentions on the count wires
    return x


def _vote_both(x, strategy, codec, byz_kw=None, n_stale=0, prev=None,
               step=None, salt=0, plan=None):
    state = ({"flip_ema": np.linspace(0, 0.4, M).astype(np.float32)}
             if codec == "weighted_vote" else None)
    jbyz_cfg = JByz(**byz_kw) if byz_kw else None
    tbyz_cfg = TByz(**byz_kw) if byz_kw else None
    jout = jva.VirtualBackend().execute(jva.VoteRequest(
        payload=jnp.asarray(x), form="stacked", strategy=JS(strategy),
        codec=codec, plan=plan[0] if plan else None,
        failures=jva.FailureSpec(n_stale=n_stale, byz=jbyz_cfg),
        prev=None if prev is None else jnp.asarray(prev),
        step=None if step is None else jnp.int32(step), salt=salt,
        server_state=state))
    tout = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
        payload=x, form="stacked", strategy=TS(strategy), codec=codec,
        plan=plan[1] if plan else None,
        failures=tva.FailureSpec(n_stale=n_stale, byz=tbyz_cfg),
        prev=prev, step=step, salt=salt, server_state=state))
    np.testing.assert_array_equal(tout.wire_signs.numpy(),
                                  np.asarray(jout.wire_signs))
    np.testing.assert_array_equal(tout.votes.numpy(), np.asarray(jout.votes))
    for k, v in (jout.server_state or {}).items():
        np.testing.assert_array_equal(
            np.asarray(tout.server_state[k]).view(np.uint32),
            np.asarray(v).view(np.uint32))
    return tout


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("wire", WIRES, ids=["-".join(w) for w in WIRES])
def test_adversary_on_every_wire(mode, wire):
    out = _vote_both(_payload(), *wire,
                     byz_kw=dict(mode=mode, num_adversaries=3, seed=5,
                                 flip_prob=0.8), step=2, salt=77)
    assert out.wire_signs.shape == (M, N)


STALE_CASES = [("sign_flip", WIRES[0]), ("random", WIRES[1]),
               ("blind", WIRES[2]), ("colluding", WIRES[3]),
               ("zero", WIRES[4]), ("blind", WIRES[5])]


@pytest.mark.parametrize("mode,wire", STALE_CASES,
                         ids=[f"{m}-{'-'.join(w)}" for m, w in STALE_CASES])
def test_stale_then_adversary(mode, wire):
    """The pinned order: the first n_stale voters send prev, then the
    adversary corrupts (a stale adversary its stale vector)."""
    prev = np.random.default_rng(9).integers(-1, 2, (M, N)).astype(np.int8)
    _vote_both(_payload(1), *wire, n_stale=4, prev=prev,
               byz_kw=dict(mode=mode, num_adversaries=2, seed=2 ** 31 - 1,
                           flip_prob=0.7), step=6, salt=2 ** 30)


@pytest.mark.parametrize("mode,overlap", [
    ("random", False), ("colluding", True), ("blind", True),
    ("zero", False)])
def test_plan_walk_with_failures(mode, overlap):
    """Through a mixed plan (ternary2bit embeddings, weighted_vote body),
    the failures act once on the flat buffer, the draws' counter running
    over the flat row."""
    shapes = {"embed.table": (4, 30), "layers.w": (100,), "z": (80,)}
    kw = dict(bucket_bytes=8, codec_map=(("embed*", "ternary2bit"),
                                         ("z", "weighted_vote")),
              strategy=None, data_size=M)
    plans = []
    for mod, S in ((jvp, JS), (tvp, TS)):
        plans.append(mod.build_plan(shapes, **{
            **kw, "strategy": S.ALLGATHER_1BIT}))
    n = plans[1].n_params
    x = np.random.default_rng(2).normal(size=(M, n)).astype(np.float32)
    prev = np.random.default_rng(3).integers(-1, 2, (M, n)).astype(np.int8)
    state = {"flip_ema": np.linspace(0, 0.3, M).astype(np.float32)}
    byz = dict(mode=mode, num_adversaries=3, seed=4, flip_prob=0.6)
    jout = jva.VirtualBackend().execute(jva.VoteRequest(
        payload=jnp.asarray(x), form="stacked", plan=plans[0],
        failures=jva.FailureSpec(n_stale=2, byz=JByz(**byz)),
        prev=jnp.asarray(prev), step=jnp.int32(9), salt=1,
        server_state=state, overlap=overlap))
    tout = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
        payload=x, form="stacked", plan=plans[1],
        failures=tva.FailureSpec(n_stale=2, byz=TByz(**byz)), prev=prev,
        step=9, salt=1, server_state=state, overlap=overlap))
    np.testing.assert_array_equal(tout.wire_signs.numpy(),
                                  np.asarray(jout.wire_signs))
    np.testing.assert_array_equal(tout.votes.numpy(), np.asarray(jout.votes))
    np.testing.assert_array_equal(
        tout.server_state["flip_ema"].numpy().view(np.uint32),
        np.asarray(jout.server_state["flip_ema"]).view(np.uint32))


def test_fused_kernel_path_refuses_failures_with_the_reference_reason():
    x = _payload()
    jreq = jva.VoteRequest(payload=jnp.asarray(x), form="stacked",
                           strategy=JS.ALLGATHER_1BIT,
                           failures=jva.FailureSpec(byz=JByz("sign_flip", 1)))
    treq = tva.VoteRequest(payload=x, form="stacked",
                           strategy=TS.ALLGATHER_1BIT,
                           failures=tva.FailureSpec(byz=TByz("sign_flip", 1)))
    reason = tva.VirtualBackend(use_kernels=True,
                                device="cpu").why_unsupported(treq)
    assert reason == jva.VirtualBackend(use_kernels=True).why_unsupported(
        jreq)
    with pytest.raises(ValueError, match="compose failures"):
        tva.VirtualBackend(use_kernels=True, device="cpu").execute(treq)


def test_virtual_vote_engine_with_failures():
    from repro.sim import VirtualVoteEngine as JEngine
    from repro_torch.sim import VirtualVoteEngine as TEngine
    x = _payload(4)
    prev = np.random.default_rng(5).integers(-1, 2, (M, N)).astype(np.int8)
    byz = dict(mode="colluding", num_adversaries=3, seed=6)
    jv, js = JEngine(JS.HIERARCHICAL, JByz(**byz), salt=3).vote_with_failures(
        jnp.asarray(x), jnp.asarray(prev), 2, jnp.int32(1))
    tv, ts_ = TEngine(TS.HIERARCHICAL, TByz(**byz), salt=3,
                      device="cpu").vote_with_failures(x, prev, 2, 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the trainer with a Byzantine model
# ---------------------------------------------------------------------------

GB, SEQ, LR, BETA = 8, 16, 1e-2, 0.9
#: the leaves each trainer case compares
LEAVES = ("embed.table", "layers.attn_wq")


def _train_cfgs(byz, **opt):
    cfg = dataclasses.replace(tbase.reduced_config(
        tbase.get_config("glm4-9b")), dtype="float32", d_model=64,
        head_dim=16, d_ff=128, vocab_size=256)
    tcfg = tbase.TrainConfig(
        global_batch=GB, seq_len=SEQ, byzantine=byz,
        optimizer=tbase.OptimizerConfig(**{
            "kind": "signum_vote", "learning_rate": LR, "momentum": BETA,
            "vote_strategy": TS.ALLGATHER_1BIT, **opt}))
    return cfg, tcfg


def _one_step(byz, n_voters=4, step=3, **opt):
    """One port step at `step` from seeded state: (params before, the
    voters' vote inputs per leaf, params after, the artifacts)."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    cfg, tcfg = _train_cfgs(byz, **opt)
    art = tTS.make_train_step(cfg, tcfg, n_voters, device="cpu")
    params, state = tTS.materialize_state(
        cfg, tcfg, art, torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
                             .global_batch_at(0)["tokens"])
    per = GB // n_voters
    grads = [tTS.voter_grads(cfg, tcfg, params, tokens[r * per:(r + 1) * per])
             [0] for r in range(n_voters)]
    before = {k: v.clone() for k, v in params.items()}
    params, state, _ = art.step_fn(params, state, {"tokens": tokens}, step)
    if "momentum" in state and opt.get("momentum_mode") is None:
        inputs = {k: state["momentum"][k].reshape(n_voters, -1)
                  for k in params}
    else:
        inputs = {k: torch.stack([g[k].reshape(-1) for g in grads])
                  for k in params}
    return before, inputs, params, art


def _reference_votes(inputs, byz, strategy, step, plan=None):
    """The reference's stacked vote of the same vote inputs with the same
    Byzantine model (salt 0, keyed by the step)."""
    jb = JByz(**dataclasses.asdict(byz))
    if plan is not None:
        flat = np.concatenate([inputs[s.name].numpy() for s in plan.leaves],
                              axis=1)
        v = np.asarray(jva.VirtualBackend().execute(jva.VoteRequest(
            payload=jnp.asarray(flat), form="stacked", plan=plan,
            failures=jva.FailureSpec(byz=jb), step=jnp.int32(step))).votes)
        return {s.name: v[s.offset:s.offset + s.length] for s in plan.leaves}
    return {k: np.asarray(jva.VirtualBackend().execute(jva.VoteRequest(
        payload=jnp.asarray(inputs[k].numpy()), form="stacked",
        strategy=JS(strategy), failures=jva.FailureSpec(byz=jb),
        step=jnp.int32(step))).votes) for k in LEAVES}


def _applied(before, votes, eta):
    """p - eta*vote (weight decay 0) as the port's apply rounds it (a ±1 or
    ternary vote, the same arithmetic on either wire)."""
    out = {}
    for k, v in votes.items():
        words = tops.ternary_pack(torch.tensor(v).view(1, -1))[0]
        out[k] = tops.apply_ternary_vote(before[k].reshape(-1), words, eta,
                                         0.0).view(before[k].shape)
    return out


TRAIN_CASES = [(m, "allgather_1bit") for m in MODES] + [
    ("blind", "psum_int8"), ("random", "hierarchical"),
    ("colluding", "psum_int8")]


@pytest.mark.parametrize("mode,strategy", TRAIN_CASES,
                         ids=[f"{m}-{s}" for m, s in TRAIN_CASES])
def test_trainer_votes_equal_the_references(mode, strategy):
    byz = TByz(mode=mode, num_adversaries=2, seed=2 ** 31 - 7,
               flip_prob=0.9)
    before, inputs, after, art = _one_step(byz, vote_strategy=TS(strategy))
    votes = _reference_votes(inputs, byz, strategy, 3)
    want = _applied(before, votes, LR)
    for k in LEAVES:
        assert torch.equal(after[k], want[k]), k


@pytest.mark.parametrize("mode", ["random", "blind"])
def test_trainer_plan_path_draws_over_the_flat_row(mode):
    byz = TByz(mode=mode, num_adversaries=1, seed=3, flip_prob=0.9)
    before, inputs, after, art = _one_step(byz, bucket_bytes=4096)
    jplan = jvp.build_plan(
        {s.name: s.shape for s in art.plan.leaves}, bucket_bytes=4096,
        strategy=JS.ALLGATHER_1BIT, data_size=4,
        dtypes={s.name: "float32" for s in art.plan.leaves})
    votes = _reference_votes(inputs, byz, None, 3, plan=jplan)
    want = _applied(before, {k: votes[k] for k in LEAVES}, LR)
    for k in LEAVES:
        assert torch.equal(after[k], want[k]), k


@pytest.mark.parametrize("opt", [
    {"momentum": 0.0, "kind": "signsgd_vote"},
    {"momentum_mode": tbase.MomentumMode.GLOBAL, "kind": "signsgd_vote",
     "momentum": 0.0},
    {"codec": "ef_sign"}], ids=["signsgd", "mode_b", "ef_sign"])
def test_trainer_adversary_under_other_optimizers(opt):
    """signSGD and Mode B (beta = 0: the vote applied as it is) vote the
    gradients' signs, ef_sign e + m' (m' at step 0): the adversary acts on
    what each voter sends."""
    byz = TByz(mode="random", num_adversaries=2, seed=8)
    before, inputs, after, art = _one_step(byz, **opt)
    want = _applied(before, _reference_votes(inputs, byz, "allgather_1bit",
                                             3), LR)
    for k in LEAVES:
        assert torch.equal(after[k], want[k]), k


def test_trainer_at_one_voter_has_no_adversary_as_the_reference():
    """Without a mesh the reference's trainer has no vote axes and applies
    no adversary; at M = 1 the port does the same."""
    byz = TByz(mode="sign_flip", num_adversaries=1)
    _, _, with_byz, _ = _one_step(byz, n_voters=1)
    _, _, honest, _ = _one_step(TByz(), n_voters=1)
    for k in LEAVES:
        assert torch.equal(with_byz[k], honest[k])


def test_dense_baselines_ignore_the_adversary_as_the_reference():
    byz = TByz(mode="sign_flip", num_adversaries=2)
    _, _, with_byz, _ = _one_step(byz, kind="sgd")
    _, _, honest, _ = _one_step(TByz(), kind="sgd")
    for k in LEAVES:
        assert torch.equal(with_byz[k], honest[k])
