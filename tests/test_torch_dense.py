"""The dense baselines of the port (``sgd`` / ``sgdm`` / ``adam``:
``repro_torch.core.signum.make_dense_optimizer`` and the train step that
runs them), against the JAX package on the CPU.

(a) The float32 microbatch accumulator (``train_step.accumulate_`` with
    the dense kinds' float32) against the reference's ``acc_body`` scan
    with ``acc_dt`` float32 on the same per-microbatch gradients.
    Tolerance: none (bit-equal float32).
(b) The optimizer on small random leaves (float32 and bf16 parameters and
    gradients), teacher-forced: before each of 3 steps the port takes the
    reference's state.
    - M = 1 against the reference's own ``make_dense_optimizer(cfg, ())``
      (eager, so each operation rounds on its own, as the port's do): the
      mean is g itself, and the parameters and moments are bit-equal.
    - M = 4 against the reference's update applied to a composed mean,
      ``jnp.sum(stacked, 0) / M`` in the gradients' dtype. With dyadic
      gradients (small integers times a power of two, so every partial
      sum is exact in any order) the mean, the parameters and the moments
      are bit-equal. With random bf16 gradients the sums round in each
      package's order: the mean is held within M - 1 bf16 roundings of
      partial sums, 1.02 * (M - 1) * 2^-8 * sum|g| / M per coordinate,
      of a float64 sum.
(c) The trainer (``make_train_step``) on the reduced glm4-9b in float32:
    - M = 1 against the reference trainer ``make_train_step(cfg, tcfg,
      mesh=None)``, one step teacher-forced at steps 0 and 2 and three
      free-running (and Adam with 2 microbatches, the float32
      accumulator);
    - M = 4 against a step composed from the reference's gradients, the
      composed mean and its update.
    Each package's update is held bit for bit to a float32 recomputation
    in numpy from its own mean gradient (the port's recomputed by its own
    ``voter_grads``; the reference's recomputed in a jit of its own, which
    may round otherwise than its train step's, so within rtol 1e-6 and
    atol 1e-3 * lr). Across the packages: the mean gradients within rtol
    1e-4 and atol 1e-6 (tests/test_torch_model.py holds each gradient to
    atol 1e-6), the first moment within atol 1e-6, the second within rtol
    1e-3 and atol 1e-12, and the parameters within atol 1e-8 and rtol 1e-6
    on all but 0.1 % of the coordinates, where Adam's g / (|g| + eps) turns
    a tiny gradient's rounding into a large step (every coordinate within
    2 * lr). Losses within rtol 1e-5 teacher-forced and 1e-3 free-running.
(d) The state layout against the reference's ``abstract_state``, and the
    refusals.
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
from repro.core.signum import make_dense_optimizer as jdense  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import majority_vote as tmv  # noqa: E402
from repro_torch.core import signum as tsignum  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

KINDS = ["sgd", "sgdm", "adam"]
LR = 0.01


def _rng(*salt):
    return np.random.default_rng(
        [31, *(s if isinstance(s, int) else zlib.crc32(repr(s).encode())
              for s in salt)])


def _opts(kind, **kw):
    args = dict(kind=kind, learning_rate=LR, momentum=0.9, **kw)
    return jbase.OptimizerConfig(**args), tbase.OptimizerConfig(**args)


def _np(t):
    """A tensor as numpy, bf16 kept (an ml_dtypes bf16 array)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x.view(
        np.uint32)


# ---------------------------------------------------------------------------
# (a) the float32 accumulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("micro", [2, 4, 8])
def test_float32_accumulator_matches_reference_scan(micro, gdtype):
    """The dense kinds' accumulator: float32 zeros, ``a + g.astype(f32)``
    per microbatch, then ``/ microbatches``, bit-equal to the reference's
    scan with ``acc_dt`` float32, on values that cancel and span 7 orders
    of magnitude."""
    rng = _rng("acc", micro, gdtype)
    gs = (rng.normal(size=(micro, 3, 500)) * 10.0 ** rng.uniform(
        -6, 1, size=(micro, 3, 500))).astype(np.float32)
    gs[1, :, 5::13] = -gs[0, :, 5::13]
    gs = np.asarray(jnp.asarray(gs).astype(gdtype).astype(jnp.float32))

    def body(acc, g):
        return acc + g.astype(acc.dtype), None
    want, _ = jax.lax.scan(body, jnp.zeros((3, 500), jnp.float32),
                           jnp.asarray(gs).astype(gdtype))
    want = np.asarray(want / micro)
    acc = None
    for i in range(micro):
        acc = tTS.accumulate_(acc, [torch.from_numpy(gs[i].copy()).to(
            getattr(torch, gdtype))], torch.float32)
    got = acc[0].div_(micro)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ---------------------------------------------------------------------------
# (b) the optimizer
# ---------------------------------------------------------------------------

SHAPES = {"embed.table": (7, 9), "layers.w": (5, 11), "norm": (3,)}


def _tree(salt, dtype, dyadic=False, shapes=SHAPES):
    rng = _rng(salt)
    out = {}
    for k, s in shapes.items():
        if dyadic:   # 4-bit multiples of 2^-3: sums of 4 exact in bf16
            x = rng.integers(-15, 16, size=s).astype(np.float32) / 8
        else:
            x = rng.normal(size=s).astype(np.float32)
        out[k] = np.asarray(jnp.asarray(x).astype(dtype))
    return out


def _to_port_state(jstate):
    ts = {"count": int(jstate["count"])}
    for key in ("m", "v"):
        if key in jstate:
            ts[key] = tM.params_from_numpy(
                {k: np.asarray(v) for k, v in jstate[key].items()},
                device="cpu")
    return ts


def _port_dense_step(to, m, state, params, grads, step):
    opt = toptim.build_optimizer(to, m)
    tp = tM.params_from_numpy(params, device="cpu")
    ts = _to_port_state(state)
    fresh = opt.init(tp)
    assert sorted(fresh) == sorted(ts)
    wire = opt.wire(tp)
    for r in range(m):
        opt.encode(r, tM.params_from_numpy(grads[r], device="cpu"), ts,
                   wire)
    opt.update(wire, ts, tp, step)
    assert ts["count"] == int(state["count"]) + 1
    return tp, ts


def _assert_equal_state(tp, ts, jparams, jstate):
    for k, v in jparams.items():
        np.testing.assert_array_equal(_bits(_np(tp[k])), _bits(v),
                                      err_msg=k)
    for key in ("m", "v"):
        for k, v in jstate.get(key, {}).items():
            np.testing.assert_array_equal(_bits(ts[key][k].numpy()),
                                          _bits(v), err_msg=(key, k))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_m1_optimizer_matches_reference(kind, pdtype):
    """Three steps at M = 1 against the reference's own dense optimizer
    (no vote axes): bit-equal parameters and moments; the mean is g."""
    jo, to = _opts(kind, weight_decay=0.01)
    j = jdense(jo, ())
    jparams = {k: jnp.asarray(v) for k, v in _tree("p", pdtype).items()}
    jstate = j.init(jparams)
    for step in range(3):
        g = _tree(("g", step), pdtype)
        tp, ts = _port_dense_step(to, 1, jstate, {
            k: np.asarray(v) for k, v in jparams.items()}, [g], step)
        jparams, jstate, _ = j.update({k: jnp.asarray(v)
                                       for k, v in g.items()},
                                      jstate, jparams, jnp.int32(step))
        _assert_equal_state(tp, ts, jparams, jstate)
        if kind == "sgdm" and step == 0:   # m = 0.9 * 0 + mean = g
            for k, v in g.items():
                np.testing.assert_array_equal(
                    ts["m"][k].numpy(), np.asarray(v, np.float32))


def _composed_dense_step(jo, jstate, jparams, grads, step):
    """The reference's update of the composed mean ``jnp.sum(stacked, 0) /
    M`` (in the gradients' dtype)."""
    m = len(grads)
    mean = {k: jnp.sum(jnp.stack([jnp.asarray(g[k]) for g in grads]), 0) / m
            for k in grads[0]}
    return jdense(jo, ()).update(mean, jstate, jparams, jnp.int32(step))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_m4_dyadic_gradients_match_composed_reference(kind, pdtype):
    """M = 4 with dyadic gradients (every partial sum exact): bit-equal
    to the reference's update of jnp.sum(stacked, 0) / M, three steps."""
    jo, to = _opts(kind)
    jparams = {k: jnp.asarray(v) for k, v in _tree("p4", pdtype).items()}
    jstate = jdense(jo, ()).init(jparams)
    for step in range(3):
        grads = [_tree(("g4", step, r), pdtype, dyadic=True)
                 for r in range(4)]
        tp, ts = _port_dense_step(to, 4, jstate, {
            k: np.asarray(v) for k, v in jparams.items()}, grads, step)
        jparams, jstate, _ = _composed_dense_step(jo, jstate, jparams,
                                                  grads, step)
        _assert_equal_state(tp, ts, jparams, jstate)


def test_m4_bf16_mean_within_bf16_rounding_of_a_float64_sum():
    """The bf16 sum of 4 voters' random gradients, divided by 4 in bf16
    (``majority_vote.add_voter_`` / ``tree_mean_``), against a float64 sum:
    within 1.02 * 3 * 2^-8 * sum|g| / 4 per coordinate (three roundings of
    partial sums, each at most bf16's unit roundoff 2^-8 times a partial
    sum; the division by 4 is exact); and the reference's composed
    jnp.sum(stacked, 0) / 4 within the same bound, whatever its order."""
    grads = [_tree(("bf", r), "bfloat16", shapes={"w": (64, 257)})
             for r in range(4)]
    total = {}
    for g in grads:
        tmv.add_voter_(total, tM.params_from_numpy(g, device="cpu"))
    mean = tmv.tree_mean_(total, 4)["w"].float().numpy()
    g64 = np.stack([np.asarray(g["w"], np.float64) for g in grads])
    want = g64.sum(0) / 4
    # 3 roundings of partial sums, each <= 2^-8 * sum|g|; / 4 is exact
    bound = 1.02 * 3 * 2.0 ** -8 * np.abs(g64).sum(0) / 4
    assert (np.abs(mean - want) <= bound).all()
    ref = np.asarray(jnp.sum(jnp.stack([jnp.asarray(g["w"]) for g in grads]),
                             0) / 4, np.float64)
    assert (np.abs(ref - want) <= bound).all()
    assert (mean != want).any()   # the bound is not vacuous


# ---------------------------------------------------------------------------
# (c) the trainer
# ---------------------------------------------------------------------------

GB, SEQ, TLR = 8, 64, 1e-3
M4 = 4


def _cfgs():
    return tuple(dataclasses.replace(
        pkg.reduced_config(pkg.get_config("glm4-9b")), dtype="float32")
        for pkg in (jbase, tbase))


def _train_cfgs(kind, micro=1):
    return tuple(pkg.TrainConfig(
        global_batch=GB, seq_len=SEQ, microbatches=micro,
        optimizer=pkg.OptimizerConfig(kind=kind, learning_rate=TLR,
                                      momentum=0.9))
        for pkg in (jbase, tbase))


_GRAD_FN = {}


def _jmean(cfg, tcfg, params, tokens, m):
    """The reference's mean gradient over m voters (float32 accumulator
    over its microbatches, as ``acc_body`` has it for the dense kinds; the
    voters' mean jnp.sum / m) and its mean loss, numpy."""
    if cfg not in _GRAD_FN:
        _GRAD_FN[cfg] = jax.jit(jax.value_and_grad(
            lambda p, t: jM.loss_fn(cfg, p, {"tokens": t}), has_aux=True))
    fn = _GRAD_FN[cfg]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    per, micro = tokens.shape[0] // m, tcfg.microbatches
    rows = per // micro
    voters, losses = [], []
    for r in range(m):
        acc = None
        for i in range(micro):
            start = r * per + i * rows
            (loss, _), g = fn(jp, jnp.asarray(tokens[start:start + rows]))
            losses.append(float(loss))
            acc = g if acc is None else {k: acc[k] + g[k] for k in g}
        voters.append({k: v / micro for k, v in acc.items()}
                      if micro > 1 else acc)
    mean = {k: jnp.sum(jnp.stack([v[k] for v in voters]), 0) / m
            for k in params}
    return {k: np.asarray(v) for k, v in mean.items()}, float(
        np.mean(losses))


def _tmean(cfg, tcfg, params, tokens, m):
    """The port's mean gradient, by its own voter_grads and aggregation."""
    tp = tM.params_from_numpy(params, device="cpu")
    per = tokens.shape[0] // m
    total = {}
    for r in range(m):
        g, _ = tTS.voter_grads(cfg, tcfg, tp, torch.as_tensor(
            tokens[r * per:(r + 1) * per]))
        tmv.add_voter_(total, g)
    return {k: v.numpy().copy() for k, v in tmv.tree_mean_(total,
                                                           m).items()}


def _expected(kind, params, state, g, count, lr=np.float32(TLR)):
    """The reference's dense update in numpy float32, each operation
    rounded on its own: (params, m, v) after one step from `state`."""
    f = np.float32
    b1, b2, eps = f(0.9), f(0.999), f(1e-8)
    m = v = None
    if kind == "sgd":
        upd = g
    elif kind == "sgdm":
        m = b1 * state["m"] + g
        upd = m
    else:
        m = b1 * state["m"] + f(1 - 0.9) * g
        v = b2 * state["v"] + (f(1 - 0.999) * g) * g
        bc1 = f(1) - f(0.9) ** f(count)
        bc2 = f(1) - f(0.999) ** f(count)
        upd = (m / bc1) / (np.sqrt(v / bc2) + eps)
    return (params - lr * (upd + f(0) * params)).astype(np.float32), m, v


def _snap(params, opt):
    out = {"params": {k: np.array(v, np.float32) for k, v in params.items()}}
    for key in ("m", "v"):
        if key in opt:
            out[key] = {k: np.array(v, np.float32)
                        for k, v in opt[key].items()}
    return out


def _port_from(state, count):
    tp = tM.params_from_numpy(state["params"], device="cpu")
    ts = {"count": count}
    for key in ("m", "v"):
        if key in state:
            ts[key] = tM.params_from_numpy(state[key], device="cpu")
    return tp, ts


def _port_train_step(cfg, tcfg, m, state, tokens, step):
    art = tTS.make_train_step(cfg, tcfg, m, device="cpu")
    tp, ts = _port_from(state, step)
    tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
    return {"loss": float(met["loss"]), **_snap(
        {k: v.numpy() for k, v in tp.items()},
        {k: {n: t.numpy() for n, t in v.items()} for k, v in ts.items()
         if k in ("m", "v")})}


def _check_dense_step(kind, state, step, ref, port, rg, pg):
    """Each package against its own numpy recomputation, then the two
    against each other (see the module doc)."""
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    outside = total = 0
    for k, p0 in state["params"].items():
        sub = {key: state[key][k] for key in ("m", "v") if key in state}
        np.testing.assert_allclose(pg[k], rg[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        for who, g, new, exact in (("port", pg[k], port, True),
                                   ("ref", rg[k], ref, False)):
            p, m, v = _expected(kind, p0, sub, g, step + 1)
            if exact:
                np.testing.assert_array_equal(new["params"][k], p,
                                              err_msg=(who, k))
                for key, want in (("m", m), ("v", v)):
                    if want is not None:
                        np.testing.assert_array_equal(new[key][k], want,
                                                      err_msg=(key, k))
            else:
                np.testing.assert_allclose(new["params"][k], p, rtol=1e-6,
                                           atol=1e-3 * TLR, err_msg=k)
        if "m" in port:
            np.testing.assert_allclose(port["m"][k], ref["m"][k], atol=1e-6,
                                       err_msg=k)
        if "v" in port:
            np.testing.assert_allclose(port["v"][k], ref["v"][k], rtol=1e-3,
                                       atol=1e-12, err_msg=k)
        a, b = port["params"][k], ref["params"][k]
        assert (np.abs(a - b) <= 2 * TLR).all(), k
        outside += int((~np.isclose(a, b, rtol=1e-6, atol=1e-8)).sum())
        total += a.size
    assert outside <= 1e-3 * total, (outside, total)


def _reference_run(kind, micro, steps=3):
    j, _ = _cfgs()
    jt, _ = _train_cfgs(kind, micro)
    art = jTS.make_train_step(j, jt, mesh=None)
    params, opt = jTS.materialize_state(j, jt, art, jax.random.PRNGKey(0))
    pipe = SyntheticLMPipeline(j, GB, SEQ, seed=0)
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


RUNS = [("sgd", 1), ("sgdm", 1), ("adam", 1), ("adam", 2)]
#: the teacher-forced steps: step 2 of each run, and step 0 of Adam, whose
#: bias correction differs most there (t = 1)
TEACHER_FORCED = [("sgd", 1, 2), ("sgdm", 1, 2), ("adam", 1, 0),
                  ("adam", 1, 2), ("adam", 2, 2)]
_RUNS = {}


def _run(kind, micro):
    """The reference trainer's run of `kind` with `micro` microbatches,
    made once per module."""
    if (kind, micro) not in _RUNS:
        _RUNS[kind, micro] = _reference_run(kind, micro)
    return _RUNS[kind, micro]


@pytest.mark.parametrize("kind,micro,step", TEACHER_FORCED)
def test_m1_teacher_forced_step_matches_reference(kind, micro, step):
    states, losses, batches = _run(kind, micro)
    (j, t), (jt, tt) = _cfgs(), _train_cfgs(kind, micro)
    state = states[step]
    port = _port_train_step(t, tt, 1, state, batches[step], step)
    rg, _ = _jmean(j, jt, state["params"], batches[step], 1)
    pg = _tmean(t, tt, state["params"], batches[step], 1)
    _check_dense_step(kind, state, step,
                      {"loss": losses[step], **states[step + 1]}, port, rg,
                      pg)


@pytest.mark.parametrize("kind,micro", RUNS)
def test_m1_free_running_losses_match_reference(kind, micro):
    states, losses, batches = _run(kind, micro)
    _, t = _cfgs()
    _, tt = _train_cfgs(kind, micro)
    art = tTS.make_train_step(t, tt, 1, device="cpu")
    tp, ts = _port_from(states[0], 0)
    got = []
    for step, tokens in enumerate(batches):
        tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
        got.append(float(met["loss"]))
    assert ts["count"] == len(batches)
    np.testing.assert_allclose(got, losses, rtol=1e-3)


@pytest.mark.parametrize("kind", ["adam"])
def test_m4_trainer_matches_composed_reference(kind):
    """Two M = 4 steps, each teacher-forced, against the reference's update
    of its composed mean gradient (jnp.sum of the 4 voters' gradients /
    4); sgd and sgdm at M = 4: the optimizer's dyadic tests above."""
    (j, t), (jt, tt) = _cfgs(), _train_cfgs(kind)
    jo = jt.optimizer
    params = {k: np.asarray(v) for k, v in jM.init_params(
        j, jax.random.PRNGKey(0)).items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jdense(jo, ()).init(jp)
    pipe = SyntheticLMPipeline(j, GB, SEQ, seed=0)
    for step in range(2):
        tokens = pipe.global_batch_at(step)["tokens"]
        state = _snap(jp, jstate)
        rg, loss = _jmean(j, jt, state["params"], tokens, M4)
        jp, jstate, _ = jdense(jo, ()).update(
            {k: jnp.asarray(v) for k, v in rg.items()}, jstate, jp,
            jnp.int32(step))
        port = _port_train_step(t, tt, M4, state, tokens, step)
        pg = _tmean(t, tt, state["params"], tokens, M4)
        _check_dense_step(kind, state, step,
                          {"loss": loss, **_snap(jp, jstate)}, port, rg, pg)


# ---------------------------------------------------------------------------
# (d) the state layout and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_state_layout_matches_abstract_state(kind, m):
    """{"count", "m"[, "v"]}: float32, leaf-shaped, zeros, as the
    reference's abstract_state lays them out (no voter axis)."""
    (j, t), (jt, tt) = _cfgs(), _train_cfgs(kind)
    _, jstate = jTS.abstract_state(j, jt, jTS.make_train_step(j, jt,
                                                              mesh=None))
    art = tTS.make_train_step(t, tt, m, device="cpu")
    assert art.n_voters == m and art.plan is None
    _, state = tTS.materialize_state(t, tt, art,
                                     torch.Generator().manual_seed(0))
    assert sorted(state) == sorted(jstate)
    assert state["count"] == 0
    for key in ("m", "v"):
        for k, s in jstate.get(key, {}).items():
            got = state[key][k]
            assert tuple(got.shape) == tuple(s.shape), k
            assert got.dtype == torch.float32 and s.dtype == jnp.float32
            assert not got.any()


@pytest.mark.parametrize("scale", [1e-30, 1.0, 1e30])
def test_adam_root_is_the_nearest_float32(scale):
    """``signum.sqrt_rn_`` (Adam's root): the nearest float32 of the
    square root, as numpy's and XLA's; PyTorch's own CPU sqrt misses it on
    some of these inputs."""
    x = (_rng("sqrt", scale).random(1 << 16) * scale).astype(np.float32)
    want = np.sqrt(x)
    got = tsignum.sqrt_rn_(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(np.asarray(jnp.sqrt(x))),
                                  _bits(want))


def test_facade_reexports_the_optimizers():
    assert toptim.build_optimizer is tsignum.build_optimizer
    assert toptim.make_dense_optimizer is tsignum.make_dense_optimizer
    assert toptim.make_sign_optimizer is tsignum.make_sign_optimizer
    assert toptim.lr_at is tsignum.lr_at
    assert toptim.Optimizer is tsignum.Optimizer
    assert sorted(toptim.__all__) == sorted(
        __import__("repro.optim", fromlist=["__all__"]).__all__)


@pytest.mark.parametrize("change,item", [
    # fsdp (the fused ZeRO backward's mean) and remat="dots" run since the
    # thirteenth slice
    ({"fsdp": True}, None),
    ({"remat": "dots"}, None),
    # AUTO over 4 voters resolves under the H100 link model since the
    # fifteenth slice (the dense baselines ignore the wire)
    ({"optimizer": {"vote_strategy": tbase.VoteStrategy.AUTO}}, None),
], ids=["fsdp", "remat_dots", "auto_m4"])
def test_dense_trainer_still_refuses(change, item):
    """fsdp (the fused ZeRO backward's mean, the layers' matrices fused),
    remat="dots" and AUTO over 4 voters (resolved for every kind, as the
    reference resolves it) build and train a finite step at M = 4 (item
    None); an item names what still raises."""
    _, t = _cfgs()
    _, tcfg = _train_cfgs("adam")
    opt = change.pop("optimizer", None)
    if opt:
        change["optimizer"] = dataclasses.replace(tcfg.optimizer, **opt)
    tcfg = dataclasses.replace(tcfg, **change)
    if item is None:
        art = tTS.make_train_step(t, tcfg, M4, device="cpu")
        assert bool(art.fused_leaves) == tcfg.fsdp
        params, state = tTS.materialize_state(
            t, tcfg, art, torch.Generator().manual_seed(0))
        _, _, met = art.step_fn(params, state, {"tokens": torch.zeros(
            (GB, SEQ), dtype=torch.int64)}, 0)
        assert np.isfinite(float(met["loss"]))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tTS.make_train_step(t, tcfg, M4, device="cpu")
