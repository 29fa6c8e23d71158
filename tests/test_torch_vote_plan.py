"""The port's bucketed VotePlan (``repro_torch.core.vote_plan``), its walk
in the vote API, and the optimizer's and the trainer's plan path,
``overlap`` and ``delayed_vote``, held against the JAX package on the same
numpy inputs (the deterministic cases of ``tests/test_vote_plan.py``).

Equality is exact: manifests and buckets equal; votes, server state,
parameters and the (step-0, or bf16) momentum bit-equal. Two quantities
are held to a tolerance, each for a reason of the reference's: float32
momentum after step 0, which XLA contracts into an FMA (rtol 1e-6, as
``tests/test_kernels.py`` holds it), and ef_sign's residual, whose
mean|t| both packages sum in their own order (rtol 1e-6 and 1e-5 of
mean|t|). The trainer's
steps are held as ``tests/test_torch_train_step.py`` holds them, with
its helpers (``tests/torch_train_step_common.py``; gradients from two
frameworks), and the plan path of the port bit for
bit against its own leaf-wise path, which those tests hold.
"""
import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

import torch_train_step_common as tts  # noqa: E402
from repro.configs.base import MomentumMode as JMode  # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt  # noqa: E402
from repro.configs.base import VoteStrategy as JS  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core import vote_plan as jvp  # noqa: E402
from repro.core.signum import build_optimizer  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import signum as tsignum  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

SHAPES = {"embed.table": (7, 9), "layers.w_gate": (5, 11),
          "layers.norm": (3,), "unembed.table": (6, 4)}
#: the reference's overlap equivalence matrix (tests/test_vote_plan.py)
OVERLAP_MATRIX = [
    ("sign1bit", "psum_int8"), ("sign1bit", "allgather_1bit"),
    ("sign1bit", "hierarchical"), ("ternary2bit", "psum_int8"),
    ("ternary2bit", "allgather_1bit"), ("weighted_vote", "allgather_1bit"),
]


def _rng(*salt):
    """A numpy generator seeded from `salt` (strings by their crc32)."""
    return np.random.default_rng(
        [17, *(zlib.crc32(s.encode()) if isinstance(s, str) else s
              for s in salt)])


def _both(fn, **kw):
    """fn(package, **kw) for (reference, port): strategies by value."""
    def conv(pkg_s, v):
        return pkg_s(v) if isinstance(v, str) and v in {
            s.value for s in pkg_s} else v
    ref = fn(jvp, **{k: conv(JS, v) if k == "strategy" else v
                     for k, v in kw.items()})
    port = fn(tvp, **{k: conv(tbase.VoteStrategy, v) if k == "strategy"
                      else v for k, v in kw.items()})
    return ref, port


def _manifest(plan):
    return (plan.n_params, plan.bucket_bytes,
            tuple((g.codec, g.strategy.value, g.start, g.total,
                   g.bucket_bytes,
                   tuple((s.name, s.offset, s.length, s.shape, s.dtype)
                         for s in g.leaves),
                   tuple((b.codec, b.strategy.value, b.start, b.length)
                         for b in g.buckets))
                  for g in plan.groups),
            plan.has_server_state, plan.worker_state_leaves,
            tuple(sorted(plan.leaf_codecs().items())))


def _build(pkg, shapes=SHAPES, **kw):
    return pkg.build_plan(shapes, **kw)


# ---------------------------------------------------------------------------
# building: manifest + schedule
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "shapes_bb8": dict(bucket_bytes=8),
    "reversed_insertion": dict(shapes=dict(reversed(list(SHAPES.items()))),
                               bucket_bytes=8),
    "aligned_200": dict(shapes={"a": (200,)}, bucket_bytes=8),
    "hierarchical_ds8": dict(shapes={"a": (2000,)}, bucket_bytes=8,
                             strategy="hierarchical", data_size=8),
    "hierarchical_ds4": dict(bucket_bytes=3, strategy="hierarchical",
                             data_size=4),
    "codec_map": dict(bucket_bytes=16, strategy="allgather_1bit",
                      codec_map=(("embed*", "ternary2bit"),
                                 ("*.table", "weighted_vote"),
                                 ("*", "sign1bit"))),
    "ef_subset": dict(bucket_bytes=8, codec_map=(("embed*", "ef_sign"),)),
    "dtypes_and_scalar": dict(shapes={**SHAPES, "scale": ()},
                              bucket_bytes=1,
                              dtypes={"layers.w_gate": "bfloat16"}),
    "auto_single_voter": dict(shapes={"a": (64,)}, bucket_bytes=8,
                              data_size=1),
    "auto_single_voter_weighted": dict(bucket_bytes=5,
                                       default_codec="weighted_vote"),
    "overlap_flag": dict(bucket_bytes=8, strategy="allgather_1bit",
                         overlap=True, data_size=4),
    **{f"count_bound_n{n}_bb{bb}": dict(shapes={"a": (n,)}, bucket_bytes=bb,
                                        strategy="allgather_1bit")
       for n in (31, 64, 1000, 4097) for bb in (1, 3, 8, 100)},
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_manifest_matches_reference(case):
    """Manifest, groups and bucket schedule equal to the reference's, and
    the reference's own properties hold: leaves cover [0, n) once, buckets
    align to the group's pack width with only each group's last one
    ragged, and their count stays within ceil(n * bits / 8 / bb)."""
    ref, port = _both(_build, **PLAN_CASES[case])
    assert _manifest(port) == _manifest(ref)
    seen = sorted((s.offset, s.offset + s.length) for s in port.leaves)
    assert seen[0][0] == 0 and seen[-1][1] == port.n_params
    assert all(e == b for (_, e), (b, _) in zip(seen, seen[1:]))
    for g in port.groups:
        align = tvp._group_align(g.strategy, PLAN_CASES[case].get(
            "data_size", 1))
        assert all(b.length % align == 0 for b in g.buckets[:-1])
        bits = tvp.codecs_mod.get_codec(g.codec).bits_per_param
        assert len(g.buckets) <= -(-int(g.total * bits) // (8 * g.bucket_bytes))
        assert sum(b.length for b in g.buckets) == g.total


def test_manifest_is_deterministic_and_aligned():
    p1 = tvp.build_plan(SHAPES, bucket_bytes=8)
    assert p1 == tvp.build_plan(dict(reversed(list(SHAPES.items()))),
                                bucket_bytes=8)
    plan = tvp.build_plan({"a": (200,)}, bucket_bytes=8)
    assert [b.length for b in plan.buckets] == [64, 64, 64, 8]
    assert [b.start for b in plan.buckets] == [0, 64, 128, 192]
    lc = tvp.build_plan(**{"shapes": SHAPES, **PLAN_CASES["codec_map"]}
                        ).leaf_codecs()
    assert (lc["embed.table"], lc["unembed.table"], lc["layers.w_gate"]) \
        == ("ternary2bit", "weighted_vote", "sign1bit")


BUILD_ERRORS = {
    "unknown_codec": ("unknown codec",
                      dict(bucket_bytes=8, codec_map=(("*", "morse"),))),
    "zero_bucket_bytes": ("bucket_bytes", dict(bucket_bytes=0)),
    "negative_bucket_bytes": ("bucket_bytes", dict(bucket_bytes=-5)),
    "empty_pattern": ("empty", dict(bucket_bytes=8,
                                    codec_map=(("", "sign1bit"),))),
    "empty_tree": ("empty tree", dict(shapes={}, bucket_bytes=8)),
    "cannot_ride": ("cannot ride", dict(
        bucket_bytes=8, codec_map=(("*", "weighted_vote"),),
        strategy="psum_int8")),
}


@pytest.mark.parametrize("case", sorted(BUILD_ERRORS))
def test_build_validation_matches_reference(case):
    match, kw = BUILD_ERRORS[case]
    msgs = []
    for pkg, strat in ((jvp, JS), (tvp, tbase.VoteStrategy)):
        args = {k: strat(v) if k == "strategy" else v for k, v in kw.items()}
        with pytest.raises(ValueError, match=match) as e:
            _build(pkg, **args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


PRICED = {
    "auto_over_voters": lambda: tvp.build_plan(
        {"a": (100_000,)}, bucket_bytes=256, data_size=16),
    "auto_bucket_bytes": lambda: tvp.build_plan(
        {"a": (50_000,)}, bucket_bytes=tvp.AUTO_BUCKET_BYTES,
        strategy=tbase.VoteStrategy.ALLGATHER_1BIT, data_size=8),
    "auto_bucket_bytes_one_voter": lambda: tvp.build_plan(
        {"a": (64,)}, bucket_bytes=tvp.AUTO_BUCKET_BYTES),
    "schedule_cost": lambda: tvp.build_plan(
        {"a": (65536,)}, bucket_bytes=64,
        strategy=tbase.VoteStrategy.ALLGATHER_1BIT).schedule_cost(16),
    "trainer_auto_ladder": lambda: tTS.make_train_step(
        *_plan_tcfgs(bucket_bytes=-1), 1, device="cpu"),
}


@pytest.mark.parametrize("case", sorted(PRICED))
def test_priced_auto_raises_naming_item_15(case):
    """The reference prices these with TPU v5e constants; the port has no
    H100 link model yet."""
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP.md Queue 1 item 15\b"):
        PRICED[case]()


@pytest.mark.parametrize("codec", ["sign1bit", "ef_sign", "ternary2bit",
                                   "weighted_vote"])
def test_single_candidate_auto_resolves_as_reference(codec):
    """AUTO with one voter has one candidate (psum_int8 where the codec
    rides it, else the codec's first strategy): no price can change it."""
    ref, port = _both(_build, bucket_bytes=8, default_codec=codec,
                      data_size=1)
    assert _manifest(port) == _manifest(ref)
    assert port.groups[0].strategy.value == (
        "allgather_1bit" if codec == "weighted_vote" else "psum_int8")


# ---------------------------------------------------------------------------
# flatten -> unflatten
# ---------------------------------------------------------------------------


def test_flatten_unflatten_roundtrip_mixed_dtypes_matches_reference():
    """float32, bf16 and float16 leaves, a scalar leaf, and planted
    zeros, -0.0 and float32 / bf16 subnormals (which the reference reads as
    0: ``sign_ternary`` abstains; a float16 subnormal is a normal float32
    and keeps its sign)."""
    shapes = {**SHAPES, "scale": ()}
    dtypes = {"embed.table": "float32", "layers.w_gate": "float16",
              "layers.norm": "bfloat16", "unembed.table": "float32",
              "scale": "float32"}
    rng = _rng(1)
    vals = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    vals["embed.table"].reshape(-1)[:6] = [1e-39, -1e-39, 1.4e-45, -0.0,
                                           0.0, -1.4e-45]
    vals["layers.norm"][:] = [-1e-39, 1e-39, -0.0]
    vals["layers.w_gate"].reshape(-1)[:2] = [1e-7, -1e-7]   # f16 subnormal
    vals["scale"] = np.float32(-1e-39)
    jtree = {k: jnp.asarray(v).astype(dtypes[k]) for k, v in vals.items()}
    ttree = {k: torch.from_numpy(np.asarray(jtree[k].astype(jnp.float32))
                                 .copy()).to(getattr(torch, dtypes[k]))
             for k in shapes}
    jplan, tplan = _both(_build, shapes=shapes, bucket_bytes=4)
    jflat = np.asarray(jvp.flatten_signs(jplan, jtree))
    tflat = tvp.flatten_signs(tplan, ttree)
    assert tflat.dtype == torch.int8 and tflat.shape == (tplan.n_params,)
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    scale = {s.name: s for s in tplan.leaves}["scale"]
    assert (jflat[:6] == 0).all() and jflat[scale.offset] == 0
    back = tvp.unflatten_votes(tplan, tflat, ttree)
    jback = jvp.unflatten_votes(jplan, jnp.asarray(jflat), jtree)
    for k in shapes:
        assert back[k].dtype == ttree[k].dtype
        assert tuple(back[k].shape) == shapes[k]
        np.testing.assert_array_equal(back[k].float().numpy(),
                                      np.asarray(jback[k], np.float32))


def test_flatten_rejects_shape_drift():
    rng = _rng(2)
    tree = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in SHAPES.items()}
    plan = tvp.build_plan(SHAPES, bucket_bytes=4)
    tree["layers.norm"] = torch.zeros(4)
    with pytest.raises(ValueError, match="manifest"):
        tvp.flatten_signs(plan, tree)
    jtree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    with pytest.raises(ValueError, match="manifest"):
        jvp.flatten_signs(jvp.build_plan(SHAPES, bucket_bytes=4), jtree)


# ---------------------------------------------------------------------------
# the walk: votes and server state against the reference
# ---------------------------------------------------------------------------


def _signs(m, n, *salt, binary=False):
    rng = _rng(*salt)
    if binary:
        return np.where(rng.integers(0, 2, size=(m, n)), 1, -1).astype(
            np.int8)
    return rng.integers(-1, 2, size=(m, n)).astype(np.int8)


def _state(codec, m, ema=None):
    if ema is not None:
        return ({"flip_ema": jnp.asarray(ema)},
                {"flip_ema": torch.from_numpy(ema.copy())})
    j = jcodecs.get_codec(codec).init_server_state(m)
    return (j or None), ({k: torch.from_numpy(np.array(v))
                          for k, v in j.items()} or None)


def _vote_both(payload, jplan, tplan, jstate, tstate, overlap=False):
    jout = jva.VirtualBackend().execute(jva.VoteRequest(
        payload=jnp.asarray(payload), form="stacked", plan=jplan,
        server_state=jstate, overlap=overlap))
    tout = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
        payload=payload, form="stacked", plan=tplan, server_state=tstate,
        overlap=overlap))
    return jout, tout


def _assert_outcomes_equal(jout, tout):
    np.testing.assert_array_equal(tout.votes.numpy(), np.asarray(jout.votes))
    assert sorted(tout.server_state) == sorted(jout.server_state)
    for k in jout.server_state:
        np.testing.assert_array_equal(
            np.asarray(tout.server_state[k]).view(np.uint32),
            np.asarray(jout.server_state[k]).view(np.uint32))
    jw, tw = jout.wire, tout.wire
    assert (tw.n_voters, tw.payload_bytes, tw.n_messages,
            tw.strategy.value if tw.strategy else None) == (
        jw.n_voters, jw.payload_bytes, jw.n_messages,
        jw.strategy.value if jw.strategy else None)


@pytest.mark.parametrize("codec", ["ef_sign", "sign1bit", "ternary2bit",
                                   "weighted_vote"])
def test_identity_under_every_codec_matches_reference(codec):
    """flatten -> bucket -> vote -> unflatten on an uneven cut: the port's
    plan walk equals the reference's, and equals the port's own
    whole-buffer codec vote."""
    m, n = 9, 61
    signs = _signs(m, n, 3)
    jplan, tplan = _both(_build, shapes={"x": (n,)}, bucket_bytes=4,
                         strategy="allgather_1bit", default_codec=codec)
    jstate, tstate = _state(codec, m)
    jout, tout = _vote_both(signs, jplan, tplan, jstate, tstate)
    _assert_outcomes_equal(jout, tout)
    whole = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
        payload=signs, form="stacked", codec=codec, server_state=tstate,
        strategy=tbase.VoteStrategy.ALLGATHER_1BIT))
    assert torch.equal(whole.votes, tout.votes)


@pytest.mark.parametrize("bb", [2, 5, 9])
def test_weighted_multi_bucket_ema_matches_reference(bb):
    """Weights fixed for the step, ONE EMA update over the flat buffer's
    true coordinates: bit-equal to the reference's walk at every cut."""
    m, n = 8, 100
    signs = _signs(m, n, 4, bb, binary=True)
    ema = _rng(5, bb).uniform(0.1, 0.6, size=(m,)).astype(np.float32)
    jplan, tplan = _both(_build, shapes={"x": (n,)}, bucket_bytes=bb,
                         strategy="allgather_1bit",
                         default_codec="weighted_vote")
    assert tplan.n_buckets > 1
    jstate, tstate = _state("weighted_vote", m, ema)
    _assert_outcomes_equal(*_vote_both(signs, jplan, tplan, jstate, tstate))


@pytest.mark.parametrize("codec,strategy", OVERLAP_MATRIX)
def test_overlap_equals_sync_and_reference(codec, strategy):
    """overlap=True reorders issue and complete only: the votes, server
    state and wire report are bit-identical to the synchronous walk, and
    both to the reference's."""
    m, n = 9, 261
    signs = _signs(m, n, 6, codec, strategy)
    jplan, tplan = _both(_build, shapes={"x": (n,)}, bucket_bytes=8,
                         strategy=strategy, default_codec=codec)
    assert tplan.n_buckets > 1
    jstate, tstate = _state(codec, m)
    outs = {ov: _vote_both(signs, jplan, tplan, jstate, tstate, ov)
            for ov in (False, True)}
    _assert_outcomes_equal(outs[False][0], outs[False][1])
    _assert_outcomes_equal(outs[True][0], outs[True][1])
    _assert_outcomes_equal(outs[False][0], outs[True][1])


def test_mixed_codec_plan_matches_reference_on_real_values():
    """A codec map of three groups (ternary2bit, weighted_vote, sign1bit) on
    float32 values with planted zeros and subnormals; the wire report's
    strategy is None only where the groups differ."""
    m = 5
    shapes = {**SHAPES, "scale": ()}
    kw = dict(shapes=shapes, **{k: v for k, v in
                                PLAN_CASES["codec_map"].items()})
    jplan, tplan = _both(_build, **kw)
    x = _rng(7).normal(size=(m, tplan.n_params)).astype(np.float32)
    x[:, ::9] = 0.0
    x[:, 1::9] = -1e-39
    x[1:, 2::9] = 1e-39
    jstate, tstate = _state("weighted_vote", m)
    _assert_outcomes_equal(*_vote_both(x, jplan, tplan, jstate, tstate))


def test_plan_vote_stacked_matches_walk_and_reference():
    m, n = 7, 333
    stacked = _rng(8).normal(size=(m, n)).astype(np.float32)
    stacked[:, ::5] = -1e-39
    jplan, tplan = _both(_build, shapes={"a": (128,), "b": (205,)},
                         bucket_bytes=8, strategy="allgather_1bit")
    x = torch.from_numpy(stacked)
    got = tvp.plan_vote_stacked(tplan, x)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jvp.plan_vote_stacked(jplan,
                                                      jnp.asarray(stacked))))
    staged = tvp.plan_vote_stacked(tplan, x, use_kernels=False)
    walk = tva.VirtualBackend(device="cpu").execute(tva.VoteRequest(
        payload=x, form="stacked", plan=tplan)).votes
    assert torch.equal(got, staged) and torch.equal(got, walk)
    tern_j, tern_t = _both(_build, shapes={"a": (333,)}, bucket_bytes=8,
                           strategy="allgather_1bit",
                           default_codec="ternary2bit")
    np.testing.assert_array_equal(
        tvp.plan_vote_stacked(tern_t, x).numpy(),
        np.asarray(jvp.plan_vote_stacked(tern_j, jnp.asarray(stacked))))


class _CopyingWire(tvp.VirtualBucketWire):
    """The walk as it was before bitpack took a row stride: every bucket
    copied contiguous before its issue."""

    def issue(self, bucket, seg):
        return super().issue(bucket, seg.contiguous())


@pytest.mark.parametrize("overlap", [False, True])
def test_plan_packs_1bit_buckets_in_place(monkeypatch, overlap):
    """A plan of 1-bit and weighted_vote buckets: bitpack reads every
    bucket as a view of the stacked buffer (its rows n_params apart, no
    copy), and the votes and flip-rate state equal both a walk that copies
    each bucket first and the reference's walk."""
    m = 5
    kw = dict(bucket_bytes=8, strategy="allgather_1bit",
              codec_map=(("embed*", "weighted_vote"), ("*", "sign1bit")))
    jplan, tplan = _both(_build, **kw)
    assert {b.codec for b in tplan.buckets} == {"weighted_vote", "sign1bit"}
    signs = _signs(m, tplan.n_params, 11, binary=True)
    buf = torch.from_numpy(signs)
    views = []
    real = tva.vote_plan.ops.bitpack

    def spy(x, **kwargs):
        if x.dim() == 2 and x.shape[0] == m:    # a bucket, not a vote row
            views.append((x.stride(), x.data_ptr()))
        return real(x, **kwargs)

    monkeypatch.setattr(tva.vote_plan.ops, "bitpack", spy)
    ema = _rng(12).uniform(0.1, 0.6, size=(m,)).astype(np.float32)
    jstate, tstate = _state("weighted_vote", m, ema)
    got, state = tvp.run_schedule(tplan, buf, tvp.VirtualBucketWire(m),
                                  tstate, overlap=overlap)
    starts = [buf.data_ptr() + b.start for b in tplan.buckets]
    assert views == [((tplan.n_params, 1), p) for p in starts]
    want, want_state = tvp.run_schedule(tplan, buf, _CopyingWire(m), tstate,
                                        overlap=overlap)
    assert torch.equal(got, want)
    assert torch.equal(state["flip_ema"], want_state["flip_ema"])
    jout, tout = _vote_both(signs, jplan, tplan, jstate, tstate, overlap)
    _assert_outcomes_equal(jout, tout)
    assert torch.equal(tout.votes, got)
    # plan_vote_stacked's staged branch packs the views too
    views.clear()
    stacked = tvp.plan_vote_stacked(_build(tvp, bucket_bytes=8,
                                           strategy="allgather_1bit"),
                                    buf, use_kernels=False)
    assert views and all(v[0] == (tplan.n_params, 1) for v in views)
    assert torch.equal(stacked, tvp.plan_vote_stacked(
        _build(tvp, bucket_bytes=8, strategy="allgather_1bit"), buf))


@pytest.mark.parametrize("case", ["psum_int8", "weighted_vote"])
def test_plan_vote_stacked_rejects_as_reference(case):
    kw = (dict(strategy="psum_int8") if case == "psum_int8" else
          dict(strategy="allgather_1bit", default_codec="weighted_vote"))
    jplan, tplan = _both(_build, shapes={"a": (64,)}, bucket_bytes=8, **kw)
    x = _rng(9).normal(size=(4, 64)).astype(np.float32)
    msgs = []
    for fn, plan, arr in ((jvp.plan_vote_stacked, jplan, jnp.asarray(x)),
                          (tvp.plan_vote_stacked, tplan,
                           torch.from_numpy(x))):
        with pytest.raises(ValueError) as e:
            fn(plan, arr)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("what", ["plan", "overlap"])
def test_kernel_backend_rejects_plan_as_reference(what):
    x = _rng(10).normal(size=(4, 64)).astype(np.float32)
    jplan, tplan = _both(_build, shapes={"a": (64,)}, bucket_bytes=8,
                         strategy="allgather_1bit")
    ov = what == "overlap"
    jreq = jva.VoteRequest(payload=jnp.asarray(x), form="stacked",
                           plan=jplan, overlap=ov)
    treq = tva.VoteRequest(payload=x, form="stacked", plan=tplan,
                           overlap=ov)
    tvb = tva.VirtualBackend(use_kernels=True, device="cpu")
    assert tvb.why_unsupported(treq) == \
        jva.VirtualBackend(use_kernels=True).why_unsupported(jreq)
    with pytest.raises(ValueError, match="fused-kernel path"):
        tvb.execute(treq)


REQUEST_ERRORS = {
    "coords": lambda va, plan, x, st: va.VoteRequest(
        payload=x[:, :-1], form="stacked", plan=plan),
    "overlap_without_plan": lambda va, plan, x, st: va.VoteRequest(
        payload=x, form="stacked", overlap=True),
    "missing_server_state": lambda va, plan, x, st: va.VoteRequest(
        payload=x, form="stacked", plan=plan),
}


@pytest.mark.parametrize("case", sorted(REQUEST_ERRORS))
def test_plan_request_validation_matches_reference(case):
    x = np.zeros((4, 64), np.float32)
    jplan, tplan = _both(_build, shapes={"a": (64,)}, bucket_bytes=8,
                         strategy="allgather_1bit",
                         default_codec="weighted_vote")
    msgs = []
    for va, plan in ((jva, jplan), (tva, tplan)):
        with pytest.raises(ValueError) as e:
            REQUEST_ERRORS[case](va, plan, x, None)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the optimizer's plan path, overlap and delayed vote (one voter, as the
# reference's single-process optimizer tests run it)
# ---------------------------------------------------------------------------


def _trees(salt, shapes=SHAPES):
    rng = _rng(11, salt)
    vals = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in vals.items()},
            {k: torch.from_numpy(v.copy()) for k, v in vals.items()})


def _jopt(**kw):
    return JOpt(kind="signum_vote", learning_rate=0.05, **kw)


def _topt(**kw):
    return tbase.OptimizerConfig(kind="signum_vote", learning_rate=0.05,
                                 **kw)


def _port_update(opt, grads, state, params, step):
    wire = opt.wire(params)
    opt.encode(0, grads, state, wire)
    opt.update(wire, state, params, step)


def _assert_params(tparams, jparams):
    for k, v in jparams.items():
        np.testing.assert_array_equal(
            tparams[k].numpy().view(np.uint32),
            np.asarray(v).view(np.uint32), err_msg=k)


OPT_CASES = {
    "plan": dict(bucket_bytes=8),
    "plan_overlap": dict(bucket_bytes=8, overlap=True),
    "plan_codec_map": dict(bucket_bytes=8,
                           codec_map=(("embed*", "ternary2bit"),
                                      ("unembed*", "weighted_vote"))),
    "plan_bf16_momentum": dict(bucket_bytes=8, momentum_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_plan_path_matches_reference(case):
    """Two steps of the optimizer's plan path against the reference's
    ``build_optimizer(cfg, (), plan=plan)``: parameters bit-equal, the
    momentum bit-equal at step 0 (and at step 1 with bf16 momentum), the
    server state bit-equal. Step 0's update also equals the port's
    leaf-wise update (the reference's single-voter plan votes sign_ternary,
    which the leaf-wise count wire votes)."""
    kw = OPT_CASES[case]
    jparams, tparams = _trees(0)
    jplan = jvp.build_plan(SHAPES, bucket_bytes=8,
                           codec_map=kw.get("codec_map", ()))
    tplan = tvp.build_plan(SHAPES, bucket_bytes=8,
                           codec_map=kw.get("codec_map", ()))
    jo = build_optimizer(_jopt(**kw), (), plan=jplan)
    to = tsignum.make_sign_optimizer(_topt(**kw), 1, tplan)
    js, ts = jo.init(jparams), to.init(tparams)
    assert sorted(ts) == sorted(js)
    for step in range(2):
        jg, tg = _trees(1 + step)
        jparams, js, _ = jo.update(jg, js, jparams, jnp.int32(step))
        _port_update(to, tg, ts, tparams, step)
        _assert_params(tparams, jparams)
        for k in jparams:
            tm = ts["momentum"][k][0]
            jm = np.asarray(js["momentum"][k])
            if step == 0 or tm.dtype == torch.bfloat16:
                np.testing.assert_array_equal(tm.float().numpy(),
                                              jm.astype(np.float32))
            else:   # XLA contracts beta*m + (1-beta)*g into an FMA
                np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6)
        for k in js.get("codec", {}):
            np.testing.assert_array_equal(ts["codec"][k].numpy(),
                                          np.asarray(js["codec"][k]))
        if step == 0 and "codec_map" not in kw:
            lw = tsignum.make_sign_optimizer(
                _topt(momentum_dtype=kw.get("momentum_dtype", "float32")),
                1)
            p0 = _trees(0)[1]
            _port_update(lw, _trees(1)[1], lw.init(p0), p0, 0)
            for k in p0:
                assert torch.equal(p0[k], tparams[k]), k


def test_optimizer_plan_ef_subset_state_matches_reference():
    cmap = (("embed*", "ef_sign"),)
    jparams, tparams = _trees(3)
    jplan = jvp.build_plan(SHAPES, bucket_bytes=8, codec_map=cmap)
    tplan = tvp.build_plan(SHAPES, bucket_bytes=8, codec_map=cmap)
    assert tplan.worker_state_leaves == jplan.worker_state_leaves \
        == ("embed.table",)
    jo = build_optimizer(_jopt(bucket_bytes=8, codec_map=cmap), (),
                         plan=jplan)
    to = tsignum.make_sign_optimizer(_topt(bucket_bytes=8, codec_map=cmap),
                                     1, tplan)
    js, ts = jo.init(jparams), to.init(tparams)
    assert sorted(ts["error"]) == sorted(js["error"]) == ["embed.table"]
    jg, tg = _trees(4)
    jparams, js, _ = jo.update(jg, js, jparams, jnp.int32(0))
    _port_update(to, tg, ts, tparams, 0)
    _assert_params(tparams, jparams)
    assert sorted(ts["error"]) == ["embed.table"]
    e = ts["error"]["embed.table"][0].numpy()
    assert np.abs(e).sum() > 0
    # mean|t| is a float32 sum in each package's own order, a few ulps of
    # the scale apart: e' = t - scale * vote moves by as much
    scale = float(np.mean(np.abs(np.asarray(tg["embed.table"])) * 0.1))
    np.testing.assert_allclose(e, np.asarray(js["error"]["embed.table"]),
                               rtol=1e-6, atol=1e-5 * scale)


@pytest.mark.parametrize("planned", [False, True])
def test_optimizer_delayed_vote_lags_exactly_one_step(planned):
    """delayed_vote banks step t's vote and applies it at t+1: step 0 moves
    nothing (weight decay 0), the momentum never lags, and step 1's
    parameters equal the synchronous step 0's; bit-equal to the reference
    with and without a plan."""
    kw = dict(bucket_bytes=8) if planned else {}
    jp0, tp0 = _trees(5)
    jplan = jvp.build_plan(SHAPES, bucket_bytes=8) if planned else None
    tplan = tvp.build_plan(SHAPES, bucket_bytes=8) if planned else None
    jd = build_optimizer(_jopt(delayed_vote=True, **kw), (), plan=jplan)
    td = tsignum.make_sign_optimizer(_topt(delayed_vote=True, **kw), 1,
                                     tplan)
    ts_ = tsignum.make_sign_optimizer(_topt(**kw), 1, tplan)
    jstate, tstate = jd.init(jp0), td.init(tp0)
    assert sorted(tstate["delayed"]) == sorted(jstate["delayed"])
    assert all(v.dtype == torch.int8 and not v.any()
               and tuple(v.shape) == SHAPES[k]
               for k, v in tstate["delayed"].items())
    jparams, tparams = dict(jp0), {k: v.clone() for k, v in tp0.items()}
    sync_p = {k: v.clone() for k, v in tp0.items()}
    sync_s = ts_.init(sync_p)
    for step in range(2):
        jg, tg = _trees(6 + step)
        jparams, jstate, _ = jd.update(jg, jstate, jparams, jnp.int32(step))
        _port_update(td, tg, tstate, tparams, step)
        _assert_params(tparams, jparams)
        for k in jstate["delayed"]:
            np.testing.assert_array_equal(tstate["delayed"][k].numpy(),
                                          np.asarray(jstate["delayed"][k]))
        if step == 0:
            for k in tp0:
                assert torch.equal(tparams[k], tp0[k]), k
            _port_update(ts_, tg, sync_s, sync_p, 0)
            for k in tp0:
                assert torch.equal(tstate["momentum"][k],
                                   sync_s["momentum"][k]), k
    for k in tp0:    # step 1 applied exactly step 0's vote
        assert torch.equal(tparams[k], sync_p[k]), k


CONFIG_ERRORS = {
    "codec_map_without_plan": ("bucket_bytes > 0", dict(
        codec_map=(("embed*", "ternary2bit"),))),
    "delayed_without_vote": ("no vote", dict(kind="sgd", delayed_vote=True)),
    "delayed_mode_b": ("per_worker", dict(kind="signum_vote",
                                          delayed_vote=True,
                                          momentum_mode="global")),
    "overlap_without_plan": ("overlap", dict(kind="signum_vote",
                                             overlap=True)),
    "bucket_bytes_below_auto": ("bucket_bytes", dict(bucket_bytes=-2)),
}


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_config_validation_matches_reference(case):
    match, kw = CONFIG_ERRORS[case]
    msgs = []
    for opt, mode in ((JOpt, JMode), (tbase.OptimizerConfig,
                                      tbase.MomentumMode)):
        args = {k: mode(v) if k == "momentum_mode" else v
                for k, v in kw.items()}
        with pytest.raises(ValueError, match=match) as e:
            opt(learning_rate=0.1, **args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # the valid spellings
    tbase.OptimizerConfig(codec_map=(("embed*", "ternary2bit"),),
                          bucket_bytes=4096)
    tbase.OptimizerConfig(overlap=True, bucket_bytes=tvp.AUTO_BUCKET_BYTES)


# ---------------------------------------------------------------------------
# the trainer's plan path
# ---------------------------------------------------------------------------


def _plan_tcfgs(**opt):
    cfg, tcfg = tts._tcfgs()
    return cfg, dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, **opt))


def test_m1_plan_trainer_matches_reference_trainer():
    """M = 1 with bucket_bytes > 0 and AUTO: both trainers build a
    psum_int8 plan (one candidate), which votes sign_ternary of m'; the
    port's step is held to the reference's as the leaf-wise M = 1 steps
    are, on the count wire (an exactly-zero m' abstains in both)."""
    jcfg, jt = tts._jcfgs()
    jt = dataclasses.replace(jt, optimizer=dataclasses.replace(
        jt.optimizer, vote_strategy=JS.AUTO, bucket_bytes=4096))
    states, losses, batches = tts._reference_trainer_run("sign1bit", 2, jt)
    assert jTS.make_train_step(jcfg, jt, mesh=None).plan is not None
    cfg, tt = _plan_tcfgs(vote_strategy=tbase.VoteStrategy.AUTO,
                          bucket_bytes=4096)
    art = tTS.make_train_step(cfg, tt, 1, device="cpu")
    assert art.plan is not None and art.plan.n_buckets > 1
    assert art.vote_strategy == tbase.VoteStrategy.PSUM_INT8
    for step in range(2):
        port = tts._port_step(1, states[step], batches[step], step,
                              tcfg=tt)
        ref = {"loss": losses[step], **states[step + 1]}
        tts._check_teacher_forced(states[step], ref, port, count_wire=True)


def _port_run(n_voters, tcfg, state, batches):
    """The port's trainer from the numpy `state` over `batches`: per step
    a snapshot (params, momentum, delayed votes or None, loss)."""
    cfg, _ = tts._tcfgs()
    art = tTS.make_train_step(cfg, tcfg, n_voters, device="cpu")
    tp, ts = tts._port_state(state)
    for key, fresh in art.optimizer.init(tp).items():
        ts.setdefault(key, fresh)    # a codec's or the delayed vote's zeros

    def clone(tree):
        return {k: v.clone() for k, v in tree.items()}

    runs = []
    for step, tokens in enumerate(batches):
        tp, ts, met = art.step_fn(tp, ts, {"tokens": tokens}, step)
        runs.append((clone(tp), clone(ts["momentum"]),
                     clone(ts["delayed"]) if "delayed" in ts else None,
                     float(met["loss"])))
    return runs


@pytest.fixture(scope="module")
def ref_m4_plan():
    return tts._composed_run("sign1bit", 2)


@pytest.fixture(scope="module")
def leafwise_m4(ref_m4_plan):
    """The port's leaf-wise sign1bit trainer at M = 4 over the same two
    batches (held to the composed reference by tests/test_torch_train_
    step.py)."""
    states, _, batches = ref_m4_plan
    return _port_run(tts.M4, _plan_tcfgs()[1], states[0], batches)


def test_m4_plan_trainer_matches_composed_reference_and_leafwise(
        ref_m4_plan, leafwise_m4):
    """M = 4, allgather_1bit, buckets of 256 bytes: the teacher-forced step
    is held to the step composed from JAX functions, and two free-running
    steps are bit-equal to the port's leaf-wise trainer (the same
    gradients): parameters, momentum and losses; likewise with
    overlap=True."""
    states, losses, batches = ref_m4_plan
    _, tt = _plan_tcfgs(bucket_bytes=256)
    port = tts._port_step(tts.M4, states[0], batches[0], 0, tcfg=tt)
    tts._check_teacher_forced(states[0], {"loss": losses[0], **states[1]},
                              port)
    for tcfg in (tt, _plan_tcfgs(bucket_bytes=256, overlap=True)[1]):
        got = _port_run(tts.M4, tcfg, states[0], batches)
        for (gp, gm, _, gl), (wp, wm, _, wl) in zip(got, leafwise_m4):
            assert gl == wl
            for k in wp:
                assert torch.equal(gp[k], wp[k]), k
                assert torch.equal(gm[k], wm[k]), k


@pytest.mark.parametrize("codec", ["ternary2bit", "weighted_vote"])
def test_m4_codec_map_trainer_equals_leafwise_codecs(ref_m4_plan,
                                                     leafwise_m4, codec):
    """A codec map: the embedding on `codec`, the rest on sign1bit. One
    step's embedding equals the leaf-wise `codec` trainer's and every
    other leaf the leaf-wise sign1bit trainer's, bit for bit (weighted_vote
    from its zero prior, whose equal weights decode the plain majority)."""
    states, _, batches = ref_m4_plan
    _, tt = _plan_tcfgs(bucket_bytes=256, codec_map=(("embed*", codec),))
    art = tTS.make_train_step(tts._tcfgs()[0], tt, tts.M4, device="cpu")
    assert art.vote_strategy == tbase.VoteStrategy.ALLGATHER_1BIT
    assert [g.codec for g in art.plan.groups] == [codec, "sign1bit"]
    got = _port_run(tts.M4, tt, states[0], batches[:1])[0][0]
    one = _port_run(tts.M4, _plan_tcfgs(codec=codec)[1], states[0],
                    batches[:1])[0][0]
    rest = leafwise_m4[0][0]
    for k in got:
        want = one if k.startswith("embed") else rest
        assert torch.equal(got[k], want[k]), k


def test_m4_delayed_plan_trainer_lags_one_step(ref_m4_plan, leafwise_m4):
    """delayed_vote through a plan at M = 4: step 0 leaves every parameter
    as it was (weight decay 0) and banks the synchronous vote; step 1
    applies exactly that int8 vote, so the parameters after step 1 are the
    synchronous trainer's after step 0."""
    states, _, batches = ref_m4_plan
    _, tt = _plan_tcfgs(bucket_bytes=256, delayed_vote=True)
    (p1, _, banked, _), (p2, _, _, _) = _port_run(tts.M4, tt, states[0],
                                                  batches)
    p0 = tts._port_state(states[0])[0]
    sync = leafwise_m4[0][0]
    for k in p0:
        assert torch.equal(p1[k], p0[k]), k
        # the banked vote is the sign of the synchronous move
        assert torch.equal(banked[k].float(), torch.sign(p0[k] - sync[k])), k
        assert torch.equal(p2[k], sync[k]), k


def test_plan_trainer_state_layout_matches_reference():
    """materialize_state under a plan: the EF residual only for the mapped
    leaves, the plan's server state, the delayed buffer; as the reference's
    abstract_state lays them out."""
    cmap = (("embed*", "ef_sign"), ("unembed*", "weighted_vote"))
    opt = dict(bucket_bytes=4096, codec_map=cmap, delayed_vote=True)
    cfg, tt = _plan_tcfgs(**opt)
    art = tTS.make_train_step(cfg, tt, 2, device="cpu")
    _, state = tTS.materialize_state(cfg, tt, art,
                                     torch.Generator().manual_seed(0))
    jcfg, jt = tts._jcfgs()
    jt = dataclasses.replace(jt, optimizer=dataclasses.replace(
        jt.optimizer, **opt))
    jart = jTS.make_train_step(jcfg, jt, mesh=None)
    _, jstate = jTS.abstract_state(jcfg, jt, jart)
    assert sorted(state) == sorted(jstate)
    assert sorted(state["error"]) == sorted(jstate["error"]) \
        == ["embed.table"]
    assert sorted(state["delayed"]) == sorted(jstate["delayed"])
    for k, v in state["delayed"].items():
        assert v.dtype == torch.int8 and v.shape == jstate["delayed"][k].shape
    assert state["codec"]["flip_ema"].shape == (2,)
    assert art.vote_strategy == tbase.VoteStrategy.ALLGATHER_1BIT
    assert art.plan.worker_state_leaves == jart.plan.worker_state_leaves
