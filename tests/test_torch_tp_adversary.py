"""The vote side of the model axis: stochastic adversaries drawn at a
shard's global coordinates (the counter map of
``kernels/csrc/byzantine.cu``), the VotePlan over a model axis and the
adaptive modes' refusal, against the JAX package on the CPU.

(a) The map alone: for leaf shapes, cut dims, part counts (2-16) and
    windows drawn by hypothesis, the plain version's block drawn under the
    map equals the same slice of the whole leaf's draw, for the three
    stochastic modes, and the whole draw equals the reference's
    ``repro.core.byzantine.evil_signs`` on the whole leaf (bit for bit).
(b) A rank's part of a plan (``vote_plan.shard_plan``) against brute force
    on random layouts: every global bucket's window is the run of local
    elements whose global index falls in it, the segments' counters are
    the elements' global flat indices, and the ranges a rank counts hold
    each coordinate once over the model group.
(c) On 8 gloo ranks (``tests/torch_mesh_harness.py <scratch>
    tp_adversary``, check g) the (data 4, model 2) step of the reduced
    glm4-9b in float32 with leaf-wise ``random`` / ``colluding`` /
    ``blind`` adversaries, a VotePlan with ``blind``, ``overlap``, a
    ``codec_map`` and ``delayed_vote``, ``weighted_vote`` and ``ef_sign``
    under a plan, and Mode B fsdp with ``colluding``, held to its stacked
    twin at the ``tp`` check's tolerances, each adversarial rank's draws
    held exactly to the twin's. The fused ZeRO backward draws over each
    rank's model block as a whole, as the reference's does inside its
    region manual over "model" (``src/repro/core/majority_vote.py``
    ``make_gather_vote``); the twin draws block by block there.
(d) Against the reference's own (data 4, model 2) mesh step
    (``tests/torch_tp_reference.py <scratch> adversary``, 8 fake XLA
    devices): leaf-wise ``random`` and ``blind`` under a VotePlan, the
    port's step from the same start held to it at the tolerances of
    ``test_the_4x2_step_holds_to_the_reference_mesh_step``; an
    ``adaptive_flip`` adversary raises the reference's ``ValueError`` at
    the reference's call. The reference's Mode B step with any adversary
    does not lower on the JAX of these tests (its ``axis_index`` inside
    the nested region manual over "model"), so the fused backward is held
    to the reference's functions instead: on the mesh, one (16, 12) leaf
    cut ("data", "model") with two adversaries of each stochastic mode,
    every rank's voted block equal to the vote of the reference's
    ``evil_signs`` over each model block of each voter's gradient.
(e) The vote API over a model axis refuses an adversary whose choice of
    coordinates depends on the layout: its payload is a shard and carries
    none (a stochastic mode at the backend; an adaptive one, which only
    the stacked form takes, as the request is made).
"""
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs.base import ByzantineConfig as JByz  # noqa: E402
from repro.core import byzantine as jbyz  # noqa: E402
from repro.core import sign_compress as jsc  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import byzantine as tbyz  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.core.codecs.base import LeafShare  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed.mesh import ProcessMesh  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from torch_tp_common import (ADAPTIVE_REFUSAL, fake_world,  # noqa: E402
                             reduced, train_config)

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
#: the criteria of the reference comparison, as in
#: tests/test_torch_tensor_parallel.py
FLIP_FRACTION, F32_RTOL, F32_ATOL_REL = 1e-4, 1e-4, 2e-5
MODES = ("random", "colluding", "blind")


# ---------------------------------------------------------------------------
# (a) the counter map alone
# ---------------------------------------------------------------------------


@st.composite
def cut_leaves(draw):
    """(global shape, cut dim, parts, rank index, leaf offset, window
    start) of a leaf cut along one dim."""
    ndim = draw(st.integers(1, 4))
    parts = draw(st.integers(2, 16))
    dim = draw(st.integers(0, ndim - 1))
    shape = [draw(st.integers(1, 4)) for _ in range(ndim)]
    shape[dim] = parts * draw(st.integers(1, 3))
    index = draw(st.integers(0, parts - 1))
    local = int(np.prod(shape)) // parts
    return (tuple(shape), dim, parts, index,
            draw(st.integers(0, 2 ** 33)), draw(st.integers(0, local - 1)))


def _block(shape, dim, parts, index):
    """The index of rank `index`'s block along `dim`."""
    sl = [slice(None)] * len(shape)
    d = shape[dim] // parts
    sl[dim] = slice(index * d, (index + 1) * d)
    return tuple(sl)


@pytest.mark.parametrize("mode", MODES)
@given(case=cut_leaves(), seed=st.integers(0, 2 ** 31 - 1))
@settings(max_examples=15, deadline=None)
def test_a_block_under_the_map_draws_the_slice_of_the_whole_leaf(mode, case,
                                                                  seed):
    shape, dim, parts, index, offset, start = case
    rng = np.random.default_rng(seed)
    signs = rng.integers(-1, 2, size=shape).astype(np.int8)
    cfg = tbase.ByzantineConfig(mode=mode, num_adversaries=1, seed=seed,
                                flip_prob=0.9)
    whole = torch.from_numpy(signs.reshape(1, -1).copy())
    tbyz.evil_signs_(whole, cfg, [0], step=5, offset=offset)
    blk = np.ascontiguousarray(signs[_block(shape, dim, parts, index)])
    cut = prng.counter_map(blk.shape, dim, parts, index, offset)
    got = torch.from_numpy(blk.reshape(1, -1)[:, start:].copy())
    tops.adversary_(got, [tbyz.adversary_key(
        cfg, None if mode == "colluding" else 0, step=5)],
        0.9 if mode == "blind" else 0.5, mode == "blind", cut[0],
        start=start, block=cut[1], gap=cut[2])
    want = whole.numpy().reshape(shape)[_block(shape, dim, parts, index)]
    np.testing.assert_array_equal(got.numpy()[0], want.reshape(-1)[start:])
    # the whole leaf from counter 0 is the reference's own draw
    whole = torch.from_numpy(signs.reshape(1, -1).copy())
    tbyz.evil_signs_(whole, cfg, [0], step=5)
    ref = jbyz.evil_signs(jnp.asarray(signs), JByz(
        mode=mode, num_adversaries=1, seed=seed, flip_prob=0.9),
        jnp.int32(0), step=jnp.int32(5))
    np.testing.assert_array_equal(whole.numpy().reshape(shape),
                                  np.asarray(ref))


def test_the_map_of_a_leading_cut_is_one_window():
    # nothing before the cut dim: the block is contiguous in the leaf
    assert prng.counter_map((4, 6), 0, 3, 2, 10) == (10 + 2 * 24, 0, 0)
    assert prng.counter_map((1, 4, 6), 1, 3, 2, 0) == (48, 0, 0)
    assert prng.counter_map((2, 4, 6), 1, 3, 1, 7) == (7 + 24, 24, 48)
    got = prng.mapped_counters(10, 5, 3, 4, 8)
    want = [5 + l + (l // 4) * 8 for l in range(3, 13)]
    assert got.tolist() == want
    with pytest.raises(ValueError, match="needs a block"):
        tops.adversary_(torch.zeros((1, 4), dtype=torch.int8), [(0, 1)],
                        0.5, False, gap=3)


# ---------------------------------------------------------------------------
# (b) a rank's part of a plan
# ---------------------------------------------------------------------------


def _stub_shares(shapes, specs, model, index):
    mesh = types.SimpleNamespace(model=model,
                                 axis_index=lambda name: index)
    return {k: LeafShare(mesh, "model" in spec, tshd.model_dim(spec),
                         tuple(shapes[k])) for k, spec in specs.items()}


def _global_index(plan, shares):
    """The global flat index of each of the rank's local elements, and
    whether the rank counts it, by brute force."""
    idx, counted = [], []
    for slot in plan.leaves:
        share = shares[slot.name]
        g = np.arange(slot.offset, slot.offset + slot.length).reshape(
            slot.shape)
        if share.sharded:
            g = g[_block(slot.shape, share.dim, share.parts,
                         share.mesh.axis_index("model"))]
        idx.append(g.reshape(-1))
        counted.append(np.full(g.size, share.counted))
    return np.concatenate(idx), np.concatenate(counted)


@pytest.mark.parametrize("arch,model,bucket_bytes", [
    ("glm4-9b", 2, 4096), ("glm4-9b", 4, 1000), ("qwen3-moe-235b-a22b", 2,
                                                 2048),
    ("mamba2-2.7b", 4, -1)])
def test_a_rank_walks_its_windows_of_the_global_plan(arch, model,
                                                     bucket_bytes):
    cfg = reduced(arch)
    shapes = cfg.param_shapes()
    specs = tshd.param_specs(shapes, fsdp=False,
                             mesh_shape={"data": 2, "model": model})
    plan = tvp.build_plan(shapes, bucket_bytes=bucket_bytes, codec_map=(
        ("embed*", "ternary2bit"), ("*", "sign1bit")),
        strategy=tbase.VoteStrategy.ALLGATHER_1BIT, data_size=2)
    for index in range(model):
        shares = _stub_shares(shapes, specs, model, index)
        shard = tvp.shard_plan(plan, shares)
        g, counted = _global_index(plan, shares)
        assert shard.plan.n_params == g.size and (np.diff(g) > 0).all()
        windows = {(b.codec, b.strategy): [] for b in plan.buckets}
        for b in shard.plan.buckets:
            windows[(b.codec, b.strategy)].append(b)
        got = [(b.start, b.start + b.length) for b in shard.plan.buckets]
        want = []
        for b in plan.buckets:
            inside = np.nonzero((g >= b.start)
                                & (g < b.start + b.length))[0]
            if inside.size:
                assert (np.diff(inside) == 1).all()
                want.append((int(inside[0]), int(inside[-1]) + 1))
        assert got == want
        for b in shard.plan.buckets:
            skip = np.zeros(b.length, dtype=bool)
            for lo, hi in b.skip:
                skip[lo:hi] = True
            np.testing.assert_array_equal(
                ~skip, counted[b.start:b.start + b.length])
        for seg in shard.segments:
            np.testing.assert_array_equal(prng.mapped_counters(
                seg.hi - seg.lo, seg.offset, 0, seg.block, seg.gap).numpy(),
                g[seg.lo:seg.hi])
        assert [x for a, b in shard.counted for x in range(a, b)] == \
            np.nonzero(counted)[0].tolist()
    # over the model group every coordinate is counted exactly once
    every = np.concatenate([_global_index(plan, _stub_shares(
        shapes, specs, model, i))[0][_global_index(plan, _stub_shares(
            shapes, specs, model, i))[1]] for i in range(model)])
    assert sorted(every.tolist()) == list(range(plan.n_params))


# ---------------------------------------------------------------------------
# (c), (d) the mesh, and the reference's mesh step
# ---------------------------------------------------------------------------


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    """The reference's adversary run beside the harness's tp_adversary
    check, in one scratch directory: the harness's last part waits for the
    reference's start states and steps from them."""
    path = tmp_path_factory.mktemp("tpa")
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "torch_tp_reference.py"), str(path),
         "adversary"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            JAX_PLATFORMS="cpu"))
    mesh = subprocess.Popen(
        [sys.executable, str(HERE / "torch_mesh_harness.py"), str(path),
         "tp_adversary"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(TPA_REFERENCE_WAIT="600"))
    try:
        ref_out = ref.communicate(timeout=600)[0]
        assert ref.returncode == 0, ref_out[-4000:]
        out = mesh.communicate(timeout=600)[0]
    finally:
        for proc in (ref, mesh):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert mesh.returncode == 0, out[-8000:]
    assert "OK tp_adversary" in out
    for label in ("random", "plan_blind"):
        assert (path / f"tpa_step_{label}_rank7.npz").exists(), label
    return path


def test_the_vote_side_holds_to_the_stacked_twins(scratch):
    with open(scratch / "tp_adversary_record.pkl", "rb") as f:
        flips = pickle.load(f)["tpa_flips"]
    assert len(flips) == 8
    assert set(flips[0]) == {"random", "colluding", "blind", "plan_blind",
                             "plan_weighted", "plan_ef_sign",
                             "mode_b_fsdp_colluding"}
    # every flip was justified by the harness; they stay rare
    for rank in flips:
        assert sum(rank.values()) <= 8, rank


def _load(path, prefix):
    with np.load(path) as z:
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}


@pytest.mark.parametrize("label", ["random", "plan_blind"])
def test_the_4x2_adversary_step_holds_to_the_reference_mesh_step(scratch,
                                                                 label):
    cfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(
        "glm4-9b")), dtype="float32")
    sizes = {"pod": 1, "data": 4, "model": 2}
    specs = tshd.param_specs(cfg.param_shapes(), fsdp=False,
                             mesh_shape=sizes)
    ranks = [scratch / f"tpa_step_{label}_rank{r}.npz" for r in range(8)]
    params = tshd.join_shards([_load(p, "p/") for p in ranks], specs,
                              sizes=sizes)
    moms = [tshd.join_shards([_load(ranks[2 * v + m], "m/")
                              for m in range(2)], specs,
                             sizes={"model": 2}) for v in range(4)]
    step = scratch / f"tpa_ref_{label}_step.npz"
    with np.load(step) as z:
        ref_loss = float(z["loss"])
    losses = [float(np.load(p)["loss"]) for p in ranks]
    want_p, want_m = _load(step, "p/"), _load(step, "m/")
    start = _load(scratch / f"tpa_ref_{label}_start.npz", "p/")
    for loss in losses:
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    flips = total = 0
    for k, w in want_p.items():
        m_ref = want_m[k].astype(np.float32)           # (4, *leaf)
        m_got = np.stack([m[k] for m in moms])
        atol = max(1e-6, F32_ATOL_REL * float(np.abs(m_ref).max()))
        np.testing.assert_allclose(m_got, m_ref, rtol=F32_RTOL, atol=atol,
                                   err_msg=k)
        bad = ~np.isclose(params[k], w, rtol=1e-5, atol=1e-6)
        a = np.abs(m_ref)
        near = (a < FLIP_FRACTION * a.max()).any(axis=0)
        assert not (bad & ~near).any(), k
        flips += int(bad.sum())
        total += w.size
        assert not np.array_equal(w, start[k]) or not w.any(), k
    assert flips <= 1e-3 * total, (flips, total)


@pytest.mark.parametrize("mode", MODES)
def test_the_fused_backward_draws_each_model_block_as_the_reference(
        scratch, mode):
    with open(scratch / "tp_adversary_record.pkl", "rb") as f:
        rec = pickle.load(f)["tpa_fused"]
    w, xs = rec["w"].astype(np.float64), rec["xs"].astype(np.float64)
    grads = [2 * x.T @ (x @ w) for x in xs]       # voter v's whole gradient
    assert min(float(np.abs(g).min()) for g in grads) > 1e-6
    cfg = JByz(mode=mode, num_adversaries=2, seed=3, flip_prob=0.9)
    want, whole = [], 0
    for j in range(2):                            # the model blocks
        count = 0
        for v, g in enumerate(grads):
            s = jsc.sign_ternary(jnp.asarray(g[:, 6 * j:6 * j + 6],
                                             jnp.float32))
            if v < 2:                             # drawn over the block
                s = jbyz.evil_signs(s, cfg, jnp.int32(v), step=None)
            count = count + np.asarray(s, np.int32)
        want.append(np.sign(count))
    for v, g in enumerate(grads):                 # the whole leaf's draw
        s = jsc.sign_ternary(jnp.asarray(g, jnp.float32))
        if v < 2:
            s = jbyz.evil_signs(s, cfg, jnp.int32(v), step=None)
        whole = whole + np.asarray(s, np.int32)
    assert len(rec["ranks"]) == 8
    for d, m, got in rec["ranks"]:
        np.testing.assert_array_equal(got[mode],
                                      want[m][4 * d:4 * d + 4],
                                      err_msg=f"rank ({d}, {m})")
    # the check tells the block's draw from the whole leaf's
    assert not np.array_equal(np.concatenate(want, axis=1),
                              np.sign(whole))


def test_an_adaptive_adversary_raises_the_reference_error_at_its_call(
        scratch):
    with open(scratch / "tpa_ref_adaptive.json") as f:
        ref = json.load(f)
    assert ref["call"] == "step_fn" and ref["type"] == "ValueError", ref
    cfg = reduced("glm4-9b")
    tcfg = train_config(byzantine=tbase.ByzantineConfig(
        mode="adaptive_flip", num_adversaries=1))
    with fake_world(8, rank=1):
        mesh = ProcessMesh((4, 2), ("data", "model"))
        art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
        params, state = TS.materialize_state(
            cfg, tcfg, art, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError) as err:
            art.step_fn(params, state, {"tokens": torch.zeros(
                (8, 16), dtype=torch.int64)}, 0)
    assert str(err.value) == ref["message"]
    assert ADAPTIVE_REFUSAL in ref["message"]


# ---------------------------------------------------------------------------
# (e) the vote API
# ---------------------------------------------------------------------------


def test_the_vote_api_refuses_a_layout_draw_over_a_model_axis():
    payload = torch.zeros(16)
    with fake_world(8, rank=3):
        mesh = ProcessMesh((4, 2), ("data", "model"))
        back = tva.MeshBackend(axes=mesh.vote_axes, device="cpu")
        for mode in tbyz.STOCHASTIC_MODES:
            byz = tbase.ByzantineConfig(mode=mode, num_adversaries=1)
            for form, p in (("leaf", payload), ("tree", {"a": payload})):
                with pytest.raises(ValueError,
                                   match="carries no leaf layout"):
                    back.execute(tva.VoteRequest(
                        payload=p, form=form,
                        failures=tva.FailureSpec(byz=byz)))
        # an adaptive mode (low_margin ranks the payload) never meets a
        # shard: a leaf or tree request refuses it as it is made
        for mode in tbyz.ATTACK_MODES:
            byz = tbase.ByzantineConfig(mode=mode, num_adversaries=1)
            for form, p in (("leaf", payload), ("tree", {"a": payload})):
                with pytest.raises(ValueError,
                                   match="has no such observation channel"):
                    tva.VoteRequest(payload=p, form=form,
                                    failures=tva.FailureSpec(byz=byz))
        for mode in ("sign_flip", "zero"):
            assert back.why_unsupported(tva.VoteRequest(
                payload=payload, failures=tva.FailureSpec(
                    byz=tbase.ByzantineConfig(mode=mode,
                                              num_adversaries=1)))) is None
        # without a model axis a draw's coordinates are the payload's own
        flat = ProcessMesh((8,), ("data",))
        assert tva.MeshBackend(axes=flat.vote_axes, device="cpu") \
            .why_unsupported(tva.VoteRequest(
                payload=payload, failures=tva.FailureSpec(
                    byz=tbase.ByzantineConfig(mode="random",
                                              num_adversaries=1)))) is None
