"""The port's α–β link model (``repro_torch.distributed.comm_model``) and
every price it sets, held against the JAX package's.

The port's constants describe an H100 host and none of them is the
reference's (the dimensionless overlap residue aside). Under the
reference's constants, read from ``repro.distributed.comm_model`` and set
on the port's module for the test (``tests/torch_comm_common.py``), every
priced quantity must equal the reference's float for float, and every
priced choice must be the reference's: ``collective_time`` and
``schedule_time``, ``select_strategy`` over a grid of sizes, voters, pods
and codecs, the VotePlan's AUTO groups and ``bucket_bytes = -1`` with
their ``schedule_cost``, the ``pred_s`` of every ``plan.issue`` span of a
recorded walk (virtual and over mesh axes), and the trainer at AUTO with
M = 4, whose step is held to a step composed from the reference's
functions as ``tests/test_torch_train_step_m4.py`` holds the named wire's.
"""
import dataclasses
import io
import json
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

import torch_train_step_common as tts  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core import vote_engine as jve  # noqa: E402
from repro.core import vote_plan as jvp  # noqa: E402
from repro.distributed import comm_model as jcm  # noqa: E402
from repro.obs import recorder as jobs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core import vote_engine as tve  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.distributed import comm_model as tcm  # noqa: E402
from repro_torch.distributed import mesh as tmesh  # noqa: E402
from repro_torch.obs import recorder as tobs  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402
from torch_comm_common import ROLES, use_reference_constants  # noqa: E402

CODECS = ("sign1bit", "ef_sign", "ternary2bit", "weighted_vote")
#: (ici bytes, dci bytes, collectives) messages of a schedule
MESSAGES = [(0.0, 0.0, 1), (1e3, 0.0, 1), (3.5e6, 0.0, 2),
            (1.25e9, 4e8, 3), (7.0, 2.0, 2), (2.5e11, 0.0, 1)]


@pytest.fixture
def ref_constants(monkeypatch):
    use_reference_constants(monkeypatch)


def test_the_ports_constants_are_the_h100s():
    """Every constant of either module has its role; none of the port's
    bandwidth, latency or peak constants equals the reference's (only the
    dimensionless overlap residue may)."""
    def upper(mod):
        return {k for k in vars(mod) if k.isupper() and k[0] != "_"}
    assert upper(tcm) == set(ROLES)
    assert upper(jcm) == set(ROLES.values())
    for port_name, ref_name in ROLES.items():
        if port_name == "OVERLAP_ALPHA_RESIDUE":
            continue
        assert getattr(tcm, port_name) != getattr(jcm, ref_name), port_name
    # NVLink within a node, 450 GB/s each way a GPU; the network between
    # nodes, 50 GB/s; HBM3 3.35 TB/s; dense bf16 half of 1,979 TFLOP/s
    assert tcm.NVLINK_BW_PER_LINK * tcm.NVLINK_LINKS == 450e9
    assert (tcm.NET_BW, tcm.HBM_BW, tcm.PEAK_FLOPS) \
        == (50e9, 3.35e12, 1979e12 / 2)


@pytest.mark.parametrize("msg", MESSAGES)
def test_collective_time_matches_reference(ref_constants, msg):
    ici, dci, n = msg
    t = tcm.collective_time(ici, dci, n_collectives=n)
    j = jcm.collective_time(ici, dci, n_collectives=n)
    assert (t.bytes_ici, t.bytes_dci, t.time_s) \
        == (j.bytes_ici, j.bytes_dci, j.time_s)


@pytest.mark.parametrize("overlap", [False, True])
def test_schedule_time_matches_reference(ref_constants, overlap):
    for k in range(len(MESSAGES) + 1):
        msgs = MESSAGES[:k]
        t = tcm.schedule_time(iter(msgs), overlap=overlap)
        j = jcm.schedule_time(iter(msgs), overlap=overlap)
        assert (t.bytes_ici, t.bytes_dci, t.time_s) \
            == (j.bytes_ici, j.bytes_dci, j.time_s)


@pytest.mark.parametrize("overlap", [False, True])
def test_repeated_runs_price_as_the_expanded_schedule(overlap):
    """repeated_schedule_time (the AUTO ladder's pricing of runs of equal
    buckets) equals schedule_time of the expanded messages float for
    float, runs past the loop's length (numpy's sequential accumulate)
    included, under both packages' constants."""
    runs = [(1e3 / 3, 0.0, 1, 5000), (7.0, 2.0 / 3, 3, 1), (0.1, 0.0, 2, 0),
            (3.3e4, 17.0, 2, 9000), (1.0, 0.0, 1, 1)]
    expanded = [r[:3] for r in runs for _ in range(r[3])]
    for patched in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if patched:
                use_reference_constants(mp)
            t = tcm.repeated_schedule_time(iter(runs), overlap=overlap)
            want = tcm.schedule_time(iter(expanded), overlap=overlap)
            assert (t.bytes_ici, t.bytes_dci, t.time_s) \
                == (want.bytes_ici, want.bytes_dci, want.time_s)


def test_roofline_terms_match_reference(ref_constants):
    for flops, hbm in ((1e12, 1e9), (3e15, 2e12), (0.0, 5e10)):
        assert tcm.compute_time(flops) == jcm.compute_time(flops)
        assert tcm.compute_time(flops, mfu=0.3) \
            == jcm.compute_time(flops, mfu=0.3)
        assert tcm.memory_time(hbm) == jcm.memory_time(hbm)
        for comm, overlap in (((1e6, 0.0, 2), 0.7), ((1e9, 1e8, 3), 0.2)):
            assert tcm.step_time_estimate(
                flops, hbm, tcm.collective_time(*comm), overlap) \
                == jcm.step_time_estimate(
                    flops, hbm, jcm.collective_time(*comm), overlap)


@pytest.mark.parametrize("codec", CODECS)
def test_select_strategy_grid_matches_reference(ref_constants, codec):
    """n from 10^3 to 10^10, data 1-64, pod 1-4: the reference's choice,
    and the estimated time of every strategy."""
    for n in [10 ** e for e in range(3, 11)] + [1_649_439_744]:
        for data in (1, 2, 3, 4, 8, 16, 64):
            for pod in (1, 2, 4):
                got = tve.select_strategy(n, data, pod, codec)
                want = jve.select_strategy(n, data, pod, codec)
                assert got.value == want.value, (n, data, pod)
                assert tve.resolve_strategy(
                    tbase.VoteStrategy.AUTO, n, data, pod, codec) == got
    for s in ("psum_int8", "allgather_1bit", "hierarchical"):
        for n, data, pod in ((10 ** 6, 4, 1), (10 ** 9, 16, 4)):
            assert tve.STRATEGIES[tbase.VoteStrategy(s)].estimated_time(
                n, data, pod) == jve.STRATEGIES[
                    jbase.VoteStrategy(s)].estimated_time(n, data, pod)


def test_select_strategy_under_the_h100_constants():
    """Under the port's own constants: one voter has no wire; the priced
    choice is one of the codec's strategies and the cheapest of them."""
    for codec in CODECS:
        cands = tcodecs.get_codec(codec).supported_strategies
        assert tve.select_strategy(10 ** 9, 1, 1, codec) == (
            tbase.VoteStrategy.PSUM_INT8
            if tbase.VoteStrategy.PSUM_INT8 in cands else cands[0])
        for n, data, pod in ((10 ** 4, 8, 1), (1_649_439_744, 4, 1),
                             (10 ** 10, 64, 4)):
            got = tve.select_strategy(n, data, pod, codec)
            assert got in cands
            times = [tve.STRATEGIES[k].estimated_time(n, data, pod)
                     for k in cands]
            if codec == "sign1bit":
                assert tve.STRATEGIES[got].estimated_time(n, data, pod) \
                    == min(times)


def _shapes(pkg_base, arch):
    return pkg_base.reduced_config(pkg_base.get_config(arch)).param_shapes()


CODEC_MAP = (("embed*", "ternary2bit"), ("*norm*", "weighted_vote"),
             ("*", "sign1bit"))


def _manifest(plan):
    return tuple((g.codec, g.strategy.value, g.start, g.total,
                  g.bucket_bytes,
                  tuple((b.codec, b.strategy.value, b.start, b.length)
                        for b in g.buckets)) for g in plan.groups)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("codec_map", [(), CODEC_MAP], ids=["one", "map"])
@pytest.mark.parametrize("arch", ["glm4-9b", "qwen1.5-32b"])
def test_auto_plan_matches_reference(ref_constants, arch, codec_map,
                                     overlap):
    """build_plan with AUTO, at bucket_bytes -1 (the priced ladder) and
    4096, over 4 and 16 voters and 2 pods: the buckets (codec, strategy,
    start, length) and each group's bucket_bytes equal, and schedule_cost
    too, overlap off and on."""
    shapes = _shapes(jbase, arch)
    assert shapes == _shapes(tbase, arch)
    for bb in (-1, 4096):
        for data, pod in ((4, 1), (16, 1), (4, 2)):
            kw = dict(bucket_bytes=bb, codec_map=codec_map,
                      data_size=data, pod_size=pod, overlap=overlap)
            ref = jvp.build_plan(shapes, strategy=jbase.VoteStrategy.AUTO,
                                 **kw)
            port = tvp.build_plan(shapes, strategy=tbase.VoteStrategy.AUTO,
                                  **kw)
            assert _manifest(port) == _manifest(ref), (bb, data, pod)
            for o in (False, True):
                assert port.schedule_cost(data, pod, o) \
                    == ref.schedule_cost(data, pod, o)


def _issue_preds(rows):
    return [(r["attrs"]["bucket"], r["attrs"]["pred_s"]) for r in rows
            if r["kind"] == "span" and r["name"] == "plan.issue"]


def _recorded(obs, fn):
    buf = io.StringIO()
    rec = obs.TraceRecorder(buf)
    with obs.recording(rec):
        fn()
    rec.close()
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("codec_map", [(), CODEC_MAP[:1]],
                         ids=["one", "map"])
def test_pred_s_of_a_virtual_walk_matches_reference(ref_constants,
                                                    codec_map, overlap):
    """The stacked plan vote under a recorder: every plan.issue span's
    pred_s is the reference's, bucket by bucket."""
    m = 4
    shapes = {"embed.table": (40, 16), "layers.w": (3000,)}
    n = sum(int(np.prod(s)) for s in shapes.values())
    x = np.random.default_rng(5).normal(size=(m, n)).astype(np.float32)
    kw = dict(bucket_bytes=64, codec_map=codec_map, data_size=m,
              overlap=overlap)
    jplan = jvp.build_plan(shapes, **kw)
    tplan = tvp.build_plan(shapes, **kw)
    assert _manifest(tplan) == _manifest(jplan)
    # the reference records its spans when it traces: trace afresh
    jax.clear_caches()
    jrows = _recorded(jobs, lambda: jva.VirtualBackend().execute(
        jva.VoteRequest(payload=x, form="stacked", plan=jplan)))
    trows = _recorded(tobs, lambda: tva.VirtualBackend(
        device="cpu").execute(tva.VoteRequest(
            payload=torch.from_numpy(x), form="stacked", plan=tplan)))
    got, want = _issue_preds(trows), _issue_preds(jrows)
    assert len(got) == tplan.n_buckets > 2
    assert got == want
    assert all(p > 0 for _, p in got)


class _StackedMeshWire(tvp.MeshBucketWire):
    """A mesh wire over `axes` whose exchange is the stacked virtual wire's
    (so that one process can walk it): what the walk prices is the
    axes' voter count."""

    def __init__(self, axes, m):
        super().__init__(axes)
        self.virtual = tvp.VirtualBucketWire(m)

    def issue(self, bucket, seg):
        return self.virtual.issue(bucket, seg)

    def complete(self, bucket, arrived, w):
        return self.virtual.complete(bucket, arrived, w)


@pytest.mark.parametrize("sizes", [{"data": 4}, {"pod": 2, "data": 4}])
def test_pred_s_of_a_mesh_walk_matches_reference(ref_constants, sizes):
    """The mesh walk prices each bucket over the vote axes' voters as the
    data axis and one pod, as the reference's ``run_schedule`` does
    (``num_voters(wire.axes)``): its pred_s is the reference's
    ``collective_time`` of ``_message_parts`` at that voter count."""
    m = int(np.prod(list(sizes.values())))
    mesh = types.SimpleNamespace(axis_size=lambda name: sizes[name])
    axes = tmesh.VoteAxes(tuple(a for a in ("pod", "data") if a in sizes),
                          mesh=mesh)
    assert tmesh.num_voters(axes) == m
    shapes = {"a": (5000,), "b": (700,)}
    plan = tvp.build_plan(shapes, bucket_bytes=128,
                          codec_map=(("a", "ternary2bit"),), data_size=m)
    buf = torch.from_numpy(np.random.default_rng(6).integers(
        -1, 2, size=(m, plan.n_params)).astype(np.int8))
    rows = _recorded(tobs, lambda: tvp.run_schedule(
        plan, buf, _StackedMeshWire(axes, m), overlap=True))
    want = []
    for k, b in enumerate(plan.buckets):
        parts = jvp._message_parts(
            jcodecs.get_codec(b.codec).bits_per_param,
            jbase.VoteStrategy(b.strategy.value), b.length, m, 1)
        want.append((k, jcm.collective_time(
            parts[0], parts[1], n_collectives=parts[2]).time_s))
    assert _issue_preds(rows) == want and len(want) > 2


def test_trainer_at_auto_matches_reference(ref_constants):
    """The trainer at AUTO with M = 4 stacked voters: the strategy the
    reference's trainer resolves for the same parameter count over 4
    voters, and one step held to the step composed from the reference's
    functions on that wire (the named wire's criteria)."""
    jcfg, _ = tts._jcfgs()
    cfg, tcfg = tts._tcfgs()
    auto = dataclasses.replace(tcfg, optimizer=dataclasses.replace(
        tcfg.optimizer, vote_strategy=tbase.VoteStrategy.AUTO))
    art = tTS.make_train_step(cfg, auto, tts.M4, device="cpu")
    want = jve.resolve_strategy(jbase.VoteStrategy.AUTO,
                                jcfg.param_count(), tts.M4, 1)
    assert art.vote_strategy.value == want.value == "allgather_1bit"
    states, losses, batches = tts._composed_run("sign1bit", 1)
    port = tts._port_step(tts.M4, states[0], batches[0], 0, tcfg=auto)
    tts._check_teacher_forced(states[0], {"loss": losses[0], **states[1]},
                              port)


def test_the_optimizer_takes_auto_resolved(ref_constants):
    """build_optimizer takes AUTO over one voter (psum_int8, no wire) and
    over M > 1 (ROADMAP.md Queue 3, F2, repaired): there it resolves at the
    first update on the total size of the leaves it votes, over a data
    axis of M stacked voters, as the reference's optimizer does through
    its vote API (``_tree_execute``: ``select_strategy`` on the voted
    tree's size, ``src/repro/core/vote_api.py:779-782``), for the sign
    family on each codec and for a dense kind; its step is then the step
    of the optimizer that names that wire, bit for bit."""
    from repro_torch.core import signum as tsignum
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 48), "b": (3000,), "c": (7,)}
    total = sum(int(np.prod(s)) for s in shapes.values())
    params0 = {k: rng.normal(size=s).astype(np.float32)
               for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]

    def run(cfg):
        opt = tsignum.build_optimizer(cfg, 4)
        params = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
        state = opt.init(params)
        wire = opt.wire(params, 0)
        for voter, g in enumerate(grads):
            opt.encode(voter, {k: torch.from_numpy(v.copy())
                               for k, v in g.items()},
                       state, wire)
        opt.update(wire, state, params, 0)
        return opt, params, state

    for kind, codec in (("signum_vote", "sign1bit"),
                        ("signum_vote", "ternary2bit"),
                        ("signum_vote", "ef_sign"), ("adam", "sign1bit")):
        auto = tbase.OptimizerConfig(kind=kind, codec=codec,
                                     vote_strategy=tbase.VoteStrategy.AUTO)
        assert tsignum.build_optimizer(auto, 1).strategy \
            == tbase.VoteStrategy.PSUM_INT8
        want = jve.select_strategy(total, 4, 1, codec=codec)
        opt, params, state = run(auto)
        assert opt.strategy.value == want.value, (kind, codec)
        named = dataclasses.replace(auto, vote_strategy=tbase.VoteStrategy(
            want.value))
        _, nparams, nstate = run(named)
        for k in shapes:
            assert torch.equal(params[k], nparams[k]), (kind, codec, k)
        assert json.dumps(_plain_state(state)) == json.dumps(
            _plain_state(nstate)), (kind, codec)


def _plain_state(tree):
    """An optimizer state as nested lists (tensors' values, ints kept)."""
    if isinstance(tree, dict):
        return {k: _plain_state(v) for k, v in sorted(tree.items())}
    if isinstance(tree, torch.Tensor):
        return tree.float().tolist()
    return tree
