"""The port's dry run (``repro_torch.launch.dryrun`` and
``launch.hlo_stats``) against the reference's ``repro.launch.dryrun`` and
``repro.launch.hlo_stats``: the collective statistics and the group rule,
every production cell's fingerprint, ``abstract_state`` against
``materialize_state``, a step counted on "meta" against the same step on
the CPU and against real gloo ranks (the harness's ``tp_wire`` check), one
production cell at full size, the kernel wrappers' meta branch, and the
reference's activation rule ``sharding.shard`` at the production meshes.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT))

import torch.distributed as dist  # noqa: E402

import torch_tp_common as tpc  # noqa: E402
from repro.launch import hlo_stats as ref_hs  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import mesh as pm  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_stats as hs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, pod_stride  # noqa: E402,E501
from repro_torch.train import serve_step as SS  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

ARCHS = base.list_archs()


def _ref_dryrun():
    """``repro.launch.dryrun``, imported with the environment kept: the
    module sets XLA_FLAGS (512 host devices) for the process that runs it,
    and this one may start JAX later."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


# ---------------------------------------------------------------------------
# the collective statistics and the group rule
# ---------------------------------------------------------------------------

#: the members of the first group of each collective of
#: ``test_measurement.HLO`` (iota groups [16, 16] <= [256]: ranks 0-15)
HLO_MEMBERS = {"all-gather": list(range(16)), "all-reduce": [0, 1, 2, 3],
               "reduce-scatter": list(range(16))}


@pytest.mark.parametrize("stride", [0, 2, 256])
def test_collective_statistics_are_the_reference(stride):
    from test_measurement import HLO
    want = ref_hs.parse_collectives(HLO, pod_stride=stride)
    assert [f.name for f in dataclasses.fields(hs.CollectiveOp)] == [
        f.name for f in dataclasses.fields(ref_hs.CollectiveOp)]
    rec = hs.Recorder(stride)
    for o in want:
        # the port records a collective at every call: a loop's trips
        for _ in range(o.trip_mult):
            got = rec.add(o.op, HLO_MEMBERS[o.op], o.bytes_result)
        assert (got.op, got.bytes_result, got.group_size, got.crosses_pod,
                got.trip_mult) == (o.op, o.bytes_result, o.group_size,
                                   o.crosses_pod, 1)
        assert got.transit_bytes * o.trip_mult == o.transit_bytes
    got, ref = hs.summarize(rec.ops), ref_hs.summarize(want)
    # the reference counts an op of a loop body once, the port each call
    assert got.pop("n_collectives") == sum(o.trip_mult for o in want)
    assert ref.pop("n_collectives") == len(want)
    assert got == ref
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for size in (0, 1, 96, 4097):
            for m in (1, 2, 3, 16, 512):
                assert hs._transit(op, size, m) == ref_hs._transit(op, size,
                                                                   m)


def test_recorder_groups_follow_the_reference_rule():
    """Every group of a (2, 16, 16) mesh in a fake world of 512: its size
    and pod crossing by the reference's ``_group_info`` on the same
    members; the collectives of rank 0's own groups as the recorder takes
    them, without running them."""
    with tpc.fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        stride = pod_stride(mesh)
        assert stride == 256
        assert len(mesh._groups) == 16 * 2 + 16 * 16 + 16 + 2 * 16 + 2
        for ranks, pg in mesh._groups.values():
            if 0 in ranks:   # a member's group: the ranks the recorder reads
                assert dist.get_process_group_ranks(pg) == list(ranks)
            line = "replica_groups={{" + ",".join(map(str, ranks)) + "}}"
            for s in (0, 2, stride):
                assert hs.group_info(ranks, s) == ref_hs._group_info(
                    line, s)
        x = torch.empty(64, device="meta")
        with hs.record_collectives(stride) as got:
            pm.psum(x, mesh.vote_axes)
            pm.all_gather(x, mesh.vote_axes, "data")
            pm.psum(x, mesh.vote_axes, ("pod",))
            pm.model_sum(x, mesh)
            pm.model_gather(x, mesh, dim=0, names=("data", "model"))
        want = [("all-reduce", ("pod", "data")), ("all-gather", ("data",)),
                ("all-reduce", ("pod",)), ("all-gather", ("model",)),
                ("all-gather", ("data", "model"))]
        for o, (op, names) in zip(got, want):
            ranks, _ = mesh.group_of(names)
            line = "replica_groups={{" + ",".join(map(str, ranks)) + "}}"
            assert o.op == op
            assert (o.group_size, o.crosses_pod) == ref_hs._group_info(
                line, stride)
        assert [o.crosses_pod for o in got] == [True, False, True, False,
                                                False]
        assert mesh.stats.calls == 3 and mesh.model_stats.calls == 2
    pm._GROUPS.clear()


def test_a_collective_under_the_recorder_returns_every_rank_sending_its_own():
    """A CPU tensor under the recorder: the value had every rank of the
    group sent this rank's (the dry run's SPMD premise); nothing runs."""
    with tpc.fake_world(8, rank=6):
        mesh = pm.ProcessMesh((2, 2, 2), ("pod", "data", "model"))
        x = torch.arange(8, dtype=torch.int64)
        with hs.record_collectives(4):
            assert torch.equal(pm.psum(x, mesh.vote_axes), 4 * x)
            assert torch.equal(pm.gather_voters(x, mesh.vote_axes),
                               x.repeat(4, 1))
            assert torch.equal(pm.psum_scatter(x, mesh.vote_axes, "data"),
                               2 * x[4:])   # rank 6 is data index 1
            assert torch.equal(pm.model_max(x, mesh), x)
            assert torch.equal(pm.broadcast(x, mesh.vote_axes), x)
            y = torch.arange(8, dtype=torch.float32)
            assert torch.equal(pm.model_sum(y, mesh), 2 * y)
    pm._GROUPS.clear()


def test_meta_is_a_device_a_caller_names():
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")


# ---------------------------------------------------------------------------
# the fingerprint of every production cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_cells_fingerprint_is_the_reference(arch):
    """Each of the arch's 4 shapes on both production meshes: the skip
    status and reason, params, active params and the train config's mode,
    fsdp, microbatches and remat (a serve cell's fsdp) as the reference's
    ``run_cell`` records them, computed without lowering."""
    refd = _ref_dryrun()
    from repro.configs import base as rb
    from repro.configs import presets as rp
    for shape in base.SHAPES:
        for multi_pod in (False, True):
            reason = refd.skip_reason(arch, shape)
            assert D.skip_reason(arch, shape) == reason
            if reason:
                rec = D.run_cell(arch, shape, multi_pod=multi_pod)
                assert rec == {"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if multi_pod else "16x16",
                               "opt": "signum_vote", "status": "skip",
                               "reason": reason}
                continue
            got = D.fingerprint(arch, shape)
            cfg = rb.get_config(arch)
            want = {"params": cfg.param_count(),
                    "active_params": cfg.active_param_count()}
            cell = rb.SHAPES[shape]
            if cell.kind == "train":
                tcfg = rp.default_train_config(arch, cell)
                want.update(mode=tcfg.optimizer.momentum_mode.value,
                            fsdp=tcfg.fsdp, microbatches=tcfg.microbatches,
                            remat=tcfg.remat)
            else:
                want["fsdp"] = arch in rp.MODE_B_ARCHS
            assert got == want


def test_the_resolved_vote_strategy_is_the_references(monkeypatch):
    """Every train cell on both meshes, at its preset's strategy and at
    AUTO: the port's step, built on "meta" under the reference's link
    constants, resolves what the reference's ``make_train_step`` resolves
    on the same sizes."""
    from torch_comm_common import use_reference_constants
    from repro.configs import base as rb
    from repro.configs import presets as rp
    from repro.core.vote_engine import resolve_strategy as ref_resolve
    from repro_torch.configs import presets
    use_reference_constants(monkeypatch)
    cell = base.SHAPES["train_4k"]
    with tpc.fake_world(512):
        for multi_pod in (False, True):
            mesh = make_production_mesh(multi_pod=multi_pod)
            sizes = mesh.axis_sizes
            for arch in ARCHS:
                for vs in (None, "auto"):
                    tcfg = presets.default_train_config(
                        arch, cell, vote_strategy=vs and base.VoteStrategy(vs))
                    art = TS.make_train_step(base.get_config(arch), tcfg,
                                             device="meta", mesh=mesh)
                    rt = rp.default_train_config(
                        arch, rb.SHAPES["train_4k"],
                        vote_strategy=vs and rb.VoteStrategy(vs))
                    want = ref_resolve(
                        rt.optimizer.vote_strategy,
                        rb.get_config(arch).param_count(),
                        sizes.get("data", 1), sizes.get("pod", 1),
                        codec=rt.optimizer.resolved_codec)
                    assert art.vote_strategy.value == want.value, (
                        arch, multi_pod, vs)
    pm._GROUPS.clear()


# ---------------------------------------------------------------------------
# abstract_state against materialize_state
# ---------------------------------------------------------------------------


def _opt(**kw):
    o = dict(kind="signum_vote", learning_rate=1e-3, momentum=0.9,
             vote_strategy=base.VoteStrategy.ALLGATHER_1BIT)
    o.update(kw)
    return base.OptimizerConfig(**o)


MODE_B = dict(kind="signsgd_vote", momentum_mode=base.MomentumMode.GLOBAL,
              vote_strategy=base.VoteStrategy.HIERARCHICAL)
#: (label, arch, mesh (shape, axes) or None for 4 stacked voters,
#: optimizer options, train options)
STATE_CASES = (
    ("mode_a", "glm4-9b", None, {}, {}),
    ("mode_a_bf16", "glm4-9b", None,
     {"momentum_dtype": "bfloat16",
      "vote_strategy": base.VoteStrategy.PSUM_INT8}, {}),
    ("mode_b", "qwen1.5-32b", None, MODE_B, {}),
    ("ef_sign", "glm4-9b", None, {"codec": "ef_sign"}, {}),
    ("ef_sign_beta0", "glm4-9b", None,
     {"codec": "ef_sign", "kind": "signsgd_vote", "momentum": 0.0}, {}),
    ("weighted_vote", "glm4-9b", None, {"codec": "weighted_vote"}, {}),
    ("delayed_vote", "glm4-9b", None, {"delayed_vote": True}, {}),
    ("plan_codec_map", "glm4-9b", None,
     {"bucket_bytes": 4096, "codec_map": (("embed*", "ef_sign"),)}, {}),
    ("adam", "glm4-9b", None, {"kind": "adam"}, {}),
    ("mamba2_bf16", "mamba2-2.7b", None, {}, {}),
    ("fsdp_mode_b", "qwen1.5-32b", ((4, 2), ("data", "model")), MODE_B,
     {"fsdp": True}),
    ("fsdp_mode_a_beta0", "glm4-9b", ((4, 2), ("data", "model")),
     {"kind": "signsgd_vote", "momentum": 0.0}, {"fsdp": True}),
    ("model_axis", "glm4-9b", ((2, 4), ("data", "model")), {}, {}),
    ("model_axis_ef_sign", "glm4-9b", ((2, 4), ("data", "model")),
     {"codec": "ef_sign"}, {}),
    ("model_axis_sgdm", "qwen2-moe-a2.7b", ((2, 4), ("data", "model")),
     {"kind": "sgdm"}, {}),
)


def _same_layout(got, want, where=""):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, type(want)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_layout(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same_layout(got[k], want[k], f"{where}/{k}")
    elif torch.is_tensor(want):
        assert got.is_meta, where
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape),
                                                 want.dtype), where
    else:
        assert got == want, where


@pytest.mark.parametrize("label,arch,mesh_spec,opt,extra", STATE_CASES,
                         ids=[c[0] for c in STATE_CASES])
def test_abstract_state_is_materialize_states_layout(label, arch, mesh_spec,
                                                    opt, extra):
    cfg = (base.reduced_config(base.get_config(arch)) if arch == "mamba2-2.7b"
           else tpc.reduced(arch))
    tcfg = base.TrainConfig(global_batch=8, seq_len=16,
                            optimizer=_opt(**opt), **extra)
    if mesh_spec is None:
        art = TS.make_train_step(cfg, tcfg, 4, device="cpu")
        meta = TS.make_train_step(cfg, tcfg, 4, device="meta")
        want = TS.materialize_state(cfg, tcfg, art,
                                    torch.Generator().manual_seed(0))
        _same_layout(TS.abstract_state(cfg, tcfg, meta), want)
        return
    with tpc.fake_world(8, rank=5):
        mesh = pm.ProcessMesh(*mesh_spec)
        art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
        meta = TS.make_train_step(cfg, tcfg, device="meta", mesh=mesh)
        want = TS.materialize_state(cfg, tcfg, art,
                                    torch.Generator().manual_seed(0))
        _same_layout(TS.abstract_state(cfg, tcfg, meta, mesh), want)
        blocks = [k for k, s in art.param_specs.items() if any(s)]
        assert blocks, "the mesh cuts no leaf"


def test_abstract_state_refuses_mode_a_momentum_under_fsdp():
    cfg = tpc.reduced("glm4-9b")
    tcfg = base.TrainConfig(global_batch=8, seq_len=16, optimizer=_opt(),
                            fsdp=True)
    with tpc.fake_world(8):
        mesh = pm.ProcessMesh((4, 2), ("data", "model"))
        art = TS.make_train_step(cfg, tcfg, device="meta", mesh=mesh)
        with pytest.raises(shd.DuplicateSpecError):
            TS.abstract_state(cfg, tcfg, art, mesh)


# ---------------------------------------------------------------------------
# a step counted on "meta" against the same step on the CPU
# ---------------------------------------------------------------------------

#: (codec, strategy, train options) of the stacked cells, 4 voters
META_CPU_CASES = (
    ("sign1bit", "allgather_1bit", {"microbatches": 2, "remat": "full"}),
    ("sign1bit", "allgather_1bit", {"remat": "nested"}),
    ("sign1bit", "allgather_1bit", {"remat": "dots"}),
    ("ternary2bit", "allgather_1bit", {}),
)


@pytest.mark.parametrize("codec,strategy,extra", META_CPU_CASES,
                         ids=[f"{c[0]}-{c[2].get('remat', 'none')}"
                              for c in META_CPU_CASES])
def test_a_step_on_meta_counts_what_it_does_on_the_cpu(codec, strategy,
                                                       extra):
    """The reduced glm4-9b, 4 stacked voters: the FLOPs (the meter's and
    ``FlopCounterMode``'s over the CPU step) and the bytes of every
    PyTorch operation and kernel equal on "meta" and on the CPU; the meta
    step's launches are the layout's count."""
    import chip_smoke
    from torch.utils.flop_counter import FlopCounterMode
    cfg = tpc.reduced("glm4-9b")
    tcfg = base.TrainConfig(
        global_batch=8, seq_len=16, optimizer=_opt(
            codec=codec, vote_strategy=base.VoteStrategy(strategy)), **extra)
    meta = D.train_record(cfg, tcfg, n_voters=4)
    art = TS.make_train_step(cfg, tcfg, 4, device="cpu")
    params, state = TS.materialize_state(cfg, tcfg, art,
                                         torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 16),
                                     generator=torch.Generator().manual_seed(1),
                                     dtype=torch.int32)}
    cpu = D.measure(lambda: art.step_fn(params, state, batch, 0),
                    (params, state, batch), "cpu")
    with FlopCounterMode(display=False) as flops:
        art.step_fn(params, state, batch, 1)
    assert meta["flops_per_chip"] == cpu["flops_per_chip"] \
        == flops.get_total_flops() > 0
    assert meta["hbm_bytes_per_chip"] == cpu["hbm_bytes_per_chip"] > 0
    assert meta["memory"]["argument_bytes"] == cpu["memory"][
        "argument_bytes"]
    assert chip_smoke.M_MAIN == 4
    want = chip_smoke.step_launches(codec, len(params))
    assert {k: v for k, v in meta["launches"].items() if v} == want
    assert not any(cpu["launches"].values())   # CPU calls count nothing


# ---------------------------------------------------------------------------
# a step counted on "meta" against real gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wire_record(tmp_path_factory):
    """The harness's ``tp_wire`` check (8 gloo ranks in a subprocess)."""
    path = tmp_path_factory.mktemp("tp_wire")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, str(HERE / "torch_mesh_harness.py"), str(path),
         "tp_wire"], env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "ALL OK" in run.stdout, (
        run.stdout[-2000:] + run.stderr[-4000:])
    with open(path / "tp_wire_record.pkl", "rb") as f:
        return pickle.load(f)["tp_wire"]


@pytest.mark.parametrize("case", tpc.WIRE_CASES, ids=[c[0] for c in
                                                      tpc.WIRE_CASES])
def test_a_step_on_meta_hands_the_axes_what_gloo_ranks_do(wire_record,
                                                          case):
    """Each rank's dry run in a fake world: its bytes by axis and its
    collective count equal to what the same rank of the harness's gloo
    world handed them in the same step; pod-crossing transit only with a
    pod axis."""
    label, shape, axes, opt, extra = case
    cfg, tcfg = tpc.wire_pair(opt, extra)
    n = int(np.prod(shape))
    for rank in range(n):
        got = wire_record[rank][label]
        with tpc.fake_world(8, rank=rank):
            mesh = pm.ProcessMesh(shape, axes)
            rec = D.train_record(cfg, tcfg, mesh=mesh)
        assert rec["wire_bytes"] == {"vote": got["vote"],
                                     "model": got["model"]}, (label, rank)
        colls = rec["collectives"]
        assert colls["n_collectives"] == got["calls"]
        assert (colls["transit_bytes_dci"] > 0) == ("pod" in axes)
        assert colls["transit_bytes_ici"] > 0


def test_the_fsdp_layout_decodes_as_the_plain_layout(wire_record):
    """The repair the Mode B archs' decode cells forced
    (``make_decode_step(..., fsdp=True)``), since extended to the SSM,
    hybrid and encoder-decoder families: the batch-sharded prefill and two
    ticks bit-equal to the plain layout's on the harness's (data 2, model
    2) ranks, for every arch of the harness's list."""
    import torch_mesh_harness as H
    assert [bool(r["decode_fsdp"]) for r in wire_record] == [True] * 4 + [
        False] * 4
    for r in wire_record[:4]:
        assert tuple(r["decode_fsdp"]) == H.DECODE_FSDP_ARCHS


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mamba2-2.7b",
                                  "zamba2-1.2b", "whisper-tiny"])
def test_an_fsdp_tick_hands_the_axes_the_layouts_count(wire_record, arch):
    """Each tick's bytes on the vote axes (the rows' logits and the ZeRO-3
    gathers) and on the model group, on each (data 2, model 2) rank of the
    harness, over the FSDP layout and the plain one:
    ``chip_smoke.tp_fsdp_tick_bytes``'s count of the rank's layout (the
    card's 19f holds its ranks to the same count)."""
    import chip_smoke
    cfg = tpc.reduced(arch)
    for rank in range(4):
        got = wire_record[rank]["decode_fsdp"][arch]
        with tpc.fake_world(8, rank=rank):
            mesh = pm.ProcessMesh((2, 2), ("data", "model"))
            for fsdp in (False, True):
                want = chip_smoke.tp_fsdp_tick_bytes(
                    cfg, mesh, got["batch"], got["seq_sharded"],
                    got["cross_sharded"], fsdp=fsdp)
                assert got["fsdp" if fsdp else "plain"] == [want] * 2, (
                    rank, fsdp)
        # the gathers are the only difference, and there are some
        assert got["fsdp"][0]["vote"] > got["plain"][0]["vote"]
        assert got["fsdp"][0]["model"] == got["plain"][0]["model"]


# ---------------------------------------------------------------------------
# one production cell
# ---------------------------------------------------------------------------


def test_a_production_decode_cell_runs_on_256_fake_ranks():
    """glm4-9b x decode_32k on (16, 16): every key of the record, and the
    arguments the rank's blocks of the layouts."""
    rec = D.run_cell("glm4-9b", "decode_32k")
    assert rec["status"] == "ok"
    for k in ("params", "active_params", "fsdp", "trace_s",
              "flops_per_chip", "hbm_bytes_per_chip", "memory",
              "collectives", "wire_bytes", "launches", "fits", "rank",
              "coords", "n_chips"):
        assert k in rec, k
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_bytes_per_chip"}
    assert rec["n_chips"] == 256 and rec["fits"]
    assert rec["flops_per_chip"] > 0 and rec["collectives"][
        "n_collectives"] > 0
    cfg, cell = base.get_config("glm4-9b"), base.SHAPES["decode_32k"]
    sizes = {"data": 16, "model": 16}
    coords = {"pod": 0, "data": 0, "model": 0}
    inputs = SS.abstract_serve_inputs(cfg, cell, sizes, fsdp=False)

    def nbytes(tree, specs):
        return sum(v.numel() * v.element_size() for v in shd.shard_tree(
            tree, specs, coords=coords, sizes=sizes).values())
    want = (nbytes(inputs["params"], inputs["param_specs"])
            + nbytes(inputs["cache"], inputs["cache_specs"])
            + nbytes({"t": inputs["tokens"]}, {"t": inputs["tokens_spec"]})
            + 4)   # the int32 position
    assert rec["memory"]["argument_bytes"] == want
    mem = rec["memory"]
    assert mem["peak_bytes_per_chip"] == (
        mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        - mem["alias_bytes"])


# ---------------------------------------------------------------------------
# the kernel wrappers on "meta"
# ---------------------------------------------------------------------------

N = 1000


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


WORDS, TWORDS = -(-N // 32), -(-N // 16)
#: (name, call, launch key, the outputs' (shape, dtype), bytes moved)
WRAPPERS = (
    ("momentum_sign_pack", lambda: ops.momentum_sign_pack(
        _meta(N, torch.bfloat16), _meta(N, torch.float32), 0.9),
     "momentum_sign_pack", [((N,), torch.float32), ((WORDS,), torch.int32)],
     N * (2 + 4 + 4) + 4 * WORDS),
    ("majority", lambda: ops.majority(_meta((4, WORDS), torch.int32)),
     "majority", [((WORDS,), torch.int32)], 5 * 4 * WORDS),
    ("apply_vote", lambda: ops.apply_vote(
        _meta(N, torch.bfloat16), _meta(WORDS, torch.int32), 1e-3, 0.0),
     "apply_vote", [((N,), torch.bfloat16)], 4 * N + 4 * WORDS),
    ("apply_ternary_vote", lambda: ops.apply_ternary_vote(
        _meta(N, torch.float32), _meta(TWORDS, torch.int32), 1e-3, 0.0),
     "apply_ternary_vote", [((N,), torch.float32)], 8 * N + 4 * TWORDS),
    ("bitpack", lambda: ops.bitpack(_meta((3, N), torch.int8)), "bitpack",
     [((3, WORDS), torch.int32)], 3 * N + 12 * WORDS),
    ("bitunpack", lambda: ops.bitunpack(_meta(WORDS, torch.int32), N,
                                        torch.int8),
     "bitunpack", [((N,), torch.int8)], 4 * WORDS + N),
    ("fused_majority", lambda: ops.fused_majority(
        _meta((4, N), torch.float32)), "fused_majority",
     [((WORDS,), torch.int32)], 16 * N + 4 * WORDS),
    ("ternary_pack", lambda: ops.ternary_pack(_meta((2, N), torch.int8)),
     "ternary_pack", [((2, TWORDS), torch.int32)], 2 * N + 8 * TWORDS),
    ("ternary_majority", lambda: ops.ternary_majority(
        _meta((4, TWORDS), torch.int32), ties="plus_one"),
     "ternary_majority_plus_one", [((TWORDS,), torch.int32)],
     5 * 4 * TWORDS),
    ("ternary_unpack", lambda: ops.ternary_unpack(
        _meta(TWORDS, torch.int32), N, torch.bfloat16), "ternary_unpack",
     [((N,), torch.bfloat16)], 4 * TWORDS + 2 * N),
    ("adversary_", lambda: ops.adversary_(
        _meta((2, N), torch.int8), [(1, 2), (3, 4)], 0.5, False, block=7,
        gap=3), "adversary_map", [((2, N), torch.int8)], 4 * N),
)


@pytest.mark.parametrize("name,call,key,outs,nbytes", WRAPPERS,
                         ids=[w[0] for w in WRAPPERS])
def test_each_wrapper_on_meta_gives_its_kernels_outputs(name, call, key,
                                                        outs, nbytes):
    """The checks as on a card, outputs of the kernel's shapes and dtypes
    on "meta", the launch counted and the kernel's bytes (PERF.md's
    bounds' count) under ``traffic``."""
    ops.reset_launch_counts()
    with ops.traffic() as t:
        out = call()
    out = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in out] == [
        (s, d) for s, d in outs]
    assert all(o.is_meta for o in out)
    assert t.bytes == nbytes and t.depth == 0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == ({"adversary": 1, "adversary_map": 1}
                      if key == "adversary_map" else {key: 1})
    ops.reset_launch_counts()


def test_a_wrapper_on_meta_still_checks_its_arguments():
    with pytest.raises(TypeError):
        ops.majority(_meta((4, 8), torch.float32))
    with pytest.raises(ValueError, match="is on"):
        ops.apply_vote(_meta(64, torch.float32), torch.zeros(2,
                                                             dtype=torch.int32),
                       1e-3, 0.0)


# ---------------------------------------------------------------------------
# the reference's activation rule at the production meshes
# ---------------------------------------------------------------------------


def _ref_shard(monkeypatch, shape, spec, sizes):
    """The spec the reference's ``sharding.shard`` constrains an array of
    `shape` to under a mesh of `sizes` (every axis Auto); None entries
    where it drops an axis."""
    import jax
    from repro import compat
    from repro.distributed import sharding as rs
    mesh = types.SimpleNamespace(
        empty=False, axis_names=tuple(sizes),
        axis_types=(compat.AxisType.Auto,) * len(sizes),
        axis_sizes=tuple(sizes.values()), concrete=None)
    monkeypatch.setattr(rs.compat, "get_abstract_mesh", lambda: mesh)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: tuple(s))
    x = types.SimpleNamespace(shape=tuple(shape))
    out = rs.shard(x, *spec)
    return (None,) * len(shape) if out is x else out


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
BATCH = ("pod", "data")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_the_hand_layout_drops_what_the_reference_shard_drops(monkeypatch,
                                                              mesh_name):
    """Where ``shard`` drops an axis at the production meshes, the port's
    layout does the same: long_500k's batch of 1 (mamba2, zamba2),
    qwen2-moe-a2.7b's 60 experts (the M2 form: every expert's d_ff
    columns), and the vocabularies of whisper-tiny and mamba2-2.7b, which
    16 does not divide."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    sizes = MESHES[mesh_name]
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = base.get_config(arch)
        S = base.SHAPES["long_500k"].seq_len
        # the hidden states (B, S, d) of a batch of 1: the batch axes drop
        assert _ref_shard(monkeypatch, (1, S, cfg.d_model), (BATCH, None,
                                                             None),
                          sizes) == (None, None, None)
        assert SS.batch_entry(1, sizes) is None
        cache = M_cache_specs(cfg, 1, S, sizes)
        assert all(spec[1] is None for spec in cache.values()), arch
        # the mamba inner activations keep "model" (d_inner divides)
        d_inner = cfg.ssm.expand * cfg.d_model
        assert _ref_shard(monkeypatch, (1, S, d_inner),
                          (BATCH, None, "model"), sizes)[2] == "model"
    cfg = base.get_config("qwen2-moe-a2.7b")
    E, ff = cfg.moe.num_experts, cfg.moe.expert_d_ff
    assert E == 60
    assert _ref_shard(monkeypatch, (E, 8, cfg.d_model),
                      ("model", None, None), sizes)[0] is None
    assert _ref_shard(monkeypatch, (E, 8, ff), (None, None, "model"),
                      sizes)[2] == "model"
    assert moe.moe_form(cfg.moe, sizes["model"]) == "M2"
    spec = shd.param_spec("layers.experts_w_gate", (cfg.num_layers, E,
                                                    cfg.d_model, ff),
                          fsdp=False, mesh_shape=sizes)
    assert spec == (None, None, None, "model")
    for arch in ("whisper-tiny", "mamba2-2.7b"):
        cfg = base.get_config(arch)
        V = cfg.vocab_size
        assert V % sizes["model"]
        assert _ref_shard(monkeypatch, (8, 16, V), (BATCH, None, "model"),
                          sizes)[2] is None
        for name in ("embed.table", "unembed.table"):
            shape = cfg.param_shapes().get(name)
            if shape is None:
                continue
            spec = shd.param_spec(name, shape, fsdp=False, mesh_shape=sizes)
            assert spec[0] is None, (arch, name)
            table = torch.empty(shape, device="meta")
            assert L.vocab_group(table, V, types.SimpleNamespace(
                model=sizes["model"])) is None


def M_cache_specs(cfg, batch, seq, sizes):
    from repro_torch.models import model as M
    return SS.cache_shardings(cfg, M.cache_specs(cfg, batch, seq), sizes)


# ---------------------------------------------------------------------------
# the repairs the production cells forced
# ---------------------------------------------------------------------------


def test_the_seq_form_attends_rows_the_axis_does_not_divide(wire_record):
    """whisper-tiny's 1500 encoder frames at model 16: the reduced whisper
    with 12 frames at model 8, on the harness's gloo ranks, within float32
    rounding of the single device (the axis' constraint dropped, as the
    reference's ``shard`` drops it)."""
    gaps = [r["seq_rows_whole"] for r in wire_record]
    assert len(gaps) == 8 and all(g < 1e-5 for g in gaps)


def test_routing_on_meta_keeps_the_dispatchs_static_shapes():
    """The MoE's routing and dispatch on "meta" (the dry run routes no
    token): every output of the CPU call's shape and dtype."""
    from repro_torch.models import moe
    T, E, k, C = 40, 6, 2, 16
    logits = torch.randn(T, E, generator=torch.Generator().manual_seed(0))
    cpu = moe.route_topk(logits, k)
    meta = moe.route_topk(logits.to("meta"), k)
    _same_layout(meta, cpu)
    _same_layout(moe.dispatch_plan(meta[1], E, C),
                 moe.dispatch_plan(cpu[1], E, C))


def test_the_decodes_position_write_on_meta_counts_the_owning_rank():
    """``_masked_local_update`` on "meta" (no position is known) writes
    every row, as the rank whose shard holds the positions does."""
    from repro_torch.models import layers as L
    cache = torch.zeros(3, 8, 2, 4, device="meta")
    new = torch.zeros(3, 1, 2, 4, device="meta")
    L._masked_local_update(cache, new, torch.zeros((), dtype=torch.int32,
                                                   device="meta"), 8)
    assert cache.shape == (3, 8, 2, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_analytic_flops_are_the_roofline_models(arch):
    """``dryrun.analytic_train_flops``, the count PERF.md's ratios divide
    by, equals ``benchmarks/roofline.py``'s on every arch, with and
    without remat."""
    from benchmarks.roofline import analytic_train_flops as ref_flops
    from repro.configs import base as rb
    cell = base.SHAPES["train_4k"]
    for remat in (True, False):
        assert D.analytic_train_flops(
            base.get_config(arch), cell.global_batch, cell.seq_len,
            remat) == ref_flops(rb.get_config(arch), cell.global_batch,
                                cell.seq_len, remat)
