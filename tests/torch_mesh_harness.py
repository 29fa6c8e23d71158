"""The port's multi-process wire on the CPU: one world of 8 gloo ranks, run
in a subprocess by ``tests/test_torch_mesh.py`` (not collected itself).

    PYTHONPATH=src python tests/torch_mesh_harness.py <scratch dir> [check]

Each rank runs one voter (``torch.set_num_threads(1)``); the world meets
through a ``file://`` store in the scratch directory. In one launch:

a. votes: every strategy x codec through ``MeshBackend``'s leaf, tree and
   stacked forms on a data-only mesh of 8, a pod 2 x data 4 mesh and the
   first 7 ranks, equal bit for bit to ``VirtualBackend`` on the stacked
   rows, with stale voters and each oblivious adversary
   (``byzantine.apply_adversary`` against ``apply_adversary_stacked`` row
   by row); ``weighted_vote``'s state on the pod mesh in the gathered,
   data-major row order; int16 counts (200 voters' count dtype) summed
   through int32; the dense mean within float32's rounding bound;
b. plans: ``plan_vote_signs`` and ``plan_tree_vote``, synchronous and
   overlapped, equal to the stacked plan vote (and to
   ``plan_vote_stacked`` on the gathered wire);
c. the trainer: ``make_train_step(..., mesh=...)`` on 4 ranks, 2 steps of
   each configuration, bit-equal to the port's stacked step (computed on
   the other 4 ranks) in losses, parameters, momenta and codec state; the
   dense sgd step within the bound of its mean's rounding; diagnostics
   with an adversary equal to the stacked step's;
d. drills: ``ScenarioRunner(backend="mesh")`` digests equal to the virtual
   runner's for the reference's tier-2 harness specs (h8/honest7 on the
   first 7 ranks, two elastic drills), and ``identity_rows`` at 1.0;
e. fsdp (run alone, by ``tests/test_torch_fsdp.py``: ``... <scratch>
   fsdp``; checks a-d run when no check is named): the fused ZeRO
   gather's backward on a data-only mesh of 8 and a pod 2 x data 4 mesh,
   along dim 0 and dim 1, equal to the sign of the summed per-rank signs
   of the whole gradient (the dense form: their mean), each rank's slice
   and inputs recorded (``fsdp_record.pkl``) for the reference's
   identity; and ``make_train_step(..., mesh=...)`` with ``fsdp=True`` on
   4 ranks, 2 steps of each configuration (Mode B on data 4 and pod 2 x
   data 2 with a sign_flip / random adversary, remat "dots", a plan and
   diagnostics, qwen3-moe's preset with its 4-D expert leaves fused;
   Mode A at beta 0 with a random adversary, and with
   ef_sign, delayed_vote and diagnostics), each rank's losses and its
   slices of the parameters and the momentum (its residual) bit-equal to
   the port's stacked step (computed on the other 4 ranks); the dense sgd
   within its mean's rounding bound.

f. tp (run alone, by ``tests/test_torch_tensor_parallel.py``: ``...
   <scratch> tp``): tensor parallelism over a ``"model"`` axis on a (data
   4, model 2), a (data 2, model 4) and a (model 8) mesh of the 8 ranks,
   the reduced glm4-9b in float32 (4 heads, 2 kv heads: the grouped,
   repeat and seq attention forms in turn), 2 steps of each configuration
   (Mode A on the four codecs and three wires, Mode B with fsdp, sgd,
   ``delayed_vote``, ``sign_flip`` with the diagnostics; then qwen1.5-32b,
   deepseek-67b, gemma3-12b and pixtral-12b, reduced), held to the
   port's stacked step of the mesh's voters computed on every rank: the
   losses within rtol 1e-5, each rank's momentum within the families'
   float32 tolerance of its block of the twin's, the parameters equal
   within float32 rounding except where a vote flipped, and every flip at
   a coordinate some voter's |m'| puts under TP_FLIP_FRACTION of its
   leaf's largest (the flips counted in the record); replicated leaves
   bit-equal over each model group; every rank's model-group bytes of a
   step equal to ``chip_smoke.tp_bytes``; the serving layouts of the five
   archs held to the single-device decode. With ``tp_reference_start.npz``
   in the
   scratch directory the (data 4, model 2) mesh also takes one Mode A
   step from that state and batch and writes each rank's blocks
   (``tp_step_rank<r>.npz``); with ``tp_decode_start.npz`` a (model 4)
   mesh of the first 4 ranks prefills and decodes from it through
   ``serve_step`` and writes its logits and cache blocks
   (``tp_decode_rank<r>.npz``).

g. tp_adversary (run alone, by ``tests/test_torch_tp_adversary.py``:
   ``... <scratch> tp_adversary``): the vote side of the model axis on the
   (data 4, model 2) mesh, the reduced glm4-9b in float32: leaf-wise
   ``random`` / ``colluding`` / ``blind`` adversaries, a VotePlan with a
   ``blind`` adversary, ``overlap``, a ``codec_map`` and ``delayed_vote``,
   ``weighted_vote`` (a ``random`` adversary) and ``ef_sign`` under a
   plan, and Mode B fsdp with ``colluding``, each held to its stacked twin
   as check f holds its runs, and every adversarial rank's draws held
   exactly to the twin's at the block's global coordinates (``random`` /
   ``colluding``: the sent signs; ``blind``: the flip mask wherever the
   honest signs agree; the fused backward's at the block's own, the
   twin's drawn block by block, :class:`BlockDraws`); each rank's bytes
   by axis of a plan step equal to
   ``chip_smoke.tp_plan_vote_bytes``; the fused backward of one (16, 12)
   leaf cut ("data", "model") with two adversaries of each stochastic
   mode, every rank's voted block recorded (``tpa_fused``). With ``tpa_ref_<case>_start.npz``
   in the scratch directory the mesh also takes one step from each of the
   reference's start states and writes each rank's blocks
   (``tpa_step_<case>_rank<r>.npz``).

Rank 0 writes what the mesh gave, with the inputs it was given, to
``<scratch dir>/mesh_record.pkl`` (numpy and plain Python only), so that
``tests/test_torch_mesh.py`` holds it against the reference on the same
inputs: every vote request (payload rows, failures, step, salt, server
state) with the mesh's votes, server state and wire; each adversary's
gathered rows with the signs they corrupted; every plan walk; each
drill's digest and margins. Two inputs come from the reference when the
scratch directory holds them (the test writes both): ``draws.pkl``, the
reference's start points and noise for every harness spec (the drills
run on them instead of ``PrngDraws``), and ``reference_step.npz``, a
start state and batch of the reference's M = 4 step, from which the
trainer's ranks take one step and write their state to
``mesh_step_rank<r>.npz``.

Rank 0 prints ``OK <check> <seconds>`` per check and ``ALL OK``; a failed
check raises on its rank and the launch exits non-zero.
"""
import dataclasses
import hashlib
import glob
import json
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
N = 203          # coordinates of a leaf vote (not a multiple of 32)
SEED = 0
#: rank 0's record of what the mesh gave (see the module doc)
RECORD = {"votes": [], "adversary": [], "plans": [], "drills": {}}
#: the scratch directory of this launch
SCRATCH = "."


def _np(t):
    return None if t is None else torch.as_tensor(t).detach().cpu().numpy(
    ).copy()


def _fail(f) -> dict:
    """A FailureSpec as plain fields."""
    return {"n_stale": f.n_stale,
            "byz": None if f.byz is None else dataclasses.asdict(f.byz)}


def _wire(w) -> tuple:
    return (w.n_voters, w.payload_bytes, w.n_messages,
            getattr(w.strategy, "value", None))


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _eq(what, got, want):
    got = torch.as_tensor(got)
    want = torch.as_tensor(want)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: mesh {got.tolist()[:12]} != "
                             f"virtual {want.tolist()[:12]}")


# ---------------------------------------------------------------------------
# a. votes
# ---------------------------------------------------------------------------


def _meshes():
    from repro_torch.distributed.mesh import ProcessMesh
    # every rank builds every mesh, in this order
    return {"data8": ProcessMesh((8,), ("data",)),
            "pod2x4": ProcessMesh((2, 4), ("pod", "data")),
            "first7": ProcessMesh((7,), ("data",))}


def _data_major(mesh):
    """Replica index of each row of a gathered (M, ...) stack."""
    return [(j % mesh.pod) * mesh.data + j // mesh.pod
            for j in range(mesh.size)]


def check_votes(rank):
    from repro_torch.configs.base import ByzantineConfig, VoteStrategy as S
    from repro_torch.core import byzantine, codecs
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import vote_api as va
    from repro_torch.core import vote_engine as ve
    from repro_torch.distributed import mesh as pm
    meshes = _meshes()
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(WORLD, N)).astype(np.float32)
    x[:, :5] = 0.0                          # abstentions
    x[2, 5:9] = 1e-39                       # subnormals abstain too
    prev = np.sign(rng.normal(size=(WORLD, N))).astype(np.int8)
    RECORD["x"], RECORD["prev"] = x, prev
    virtual = va.VirtualBackend(device="cpu")
    for name, mesh in meshes.items():
        if not mesh.member:
            continue
        m, r, axes = mesh.size, mesh.replica_index(), mesh.vote_axes
        back = va.MeshBackend(axes=axes, device="cpu")
        order = _data_major(mesh)
        for codec in codecs.CODECS:
            for strat in codecs.get_codec(codec).supported_strategies:
                fails = [va.FailureSpec()]
                fails += [va.FailureSpec(n_stale=2)]
                fails += [va.FailureSpec(byz=ByzantineConfig(
                    mode=mode, num_adversaries=3, seed=5, flip_prob=0.7))
                    for mode in ("sign_flip", "random", "zero", "colluding",
                                 "blind")]
                for f in fails:
                    state = None
                    if codec == "weighted_vote":
                        ema = np.linspace(0.0, 0.4, m).astype(np.float32)
                        state = {"flip_ema": torch.from_numpy(ema)}
                        mesh_state = {"flip_ema": torch.from_numpy(
                            ema[order].copy())}
                    req = dict(strategy=strat, codec=codec, failures=f,
                               step=3, salt=11)
                    want = virtual.execute(va.VoteRequest(
                        payload=x[:m], form="stacked", prev=prev[:m],
                        server_state=state, **req))
                    got = back.execute(va.VoteRequest(
                        payload=torch.from_numpy(x[r]), form="leaf",
                        prev=prev[r] if f.n_stale else None,
                        server_state=(mesh_state if state else None), **req))
                    what = f"{name} leaf {codec}/{strat.value}/{f}"
                    _eq(what, got.votes, want.votes)
                    if state:
                        _eq(what + " flip_ema", got.server_state["flip_ema"],
                            want.server_state["flip_ema"][order])
                    if got.wire != dataclasses.replace(want.wire):
                        raise AssertionError(f"{what}: wire {got.wire} != "
                                             f"{want.wire}")
                    if rank == 0:
                        RECORD["votes"].append(dict(
                            what=what, m=m, prev=True, codec=codec,
                            strategy=strat.value, failures=_fail(f), step=3,
                            salt=11, ema=_np(state and state["flip_ema"]),
                            order=order, votes=_np(got.votes),
                            mesh_ema=_np(state and got.server_state[
                                "flip_ema"]), wire=_wire(got.wire)))
        # the five oblivious adversaries, row by row
        s_all = sc.sign_ternary(torch.from_numpy(x[:m]))
        for mode in ("sign_flip", "random", "zero", "colluding", "blind"):
            cfg = ByzantineConfig(mode=mode, num_adversaries=5, seed=2,
                                  flip_prob=0.3)
            want = byzantine.apply_adversary_stacked(s_all.clone(), cfg,
                                                     step=7, salt=1)
            got = byzantine.apply_adversary(s_all[r].clone(), cfg, axes,
                                            step=7, salt=1)
            _eq(f"{name} adversary {mode}", got, want[r])
            rows = pm.gather_voters(got, axes)
            if rank == 0:
                RECORD["adversary"].append(dict(
                    what=f"{name} adversary {mode}", signs=_np(s_all),
                    cfg=dataclasses.asdict(cfg), step=7, salt=1,
                    rows=_np(rows)))
        # a tree: every leaf its own vote; weighted folds one EMA update
        tree = {"a": torch.from_numpy(x[r, :70].reshape(7, 10)),
                "b": torch.from_numpy(x[r, 70:])}
        for codec in codecs.CODECS:
            c = codecs.get_codec(codec)
            for strat in c.supported_strategies:
                state = None
                if c.server_state:
                    ema = np.linspace(0.05, 0.3, m).astype(np.float32)
                    state = {"flip_ema": torch.from_numpy(ema)}
                    mesh_state = {"flip_ema": torch.from_numpy(
                        ema[order].copy())}
                got = back.execute(va.VoteRequest(
                    payload=tree, form="tree", strategy=strat, codec=codec,
                    server_state=mesh_state if state else None))
                want = virtual.execute(va.VoteRequest(
                    payload=x[:m], form="stacked", strategy=strat,
                    codec=codec, server_state=state))
                flat = torch.cat([got.votes["a"].reshape(-1),
                                  got.votes["b"]])
                what = f"{name} tree {codec}/{strat.value}"
                _eq(what, sc.sign_ternary(flat), want.votes)
                if state:
                    _eq(f"{name} tree ema", got.server_state["flip_ema"],
                        want.server_state["flip_ema"][order])
                if rank == 0:
                    RECORD["votes"].append(dict(
                        what=what, m=m, prev=False, codec=codec,
                        strategy=strat.value, failures=None, step=None,
                        salt=0, ema=_np(state and state["flip_ema"]),
                        order=order, votes=_np(sc.sign_ternary(flat)),
                        mesh_ema=_np(state and got.server_state[
                            "flip_ema"]), wire=None))
        # int16 counts (the count dtype of 200 voters) ride as int32
        impl = ve.STRATEGIES[S.PSUM_INT8]
        s16 = impl.pack(s_all[r].view(1, -1), 200)
        assert s16.dtype == torch.int16
        got = impl.exchange(s16, axes)
        _eq(f"{name} int16 psum", got[0],
            s_all.to(torch.int16).sum(0, dtype=torch.int16))
        # the dense mean: an all-reduce, within float32's rounding of the
        # sum (each partial sum rounds once, M - 1 adds)
        from repro_torch.core import majority_vote as mv
        g = {"w": torch.from_numpy(x[r].copy())}
        mean = mv.tree_mean(g, axes)["w"].double()
        exact = torch.from_numpy(x[:m]).double().sum(0) / m
        bound = (m * 2.0 ** -24 * torch.from_numpy(np.abs(x[:m])).double()
                 .sum(0) / m + 2.0 ** -24 * exact.abs())
        if not bool(((mean - exact).abs() <= bound).all()):
            raise AssertionError(f"{name} tree_mean outside its bound")
    # the stacked form: every rank passes the payload; the first M vote
    back = va.MeshBackend(device="cpu")
    for m in (8, 5):
        for codec in codecs.CODECS:
            for strat in codecs.get_codec(codec).supported_strategies:
                state = ({"flip_ema": torch.linspace(0.0, 0.2, m)}
                         if codecs.get_codec(codec).server_state else None)
                req = dict(payload=x[:m], form="stacked", strategy=strat,
                           codec=codec, prev=prev[:m], step=2,
                           failures=va.FailureSpec(n_stale=1, byz=(
                               ByzantineConfig(mode="random",
                                               num_adversaries=2))),
                           server_state=state)
                got = back.execute(va.VoteRequest(**req))
                want = virtual.execute(va.VoteRequest(**req))
                what = f"stacked M={m} {codec}/{strat.value}"
                _eq(what, got.votes, want.votes)
                if state:
                    _eq("stacked ema", got.server_state["flip_ema"],
                        want.server_state["flip_ema"])
                if rank == 0:
                    RECORD["votes"].append(dict(
                        what=what, m=m, prev=True, codec=codec,
                        strategy=strat.value,
                        failures=_fail(req["failures"]), step=2, salt=0,
                        ema=_np(state and state["flip_ema"]), order=None,
                        votes=_np(got.votes), mesh_ema=_np(
                            state and got.server_state["flip_ema"]),
                        wire=_wire(got.wire)))
    assert "needs 9 ranks" in back.why_unsupported(va.VoteRequest(
        payload=np.zeros((9, 4), np.float32), form="stacked"))


# ---------------------------------------------------------------------------
# b. plans
# ---------------------------------------------------------------------------


def check_plans(rank):
    from repro_torch.configs.base import ByzantineConfig, VoteStrategy as S
    from repro_torch.core import sign_compress as sc
    from repro_torch.core import vote_api as va
    from repro_torch.core import vote_plan as vp
    meshes = _meshes()
    rng = np.random.default_rng(SEED + 1)
    shapes = {"embed.table": (6, 11), "body.w": (9, 13), "head": (29,)}
    n = sum(int(np.prod(s)) for s in shapes.values())
    x = rng.normal(size=(WORLD, n)).astype(np.float32)
    x[:, 3:7] = 0.0
    RECORD["plan_x"], RECORD["plan_shapes"] = x, shapes
    virtual = va.VirtualBackend(device="cpu")
    for name, mesh in meshes.items():
        if not mesh.member:
            continue
        m, r, axes = mesh.size, mesh.replica_index(), mesh.vote_axes
        order = _data_major(mesh)
        maps = [((), "sign1bit", S.ALLGATHER_1BIT),
                ((("embed*", "ternary2bit"),), "sign1bit", S.ALLGATHER_1BIT),
                ((("body*", "weighted_vote"), ("embed*", "ternary2bit")),
                 "sign1bit", S.ALLGATHER_1BIT),
                ((), "sign1bit", S.PSUM_INT8),
                ((), "ef_sign", S.HIERARCHICAL)]
        for codec_map, default, strat in maps:
            plan = vp.build_plan(shapes, bucket_bytes=9, codec_map=codec_map,
                                 default_codec=default, strategy=strat,
                                 data_size=mesh.data, pod_size=mesh.pod)
            state = None
            if plan.has_server_state:
                ema = np.linspace(0.0, 0.3, m).astype(np.float32)
                state = {"flip_ema": torch.from_numpy(ema)}
                mstate = {"flip_ema": torch.from_numpy(ema[order].copy())}
            want = virtual.execute(va.VoteRequest(
                payload=x[:m], form="stacked", plan=plan,
                server_state=state))
            tree = {}
            for slot in plan.leaves:
                tree[slot.name] = torch.from_numpy(
                    x[r, slot.offset:slot.offset + slot.length]
                    .reshape(slot.shape))
            for overlap in (False, True):
                what = f"{name} plan {codec_map}/{strat.value}/{overlap}"
                flat = sc.sign_ternary(torch.from_numpy(x[r]))
                got = va.MeshBackend(axes=axes, device="cpu").execute(
                    va.VoteRequest(payload=flat, form="leaf", plan=plan,
                                   overlap=overlap,
                                   server_state=mstate if state else None))
                _eq(what, got.votes, want.votes)
                votes, st, diag = vp.plan_tree_vote(
                    plan, tree, axes, server_state=mstate if state else None,
                    diagnostics=True)
                got = torch.cat([votes[s.name].reshape(-1).to(torch.int8)
                                 for s in plan.leaves])
                _eq(what + " tree", got, want.votes)
                if state:
                    _eq(what + " ema", st["flip_ema"],
                        want.server_state["flip_ema"][order])
                v2, _ = vp.plan_vote_signs(plan, flat, axes,
                                           mstate if state else None)
                _eq(what + " plan_vote_signs", v2, want.votes)
                if rank == 0:
                    RECORD["plans"].append(dict(
                        what=what, m=m, bucket_bytes=9,
                        codec_map=codec_map, default=default,
                        strategy=strat.value, data=mesh.data, pod=mesh.pod,
                        byz=None, step=None,
                        ema=_np(state and state["flip_ema"]), order=order,
                        votes=_np(got), mesh_ema=_np(
                            state and st["flip_ema"])))
            if strat == S.ALLGATHER_1BIT and not plan.has_server_state:
                _eq(f"{name} plan_vote_stacked", vp.plan_vote_stacked(
                    plan, torch.from_numpy(x[:m])), want.votes)
        # a plan under an adversary: the flat buffer corrupted once
        byz = ByzantineConfig(mode="blind", num_adversaries=3, seed=4,
                              flip_prob=0.6)
        plan = vp.build_plan(shapes, bucket_bytes=7,
                             strategy=S.ALLGATHER_1BIT)
        want = virtual.execute(va.VoteRequest(
            payload=x[:m], form="stacked", plan=plan, step=5,
            failures=va.FailureSpec(byz=byz)))
        tree = {s.name: torch.from_numpy(
            x[r, s.offset:s.offset + s.length].reshape(s.shape))
            for s in plan.leaves}
        votes, _, _ = vp.plan_tree_vote(plan, tree, axes, byz=byz, step=5)
        got = torch.cat([votes[s.name].reshape(-1).to(torch.int8)
                         for s in plan.leaves])
        _eq(f"{name} plan adversary", got, want.votes)
        if rank == 0:
            RECORD["plans"].append(dict(
                what=f"{name} plan adversary", m=m, bucket_bytes=7,
                codec_map=(), default="sign1bit",
                strategy=S.ALLGATHER_1BIT.value, data=1, pod=1,
                byz=dataclasses.asdict(byz), step=5, ema=None, order=None,
                votes=_np(got), mesh_ema=None))


# ---------------------------------------------------------------------------
# c. the trainer
# ---------------------------------------------------------------------------

GB, SEQ, STEPS = 4, 16, 2


def _train_cfgs():
    from repro_torch.configs import base
    S = base.VoteStrategy

    def opt(**kw):
        d = dict(kind="signum_vote", learning_rate=1e-3, momentum=0.9,
                 vote_strategy=S.ALLGATHER_1BIT)
        d.update(kw)
        return base.OptimizerConfig(**d)
    byz = base.ByzantineConfig(mode="sign_flip", num_adversaries=1)
    # (label, mesh, optimizer, train options)
    return [
        ("sign1bit_allgather", "data4", opt(), {}),
        ("sign1bit_psum", "data4", opt(vote_strategy=S.PSUM_INT8), {}),
        ("sign1bit_hier_pod", "pod2x2", opt(vote_strategy=S.HIERARCHICAL),
         {}),
        ("ternary2bit", "data4", opt(codec="ternary2bit"), {}),
        ("ef_sign", "data4", opt(codec="ef_sign"), {}),
        ("weighted_vote", "data4", opt(codec="weighted_vote"), {}),
        ("signsgd", "data4", opt(momentum=0.0, kind="signsgd_vote",
                                 vote_strategy=S.PSUM_INT8), {}),
        ("mode_b", "data4", opt(kind="signsgd_vote",
                                momentum_mode=base.MomentumMode.GLOBAL,
                                vote_strategy=S.HIERARCHICAL), {}),
        ("plan_map", "data4", opt(bucket_bytes=512, overlap=True,
                                  codec_map=(("embed*", "ternary2bit"),
                                             ("*", "sign1bit"))), {}),
        ("diag_adversary", "data4", opt(), {"diagnostics": True,
                                            "byzantine": byz}),
        ("diag_plan", "pod2x2", opt(bucket_bytes=1024,
                                    vote_strategy=S.HIERARCHICAL),
         {"diagnostics": True, "byzantine": byz}),
    ]


def _cfg_pair(opt, extra):
    from repro_torch.configs import base
    cfg = dataclasses.replace(base.reduced_config(base.get_config(
        "glm4-9b")), dtype="float32")
    tcfg = base.TrainConfig(global_batch=GB, seq_len=SEQ, optimizer=opt,
                            **extra)
    return cfg, tcfg


def _state_digest(params, state, voter):
    """sha256 of the params, the momentum and residual (of a stacked state,
    voter `voter`'s rows of the per-voter ones) and the codec state."""
    parts = [params[k] for k in sorted(params)]
    for key in ("momentum", "error"):
        for k in sorted(state.get(key, {})):
            t = state[key][k]
            stacked = voter is not None and t.dim() > params[k].dim()
            parts.append(t[voter] if stacked else t)
    for k in sorted(state.get("codec", {})):
        parts.append(state["codec"][k])
    return _digest(*parts)


def _run_steps(art, cfg, tcfg, params, state):
    from repro_torch.data.pipeline import SyntheticLMPipeline
    pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, SEQ, seed=0)
    out = []
    for step in range(STEPS):
        tokens = pipe.global_batch_at(step)["tokens"]
        params, state, met = art.step_fn(params, state, {"tokens": tokens},
                                         step)
        out.append({k: (float(v) if not isinstance(v, float) else v)
                    for k, v in met.items()})
    return params, state, out


def check_trainer(rank):
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.train import train_step as TS
    meshes = {"data4": ProcessMesh((4,), ("data",)),
              "pod2x2": ProcessMesh((2, 2), ("pod", "data"))}
    cfgs = _train_cfgs()
    mine = {}
    if rank >= 4:
        # the stacked twins, one configuration per spare rank in turn
        for j, (label, _, opt, extra) in enumerate(cfgs):
            if j % 4 != rank - 4:
                continue
            cfg, tcfg = _cfg_pair(opt, extra)
            art = TS.make_train_step(cfg, tcfg, 4, device="cpu")
            params, state = TS.materialize_state(
                cfg, tcfg, art, torch.Generator().manual_seed(0))
            params, state, mets = _run_steps(art, cfg, tcfg, params, state)
            mine[label] = {"metrics": mets, "digests": [
                _state_digest(params, state, v) for v in range(4)]}
    else:
        for label, mname, opt, extra in cfgs:
            cfg, tcfg = _cfg_pair(opt, extra)
            art = TS.make_train_step(cfg, tcfg, device="cpu",
                                     mesh=meshes[mname])
            params, state = TS.materialize_state(
                cfg, tcfg, art, torch.Generator().manual_seed(0))
            params, state, mets = _run_steps(art, cfg, tcfg, params, state)
            mine[label] = {"metrics": mets,
                           "digest": _state_digest(params, state, None)}
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    if rank < 4:
        twins = {}
        for d in every[4:]:
            twins.update(d)
        for label, _, _, _ in cfgs:
            got, want = mine[label], twins[label]
            if got["metrics"] != want["metrics"]:
                raise AssertionError(f"trainer {label}: mesh metrics "
                                     f"{got['metrics']} != stacked "
                                     f"{want['metrics']}")
            if got["digest"] != want["digests"][rank]:
                raise AssertionError(f"trainer {label}: rank {rank}'s state "
                                     "differs from the stacked voter's")
    check_dense(rank, meshes["data4"])
    reference_step(rank, meshes["data4"])


#: the reference's M = 4 step (tests/torch_train_step_common.py's
#: composed step): global batch, sequence, learning rate, beta
REF_GB, REF_SEQ, REF_LR, REF_BETA = 8, 64, 1e-3, 0.9


def reference_step(rank, mesh):
    """One mesh step of the 1-bit wire from the reference's start state
    and batch (``reference_step.npz``, when the scratch directory holds
    it): each rank writes its loss, parameters and momentum to
    ``mesh_step_rank<r>.npz``."""
    from repro_torch.configs import base
    from repro_torch.models import model as tM
    from repro_torch.train import train_step as TS
    path = os.path.join(SCRATCH, "reference_step.npz")
    if not mesh.member or not os.path.exists(path):
        return
    with np.load(path) as z:
        start = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
        tokens = z["tokens"]
    opt = base.OptimizerConfig(kind="signum_vote", learning_rate=REF_LR,
                               momentum=REF_BETA,
                               vote_strategy=base.VoteStrategy.ALLGATHER_1BIT)
    cfg = dataclasses.replace(base.reduced_config(base.get_config(
        "glm4-9b")), dtype="float32")
    tcfg = base.TrainConfig(global_batch=REF_GB, seq_len=REF_SEQ,
                            optimizer=opt)
    art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    params = tM.params_from_numpy(start, device="cpu")
    state = art.optimizer.init(params)
    params, state, met = art.step_fn(params, state, {"tokens": tokens}, 0)
    np.savez(os.path.join(SCRATCH, f"mesh_step_rank{rank}.npz"),
             loss=np.float64(met["loss"]),
             **{"p/" + k: v.numpy() for k, v in params.items()},
             **{"m/" + k: v.float().numpy()
                for k, v in state["momentum"].items()})


def check_dense(rank, mesh):
    """One sgd step on the mesh against the stacked step: the parameters
    within lr times the rounding bound of the mean gradient."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.train import train_step as TS
    from repro_torch.configs import base
    opt = base.OptimizerConfig(kind="sgd", learning_rate=1e-2)
    cfg, tcfg = _cfg_pair(opt, {})
    tokens = SyntheticLMPipeline(cfg, GB, SEQ, seed=0).global_batch_at(0)[
        "tokens"]
    if not mesh.member:
        return
    twin = TS.make_train_step(cfg, tcfg, 4, device="cpu")
    tp, ts = TS.materialize_state(cfg, tcfg, twin,
                                  torch.Generator().manual_seed(0))
    p0 = {k: v.clone() for k, v in tp.items()}
    per = GB // 4
    grads = [TS.voter_grads(cfg, tcfg, p0, torch.as_tensor(
        tokens[v * per:(v + 1) * per]))[0] for v in range(4)]
    tp, ts, _ = twin.step_fn(tp, ts, {"tokens": tokens}, 0)
    art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    mp_, ms = TS.materialize_state(cfg, tcfg, art,
                                   torch.Generator().manual_seed(0))
    mp_, ms, _ = art.step_fn(mp_, ms, {"tokens": tokens}, 0)
    u = 2.0 ** -24
    for k in tp:
        s = sum(g[k].double().abs() for g in grads)
        bound = 1e-2 * (2 * 4 * u * s / 4) + 2 * u * p0[k].double().abs()
        diff = (mp_[k].double() - tp[k].double()).abs()
        if not bool((diff <= bound).all()):
            raise AssertionError(f"sgd {k}: mesh - stacked "
                                 f"{float(diff.max())} over the bound")


# ---------------------------------------------------------------------------
# d. drills
# ---------------------------------------------------------------------------


def harness_specs():
    """The reference's tier-2 harness specs
    (``tests/tier2/scenario_harness.py``), in the port's classes."""
    from repro_torch.configs.base import VoteStrategy as S
    from repro_torch.sim import (AdversarySpec, ElasticEvent, PlanSpec,
                                 ScenarioSpec)
    return [
        ScenarioSpec("h8/honest7", n_workers=7, n_steps=5, dim=129,
                     strategy=S.PSUM_INT8),
        ScenarioSpec("h8/flip_stale", n_workers=8, n_steps=5, dim=128,
                     strategy=S.ALLGATHER_1BIT,
                     adversary=AdversarySpec("sign_flip", 0.25),
                     straggler_fraction=0.25),
        ScenarioSpec("h8/random", n_workers=8, n_steps=5, dim=100,
                     strategy=S.PSUM_INT8,
                     adversary=AdversarySpec("random", 0.375)),
        ScenarioSpec("h8/blind_half", n_workers=8, n_steps=5, dim=96,
                     strategy=S.HIERARCHICAL,
                     adversary=AdversarySpec("blind", 0.5, flip_prob=0.8)),
        ScenarioSpec("h8/zero", n_workers=8, n_steps=4, dim=64,
                     strategy=S.HIERARCHICAL,
                     adversary=AdversarySpec("zero", 0.25)),
        ScenarioSpec("h8/collude_elastic", n_workers=8, n_steps=9, dim=64,
                     strategy=S.PSUM_INT8,
                     adversary=AdversarySpec("colluding", 0.375),
                     straggler_fraction=0.125,
                     elastic=(ElasticEvent(3, 4, "pod loss"),
                              ElasticEvent(6, 6, "rejoin"))),
        ScenarioSpec("h8/ef_flip_stale", n_workers=8, n_steps=6, dim=100,
                     strategy=S.ALLGATHER_1BIT, codec="ef_sign",
                     adversary=AdversarySpec("sign_flip", 0.25),
                     straggler_fraction=0.25),
        ScenarioSpec("h8/ternary_random", n_workers=8, n_steps=6, dim=90,
                     strategy=S.ALLGATHER_1BIT, codec="ternary2bit",
                     adversary=AdversarySpec("random", 0.375)),
        ScenarioSpec("h8/weighted_flip_elastic", n_workers=8, n_steps=8,
                     dim=96, strategy=S.ALLGATHER_1BIT,
                     codec="weighted_vote",
                     adversary=AdversarySpec("sign_flip", 0.375),
                     elastic=(ElasticEvent(4, 6, "pod loss"),)),
        ScenarioSpec("h8/plan_mixed_collude", n_workers=8, n_steps=6,
                     dim=128, strategy=S.ALLGATHER_1BIT,
                     adversary=AdversarySpec("colluding", 0.375),
                     plan=PlanSpec(bucket_bytes=8,
                                   leaves=(("embed.table", 48),
                                           ("body.w", 80)),
                                   codec_map=(("embed*", "ternary2bit"),
                                              ("*", "sign1bit")))),
        ScenarioSpec("h8/plan_weighted_elastic", n_workers=8, n_steps=8,
                     dim=96, strategy=S.ALLGATHER_1BIT,
                     codec="weighted_vote",
                     adversary=AdversarySpec("sign_flip", 0.375),
                     elastic=(ElasticEvent(4, 6, "pod loss"),),
                     plan=PlanSpec(bucket_bytes=6)),
        ScenarioSpec("h8/plan_hier_stale", n_workers=8, n_steps=5,
                     dim=100, strategy=S.HIERARCHICAL,
                     straggler_fraction=0.25,
                     adversary=AdversarySpec("random", 0.25),
                     plan=PlanSpec(bucket_bytes=5)),
    ]


class FileDraws:
    """The reference's draws, handed over as numpy (``draws.pkl``: the
    start point of each spec and its noise by (step, voters))."""

    def __init__(self, path):
        with open(path, "rb") as f:
            self.x0, self.table = pickle.load(f)

    def init_x(self, spec):
        return self.x0[spec.name]

    def noise(self, spec, step, m):
        return self.table[(spec.name, step, m)]


def check_drills(rank):
    from repro_torch.core.attacks import breaking_point
    from repro_torch.sim import ScenarioRunner
    path = os.path.join(SCRATCH, "draws.pkl")
    draws = FileDraws(path) if os.path.exists(path) else None
    for spec in harness_specs():
        style = "data_only" if spec.name == "h8/flip_stale" else "data_model"
        tm = ScenarioRunner(spec, backend="mesh", device="cpu",
                            mesh_style=style, draws=draws).run()
        tv = ScenarioRunner(spec, backend="virtual", device="cpu",
                            draws=draws).run()
        if tm.digest != tv.digest:
            raise AssertionError(f"{spec.name}: mesh digest {tm.digest[:12]}"
                                 f" != virtual {tv.digest[:12]}")
        if [s.margin for s in tm.steps] != [s.margin for s in tv.steps]:
            raise AssertionError(f"{spec.name}: margins differ")
        RECORD["drills"][spec.name] = dict(
            digest=tm.digest, margins=[s.margin for s in tm.steps],
            reference_draws=draws is not None)
    rows = breaking_point.identity_rows(device="cpu")
    if [v for _, v, _ in rows] != [1.0] * len(rows):
        raise AssertionError(f"identity rows {rows}")


# ---------------------------------------------------------------------------
# e. fsdp: the fused ZeRO backward and the ZeRO-3 trainer
# ---------------------------------------------------------------------------


def check_fused_gather(rank):
    """The reference's identity (``tests/distributed_harness.py:93-113``)
    on the port's gather: rank r's loss ``sum((x_r @ W) ** 2)`` through
    the gather of its slice of W; the gradient of its slice must be its
    slice of the sign of the summed per-rank signs of the whole gradients
    (the dense form: of their mean)."""
    from repro_torch.core import majority_vote as mv
    from repro_torch.core import sign_compress as sc
    rng = np.random.default_rng(SEED + 5)
    w_full = rng.normal(size=(16, 24)).astype(np.float32)
    xs = rng.normal(size=(WORLD, 4, 16)).astype(np.float32)
    W, X = torch.from_numpy(w_full), torch.from_numpy(xs)
    fsdp = RECORD.setdefault("fsdp", [])
    for name, mesh in _meshes().items():
        if not mesh.member or name == "first7":
            continue
        r = mesh.replica_index()
        d, data = mesh.axis_index("data"), mesh.data

        def loss_of(w, x):
            return torch.sum((x @ w) ** 2)
        grads = []
        for i in range(mesh.size):
            w = W.clone().requires_grad_()
            grads.append(torch.autograd.grad(loss_of(w, X[i]), [w])[0])
        count = sum(sc.sign_ternary(g).to(torch.int32) for g in grads)
        mean = sum(grads) / mesh.size
        for dim in (0, 1):
            size = W.shape[dim] // data
            part = [slice(None)] * 2
            part[dim] = slice(d * size, (d + 1) * size)
            part = tuple(part)
            for vote in (True, False):
                gather = mv.make_gather_vote(dim, mesh.vote_axes, vote=vote)
                w = W[part].clone().requires_grad_()
                got = torch.autograd.grad(loss_of(gather(w), X[r]), [w])[0]
                want = (torch.sign(count).float() if vote else mean)[part]
                if vote:
                    _eq(f"fused vote {name} dim {dim} rank {rank}", got,
                        want)
                elif not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
                    raise AssertionError(f"fused mean {name} dim {dim}")
                if rank == 0:
                    fsdp.append(dict(mesh=name, rank=rank, replica=r,
                                     data_index=d, dim=dim, vote=vote,
                                     got=_np(got)))
    RECORD["fsdp_inputs"] = {"w": w_full, "xs": xs}


def _fsdp_cfgs():
    from repro_torch.configs import base
    S = base.VoteStrategy

    def opt(**kw):
        d = dict(kind="signsgd_vote", momentum_mode=base.MomentumMode.GLOBAL,
                 learning_rate=1e-3, momentum=0.9,
                 vote_strategy=S.HIERARCHICAL)
        d.update(kw)
        return base.OptimizerConfig(**d)
    flip = base.ByzantineConfig(mode="sign_flip", num_adversaries=1)
    rand = base.ByzantineConfig(mode="random", num_adversaries=1)
    # (label, mesh, optimizer, train options); fsdp on in every one
    return [
        ("mode_b_flip", "data4", opt(), {"byzantine": flip,
                                         "remat": "nested"}),
        ("mode_b_pod_random", "pod2x2", opt(), {"byzantine": rand}),
        ("mode_b_dots", "data4", opt(vote_strategy=S.ALLGATHER_1BIT),
         {"remat": "dots", "microbatches": 1}),
        ("mode_b_plan_diag", "data4", opt(bucket_bytes=4096),
         {"diagnostics": True}),
        ("signsgd_beta0", "data4", opt(momentum=0.0), {}),
        # Mode A at beta 0: the fused leaves' votes voted again, each
        # rank's slice against the others'
        ("mode_a_beta0_random", "data4", opt(
            momentum_mode=base.MomentumMode.PER_WORKER, momentum=0.0),
         {"byzantine": rand}),
        ("mode_a_beta0_ef_delayed_diag", "data4", opt(
            momentum_mode=base.MomentumMode.PER_WORKER, momentum=0.0,
            codec="ef_sign", delayed_vote=True,
            vote_strategy=S.ALLGATHER_1BIT), {"diagnostics": True}),
        # qwen3-moe's preset: the router and the 4-D expert leaves fused
        ("mode_b_qwen3_moe", "data4", opt(),
         {"remat": "nested", "arch": "qwen3-moe-235b-a22b"}),
    ]


def _fsdp_pair(opt, extra):
    from repro_torch.configs import base
    extra = dict(extra)
    cfg = dataclasses.replace(base.reduced_config(base.get_config(
        extra.pop("arch", "qwen1.5-32b"))), dtype="float32")
    train = {"microbatches": 2, **extra}
    tcfg = base.TrainConfig(global_batch=8, seq_len=SEQ, optimizer=opt,
                            fsdp=True, **train)
    return cfg, tcfg


def _slices(tree, dims, index, count):
    from repro_torch.distributed import sharding as shd
    return shd.shard_tree(tree, dims, index, count)


def check_fsdp_trainer(rank):
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.train import train_step as TS
    meshes = {"data4": ProcessMesh((4,), ("data",)),
              "pod2x2": ProcessMesh((2, 2), ("pod", "data"))}
    cfgs = _fsdp_cfgs()
    mine = {}
    if rank >= 4:
        for j, (label, mname, opt, extra) in enumerate(cfgs):
            if j % 4 != rank - 4:
                continue
            cfg, tcfg = _fsdp_pair(opt, extra)
            art = TS.make_train_step(cfg, tcfg, 4, device="cpu")
            params, state = TS.materialize_state(
                cfg, tcfg, art, torch.Generator().manual_seed(0))
            params, state, mets = _run_steps(art, cfg, tcfg, params, state)
            data = 2 if mname == "pod2x2" else 4
            # each mesh rank's slices: data index = rank % data; voter v's
            # residual row (a fused leaf's already v's slice)
            mine[label] = {"metrics": mets, "digests": [_state_digest(
                _slices(params, art.fused_dims, v % data, data),
                {"momentum": _slices(state.get("momentum", {}),
                                     art.fused_dims, v % data, data),
                 "error": {k: e[v] for k, e in state.get(
                     "error", {}).items()}},
                None) for v in range(4)]}
    else:
        for label, mname, opt, extra in cfgs:
            cfg, tcfg = _fsdp_pair(opt, extra)
            art = TS.make_train_step(cfg, tcfg, device="cpu",
                                     mesh=meshes[mname])
            params, state = TS.materialize_state(
                cfg, tcfg, art, torch.Generator().manual_seed(0))
            params, state, mets = _run_steps(art, cfg, tcfg, params, state)
            mine[label] = {"metrics": mets, "digest": _state_digest(
                params, {"momentum": state.get("momentum", {}),
                         "error": state.get("error", {})}, None)}
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    if rank < 4:
        twins = {}
        for d in every[4:]:
            twins.update(d)
        for label, _, _, _ in cfgs:
            got, want = mine[label], twins[label]
            if got["metrics"] != want["metrics"]:
                raise AssertionError(f"fsdp {label}: mesh metrics "
                                     f"{got['metrics']} != stacked "
                                     f"{want['metrics']}")
            if got["digest"] != want["digests"][rank]:
                raise AssertionError(f"fsdp {label}: rank {rank}'s slices "
                                     "differ from the stacked step's")
        if rank == 0:
            RECORD["fsdp_trainer"] = {label: mine[label]["metrics"]
                                      for label, _, _, _ in cfgs}
    check_fsdp_dense(rank, meshes["data4"])


def check_fsdp_dense(rank, mesh):
    """One sgd step with fsdp on the mesh against the stacked step: each
    rank's parameter slices within lr times the rounding bound of the mean
    gradient (float32 parameters, one microbatch)."""
    from repro_torch.configs import base
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.train import train_step as TS
    opt = base.OptimizerConfig(kind="sgd", learning_rate=1e-2)
    cfg, tcfg = _fsdp_pair(opt, {"microbatches": 1})
    tokens = SyntheticLMPipeline(cfg, 8, SEQ, seed=0).global_batch_at(0)[
        "tokens"]
    if not mesh.member:
        return
    twin = TS.make_train_step(cfg, tcfg, 4, device="cpu")
    tp, ts = TS.materialize_state(cfg, tcfg, twin,
                                  torch.Generator().manual_seed(0))
    p0 = {k: v.clone() for k, v in tp.items()}
    plain = dataclasses.replace(tcfg, fsdp=False)
    grads = [TS.voter_grads(cfg, plain, p0, torch.as_tensor(
        tokens[v * 2:(v + 1) * 2]))[0] for v in range(4)]
    tp, ts, _ = twin.step_fn(tp, ts, {"tokens": tokens}, 0)
    art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    if not art.fused_leaves:
        raise AssertionError("sgd with fsdp fused no leaf")
    mp_, ms = TS.materialize_state(cfg, tcfg, art,
                                   torch.Generator().manual_seed(0))
    mp_, ms, _ = art.step_fn(mp_, ms, {"tokens": tokens}, 0)
    d = mesh.axis_index("data")
    want = _slices(tp, art.fused_dims, d, 4)
    s = _slices({k: sum(g[k].double().abs() for g in grads) for k in p0},
                art.fused_dims, d, 4)
    p0 = _slices(p0, art.fused_dims, d, 4)
    u = 2.0 ** -24
    for k in want:
        bound = 1e-2 * (2 * 4 * u * s[k] / 4) + 2 * u * p0[k].double().abs()
        diff = (mp_[k].double() - want[k].double()).abs()
        if not bool((diff <= bound).all()):
            raise AssertionError(f"fsdp sgd {k}: mesh - stacked "
                                 f"{float(diff.max())} over the bound")


def check_fsdp(rank):
    check_fused_gather(rank)
    check_fsdp_trainer(rank)


# ---------------------------------------------------------------------------
# f. tensor parallelism over a "model" axis
# ---------------------------------------------------------------------------

#: the tp check's meshes, built by every rank in this order
TP_MESHES = (("d4m2", (4, 2), ("data", "model")),
             ("d2m4", (2, 4), ("data", "model")),
             ("m8", (8,), ("model",)))
#: a vote may flip only where some voter's |m'| is under this fraction of
#: its leaf's largest |m'| (float32: the TP sums' rounding moves m' by a
#: few ulps)
TP_FLIP_FRACTION = 1e-4
#: the families' float32 tolerance (tests/torch_family_common.py); with
#: microbatches the sign family's accumulator is bf16, which a few ulps of
#: float32 may round to a neighbour, and whose sum may cancel: one bf16
#: ulp (2^-7) of the value and of the leaf's largest there
F32_RTOL, F32_ATOL_REL, BF16_ACC_RTOL = 1e-4, 2e-5, 2.0 ** -7
#: the largest share of a leaf's coordinates whose vote may flip where no
#: per-voter momentum tells how close it was (Mode B, beta = 0)
TP_FLIP_SHARE = 1e-3
TP_GB, TP_SEQ = 8, 16
#: the encoder-decoder's stubbed frames a row
TP_FRAMES = 16


def _tp_cfgs():
    from repro_torch.configs import base
    S = base.VoteStrategy

    def opt(**kw):
        d = dict(kind="signum_vote", learning_rate=1e-3, momentum=0.9,
                 vote_strategy=S.ALLGATHER_1BIT)
        d.update(kw)
        return base.OptimizerConfig(**d)
    flip = base.ByzantineConfig(mode="sign_flip", num_adversaries=1)
    mode_b = opt(kind="signsgd_vote", momentum_mode=base.MomentumMode.GLOBAL,
                 vote_strategy=S.HIERARCHICAL)
    # (label, mesh, optimizer, train options)
    return [
        ("sign1bit_grouped", "d4m2", opt(), {}),
        ("sign1bit_repeat", "d2m4", opt(), {}),
        ("sign1bit_seq", "m8", opt(), {}),
        ("psum_int8", "d4m2", opt(vote_strategy=S.PSUM_INT8), {}),
        ("hierarchical_repeat", "d2m4", opt(vote_strategy=S.HIERARCHICAL),
         {"microbatches": 2}),
        ("ternary2bit", "d2m4", opt(codec="ternary2bit"), {}),
        ("ef_sign", "d4m2", opt(codec="ef_sign"), {}),
        ("weighted_vote", "d2m4", opt(codec="weighted_vote"), {}),
        ("signsgd_seq", "m8", opt(kind="signsgd_vote", momentum=0.0,
                                  vote_strategy=S.PSUM_INT8), {}),
        ("delayed_vote", "d2m4", opt(delayed_vote=True), {}),
        ("sign_flip_diag", "d4m2", opt(), {"diagnostics": True,
                                           "byzantine": flip}),
        ("mode_b_fsdp", "d4m2", mode_b, {"fsdp": True, "microbatches": 2,
                                         "remat": "full"}),
        ("sgd", "d2m4", opt(kind="sgd", learning_rate=1e-2), {}),
        # the other dense decoder-only archs (gemma3: windows and a tied
        # table; pixtral: a patch prefix)
        ("qwen1p5", "d4m2", opt(), {"arch": "qwen1.5-32b"}),
        ("deepseek", "d2m4", opt(), {"arch": "deepseek-67b"}),
        ("gemma3", "d2m4", opt(), {"arch": "gemma3-12b"}),
        ("pixtral", "m8", opt(), {"arch": "pixtral-12b"}),
    ]


def _tp_pair(opt, extra):
    from repro_torch.configs import base
    extra = dict(extra)
    cfg = dataclasses.replace(base.reduced_config(base.get_config(
        extra.pop("arch", "glm4-9b"))), dtype="float32")
    tcfg = base.TrainConfig(global_batch=TP_GB, seq_len=TP_SEQ,
                            optimizer=opt, **extra)
    return cfg, tcfg


def _close(what, got, want, rtol, atol):
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol,
                                                     atol=atol):
        diff = float((got - want).abs().max()) if got.shape == want.shape \
            else None
        raise AssertionError(f"{what}: differs by {diff} (rtol {rtol}, "
                             f"atol {atol})")


def tp_bytes(cfg, tcfg, mesh) -> int:
    """``chip_smoke.tp_bytes``: a step's model-group bytes, counted from
    the layout (the card's phase 19 holds its ranks to the same count)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    return chip_smoke.tp_bytes(cfg, tcfg, mesh, TP_FRAMES)


def _gather_objects(obj, mesh) -> list:
    """`obj` of every rank of `mesh`, on every rank, in rank order
    (row-major over pod, data, model): gathered over each pod's (data,
    model) ranks, then over the pods."""
    import torch.distributed as dist
    ranks, group = mesh.group_of(("data", "model"))
    every = [obj] if group is None else [None] * len(ranks)
    if group is not None:
        dist.all_gather_object(every, obj, group=group)
    if mesh.pod == 1:
        return every
    ranks, group = mesh.group_of(("pod",))
    pods = [None] * len(ranks)
    dist.all_gather_object(pods, every, group=group)
    return [o for pod in pods for o in pod]


def _tp_join(art, tcfg, mesh, params, state):
    """The stacked twin's (params, state) joined from every rank's blocks
    of a tensor-parallel step's: the parameters, a Mode B momentum and the
    banked votes over the whole mesh, each voter's Mode A momentum and
    residual over its model ranks, stacked in voter order."""
    from repro_torch.core import signum
    from repro_torch.distributed import sharding as shd
    mine = {"params": params, **{k: state[k] for k in (
        "momentum", "error", "delayed") if k in state}}
    # every rank of the mesh's blocks, in its rank order
    trees = _gather_objects({k: {n: t.clone() for n, t in v.items()}
                             for k, v in mine.items()}, mesh)
    specs, sizes = art.param_specs, art.mesh_sizes
    full = shd.join_shards([t["params"] for t in trees], specs, sizes=sizes)
    out = {"count": state["count"]}
    if "codec" in state:
        out["codec"] = {k: v.clone() for k, v in state["codec"].items()}
    for key in ("momentum", "error", "delayed"):
        if key not in mine:
            continue
        # Mode B's momentum and the banked votes are leaf-shaped; Mode A's
        # momentum and the residual one row per voter
        leaf_shaped = key == "delayed" or (
            key == "momentum" and not signum.per_worker(tcfg.optimizer))
        if leaf_shaped:
            out[key] = shd.join_shards([t[key] for t in trees], specs,
                                       sizes=sizes)
            continue
        rows = []
        for v in range(mesh.size):
            voter = [trees[v * mesh.model + m][key]
                     for m in range(mesh.model)]
            rows.append(shd.join_shards(voter, specs,
                                        sizes={"model": mesh.model}))
        out[key] = {k: torch.stack([r[k] for r in rows])
                    for k in rows[0]}
    return full, out


def _flippable(twin_state, twin_params, k, error0):
    """The coordinates of leaf k where some voter's vote input (the
    twin's m', or ef_sign's t = e + m' from the step's start residual
    `error0`) is under TP_FLIP_FRACTION of the leaf's largest (None
    without a per-voter momentum)."""
    m = twin_state.get("momentum", {}).get(k)
    if m is None or m.dim() == twin_params[k].dim():
        return None
    if k in error0:
        m = m.float() + error0[k].float()
    a = m.abs().float()
    return (a < TP_FLIP_FRACTION * a.max()).any(dim=0)


def tp_batch(cfg, tcfg, pipe, step):
    """Step `step`'s global batch: the pipeline's tokens, and a seeded
    patch prefix (the VLM) or seeded frames (the encoder-decoder)."""
    batch = {"tokens": pipe.global_batch_at(step)["tokens"]}
    gen = torch.Generator().manual_seed(step)
    if cfg.family.value == "vlm":
        batch["patch_embeds"] = torch.randn(
            (tcfg.global_batch, 4, cfg.d_model), generator=gen)
    if cfg.family.value == "audio":
        batch["enc_embeds"] = torch.randn(
            (tcfg.global_batch, TP_FRAMES, cfg.d_model), generator=gen)
    return batch


class AdversaryRecorder:
    """Within the block, each ``byzantine.evil_signs_`` call: (the signs it
    was handed, the signs it left, its counter map, the voter ids, the
    step)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.core import byzantine
        self.mod, self.orig = byzantine, byzantine.evil_signs_

        def evil_signs_(signs, cfg, ids, **kw):
            before = signs.clone()
            out = self.orig(signs, cfg, ids, **kw)
            self.calls.append((before, signs.clone(), {
                k: kw.get(k, 0) for k in ("offset", "block", "gap")},
                [int(i) for i in ids], kw.get("step")))
            return out
        byzantine.evil_signs_ = evil_signs_
        return self

    def __exit__(self, *exc):
        self.mod.evil_signs_ = self.orig


class BlockDraws:
    """Within the block, the stacked twin's fused ZeRO backward draws an
    adversary's signs of every leaf that `specs` cut over ``"model"``
    block by block, each of the `parts` blocks (of each layer of a stacked
    leaf) drawn as a whole from counter 0: what the reference's fused
    backward draws on each model rank, inside its region manual over
    ``"model"``. Other leaves draw as the twin does."""

    def __init__(self, specs, parts):
        self.specs, self.parts, self.leaf = specs, parts, None

    def __enter__(self):
        from repro_torch.core import byzantine
        from repro_torch.core import majority_vote as mv
        from repro_torch.core import sign_compress as sc
        from repro_torch.train import train_step as TS
        self.mv, self.orig = mv, mv.fused_signs
        self.cls, self.call = TS.StackedFusedVote, TS.StackedFusedVote.__call__
        ctx, call = self, self.call

        def named(vote, i, k, g):
            ctx.leaf = k
            return call(vote, i, k, g)

        def fused_signs(g, byz, replica, rows=1):
            spec = ctx.specs.get(ctx.leaf, ())
            if "model" not in spec or byz is None or byz.mode == "none" \
                    or replica >= byz.num_adversaries:
                return ctx.orig(g, byz, replica, rows)
            s = sc.sign_ternary(g)
            dim = spec.index("model")
            width = s.shape[dim] // ctx.parts
            for j in range(ctx.parts):
                blk = s.narrow(dim, j * width, width).contiguous()
                byzantine.evil_signs_(blk.view(rows, -1), byz,
                                      [replica] * rows, step=None)
                s.narrow(dim, j * width, width).copy_(blk)
            return s
        TS.StackedFusedVote.__call__ = named
        mv.fused_signs = fused_signs
        return self

    def __exit__(self, *exc):
        self.mv.fused_signs = self.orig
        self.cls.__call__ = self.call


def check_draws(what, byz, voter, mine, theirs, match):
    """Every draw of this rank's adversary (`mine`) against the stacked
    twin's (`theirs`) at the block's global coordinates: each call's
    counters (``prng.mapped_counters`` of its map) index a twin row of the
    same voter: a draw under a step takes the twin's i-th such row
    (`match` "order": leaf-wise) or its one flat row ("flat": a plan); a
    draw under no step (the fused backward's, per layer) takes the twin's
    longest such row (under a colluding key a draw depends on its counter
    alone). ``random`` / ``colluding``: the sent signs equal; ``blind``:
    the flip mask equal wherever the honest signs agree (at least
    TPA_HONEST_SHARE of them). Returns the coordinates checked."""
    from repro_torch.core import prng

    def rows_of(calls, stepped):
        return [(b[r], a[r]) for b, a, _, ids, step in calls
                for r, i in enumerate(ids)
                if i == voter and (step is not None) == stepped]
    stepped = rows_of(theirs, True)
    fused = rows_of(theirs, False)
    n_stepped = sum(1 for c in mine if c[4] is not None)
    if not mine or (n_stepped and not stepped) or (
            len(mine) > n_stepped and not fused):
        raise AssertionError(f"{what}: voter {voter}'s adversary drew "
                             f"{len(mine)} times, the twin's "
                             f"{len(stepped) + len(fused)}")
    if match == "order" and len(stepped) != n_stepped:
        raise AssertionError(f"{what}: {n_stepped} draws under a step "
                             f"against the twin's {len(stepped)}")
    checked = i = 0
    for b, a, cut, ids, step in mine:
        if ids != [voter] * b.shape[0]:
            raise AssertionError(f"{what}: a draw for ids {ids} on voter "
                                 f"{voter}'s rank")
        if step is None:
            tb, ta = max(fused, key=lambda r: r[0].numel())
        else:
            tb, ta = stepped[i] if match == "order" else stepped[0]
            i += 1
        b, a = b.reshape(-1), a.reshape(-1)
        pos = prng.mapped_counters(b.numel(), cut["offset"], 0,
                                   cut["block"], cut["gap"])
        if int(pos.max()) >= ta.numel():
            raise AssertionError(f"{what}: a draw reaches counter "
                                 f"{int(pos.max())} of a row of "
                                 f"{ta.numel()}")
        wb, wa = tb.reshape(-1)[pos], ta.reshape(-1)[pos]
        if byz.mode == "blind":
            same = b == wb
            if float(same.float().mean()) < TPA_HONEST_SHARE:
                raise AssertionError(f"{what}: a draw's honest signs "
                                     "agree with the twin's on "
                                     f"{float(same.float().mean())}")
            bad = ((a != b) != (wa != wb)) & same
        else:
            bad = a != wa
        if bool(bad.any()):
            raise AssertionError(f"{what}: a draw ({b.numel()} "
                                 f"coordinates, step {step}, map {cut}) "
                                 f"differs from the twin's at "
                                 f"{int(bad.sum())}")
        checked += b.numel()
    return checked


def tp_train_case(label, mesh, cfg, tcfg, record=None, routes=None,
                  draws=None):
    """STEPS steps of the model-axis train step over `mesh`, each from the
    state its stacked twin takes too (the mesh's, joined), held to the
    twin as ``check_tp`` sets out; `record`, when given, is called with
    (step, mesh params, mesh state) after each step; `draws` (a
    :func:`check_draws` match) holds the adversary's draws to the twin's
    and, under a plan, the vote axes' bytes to
    ``chip_smoke.tp_plan_vote_bytes``. Returns the count of coordinates
    whose vote flipped."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.distributed import mesh as pm
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import train_step as TS
    twin = TS.make_train_step(cfg, tcfg, mesh.size, device="cpu")
    art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    params, state = TS.materialize_state(
        cfg, tcfg, art, torch.Generator().manual_seed(0))
    pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, TP_SEQ, seed=0)
    coords, sizes = art.mesh_coords, art.mesh_sizes
    voter = mesh.replica_index()
    n_flips = 0
    for step in range(STEPS):
        # each step from one start: the twin takes the mesh's state
        tparams, tstate = _tp_join(art, tcfg, mesh, params, state)
        error0 = {k: v.clone() for k, v in tstate.get("error",
                                                     {}).items()}
        batch = tp_batch(cfg, tcfg, pipe, step)
        mesh.reset_stats()
        if routes is not None:
            routes.calls.clear()
        with AdversaryRecorder() as mine:
            params, state, met = art.step_fn(params, state, batch, step)
        ours = list(routes.calls) if routes is not None else None
        with AdversaryRecorder() as theirs, BlockDraws(
                art.param_specs if tcfg.fsdp else {}, mesh.model):
            tparams, tstate, tmet = twin.step_fn(tparams, tstate, batch,
                                                 step)
        if draws is not None and voter < tcfg.byzantine.num_adversaries:
            check_draws(f"tp {label} step {step}", tcfg.byzantine, voter,
                        mine.calls, theirs.calls, draws)
        elif mine.calls and voter >= tcfg.byzantine.num_adversaries:
            raise AssertionError(f"tp {label}: honest voter {voter} drew")
        if draws is not None and art.plan is not None:
            want = tp_plan_vote_bytes(art, tcfg)
            if mesh.stats.bytes != want:
                raise AssertionError(
                    f"tp {label} step {step}: the vote axes took "
                    f"{mesh.stats.bytes} bytes, the windows' count is "
                    f"{want}")
        del mine, theirs
        if routes is not None:
            routes.flips += route_flips(label, ours,
                                        routes.calls[len(ours):], voter,
                                        mesh.size)
        # the model group's bytes, counted from the layout
        if mesh.model_stats.bytes != tp_bytes(cfg, tcfg, mesh):
            raise AssertionError(
                f"tp {label} step {step}: the model group took "
                f"{mesh.model_stats.bytes} bytes, the layout's count "
                f"is {tp_bytes(cfg, tcfg, mesh)}")
        for key in ("loss", "ce", "vote_agreement", "vote_margin"):
            if key in tmet:
                got, exp = float(met[key]), float(tmet[key])
                if abs(got - exp) > 1e-5 * abs(exp) + (
                        0 if key in ("loss", "ce") else 1e-3):
                    raise AssertionError(f"tp {label} step {step}: "
                                         f"{key} {got} != twin {exp}")
        for k, p in params.items():
            spec = art.param_specs[k]

            def blk(t):
                return shd.shard_leaf(t, spec, coords, sizes)
            w = blk(tparams[k])
            bad = ~torch.isclose(p, w, rtol=1e-5, atol=1e-6)
            n_bad = int(bad.sum())
            fl = _flippable(tstate, tparams, k, error0)
            if n_bad and fl is not None:
                lost = bad & ~blk(fl)
                if bool(lost.any()):
                    raise AssertionError(
                        f"tp {label} step {step} {k}: "
                        f"{int(lost.sum())} coordinates differ where "
                        "no voter's |m'| was near zero")
            elif n_bad > TP_FLIP_SHARE * p.numel():
                raise AssertionError(
                    f"tp {label} step {step} {k}: {n_bad} of "
                    f"{p.numel()} coordinates differ")
            n_flips += n_bad
            for key in ("momentum", "error"):
                if k not in state.get(key, {}):
                    continue
                t = tstate[key][k]
                t = t[voter] if t.dim() > tparams[k].dim() else t
                t = blk(t).float()
                g = state[key][k].float()
                acc = tcfg.microbatches > 1
                rtol = BF16_ACC_RTOL if acc else F32_RTOL
                ok = torch.isclose(g, t, rtol=rtol, atol=max(
                    1e-6, (BF16_ACC_RTOL if acc else F32_ATOL_REL)
                    * float(t.abs().max())))
                # a flipped vote moves the residual (Mode B: the
                # momentum) at its coordinate
                ok |= bad.view(ok.shape)
                if draws is not None and not bool(ok.all()) and \
                        t.dim() == p.dim() and key == "momentum":
                    # Mode B's fused vote at a near tie (an adversary's
                    # count makes more): a flipped microbatch vote moves u
                    # by whole steps of (1 - beta) / microbatches, on at
                    # most TP_FLIP_SHARE of the leaf (as the parameters)
                    q = (1 - tcfg.optimizer.momentum) / tcfg.microbatches
                    k_ = (g - t) / q
                    whole = ((k_ - k_.round()).abs() < 1e-3) & (
                        k_.round() != 0) & ~ok
                    if int(whole.sum()) <= TP_FLIP_SHARE * g.numel():
                        ok |= whole
                        n_flips += int(whole.sum())
                if not bool(ok.all()):
                    raise AssertionError(
                        f"tp {label} step {step} {key} {k}: "
                        f"{int((~ok).sum())} coordinates out of the "
                        f"families' tolerance: {g[~ok][:4].tolist()} "
                        f"against {t[~ok][:4].tolist()} (largest "
                        f"{float(t.abs().max())})")
        # replicated leaves bit-equal over the model group
        for k, p in params.items():
            if "model" in art.param_specs[k] or mesh.model == 1:
                continue
            every = pm.model_gather(p.reshape(1, -1), mesh, dim=0)
            if not bool((every == p.reshape(1, -1)).all()):
                raise AssertionError(f"tp {label} step {step}: "
                                     f"replicated {k} differs over the "
                                     "model group")
        if record is not None:
            record(step, params, state)
    return n_flips


def check_tp(rank):
    from repro_torch.distributed import mesh as pm
    from repro_torch.distributed.mesh import ProcessMesh
    meshes = {name: ProcessMesh(shape, axes)
              for name, shape, axes in TP_MESHES}
    # a float sum over more than two ranks by blocks (an all-to-all) is the
    # gathered parts' sum bit for bit
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(1000, generator=gen).to(torch.bfloat16)
    whole = pm.model_sum(x, meshes["m8"])
    pm.A2A_MIN_BYTES, default = 0, pm.A2A_MIN_BYTES
    try:
        _eq("model_sum by blocks", pm.model_sum(x, meshes["m8"]).view(
            torch.int16), whole.view(torch.int16))
    finally:
        pm.A2A_MIN_BYTES = default
    flips = {}
    # the training runs sum by blocks wherever a line has more than two
    # ranks (the card's prefill sizes do; these small ones would not)
    pm.A2A_MIN_BYTES = 0
    for label, mname, opt, extra in _tp_cfgs():
        cfg, tcfg = _tp_pair(opt, extra)
        flips[label] = tp_train_case(label, meshes[mname], cfg, tcfg)
    pm.A2A_MIN_BYTES = default
    every = [None] * WORLD
    dist.all_gather_object(every, flips)
    if rank == 0:
        RECORD["tp_flips"] = every
    # the vote API's AUTO prices the global payload: a rank's shard times
    # the model ranks
    from repro_torch.core import vote_api as va
    for mesh in meshes.values():
        if va.global_numel(203, mesh.vote_axes) != 203 * mesh.model:
            raise AssertionError(f"AUTO's size over {mesh!r}")
    check_tp_serve(rank, meshes)
    tp_reference_step(rank, meshes["d4m2"])
    tp_reference_decode(rank)


def tp_plan_vote_bytes(art, tcfg) -> int:
    """``chip_smoke.tp_plan_vote_bytes``: the vote axes' bytes of one plan
    step on this rank, counted from its windows."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    return chip_smoke.tp_plan_vote_bytes(art, tcfg)


#: blind draws: the least share of a draw's coordinates where the rank's
#: honest signs must equal the twin's (float32: they differ only where an
#: m' is within rounding of zero)
TPA_HONEST_SHARE = 0.99
#: the plans' bucket size (the reference's run reads the same)
TPA_BUCKET_BYTES = 4096


def _tpa_cfgs():
    from repro_torch.configs import base
    S = base.VoteStrategy

    def opt(**kw):
        d = dict(kind="signum_vote", learning_rate=1e-3, momentum=0.9,
                 vote_strategy=S.ALLGATHER_1BIT)
        d.update(kw)
        return base.OptimizerConfig(**d)

    def byz(mode, n=1, p=0.5):
        return base.ByzantineConfig(mode=mode, num_adversaries=n, seed=3,
                                    flip_prob=p)
    plan = dict(bucket_bytes=TPA_BUCKET_BYTES)
    mode_b = opt(kind="signsgd_vote", momentum_mode=base.MomentumMode.GLOBAL,
                 vote_strategy=S.HIERARCHICAL)
    # (label, optimizer, train options, the draws' match)
    return [
        ("random", opt(), {"byzantine": byz("random")}, "order"),
        ("colluding", opt(vote_strategy=S.PSUM_INT8),
         {"byzantine": byz("colluding", 2)}, "order"),
        ("blind", opt(vote_strategy=S.HIERARCHICAL),
         {"byzantine": byz("blind", 1, 0.9), "diagnostics": True}, "order"),
        ("plan_blind", opt(overlap=True, delayed_vote=True, codec_map=(
            ("embed*", "ternary2bit"), ("*", "sign1bit")), **plan),
         {"byzantine": byz("blind", 1, 0.9), "diagnostics": True}, "flat"),
        ("plan_weighted", opt(codec="weighted_vote", **plan),
         {"byzantine": byz("random")}, "flat"),
        ("plan_ef_sign", opt(codec="ef_sign", vote_strategy=S.PSUM_INT8,
                             **plan), {}, "flat"),
        ("mode_b_fsdp_colluding", mode_b,
         {"fsdp": True, "microbatches": 2, "byzantine": byz("colluding")},
         "any"),
    ]


def check_tp_adversary(rank):
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.distributed import mesh as pm
    mesh = ProcessMesh((4, 2), ("data", "model"))
    flips = {}
    only = os.environ.get("TPA_ONLY")
    pm.A2A_MIN_BYTES, default = 0, pm.A2A_MIN_BYTES
    for label, opt, extra, match in _tpa_cfgs():
        if only and label != only:
            continue
        cfg, tcfg = _tp_pair(opt, extra)
        flips[label] = tp_train_case(label, mesh, cfg, tcfg, draws=match)
    pm.A2A_MIN_BYTES = default
    every = [None] * WORLD
    dist.all_gather_object(every, flips)
    if rank == 0:
        RECORD["tpa_flips"] = every
    tpa_fused_gather(rank, mesh)
    tpa_reference_steps(rank, mesh)


#: the fused backward's adversaries: two of the four voters, each mode
TPA_FUSED_MODES = ("random", "colluding", "blind")


def tpa_fused_gather(rank, mesh):
    """The fused ZeRO backward over the (data 4, model 2) `mesh` with two
    adversaries of four: W (16, 12) cut ("data", "model"), rank (d, m)'s
    loss ``sum((x_d @ W[:, block m]) ** 2)`` through the gather of its
    block; rank 0 records every rank's voted block of the gradient with the
    inputs (``tpa_fused``), which the test holds to the reference's own
    ``evil_signs`` of each model block."""
    from repro_torch.configs import base
    from repro_torch.core import majority_vote as mv
    rng = np.random.default_rng(SEED + 29)
    w_full = rng.normal(size=(16, 12)).astype(np.float32)
    xs = rng.normal(size=(4, 5, 16)).astype(np.float32)
    d, m = mesh.axis_index("data"), mesh.axis_index("model")
    block = torch.from_numpy(w_full[4 * d:4 * d + 4, 6 * m:6 * m + 6])
    got = {}
    for mode in TPA_FUSED_MODES:
        byz = base.ByzantineConfig(mode=mode, num_adversaries=2, seed=3,
                                   flip_prob=0.9)
        gather = mv.make_gather_vote(0, mesh.vote_axes, vote=True, byz=byz)
        w = block.clone().requires_grad_()
        loss = torch.sum((torch.from_numpy(xs[d]) @ gather(w)) ** 2)
        got[mode] = _np(torch.autograd.grad(loss, [w])[0])
    every = [None] * WORLD
    dist.all_gather_object(every, (d, m, got))
    if rank == 0:
        RECORD["tpa_fused"] = {"w": w_full, "xs": xs, "ranks": every}


def tpa_reference_steps(rank, mesh):
    """One (data 4, model 2) step of each adversary case from the
    reference's start state and batch (``tpa_ref_<case>_start.npz``):
    each rank writes its blocks of the parameters and momentum, and its
    loss, to ``tpa_step_<case>_rank<r>.npz``."""
    from repro_torch.configs import base
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as tM
    from repro_torch.train import train_step as TS
    cases = {"random": ({}, base.ByzantineConfig(
        mode="random", num_adversaries=1, seed=3)),
             "plan_blind": ({"bucket_bytes": TPA_BUCKET_BYTES,
                             "overlap": True}, base.ByzantineConfig(
                 mode="blind", num_adversaries=1, seed=3, flip_prob=0.9))}
    # the reference may still be running beside this launch: its last
    # file marks it done (TPA_REFERENCE_WAIT seconds at most)
    done = os.path.join(SCRATCH, "tpa_ref_adaptive.json")
    deadline = time.time() + float(os.environ.get("TPA_REFERENCE_WAIT", 0))
    while not os.path.exists(done) and time.time() < deadline:
        time.sleep(0.2)
    for label, (opt_kw, byz) in cases.items():
        path = os.path.join(SCRATCH, f"tpa_ref_{label}_start.npz")
        if not os.path.exists(path):
            continue
        with np.load(path) as z:
            start = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
            tokens = z["tokens"]
        opt = base.OptimizerConfig(
            kind="signum_vote", learning_rate=REF_LR, momentum=REF_BETA,
            vote_strategy=base.VoteStrategy.ALLGATHER_1BIT, **opt_kw)
        cfg = dataclasses.replace(base.reduced_config(base.get_config(
            "glm4-9b")), dtype="float32")
        tcfg = base.TrainConfig(global_batch=REF_GB, seq_len=REF_SEQ,
                                optimizer=opt, byzantine=byz)
        art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
        mine = shd.shard_tree(start, art.param_specs, coords=art.mesh_coords,
                              sizes=art.mesh_sizes)
        params = tM.params_from_numpy(mine, device="cpu")
        state = art.optimizer.init(params)
        params, state, met = art.step_fn(params, state, {"tokens": tokens},
                                         0)
        np.savez(os.path.join(SCRATCH, f"tpa_step_{label}_rank{rank}.npz"),
                 loss=np.float64(met["loss"]),
                 **{"p/" + k: v.numpy() for k, v in params.items()},
                 **{"m/" + k: v.float().numpy()
                    for k, v in state["momentum"].items()})


def tp_reference_step(rank, mesh):
    """One (data 4, model 2) Mode A step from the reference's start state
    and batch (``tp_reference_start.npz``): each rank writes its blocks of
    the parameters and momentum, and its loss, to ``tp_step_rank<r>.npz``."""
    from repro_torch.configs import base
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as tM
    from repro_torch.train import train_step as TS
    path = os.path.join(SCRATCH, "tp_reference_start.npz")
    if not os.path.exists(path):
        return
    with np.load(path) as z:
        start = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
        tokens = z["tokens"]
    opt = base.OptimizerConfig(kind="signum_vote", learning_rate=REF_LR,
                               momentum=REF_BETA,
                               vote_strategy=base.VoteStrategy.ALLGATHER_1BIT)
    cfg = dataclasses.replace(base.reduced_config(base.get_config(
        "glm4-9b")), dtype="float32")
    tcfg = base.TrainConfig(global_batch=REF_GB, seq_len=REF_SEQ,
                            optimizer=opt)
    art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
    mine = shd.shard_tree(start, art.param_specs, coords=art.mesh_coords,
                          sizes=art.mesh_sizes)
    params = tM.params_from_numpy(mine, device="cpu")
    state = art.optimizer.init(params)
    params, state, met = art.step_fn(params, state, {"tokens": tokens}, 0)
    np.savez(os.path.join(SCRATCH, f"tp_step_rank{rank}.npz"),
             loss=np.float64(met["loss"]),
             **{"p/" + k: v.numpy() for k, v in params.items()},
             **{"m/" + k: v.float().numpy()
                for k, v in state["momentum"].items()})


def tp_reference_decode(rank):
    """Prefill and decode on a (model 4) mesh of the first 4 ranks from
    ``tp_decode_start[_int8].npz`` (parameters, prompt tokens, the decode
    length and the ticks' tokens): each rank writes the prefill's and each
    tick's logits, the decode paths its layers took and its cache blocks
    to ``tp_decode_rank<r>[_int8].npz``."""
    from repro_torch.distributed.mesh import ProcessMesh
    mesh = ProcessMesh((4,), ("model",))
    for suffix in ("", "_int8"):
        path = os.path.join(SCRATCH, f"tp_decode_start{suffix}.npz")
        if not mesh.member or not os.path.exists(path):
            continue
        with np.load(path) as z:
            start = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
            prompt, ticks = z["prompt"], z["ticks"]
            max_len, kv_dtype = int(z["max_len"]), str(z["kv_dtype"])
        out, cache = _serve_run(mesh, start, prompt, ticks, max_len,
                                kv_dtype)
        out["paths"] = np.array([f"{k}={v}" for k, v in out["paths"]])
        np.savez(os.path.join(SCRATCH, f"tp_decode_rank{rank}{suffix}.npz"),
                 **out, **{"c/" + k: v.float().numpy()
                           for k, v in cache.items()})


def _serve_run(mesh, start, prompt, ticks, max_len, kv_dtype,
               arch="glm4-9b"):
    """The port's prefill, re-home and teacher-forced ticks over `mesh`
    (`start` the full numpy parameters, cut to the rank's blocks):
    ({"prefill", "tick<i>": logits, "paths": the decode paths' counts},
    the cache blocks)."""
    from repro_torch.configs import base
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as tL
    from repro_torch.models import model as tM
    from repro_torch.train import serve_step as SS
    cfg = dataclasses.replace(base.reduced_config(base.get_config(arch)),
                              dtype="float32", kv_cache_dtype=kv_dtype)
    specs = SS.serve_param_shardings(cfg, mesh, fsdp=False)
    params = tM.params_from_numpy(shd.shard_tree(
        start, specs, coords=mesh.coords, sizes=mesh.axis_sizes),
        device="cpu")
    B, S = prompt.shape
    logits, cache = SS.make_prefill(cfg, mesh=mesh)(
        params, {"tokens": torch.as_tensor(prompt)})
    cache = SS.make_cache_rehome(cfg, B, max_len, mesh=mesh)(cache, S)
    step = SS.make_decode_step(cfg, mesh=mesh, max_len=max_len)
    out = {"prefill": SS.gather_vocab(logits, mesh).numpy()}
    tL.reset_decode_paths()
    for i, tok in enumerate(ticks):
        lg, cache = step(params, torch.as_tensor(tok)[:, None], cache,
                         S + i)
        out[f"tick{i}"] = lg.numpy()
    out["paths"] = sorted(tL.reset_decode_paths().items())
    return out, cache


#: the serving layouts held to the single-device decode on the 8 ranks:
#: (mesh, batch, cache rows, the decode path every layer must take, arch)
TP_SERVE = (("d2m4", 1, 64, "sharded_short", "glm4-9b"),  # (data, model)
            ("d2m4", 2, 64, "sharded_short", "glm4-9b"),  # batch, seq
            ("d2m4", 1, 8192, "flash_sharded", "glm4-9b"),
            ("d4m2", 4, 64, "heads", "glm4-9b"),          # batch, heads
            ("d4m2", 4, 64, "heads", "qwen1.5-32b"),
            ("d2m4", 2, 64, "sharded_short", "deepseek-67b"),
            ("d2m4", 2, 64, "sharded_short", "gemma3-12b"),
            ("d2m4", 2, 64, "sharded_short", "pixtral-12b"))


def check_tp_serve(rank, meshes):
    """Each TP_SERVE layout's prefill, re-home and 3 ticks (a float32 and
    an int8 cache) against the single-device steps on the same
    parameters: logits within rtol / atol 1e-4 (the int8 cache: 2e-2, its
    products run in bf16 and each shard's partial rounds to bf16 on its
    own), greedy tokens equal, every layer on the named decode path."""
    from repro_torch.configs import base
    from repro_torch.models import model as tM
    from repro_torch.train import serve_step as SS
    for kv in ("bfloat16", "int8"):
        for mname, B, T, path, arch in TP_SERVE:
            cfg = dataclasses.replace(base.reduced_config(base.get_config(
                arch)), dtype="float32", kv_cache_dtype=kv)
            full = tM.init_params(cfg, torch.Generator().manual_seed(5),
                                  "cpu")
            start = {k: v.numpy() for k, v in full.items()}
            rng = np.random.default_rng(B * 100 + T)
            S = 12
            prompt = rng.integers(0, cfg.vocab_size, (B, S))
            ticks = rng.integers(0, cfg.vocab_size, (3, B))
            lg, cache = SS.make_prefill(cfg)(full, {"tokens": torch.as_tensor(
                prompt)})
            cache = SS.make_cache_rehome(cfg, B, T)(cache)
            step = SS.make_decode_step(cfg)
            want = {"prefill": lg}
            for i, tok in enumerate(ticks):
                want[f"tick{i}"], cache = step(full, torch.as_tensor(tok)[
                    :, None], cache, S + i)
            got, _ = _serve_run(meshes[mname], start, prompt, ticks, T, kv,
                                arch)
            tol = 1e-4 if kv != "int8" else 2e-2
            for key, w in want.items():
                g = torch.as_tensor(got[key])
                _close(f"serve {arch} {mname} B={B} T={T} {kv} {key}", g, w,
                       rtol=tol, atol=tol)
                if not torch.equal(g.argmax(-1), w.argmax(-1)):
                    raise AssertionError(f"serve {arch} {mname} B={B} T={T} "
                                         f"{kv} {key}: greedy tokens differ")
            paths = dict(got["paths"])
            if paths != {path: 3 * cfg.num_layers}:
                raise AssertionError(f"serve {arch} {mname} B={B} T={T}: "
                                     f"decode paths {paths}, expected {path}")


# ---------------------------------------------------------------------------
# g. the model axis for the MoE, SSM, hybrid and encoder-decoder archs
# ---------------------------------------------------------------------------

#: a routing choice may differ from the twin's only at a token whose k-th
#: and (k+1)-th router probabilities are within this of each other
#: (float32: the TP sums move the router's input by a few ulps)
TP_ROUTE_TIE = 1e-5


def _tpf_cfgs():
    """(label, mesh, arch, optimizer, train options, config overrides):
    Mode A sign1bit and the arch's preset wire (its optimizer and
    microbatches, cut to the batch) on the reduced configs, so that each
    form is taken: the MoE's EP (model 2, 4) and M2 (model 8) with the
    shared branch, qwen3-moe's Mode B fsdp with 4-D fused expert leaves,
    the SSD heads-sharded, whisper's grouped / repeat / seq attention and
    a whole vocabulary (515 rows, which no model size divides)."""
    from repro_torch.configs import base, presets
    S = base.VoteStrategy

    def opt(**kw):
        d = dict(kind="signum_vote", learning_rate=1e-3, momentum=0.9,
                 vote_strategy=S.ALLGATHER_1BIT)
        d.update(kw)
        return base.OptimizerConfig(**d)

    def preset(arch):
        o = presets.default_optimizer(arch)
        return dataclasses.replace(o, learning_rate=1e-3)
    micro = {"microbatches": 2}
    q3 = "qwen3-moe-235b-a22b"
    return [
        ("moe_ep_grouped", "d4m2", "qwen2-moe-a2.7b", opt(), {}, {}),
        ("moe_ep_repeat", "d2m4", "qwen2-moe-a2.7b", opt(), {}, {}),
        ("moe_m2_seq", "m8", "qwen2-moe-a2.7b", opt(), {}, {}),
        ("moe_preset", "d2m4", "qwen2-moe-a2.7b", preset("qwen2-moe-a2.7b"),
         dict(micro, remat="full"), {}),
        ("qwen3_mode_b_fsdp", "d4m2", q3, preset(q3),
         dict(micro, fsdp=True, remat="nested"), {}),
        ("qwen3_m2", "m8", q3, opt(), {}, {}),
        ("mamba2", "d4m2", "mamba2-2.7b", opt(), {}, {}),
        ("mamba2_preset", "d2m4", "mamba2-2.7b", preset("mamba2-2.7b"),
         dict(micro, remat="full"), {}),
        ("zamba2", "d2m4", "zamba2-1.2b", opt(), {}, {}),
        ("zamba2_preset", "m8", "zamba2-1.2b", preset("zamba2-1.2b"),
         dict(micro, remat="full"), {}),
        ("whisper_grouped", "d4m2", "whisper-tiny", opt(), {}, {}),
        ("whisper_repeat", "d2m4", "whisper-tiny", opt(), {}, {}),
        ("whisper_seq", "m8", "whisper-tiny", opt(), {}, {}),
        ("whisper_vocab515", "d2m4", "whisper-tiny",
         preset("whisper-tiny"), dict(micro, remat="full"),
         {"vocab_size": 515}),
    ]


class RouteRecorder:
    """Within the block, every ``moe.route_topk`` call's experts and the
    margin of each token's k-th over its (k+1)-th router probability."""

    def __init__(self):
        self.calls, self.flips = [], 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route_topk

        def route(logits, k):
            out = self.orig(logits, k)
            probs = torch.sort(torch.softmax(logits.float(), -1), -1,
                               descending=True)[0]
            margin = (probs[:, k - 1] - probs[:, k] if probs.shape[1] > k
                      else torch.full_like(probs[:, 0], torch.inf))
            self.calls.append((out[1].detach().clone(), margin.detach()))
            return out
        moe.route_topk = route
        return self

    def __exit__(self, *exc):
        self.moe.route_topk = self.orig


def route_flips(label, mine, twin, voter, n_voters):
    """The tokens whose routing differs between this rank's calls `mine`
    and the twin's calls of its voter (the twin runs every voter's calls
    in turn), each required at a near tie (TP_ROUTE_TIE)."""
    per = len(twin) // n_voters
    if len(mine) != per:
        raise AssertionError(f"{label}: {len(mine)} routing calls, the "
                             f"twin's voter made {per}")
    flips = 0
    for (e, _), (te, margin) in zip(mine, twin[voter * per:(voter + 1)
                                               * per]):
        bad = (torch.sort(e, -1)[0] != torch.sort(te, -1)[0]).any(-1)
        if bool((bad & (margin >= TP_ROUTE_TIE)).any()):
            raise AssertionError(f"{label}: a token's experts differ from "
                                 "the twin's away from a near tie")
        flips += int(bad.sum())
    return flips


#: one decode per arch against the single-device steps: (mesh, arch,
#: batch, cache rows, the decode paths a tick takes, by kind: a count per
#: layer or shared-block call); the MoE with capacity factor E / k, so no
#: token is dropped however its rows are split
TPF_SERVE = (
    ("d2m4", "qwen2-moe-a2.7b", 2, 64, {"sharded_short": 1}),
    ("d4m2", "qwen3-moe-235b-a22b", 4, 64, {"heads": 1}),
    ("d2m4", "mamba2-2.7b", 2, 64, {}),
    ("d2m4", "zamba2-1.2b", 2, 64, {"shared_sharded": 1}),
    ("d4m2", "zamba2-1.2b", 4, 64, {"shared_heads": 1}),
    ("d2m4", "whisper-tiny", 2, 64, {"sharded_short": 1,
                                     "cross_sharded": 1}),
)
TPF_TICKS = 4


def _family_cfg(arch):
    from repro_torch.configs import base
    cfg = dataclasses.replace(base.reduced_config(base.get_config(arch)),
                              dtype="float32")
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def check_tpf_serve(rank, meshes):
    """Each TPF_SERVE case's prefill, re-home and TPF_TICKS ticks over its
    mesh against the single-device steps on the same parameters: logits
    within rtol / atol 1e-4, greedy tokens equal, every tick's
    model-group bytes ``chip_smoke.tp_tick_bytes``'s, the decode paths
    the layout's."""
    from repro_torch.configs.base import ArchFamily
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as tL
    from repro_torch.models import model as tM
    from repro_torch.models.hybrid import _segments
    from repro_torch.train import serve_step as SS
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    for mname, arch, B, T, paths in TPF_SERVE:
        mesh = meshes[mname]
        cfg = _family_cfg(arch)
        full = tM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        rng = np.random.default_rng(B * 100 + T)
        S = 12
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                        (B, S)))}
        if cfg.family == ArchFamily.AUDIO:
            batch["enc_embeds"] = torch.as_tensor(rng.normal(size=(
                B, TP_FRAMES, cfg.d_model)).astype(np.float32))
        ticks = rng.integers(0, cfg.vocab_size, (TPF_TICKS, B))
        lg, cache = SS.make_prefill(cfg)(full, batch)
        cache = SS.make_cache_rehome(cfg, B, T)(cache)
        step = SS.make_decode_step(cfg)
        want = {"prefill": lg}
        for i, tok in enumerate(ticks):
            want[f"tick{i}"], cache = step(full, torch.as_tensor(tok)[
                :, None], cache, S + i)
        specs = SS.serve_param_shardings(cfg, mesh, fsdp=False)
        params = {k: v.clone() for k, v in shd.shard_tree(
            full, specs, coords=mesh.coords, sizes=mesh.axis_sizes).items()}
        lg, cache = SS.make_prefill(cfg, mesh=mesh)(params, batch)
        cache = SS.make_cache_rehome(cfg, B, T, mesh=mesh)(cache, S,
                                                           TP_FRAMES)
        step = SS.make_decode_step(cfg, mesh=mesh, max_len=T)
        got = {"prefill": SS.gather_vocab(lg, mesh, cfg.vocab_size)}
        glob = SS._global_shapes(cfg, B, T)
        specs = {k: SS.cache_leaf_spec(k, v, mesh.axis_sizes)
                 for k, v in glob.items()}
        rows = B // shd.spec_block(next(iter(specs.values())), mesh.coords,
                                   mesh.axis_sizes)[1][1]
        attn = next((specs[k] for k in ("k", "attn_k") if k in specs), None)
        expect = chip_smoke.tp_tick_bytes(
            cfg, mesh, rows, seq_sharded=bool(attn and attn[2]),
            cross_sharded=bool("xk" in specs and specs["xk"][2]))
        tL.reset_decode_paths()
        for i, tok in enumerate(ticks):
            mesh.reset_stats()
            got[f"tick{i}"], cache = step(params, torch.as_tensor(tok)[
                :, None], cache, S + i)
            if mesh.model_stats.bytes != expect:
                raise AssertionError(
                    f"serve {arch} {mname} tick {i}: the model group took "
                    f"{mesh.model_stats.bytes} bytes, the layout's count is "
                    f"{expect}")
        # the prefill's logits stay the rank's rows of the vocab's shard
        if tuple(got["prefill"].shape) != tuple(want["prefill"].shape):
            raise AssertionError(f"serve {arch}: prefill logits "
                                 f"{tuple(got['prefill'].shape)}")
        for key, w in want.items():
            g = got[key]
            _close(f"serve {arch} {mname} {key}", g, w, rtol=1e-4,
                   atol=1e-4)
            if not torch.equal(g.argmax(-1), w.argmax(-1)):
                raise AssertionError(f"serve {arch} {mname} {key}: greedy "
                                     "tokens differ")
        per = (sum(s[2] for s in _segments(cfg))
               if cfg.family == ArchFamily.HYBRID else cfg.num_layers)
        want_paths = {k: v * per * TPF_TICKS for k, v in paths.items()}
        if dict(tL.reset_decode_paths()) != want_paths:
            raise AssertionError(f"serve {arch} {mname}: decode paths "
                                 f"differ from {want_paths}")


def _flat_state(params, state):
    """{"params/<leaf>", "opt/<key>/<leaf>": tensor} of a (params, state)
    pair, as a checkpoint names its arrays."""
    from repro_torch.checkpoint.checkpoint import _flatten
    out = {"params/" + k: v for k, v in params.items()}
    out.update({"opt/" + k: v for k, v in _flatten(state).items()})
    return out


def _eq_tree(what, got, want):
    if set(got) != set(want):
        raise AssertionError(f"{what}: leaves {sorted(set(got) ^ set(want))}")
    for k, w in want.items():
        g = got[k]
        if not (torch.is_tensor(g) and torch.is_tensor(w)):
            # a Python count, restored as the reference's int32 scalar
            if int(g) != int(w):
                raise AssertionError(f"{what}: {k} {g} != {w}")
            continue
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: {k} differs")


def _load_npz(path):
    """A step directory's arrays as tensors (bf16 restored from its bits,
    by the checkpoint's own dtype map)."""
    from repro_torch.checkpoint.checkpoint import _from_host
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: _from_host(z[k], dtypes.get(k), torch.device("cpu"))
                for k in z.files}


#: the checkpoint cases: (label, arch, optimizer, train options)
def _ck_cfgs():
    from repro_torch.configs import base, presets
    q3 = "qwen3-moe-235b-a22b"
    mode_b = dataclasses.replace(presets.default_optimizer(q3),
                                 learning_rate=1e-3)
    sign1 = base.OptimizerConfig(
        kind="signum_vote", learning_rate=1e-3, momentum=0.9,
        vote_strategy=base.VoteStrategy.ALLGATHER_1BIT)
    return (("qwen3_mode_b_fsdp", q3, mode_b,
             {"fsdp": True, "microbatches": 2, "remat": "nested"}),
            ("mamba2_mode_a", "mamba2-2.7b", sign1, {}))


def check_tpf_checkpoint(rank):
    """A model-sharded state on (data 2, model 2) (world ranks 0-3) saved
    after step 0: the files equal the stacked save of the state joined by
    :func:`_tp_join`; restored on the same mesh it is the rank's blocks
    bit for bit and takes step 1 bit-equal to the uninterrupted run;
    restored on (data 4, model 1) and (data 1, model 4) its blocks join
    back to the files' arrays (the per-voter rows refit: zero rows for the
    new voters, the first row kept for one); restored stacked it is the
    files' arrays."""
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.configs import base
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.train import train_step as TS
    quad = (0, 1, 2, 3)
    meshes = {"d2m2": ProcessMesh((2, 2), ("data", "model"), ranks=quad),
              "d4m1": ProcessMesh((4,), ("data",), ranks=quad),
              "d1m4": ProcessMesh((4,), ("model",), ranks=quad)}
    for label, arch, opt, extra in _ck_cfgs():
        cfg = _family_cfg(arch)
        tcfg = base.TrainConfig(global_batch=TP_GB, seq_len=TP_SEQ,
                                optimizer=opt, **extra)
        root = os.path.join(SCRATCH, f"tpf_ck_{label}")
        pipe = SyntheticLMPipeline(cfg, tcfg.global_batch, TP_SEQ, seed=0)
        batches = [tp_batch(cfg, tcfg, pipe, s) for s in range(2)]
        mesh = meshes["d2m2"]
        if mesh.member:
            art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
            params, state = TS.materialize_state(
                cfg, tcfg, art, torch.Generator().manual_seed(0))
            params, state, _ = art.step_fn(params, state, batches[0], 0)
            saved = {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in _flat_state(params, state).items()}
            path = ck.save(os.path.join(root, "mesh"), 1, params, state,
                           mesh=mesh, art=art)
            joined = _tp_join(art, tcfg, mesh, params, state)
            if rank == 0:
                ck.save(os.path.join(root, "stacked"), 1, *joined)
                files = _load_npz(path)
                _eq_tree(f"{label} files", files, _load_npz(os.path.join(
                    root, "stacked", os.path.basename(path))))
            params, state, _ = art.step_fn(params, state, batches[1], 1)
            after = _flat_state(params, state)
            rp, rs, _, _ = ck.restore(os.path.join(root, "mesh"),
                                      device="cpu", mesh=mesh, art=art)
            _eq_tree(f"{label} restored on d2m2", _flat_state(rp, rs), saved)
            rp, rs, _ = art.step_fn(rp, rs, batches[1], 1)
            _eq_tree(f"{label} resumed step 1", _flat_state(rp, rs), after)
        dist.barrier()
        files = _load_npz(os.path.join(ck.latest_step_dir(
            os.path.join(root, "mesh"))))
        for name in ("d4m1", "d1m4"):
            mesh = meshes[name]
            if not mesh.member:
                continue
            art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=mesh)
            rp, rs, _, _ = ck.restore(os.path.join(root, "mesh"),
                                      device="cpu", mesh=mesh, art=art)
            jp, js = _tp_join(art, tcfg, mesh, rp, rs)
            want = {}
            for k, v in files.items():
                if _voter_key(k, opt):
                    v = ck.refit_leading_axis(v, (mesh.size,) + tuple(
                        v.shape[1:]))
                want[k] = v
            _eq_tree(f"{label} restored on {name}", _flat_state(jp, js),
                     want)
        if rank == 0:
            twin = TS.make_train_step(cfg, tcfg, 2, device="cpu")
            lp, ls = TS.materialize_state(cfg, tcfg, twin,
                                          torch.Generator().manual_seed(0))
            rp, rs, _, _ = ck.restore(os.path.join(root, "mesh"), lp, ls,
                                      device="cpu")
            _eq_tree(f"{label} restored stacked", _flat_state(rp, rs),
                     files)


def _voter_key(key, opt):
    """Whether the flat array `key` holds one row a voter."""
    from repro_torch.core import signum
    group = key.split("/")[1] if key.startswith("opt/") else ""
    return group == "error" or (group == "momentum"
                                and signum.per_worker(opt))


def check_tp_families_ref(rank):
    """The port's side of ``tests/torch_tp_reference.py families``: from
    each ``tpf_ref_<arch>_start.npz`` one (data 4, model 2) Mode A step,
    each rank writing its loss and blocks of the parameters and momentum
    to ``tpf_step_<arch>_rank<r>.npz``; from each
    ``tpf_dec_<arch>_start.npz`` the prefill, re-home and teacher-forced
    ticks on a (model 4) mesh of the first 4 ranks, each writing its
    logits to ``tpf_dec_<arch>_rank<r>.npz``."""
    from repro_torch.configs import base
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import ProcessMesh
    from repro_torch.models import model as tM
    from repro_torch.train import serve_step as SS
    from repro_torch.train import train_step as TS
    d4m2 = ProcessMesh((4, 2), ("data", "model"))
    m4 = ProcessMesh((4,), ("model",), ranks=(0, 1, 2, 3))
    for path in sorted(glob.glob(os.path.join(SCRATCH,
                                              "tpf_ref_*_start.npz"))):
        arch = os.path.basename(path)[len("tpf_ref_"):-len("_start.npz")]
        with np.load(path) as z:
            start = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
            batch = {k[2:]: torch.as_tensor(z[k]) for k in z.files
                     if k.startswith("b/")}
        opt = base.OptimizerConfig(
            kind="signum_vote", learning_rate=REF_LR, momentum=REF_BETA,
            vote_strategy=base.VoteStrategy.ALLGATHER_1BIT)
        cfg = _family_cfg(arch)
        tcfg = base.TrainConfig(global_batch=REF_GB, seq_len=REF_SEQ,
                                optimizer=opt)
        art = TS.make_train_step(cfg, tcfg, device="cpu", mesh=d4m2)
        params = tM.params_from_numpy(shd.shard_tree(
            start, art.param_specs, coords=art.mesh_coords,
            sizes=art.mesh_sizes), device="cpu")
        state = art.optimizer.init(params)
        params, state, met = art.step_fn(params, state, batch, 0)
        np.savez(os.path.join(SCRATCH, f"tpf_step_{arch}_rank{rank}.npz"),
                 loss=np.float64(met["loss"]),
                 **{"p/" + k: v.numpy() for k, v in params.items()},
                 **{"m/" + k: v.float().numpy()
                    for k, v in state["momentum"].items()})
    for path in sorted(glob.glob(os.path.join(SCRATCH,
                                              "tpf_dec_*_start.npz"))):
        if not m4.member:
            continue
        arch = os.path.basename(path)[len("tpf_dec_"):-len("_start.npz")]
        with np.load(path) as z:
            start = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
            batch = {k[2:]: torch.as_tensor(z[k]) for k in z.files
                     if k.startswith("b/")}
            ticks = z["ticks"]
        cfg = _family_cfg(arch)
        specs = SS.serve_param_shardings(cfg, m4, fsdp=False)
        params = tM.params_from_numpy(shd.shard_tree(
            start, specs, coords=m4.coords, sizes=m4.axis_sizes),
            device="cpu")
        B, S = batch["tokens"].shape
        lg, cache = SS.make_prefill(cfg, mesh=m4)(params, batch)
        src = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
        cache = SS.make_cache_rehome(cfg, B, TPF_REF_T, mesh=m4)(cache, S,
                                                                  src)
        step = SS.make_decode_step(cfg, mesh=m4, max_len=TPF_REF_T)
        out = {"prefill": SS.gather_vocab(lg, m4, cfg.vocab_size).numpy()}
        for i, tok in enumerate(ticks):
            lg, cache = step(params, torch.as_tensor(tok).long()[:, None],
                             cache, S + i)
            out[f"tick{i}"] = lg.numpy()
        np.savez(os.path.join(SCRATCH, f"tpf_dec_{arch}_rank{rank}.npz"),
                 **out)


#: the reference decodes' cache rows (``torch_tp_reference.FDEC_T``)
TPF_REF_T = 64


def check_tp_families(rank):
    from repro_torch.configs import base
    from repro_torch.distributed import mesh as pm
    from repro_torch.distributed.mesh import ProcessMesh
    meshes = {name: ProcessMesh(shape, axes)
              for name, shape, axes in TP_MESHES}
    pm.A2A_MIN_BYTES, default = 0, pm.A2A_MIN_BYTES
    flips, routes = {}, {}
    only = os.environ.get("TPF_ONLY")
    for label, mname, arch, opt, extra, over in _tpf_cfgs():
        if only and only not in label:
            continue
        cfg = dataclasses.replace(base.reduced_config(base.get_config(
            arch)), dtype="float32", **over)
        tcfg = base.TrainConfig(global_batch=TP_GB, seq_len=TP_SEQ,
                                optimizer=opt, **extra)
        mesh = meshes[mname]
        with RouteRecorder() as rec:
            flips[label] = tp_train_case(label, mesh, cfg, tcfg,
                                         routes=rec)
        routes[label] = rec.flips
        if rank == 0:
            print(f"  tp_families {label}", flush=True)
    pm.A2A_MIN_BYTES = default
    every = [None] * WORLD
    dist.all_gather_object(every, {"flips": flips, "routes": routes})
    if rank == 0:
        RECORD["tp_families"] = every
    if not only or only == "serve":
        check_tpf_serve(rank, meshes)
    if not only or only == "checkpoint":
        check_tpf_checkpoint(rank)


CHECKS = (("votes", check_votes), ("plans", check_plans),
          ("trainer", check_trainer), ("drills", check_drills))
#: checks run only when named on the command line
NAMED_CHECKS = (("fsdp", check_fsdp), ("tp", check_tp),
                ("tp_adversary", check_tp_adversary),
                ("tp_families", check_tp_families),
                ("tp_families_ref", check_tp_families_ref))


def worker(rank, scratch, names=None):
    global SCRATCH
    SCRATCH = scratch
    torch.set_num_threads(1)
    init = os.path.join(scratch, "torch_mesh_store")
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=WORLD)
    checks = (CHECKS if not names else
              [c for c in CHECKS + NAMED_CHECKS if c[0] in names])
    record = "mesh_record.pkl" if not names else "_".join(names) + \
        "_record.pkl"
    try:
        for name, fn in checks:
            t0 = time.perf_counter()
            fn(rank)
            dist.barrier()
            if rank == 0:
                print(f"OK {name} {time.perf_counter() - t0:.1f}s",
                      flush=True)
        if rank == 0:
            with open(os.path.join(scratch, record), "wb") as f:
                pickle.dump(RECORD, f)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    scratch = os.path.abspath(argv[1] if len(argv) > 1 else ".")
    init = os.path.join(scratch, "torch_mesh_store")
    if os.path.exists(init):
        os.remove(init)
    t0 = time.perf_counter()
    mp.spawn(worker, args=(scratch, tuple(argv[2:])), nprocs=WORLD,
             join=True)
    print(f"ALL OK {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
