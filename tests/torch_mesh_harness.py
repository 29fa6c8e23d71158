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


CHECKS = (("votes", check_votes), ("plans", check_plans),
          ("trainer", check_trainer), ("drills", check_drills))
#: checks run only when named on the command line
NAMED_CHECKS = (("fsdp", check_fsdp),)


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
