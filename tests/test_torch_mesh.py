"""The multi-process wire (``repro_torch.distributed.mesh``, ``MeshBackend``,
the mesh trainer) and the vote diagnostics.

The 8-rank gloo world runs once, in a subprocess
(``tests/torch_mesh_harness.py``, its checks a-d, each reported here as its
own test): on the mesh every vote, plan walk, trainer step and drill equals
the port's stacked path bit for bit (the dense sgd within its mean's
rounding bound). The reference's own tier-2 suite proves its mesh path
equal to its virtual one, so no JAX process is spawned there.

What the mesh gave, with the inputs it was given (the harness's record),
is then held here against the reference on those same inputs:

* every vote request (leaf, tree and stacked forms, stale voters, the
  oblivious adversaries, ``weighted_vote``'s state in the gathered
  data-major order) and every plan walk: the mesh's votes, server state
  and wire report equal to the reference's ``VirtualBackend`` bit for bit;
* each adversary's rows gathered from the ranks equal to the reference's
  ``apply_adversary_stacked`` of the same signs;
* each drill's digest and margins, run on the reference's draws (handed
  to the harness as numpy), equal to the reference's virtual
  ``ScenarioRunner`` for the reference's own tier-2 harness specs;
* the mesh trainer: one step of 4 ranks from the start state and batch of
  the M = 4 step composed from the reference's functions
  (``tests/torch_train_step_common.py``), held to it by that module's
  teacher-forced criteria (losses and momenta within float32 rounding,
  every vote whose inputs are not within rounding of zero equal).

In this process, against the reference:

* the tree form over empty vote axes (M = 1, the vote the local sign):
  votes, ``margin`` and ``agreement`` equal to the reference's
  ``MeshBackend(axes=())``, leaf-wise and through a plan;
* the trainer's diagnostics at M = 1 against the reference's
  ``make_train_step(cfg, tcfg, mesh=None)`` with ``diagnostics=True``: the
  margin equal within 1 float32 ulp (both are a count over the coordinate
  count in float32; the reference's jitted division may be a product with
  the reciprocal); the agreement equal within 1 ulp on ``ternary2bit``
  (both abstain on a zero input), and on the 1-bit wire, which votes +1
  where the reference's M = 1 vote is 0 (ROADMAP.md Queue 3), equal to the
  reference's minus the fraction of exactly-zero vote inputs;
* the stacked trainer's agreement at M = 4 against voter 0's own signs
  and the vote it applied, computed by hand;
* the backends' refusals and their reasons.
"""
import ast
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

import torch_mesh_harness as harness_mod  # noqa: E402
import torch_train_step_common as common  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.configs.base import (ByzantineConfig,  # noqa: E402
                                OptimizerConfig, TrainConfig, VoteStrategy,
                                get_config, reduced_config)
from repro.core import byzantine as jbyz  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core import vote_plan as jvp  # noqa: E402
from repro.sim import runner as jrunner  # noqa: E402
from repro.data.pipeline import SyntheticLMPipeline  # noqa: E402
from repro.train import train_step as jTS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.distributed import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

HARNESS = Path(__file__).with_name("torch_mesh_harness.py")
SRC = Path(__file__).resolve().parents[1] / "src"
#: the harness's checks, in its order
CHECKS = ("votes", "plans", "trainer", "drills")


def _reference_harness_specs():
    """The reference's tier-2 harness specs, read from
    ``tests/tier2/scenario_harness.py`` without importing it (its import
    asks XLA for 8 host devices)."""
    src = (Path(__file__).parent / "tier2" / "scenario_harness.py"
           ).read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "harness_specs")
    ns = {"VoteStrategy": VoteStrategy, "AdversarySpec": jsim.AdversarySpec,
          "ElasticEvent": jsim.ElasticEvent, "PlanSpec": jsim.PlanSpec,
          "ScenarioSpec": jsim.ScenarioSpec}
    exec(compile(ast.Module([fn], []), "scenario_harness.py", "exec"), ns)
    return ns["harness_specs"]()


def _reference_draws(specs):
    """The reference's start point of each spec and its noise for every
    step and every voter count the drill reaches."""
    x0, table = {}, {}
    for spec in specs:
        j = jsim.ScenarioSpec.from_dict(spec.to_dict())
        x0[spec.name] = np.asarray(jrunner._init_x(j))
        counts = {spec.n_workers} | {e.n_workers for e in spec.elastic}
        for step in range(spec.n_steps):
            for m in counts:
                table[(spec.name, step, m)] = np.asarray(
                    jrunner._noise(j, step, m))
    return x0, table


@pytest.fixture(scope="module")
def composed():
    """The reference's M = 4 step, composed from its functions: (states,
    losses, batches) of one step."""
    assert (common.GB, common.SEQ, common.LR, common.BETA) == (
        harness_mod.REF_GB, harness_mod.REF_SEQ, harness_mod.REF_LR,
        harness_mod.REF_BETA)
    return common._composed_run("sign1bit", 1)


@pytest.fixture(scope="module")
def harness(tmp_path_factory, composed):
    """One launch of the 8-rank harness, given the reference's draws and
    start state: its exit code, output and scratch directory."""
    scratch = tmp_path_factory.mktemp("mesh")
    with open(scratch / "draws.pkl", "wb") as f:
        pickle.dump(_reference_draws(harness_mod.harness_specs()), f)
    states, _, batches = composed
    np.savez(scratch / "reference_step.npz", tokens=batches[0],
             **{"p/" + k: v for k, v in states[0]["params"].items()})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    out = subprocess.run(
        [sys.executable, str(HARNESS), str(scratch)],
        capture_output=True, text=True, timeout=900, env=env)
    return out.returncode, out.stdout, out.stderr, scratch


@pytest.mark.parametrize("check", CHECKS)
def test_eight_rank_mesh_equals_the_stacked_path(harness, check):
    rc, stdout, stderr, _ = harness
    assert f"OK {check} " in stdout, (
        f"harness exit {rc}\n{stdout[-3000:]}\n{stderr[-6000:]}")
    if check == CHECKS[-1]:
        assert rc == 0 and "ALL OK" in stdout, stderr[-6000:]


# ---------------------------------------------------------------------------
# the harness's record against the reference, on the same inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def record(harness):
    rc, stdout, stderr, scratch = harness
    assert rc == 0, f"harness exit {rc}\n{stdout[-3000:]}\n{stderr[-6000:]}"
    with open(scratch / "mesh_record.pkl", "rb") as f:
        return pickle.load(f)


def _jfailures(d):
    if d is None:
        return jva.FailureSpec()
    return jva.FailureSpec(n_stale=d["n_stale"], byz=None if d["byz"] is None
                           else ByzantineConfig(**d["byz"]))


def _jwire(w):
    return (w.n_voters, w.payload_bytes, w.n_messages,
            getattr(w.strategy, "value", None))


def _held(what, got, want):
    np.testing.assert_array_equal(
        np.asarray(got).astype(np.int8).reshape(-1),
        np.asarray(want).astype(np.int8).reshape(-1), err_msg=what)


def _held_state(r, out):
    if r["mesh_ema"] is None:
        return
    want = np.asarray(out.server_state["flip_ema"])
    if r["order"] is not None:
        want = want[r["order"]]
    np.testing.assert_array_equal(r["mesh_ema"], want,
                                  err_msg=r["what"] + " flip_ema")


def _check_votes(rec):
    x, prev = rec["x"], rec["prev"]
    back, cache = jva.VirtualBackend(), {}
    assert len(rec["votes"]) > 200
    for r in rec["votes"]:
        m = r["m"]
        kw = dict(payload=jnp.asarray(x[:m]), form="stacked",
                  strategy=VoteStrategy(r["strategy"]), codec=r["codec"],
                  failures=_jfailures(r["failures"]), step=r["step"],
                  salt=r["salt"])
        if r["prev"]:
            kw["prev"] = jnp.asarray(prev[:m])
        if r["ema"] is not None:
            kw["server_state"] = {"flip_ema": jnp.asarray(r["ema"])}
        key = (m, r["prev"], r["strategy"], r["codec"], repr(r["failures"]),
               r["step"], r["salt"], None if r["ema"] is None
               else r["ema"].tobytes())
        if key not in cache:
            cache[key] = back.execute(jva.VoteRequest(**kw))
        out = cache[key]
        _held(r["what"], r["votes"], out.votes)
        _held_state(r, out)
        if r["wire"] is not None:
            assert r["wire"] == _jwire(out.wire), r["what"]


def _check_adversary(rec):
    assert len(rec["adversary"]) == 15
    for r in rec["adversary"]:
        want = jbyz.apply_adversary_stacked(
            jnp.asarray(r["signs"]), ByzantineConfig(**r["cfg"]),
            step=r["step"], salt=r["salt"])
        _held(r["what"], r["rows"], want)


def _check_plans(rec):
    x, shapes = rec["plan_x"], rec["plan_shapes"]
    back = jva.VirtualBackend()
    assert len(rec["plans"]) == 33
    for r in rec["plans"]:
        plan = jvp.build_plan(shapes, bucket_bytes=r["bucket_bytes"],
                              codec_map=r["codec_map"],
                              default_codec=r["default"],
                              strategy=VoteStrategy(r["strategy"]),
                              data_size=r["data"], pod_size=r["pod"])
        kw = dict(payload=jnp.asarray(x[:r["m"]]), form="stacked", plan=plan)
        if r["ema"] is not None:
            kw["server_state"] = {"flip_ema": jnp.asarray(r["ema"])}
        if r["byz"] is not None:
            kw.update(failures=jva.FailureSpec(byz=ByzantineConfig(
                **r["byz"])), step=r["step"])
        out = back.execute(jva.VoteRequest(**kw))
        _held(r["what"], r["votes"], out.votes)
        _held_state(r, out)


def _check_drills(rec):
    specs = harness_mod.harness_specs()
    assert [s.to_dict() for s in specs] == [
        s.to_dict() for s in _reference_harness_specs()]
    assert sorted(rec["drills"]) == sorted(s.name for s in specs)
    for spec in specs:
        got = rec["drills"][spec.name]
        assert got["reference_draws"]
        want = jsim.ScenarioRunner(jsim.ScenarioSpec.from_dict(
            spec.to_dict())).run()
        assert got["digest"] == want.digest, spec.name
        assert got["margins"] == [s.margin for s in want.steps], spec.name


def _check_trainer(rec, scratch, composed):
    states, losses, _ = composed
    ranks = [np.load(scratch / f"mesh_step_rank{r}.npz")
             for r in range(common.M4)]
    names = [k[2:] for k in ranks[0].files if k.startswith("p/")]
    assert sorted(names) == sorted(states[0]["params"])
    for z in ranks[1:]:
        assert float(z["loss"]) == float(ranks[0]["loss"])
        for k in names:
            np.testing.assert_array_equal(z["p/" + k], ranks[0]["p/" + k])
    port = {"loss": float(ranks[0]["loss"]),
            "params": {k: ranks[0]["p/" + k] for k in names},
            "momentum": {k: np.stack([z["m/" + k] for z in ranks])
                         for k in names}}
    common._check_teacher_forced(states[0], {"loss": losses[0],
                                             **states[1]}, port)


@pytest.mark.parametrize("part", ["votes", "adversary", "plans", "drills",
                                  "trainer"])
def test_mesh_record_equals_the_reference(record, harness, composed, part):
    if part == "trainer":
        _check_trainer(record, harness[3], composed)
    else:
        {"votes": _check_votes, "adversary": _check_adversary,
         "plans": _check_plans, "drills": _check_drills}[part](record)


# ---------------------------------------------------------------------------
# the tree form at M = 1 against the reference
# ---------------------------------------------------------------------------


def _tree(rng):
    a = rng.normal(size=(6, 11)).astype(np.float32)
    b = rng.normal(size=(37,)).astype(np.float32)
    a[1, :4] = 0.0                          # abstaining coordinates
    b[3] = 1e-39                            # a subnormal abstains too
    return {"a": a, "b": b}


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("codec", ["sign1bit", "ternary2bit"])
def test_tree_diagnostics_without_axes_match_reference(codec, plan):
    tree = _tree(np.random.default_rng(3))
    kw = dict(form="tree", codec=codec, diagnostics=True,
              strategy=VoteStrategy.ALLGATHER_1BIT)
    tkw = dict(kw, strategy=tbase.VoteStrategy.ALLGATHER_1BIT)
    if plan:
        shapes = {k: v.shape for k, v in tree.items()}
        kw["plan"] = jvp.build_plan(shapes, bucket_bytes=4,
                                    default_codec=codec,
                                    strategy=VoteStrategy.ALLGATHER_1BIT)
        tkw["plan"] = tvp.build_plan(
            shapes, bucket_bytes=4, default_codec=codec,
            strategy=tbase.VoteStrategy.ALLGATHER_1BIT)
    want = jva.MeshBackend(axes=()).execute(jva.VoteRequest(
        payload={k: jnp.asarray(v) for k, v in tree.items()}, **kw))
    got = tva.MeshBackend(axes=(), device="cpu").execute(tva.VoteRequest(
        payload={k: torch.from_numpy(v) for k, v in tree.items()}, **tkw))
    for k in tree:
        np.testing.assert_array_equal(got.votes[k].numpy(),
                                      np.asarray(want.votes[k]))
    assert got.wire.margin == float(want.wire.margin)
    assert got.wire.agreement == float(want.wire.agreement)
    w = want.wire
    assert (got.wire.n_voters, got.wire.payload_bytes, got.wire.n_messages,
            getattr(got.wire.strategy, "value", None)) == (
        w.n_voters, w.payload_bytes, w.n_messages,
        getattr(w.strategy, "value", None))


# ---------------------------------------------------------------------------
# the trainer's diagnostics at M = 1 against the reference
# ---------------------------------------------------------------------------

GB, SEQ = 4, 32


def _diag_run(codec):
    """One reference step with diagnostics from its init and the port's
    step from the same state: (reference metrics, port metrics, the
    fraction of exactly-zero vote inputs)."""
    jcfg = dataclasses.replace(reduced_config(get_config("glm4-9b")),
                               dtype="float32")
    opt = dict(kind="signum_vote", learning_rate=1e-3, momentum=0.9,
               codec=codec)
    jtcfg = TrainConfig(global_batch=GB, seq_len=SEQ, diagnostics=True,
                        optimizer=OptimizerConfig(
                            vote_strategy=VoteStrategy.ALLGATHER_1BIT,
                            **opt))
    art = jTS.make_train_step(jcfg, jtcfg, mesh=None)
    params, opt_state = jTS.materialize_state(jcfg, jtcfg, art,
                                              jax.random.PRNGKey(0))
    start = {k: np.array(v) for k, v in params.items()}
    tokens = SyntheticLMPipeline(jcfg, GB, SEQ, seed=0).global_batch_at(0)[
        "tokens"]
    _, jstate, jmet = art.step_fn(params, opt_state,
                                  {"tokens": jnp.asarray(tokens)},
                                  jnp.int32(0))
    zeros = sum(int((np.array(m) == 0).sum())
                for m in jstate["momentum"].values())
    total = sum(v.size for v in start.values())

    tcfg = dataclasses.replace(
        tbase.reduced_config(tbase.get_config("glm4-9b")), dtype="float32")
    ttcfg = tbase.TrainConfig(global_batch=GB, seq_len=SEQ, diagnostics=True,
                              optimizer=tbase.OptimizerConfig(
                                  vote_strategy=(
                                      tbase.VoteStrategy.ALLGATHER_1BIT),
                                  **opt))
    tart = tTS.make_train_step(tcfg, ttcfg, 1, device="cpu")
    tp = tM.params_from_numpy(start, device="cpu")
    ts = tart.optimizer.init(tp)
    _, _, tmet = tart.step_fn(tp, ts, {"tokens": tokens}, 0)
    return jmet, tmet, zeros / total


def _ulps(a, b) -> float:
    return abs(a - b) / float(np.spacing(np.float32(max(abs(a), abs(b)))))


@pytest.mark.parametrize("codec", ["sign1bit", "ternary2bit"])
def test_m1_trainer_diagnostics_match_reference(codec):
    jmet, tmet, zero_frac = _diag_run(codec)
    assert isinstance(tmet["vote_margin"], float)
    assert _ulps(tmet["vote_margin"], float(jmet["vote_margin"])) <= 1
    want = float(jmet["vote_agreement"])
    if codec == "sign1bit":
        # the 1-bit wire votes +1 where the vote input is exactly 0
        assert zero_frac > 0
        want = float(np.float32(want) - np.float32(zero_frac))
        assert abs(tmet["vote_agreement"] - want) <= 2e-7
    else:
        assert _ulps(tmet["vote_agreement"], want) <= 1


def test_stacked_trainer_agreement_is_voter_zeros_own_signs():
    """At M = 4 stacked (int8 counts) with an honest voter 0, the
    agreement compares voter 0's own signs with the vote, not the tally
    its signs start: the fraction of coordinates where the sign of voter
    0's gradient is the applied vote (signSGD on the 1-bit wire, no weight
    decay, so the vote is the sign of each parameter's step)."""
    from repro_torch.core import sign_compress as sc
    cfg = dataclasses.replace(
        tbase.reduced_config(tbase.get_config("glm4-9b")), dtype="float32")
    tcfg = tbase.TrainConfig(
        global_batch=GB, seq_len=SEQ, diagnostics=True,
        optimizer=tbase.OptimizerConfig(
            kind="signsgd_vote", momentum=0.0, learning_rate=1e-3,
            weight_decay=0.0,
            vote_strategy=tbase.VoteStrategy.ALLGATHER_1BIT))
    art = tTS.make_train_step(cfg, tcfg, 4, device="cpu")
    params, state = tTS.materialize_state(cfg, tcfg, art,
                                          torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in params.items()}
    tokens = torch.as_tensor(SyntheticLMPipeline(cfg, GB, SEQ, seed=0)
                             .global_batch_at(0)["tokens"])
    own, _ = tTS.voter_grads(cfg, tcfg, start, tokens[:GB // 4])
    params, _, met = art.step_fn(params, state, {"tokens": tokens}, 0)
    agree = total = 0
    for k, p in start.items():
        vote = torch.sign(p - params[k])
        assert bool((vote != 0).all()), k
        agree += int((sc.sign_ternary(own[k]).float() == vote).sum())
        total += vote.numel()
    assert abs(met["vote_agreement"] - agree / total) <= 1e-6


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_backends_refuse_with_the_reference_reasons():
    x = np.zeros((3, 8), np.float32)
    stream = tva.PopulationStream(n_voters=3, n_coords=8,
                                  values=lambda ids: x[:len(ids)])
    jstream = jva.PopulationStream(n_voters=3, n_coords=8,
                                   values=lambda ids: x[:len(ids)])
    back = tva.MeshBackend(device="cpu")
    for req, jreq in (
            (tva.VoteRequest(payload=stream, form="streamed"),
             jva.VoteRequest(payload=jstream, form="streamed")),
            (tva.VoteRequest(payload=x, form="stacked",
                             voter_ids=np.arange(3)),
             jva.VoteRequest(payload=x, form="stacked",
                             voter_ids=np.arange(3)))):
        assert back.why_unsupported(req) == \
            jva.MeshBackend().why_unsupported(jreq)
    leaf = tva.VoteRequest(payload=torch.zeros(8))
    assert "run over a mesh's vote axes" in back.why_unsupported(leaf)
    assert "needs 3 ranks for 3 voters, have 1" in back.why_unsupported(
        tva.VoteRequest(payload=x, form="stacked"))
    assert "not 'leaf'" in tva.VirtualBackend(
        device="cpu").why_unsupported(leaf)
    with pytest.raises(ValueError, match="must be bound to their"):
        tva.MeshBackend(axes=("data",), device="cpu")
    # a model axis needs its ranks (one world rank here); over a world of
    # 8 every arch's train step builds on (data 4, model 2), with the
    # stochastic adversaries and a VotePlan too, and an adaptive adversary
    # raises the reference's ValueError when the step is called
    with pytest.raises(ValueError, match="the world has 1"):
        tmesh.ProcessMesh((1, 2), ("data", "model"))
    from torch_tp_common import assert_train_builds_and_refusals, fake_world
    with fake_world(8, rank=2):
        assert_train_builds_and_refusals(tmesh.ProcessMesh(
            (4, 2), ("data", "model")))
    # the fused ZeRO backward runs since the thirteenth slice: on a
    # one-rank mesh its gather is the identity and its backward the sign
    # of the gradient (ties 0), the dense form the gradient itself
    from repro_torch.core import majority_vote as tmv
    one = tmesh.ProcessMesh((1,), ("data",)).vote_axes
    w = torch.tensor([[1.0, -2.0], [0.5, 3.0]], requires_grad=True)
    x = torch.tensor([[1.0, 0.0], [-1.0, 2.0]])
    for vote in (True, False):
        hook = tmv.make_fsdp_hooks({"layers.w": 1}, one, vote=vote)
        g = torch.autograd.grad(
            torch.sum((x @ hook({"w": w}, "layers")["w"]) ** 2), [w])[0]
        plain = torch.autograd.grad(torch.sum((x @ w) ** 2), [w])[0]
        assert torch.equal(g, torch.sign(plain) if vote else plain)
        assert hook.issued == ["layers.w", "layers.w"]
    with pytest.raises(ValueError, match="has 1"):
        tmesh.ProcessMesh((2,), ("data",))
    # diagnostics belong to the tree form; an adaptive adversary to the
    # stacked and streamed forms, as in the reference
    with pytest.raises(ValueError, match="voted tree"):
        tva.VoteRequest(payload=torch.zeros(8), diagnostics=True)
    with pytest.raises(ValueError, match="no such observation channel"):
        tva.VoteRequest(payload={"a": torch.zeros(8)}, form="tree",
                        failures=tva.FailureSpec(byz=tbase.ByzantineConfig(
                            mode="adaptive_flip", num_adversaries=1)),
                        attack_obs={"prev_vote": np.zeros(8, np.int8)})
