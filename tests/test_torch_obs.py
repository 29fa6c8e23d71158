"""Parity tests of the port's telemetry (``repro_torch.obs``) against the
JAX package's (``repro.obs``): the counter registry's semantics, the span
rows' nesting, the vote API's ``vote.*`` counters and the plan walk's
``plan.buckets`` counter and ``plan.*`` spans for the same requests, and a
port trace read back by the reference's ``read_trace`` with the reference's
row keys. The port's ``plan.issue`` spans carry ``pred_s`` None (no H100
link model yet, ROADMAP.md Queue 1 item 15).
"""
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

from repro import sim as jsim  # noqa: E402
from repro.configs.base import ByzantineConfig as JByz  # noqa: E402
from repro.configs.base import VoteStrategy as JS  # noqa: E402
from repro.core import vote_api as jva  # noqa: E402
from repro.core import vote_plan as jvp  # noqa: E402
from repro.obs import recorder as jobs  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.configs.base import ByzantineConfig as TByz  # noqa: E402
from repro_torch.configs.base import VoteStrategy as TS  # noqa: E402
from repro_torch.core import vote_api as tva  # noqa: E402
from repro_torch.core import vote_plan as tvp  # noqa: E402
from repro_torch.obs import recorder as tobs  # noqa: E402


def _program(obs):
    reg = obs.CounterRegistry()
    reg.inc("a.x")
    reg.inc("a.x", 41)
    reg.inc("a.y", 2 ** 70)
    reg.set("b.gauge", 7)
    reg.set("b.gauge", 3)
    reg.record_max("b.high", 5)
    reg.record_max("b.high", 2)
    before = reg.snapshot()
    reg.inc("a.x", 5)
    reg.inc("c.z", 3)
    out = [reg.snapshot(), reg.snapshot("a."), reg.delta_since(before),
           reg.delta_since(before, "a."), reg.get("missing")]
    reg.reset("a.")
    out.append(reg.snapshot())
    reg.reset()
    return out + [reg.snapshot()]


def test_counter_registry_as_the_reference():
    assert _program(tobs) == _program(jobs)


def _span_rows(obs):
    buf = io.StringIO()
    rec = obs.TraceRecorder(buf, meta={"harness": "unit"})
    with rec.span("outer", kind="test"):
        with rec.span("inner1"):
            rec.event("e", n=1)
        with rec.span("inner2") as s:
            s.set(late=1)
    rec.step(step=0, loss=1.5)
    rec.close()
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    drop = ("t0_s", "dur_s", "unix_time")
    return [{k: v for k, v in r.items() if k not in drop and k != "values"}
            for r in rows]


def test_span_rows_as_the_reference():
    assert _span_rows(tobs) == _span_rows(jobs)


def test_noop_recorder_and_scoping():
    rec = tobs.Recorder()
    assert not rec.enabled and rec.span("a", x=1) is rec.span("b")
    assert not tobs.get_recorder().enabled
    live = tobs.TraceRecorder(io.StringIO())
    with tobs.recording(live) as r:
        assert tobs.get_recorder() is r is live
    assert not tobs.get_recorder().enabled
    prev = tobs.set_recorder(live)
    assert tobs.get_recorder() is live and not prev.enabled
    tobs.set_recorder(None)
    assert not tobs.get_recorder().enabled


def test_read_trace_rejects_schema_drift(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text(json.dumps({"v": 99, "kind": "step"}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        tobs.read_trace(str(p))
    p.write_text(json.dumps({"v": 1, "kind": "nope"}) + "\n")
    with pytest.raises(ValueError, match="unknown row kind"):
        tobs.read_trace(str(p))


def _plans():
    # shapes no other test compiles, so the reference's walk traces afresh
    shapes = {"embed.table": (4, 31), "layers.w": (101,)}
    kw = dict(bucket_bytes=8, codec_map=(("embed*", "ternary2bit"),),
              data_size=5)
    return (jvp.build_plan(shapes, strategy=JS.ALLGATHER_1BIT, **kw),
            tvp.build_plan(shapes, strategy=TS.ALLGATHER_1BIT, **kw))


@pytest.mark.parametrize("case", ["leaf_wire", "failures", "plan"])
def test_vote_and_plan_counters_as_the_reference(case):
    jplan, tplan = _plans()
    n = jplan.n_params if case == "plan" else 70
    x = np.random.default_rng(0).normal(size=(5, n)).astype(np.float32)
    kw = dict(form="stacked", strategy={"leaf_wire": "psum_int8",
                                        "failures": "hierarchical",
                                        "plan": "allgather_1bit"}[case])
    byz = dict(mode="random", num_adversaries=2, seed=1) \
        if case == "failures" else None
    deltas = []
    for va, obs, S, Byz, plan, payload in (
            (jva, jobs, JS, JByz, jplan, jnp.asarray(x)),
            (tva, tobs, TS, TByz, tplan, x)):
        before = obs.COUNTERS.snapshot()
        req = va.VoteRequest(
            payload=payload, strategy=S(kw["strategy"]), form="stacked",
            plan=plan if case == "plan" else None,
            failures=va.FailureSpec(byz=Byz(**byz) if byz else None),
            step=None)
        backend = (va.VirtualBackend(device="cpu") if va is tva
                   else va.VirtualBackend())
        backend.execute(req)
        deltas.append({k: v for k, v in obs.COUNTERS.delta_since(before)
                       .items() if k.startswith(("vote.", "plan."))})
    assert deltas[0] == deltas[1]
    assert deltas[1]["vote.requests"] == 1
    if case == "plan":
        assert deltas[1]["plan.buckets"] == tplan.n_buckets
    # the reference counts the walk's buckets at trace time (once per
    # compilation of a request); the port runs eagerly, once per call
    before = tobs.COUNTERS.snapshot()
    backend.execute(req)
    assert tobs.COUNTERS.delta_since(before, "vote.") == {
        k: v for k, v in deltas[1].items() if k.startswith("vote.")}


def _trace(sim, obs, path, spec, **kw):
    rec = obs.TraceRecorder(str(path))
    with obs.recording(rec):
        trace = sim.ScenarioRunner(spec, **kw).run()
    rec.close()
    return trace


def test_port_trace_reads_back_with_the_reference_keys(tmp_path):
    """A drill traced by the port: the reference's read_trace accepts every
    row, the step rows carry the reference's keys and values, the spans
    are the reference's, and tracing leaves the digest as it was."""
    spec = tsim.ScenarioSpec(
        "obs/x", n_workers=5, n_steps=3, dim=64,
        strategy=TS.ALLGATHER_1BIT,
        adversary=tsim.AdversarySpec("blind", 0.4, flip_prob=0.8),
        plan=tsim.PlanSpec(bucket_bytes=4))
    port = _trace(tsim, tobs, tmp_path / "port.jsonl", spec, device="cpu")
    ref = _trace(jsim, jobs, tmp_path / "ref.jsonl",
                 jsim.ScenarioSpec.from_dict(spec.to_dict()))
    prow = jobs.read_trace(str(tmp_path / "port.jsonl"))
    rrow = jobs.read_trace(str(tmp_path / "ref.jsonl"))
    psteps = [r for r in prow if r["kind"] == "step"]
    rsteps = [r for r in rrow if r["kind"] == "step"]
    assert len(psteps) == len(rsteps) == 3
    for p, r in zip(psteps, rsteps):
        assert sorted(p) == sorted(r)
        assert sorted(p["phase_s"]) == sorted(r["phase_s"])
        for k in ("scenario", "backend", "step", "n_voters", "n_adversaries",
                  "n_stale", "strategy", "codec", "payload_bytes",
                  "n_messages", "n_coords", "compression_vs_f32"):
            assert p[k] == r[k], k

    def names(rows):
        return {r["name"] for r in rows if r["kind"] == "span"}
    assert names(prow) == names(rrow)
    issue = [r for r in prow if r["kind"] == "span"
             and r["name"] == "plan.issue"]
    rissue = [r for r in rrow if r["kind"] == "span"
              and r["name"] == "plan.issue"]
    assert sorted(issue[0]["attrs"]) == sorted(rissue[0]["attrs"])
    assert all(r["attrs"]["pred_s"] is None for r in issue)
    assert prow[-1]["kind"] == "counters"
    plain = tsim.ScenarioRunner(spec, device="cpu").run()
    assert plain.digest == port.digest
    assert ref.digest                     # the reference's own run
