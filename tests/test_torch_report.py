"""The port's trace report (``repro_torch.obs.report``) against the JAX
package's (``repro.obs.report``).

A trace the reference records (a Scenario Lab drill through a VotePlan,
walked synchronously and double-buffered, with its step rows) is rendered
by both reports: ``summarize`` must give equal dicts and ``render`` equal
text. A trace the port's trainer records on the CPU through an AUTO plan
(``bucket_bytes = -1``, overlap on) must render every section, carry a
non-null ``pred_s`` on every bucket and cite the paper's 1/32, and the
command line must print the same aggregate as JSON.
"""
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite's test workers already share the cores
torch.set_num_threads(1)

import torch_train_step_common as tts  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.configs.base import VoteStrategy as JS  # noqa: E402
from repro.obs import recorder as jobs  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.obs import recorder as tobs  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402
from repro_torch.train import train_step as tTS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference_trace(path, overlap):
    spec = jsim.ScenarioSpec(
        f"report/{overlap}", n_workers=5, n_steps=3, dim=96,
        strategy=JS.ALLGATHER_1BIT,
        adversary=jsim.AdversarySpec("blind", 0.4, flip_prob=0.8),
        plan=jsim.PlanSpec(bucket_bytes=4, overlap=overlap))
    # the reference records its spans when it traces: trace afresh
    jax.clear_caches()
    rec = jobs.TraceRecorder(str(path), meta={"harness": "report"})
    with jobs.recording(rec):
        jsim.ScenarioRunner(spec).run()
    rec.close()


@pytest.mark.parametrize("overlap", [False, True])
def test_reference_trace_reports_as_the_reference(tmp_path, overlap):
    path = tmp_path / "ref.jsonl"
    _reference_trace(path, overlap)
    got, want = treport.summarize(str(path)), jreport.summarize(str(path))
    assert got == want
    assert got["buckets"] and got["schedules"] and got["steps"]["n_steps"]
    assert any(w["overlap"] for w in got["schedules"]) == overlap
    assert treport.render(str(path)) == jreport.render(str(path))
    assert treport.SECTIONS == jreport.SECTIONS
    assert treport.IDEAL_RATIO == jreport.IDEAL_RATIO


def _port_trainer_trace(path, steps=2):
    """The port's trainer at M = 4 through an AUTO plan (bucket_bytes -1,
    overlap on) on the CPU, recorded; each step's row carries the plan's
    wire payload per voter."""
    cfg, tcfg = tts._tcfgs()
    tcfg = tbase.TrainConfig(
        global_batch=tcfg.global_batch, seq_len=tcfg.seq_len,
        optimizer=tbase.OptimizerConfig(
            kind="signum_vote", learning_rate=tts.LR, momentum=tts.BETA,
            vote_strategy=tbase.VoteStrategy.AUTO, bucket_bytes=-1,
            overlap=True))
    art = tTS.make_train_step(cfg, tcfg, tts.M4, device="cpu")
    params, state = tTS.materialize_state(cfg, tcfg, art,
                                          torch.Generator().manual_seed(0))
    plan = art.plan
    payload = sum(g.total * tcodecs.get_codec(g.codec).wire_bits(g.strategy)
                  / 8.0 for g in plan.groups)
    rng = np.random.default_rng(3)
    rec = tobs.TraceRecorder(str(path), meta={"harness": "report"})
    with tobs.recording(rec):
        for step in range(steps):
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (tcfg.global_batch, tcfg.seq_len)))
            with rec.span("train.step", step=step):
                params, state, met = art.step_fn(params, state,
                                                 {"tokens": tokens}, step)
            rec.step(kind_detail="train", step=step,
                     loss=float(met["loss"]), payload_bytes=payload,
                     n_coords=plan.n_params, n_voters=tts.M4)
    rec.close()
    return plan


def test_port_trainer_trace_renders_every_section(tmp_path):
    path = tmp_path / "port.jsonl"
    plan = _port_trainer_trace(path)
    text = treport.render(str(path))
    for section in treport.SECTIONS:
        assert f"== {section} ==" in text
    for empty in ("(no spans)", "(no plan.schedule walks",
                  "(no bucketed walks", "(no counters snapshot"):
        assert empty not in text
    assert "paper ideal 1/32" in text
    s = treport.summarize(str(path))
    assert len(s["buckets"]) == plan.n_buckets
    assert all(b["predicted_s"] is not None and b["predicted_s"] > 0
               for b in s["buckets"])
    assert all(w["overlap"] == (plan.n_buckets > 1) for w in s["schedules"])
    assert s["steps"]["n_steps"] == 2
    # the reference's report reads the port's trace alike
    assert s == jreport.summarize(str(path))


def test_report_command_line(tmp_path):
    path = tmp_path / "port.jsonl"
    _port_trainer_trace(path, steps=1)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(path),
         "--json"], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout)
    want = json.loads(json.dumps(treport.summarize(str(path)), default=str))
    assert got == want and got["buckets"]
    buf = io.StringIO()
    sys_stdout, sys.stdout = sys.stdout, buf
    try:
        assert treport.main([str(path)]) == 0
    finally:
        sys.stdout = sys_stdout
    assert buf.getvalue().rstrip("\n") == treport.render(str(path))
