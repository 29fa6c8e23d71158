"""The port's serving engine, hot swap, traffic and serve launcher
(``repro_torch.serve``, ``repro_torch.launch.serve``) against the JAX
package on the CPU.

* The engine, greedy and float32, with the reference tests' engine shape
  ``SC = ServeConfig(n_slots=3, max_len=32, prompt_pad=8)``: every case of
  the reference's ``tests/test_serve_engine.py`` (one request, staggered
  slots, mamba2 inline, prefill admission, EOS, ``max_ticks``, static
  against continuous) gives the reference engine's tokens on the same
  requests and parameters, token for token, and the reference's
  schedule-level assertions on the port's reports; a temperature > 0 run
  too (handed the reference's Gumbel noise: the port's uniforms are
  ``jax.random.uniform``'s bit for bit, its noise within PyTorch's float32
  ``log``, an ulp from XLA's on some draws).
* Builds: one decode build across engines, schedulers and admission modes.
* Hot swap over the port's checkpoint: zero dropped, post-swap tokens equal
  to an engine started on the new parameters, versions never decreasing,
  each checkpoint surfaced once.
* Traffic schedules bit-equal to the reference's; ``ServeConfig`` and the
  traffic generator raise where the reference's do; the engine refuses
  recurrent prefill admission and oversize prompts.
* A traced run gives the untraced tokens and records the reference's span
  and counter names.
* ``python -m repro_torch.launch.serve`` in both modes on the CPU.
"""
import dataclasses
import os
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

from repro import serve as jS  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro_torch import serve as tS  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.obs import recorder as obs  # noqa: E402
from repro_torch.serve import engine as tE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(n_slots=3, max_len=32, prompt_pad=8)
SC = tS.ServeConfig(**SHAPE)


def _pair(arch, seed=0):
    """(reference cfg, its params, port cfg, its params): the float32
    reduced arch, the reference's init handed over as numpy."""
    jc = dataclasses.replace(jbase.reduced_config(jbase.get_config(arch)),
                             dtype="float32")
    tc = dataclasses.replace(tbase.reduced_config(tbase.get_config(arch)),
                             dtype="float32")
    jp = jM.init_params(jc, jax.random.PRNGKey(seed))
    tp = tM.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def dense():
    return _pair("glm4-9b")


@pytest.fixture(scope="module")
def ssm():
    return _pair("mamba2-2.7b")


def _reqs(n, seed=3, rate=0.5, lens=(4, 6, 8), gens=(3, 6), vocab=512):
    """The same schedule from both packages' generators (asserted equal)."""
    kw = dict(n_requests=n, rate=rate, vocab_size=vocab, prompt_lens=lens,
              gen_range=gens, seed=seed)
    t, j = tS.poisson_requests(**kw), jS.poisson_requests(**kw)
    assert [dataclasses.astuple(r) for r in t] == [
        dataclasses.astuple(r) for r in j]
    return j, t


def _both(pair, reqs, **sc):
    """The reference engine's and the port's reports on the same
    requests, parameters and engine config."""
    jc, jp, tc, tp = pair
    jrep = jS.ServeEngine(jc, jp, jS.ServeConfig(**{**SHAPE, **sc})).run(
        reqs[0])
    trep = tS.ServeEngine(tc, tp, tS.ServeConfig(**{**SHAPE, **sc})).run(
        reqs[1])
    assert trep.tokens_by_request() == jrep.tokens_by_request()
    for f in ("ticks", "completed", "dropped", "total_tokens",
              "goodput_tokens_per_tick", "ttft_p50", "latency_p50",
              "latency_p95", "latency_p99", "tpot_mean", "occupancy_mean"):
        assert getattr(trep, f) == getattr(jrep, f), f
    return jrep, trep


def _oracle(cfg, params, r, max_len):
    """Batch-1 greedy decode through the port's model API (the reference
    test's oracle)."""
    cache = tM.init_cache(cfg, 1, max_len, device="cpu")
    tok, out, pos = r.prompt[0], [], 0
    budget = min(r.max_gen, max_len - r.prompt_len)
    while len(out) < budget:
        logits, cache = tM.decode_step(cfg, params, torch.tensor([[tok]]),
                                       cache, pos)
        if pos + 1 < r.prompt_len:
            tok = r.prompt[pos + 1]
        else:
            tok = int(torch.argmax(logits[0]))
            out.append(tok)
        pos += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------


def test_single_request_matches_the_reference_and_the_oracle(dense):
    reqs = _reqs(1)
    _, trep = _both(dense, reqs)
    r = reqs[1][0]
    assert trep.completed == 1 and trep.dropped == 0
    assert trep.tokens_by_request()[r.req_id] == _oracle(
        dense[2], dense[3], r, SC.max_len)


def test_staggered_slots_match_the_reference(dense):
    reqs = _reqs(7, seed=5)
    _, trep = _both(dense, reqs)
    assert trep.completed == 7 and trep.dropped == 0
    toks = trep.tokens_by_request()
    for r in reqs[1][:3]:
        assert toks[r.req_id] == _oracle(dense[2], dense[3], r, SC.max_len)
    assert len({rec.slot for rec in trep.records.values()}) <= SC.n_slots


def test_ssm_inline_matches_the_reference(ssm):
    reqs = _reqs(4, seed=9)
    _, trep = _both(ssm, reqs)
    assert trep.completed == 4 and trep.dropped == 0
    toks = trep.tokens_by_request()
    for r in reqs[1][:2]:   # recurrent state is reset at admission
        assert toks[r.req_id] == _oracle(ssm[2], ssm[3], r, SC.max_len)


def test_prefill_admission_matches_inline_and_the_reference(dense):
    reqs = _reqs(5, seed=11)
    _, tp = _both(dense, reqs, admit="prefill", prefill_buckets=(4, 6, 8))
    ti = tS.ServeEngine(dense[2], dense[3], SC).run(reqs[1])
    assert ti.tokens_by_request() == tp.tokens_by_request()


def test_eos_retires_early(dense):
    reqs = _reqs(1, seed=23, gens=(6, 6))
    probe = tS.ServeEngine(dense[2], dense[3], SC).run(reqs[1])
    first = probe.tokens_by_request()[reqs[1][0].req_id][0]
    _, trep = _both(dense, reqs, eos_id=first)
    assert trep.completed == 1
    assert trep.tokens_by_request()[reqs[1][0].req_id] == (first,)


def test_max_ticks_reports_dropped(dense):
    jc, jp, tc, tp = dense
    reqs = _reqs(3, seed=29)
    jrep = jS.ServeEngine(jc, jp, jS.ServeConfig(**SHAPE)).run(
        reqs[0], max_ticks=3)
    trep = tS.ServeEngine(tc, tp, SC).run(reqs[1], max_ticks=3)
    assert trep.dropped == jrep.dropped > 0
    assert trep.completed + trep.dropped == 3
    assert trep.tokens_by_request() == jrep.tokens_by_request()


def test_continuous_beats_static_goodput(dense):
    reqs = _reqs(8, seed=19, rate=0.6)
    _, cont = _both(dense, reqs)
    _, stat = _both(dense, reqs, scheduler="static")
    assert cont.completed == stat.completed == 8
    assert cont.goodput_tokens_per_tick > stat.goodput_tokens_per_tick
    assert cont.tokens_by_request() == stat.tokens_by_request()


def _reference_gumbel(key, n, dtype):
    """The reference's Gumbel noise for each row's key words, as the
    port's dtype (handed over: PyTorch's float32 log may differ from
    XLA's by an ulp)."""
    rows = [np.asarray(jax.random.gumbel(
        jnp.asarray([int(a), int(b)], jnp.uint32), (n,),
        jnp.dtype(str(dtype).split(".")[-1]))) for a, b in zip(*key)]
    return tM.params_from_numpy({"g": np.stack(rows)}, "cpu")["g"]


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-moe-a2.7b"])
def test_temperature_sampling_matches_the_reference(arch, dense,
                                                    monkeypatch):
    """Temperature 0.8: the port's sampler handed the reference's noise
    for its rows' keys, so every token is the reference's."""
    monkeypatch.setattr(tE, "gumbel", _reference_gumbel)
    pair = dense if arch == "glm4-9b" else _pair(arch)
    _both(pair, _reqs(5, seed=41), temperature=0.8, seed=7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sampling_noise_is_the_references(dtype):
    """Each row's key fold_in(fold_in(PRNGKey(seed), req), pos) and its
    uniforms bit for bit; the Gumbel noise bit for bit in bf16 and within
    rtol / atol 1e-6 in float32 (PyTorch's log against XLA's)."""
    req, pos, seed, n = [0, 3, 70000], [5, 0, 2 ** 31 - 1], 11, 1000
    key = tE.sample_keys(seed, torch.tensor(req), torch.tensor(pos))
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    u, g = tE.uniform(key, n, tdt), tE.gumbel(key, n, tdt)
    for i, (r, p) in enumerate(zip(req, pos)):
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), r), p)
        assert [int(key[0][i]), int(key[1][i])] == np.asarray(k).tolist()
        want_u = np.asarray(jax.random.uniform(
            k, (n,), jdt, minval=jnp.finfo(jdt).tiny, maxval=1.0))
        np.testing.assert_array_equal(u[i].float().numpy(),
                                      want_u.astype(np.float32))
        want_g = np.asarray(jax.random.gumbel(k, (n,), jdt)).astype(
            np.float32)
        tol = 0 if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(g[i].float().numpy(), want_g, rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------


def test_one_decode_build_across_engines(dense):
    tc, tp = dense[2], dense[3]
    sc = tS.ServeConfig(n_slots=2, max_len=24, prompt_pad=6)
    reqs = _reqs(4, seed=13, lens=(4, 6))[1]
    before = obs.COUNTERS.get("serve.decode.compiles")
    t1 = tS.ServeEngine(tc, tp, sc).run(reqs).tokens_by_request()
    assert obs.COUNTERS.get("serve.decode.compiles") - before == 1
    t2 = tS.ServeEngine(tc, tp, sc).run(reqs).tokens_by_request()
    assert obs.COUNTERS.get("serve.decode.compiles") - before == 1
    assert t1 == t2


def test_scheduler_and_admit_share_builds(dense):
    tc, tp = dense[2], dense[3]
    reqs = _reqs(4, seed=17)[1]
    tS.ServeEngine(tc, tp, SC).run(reqs)     # warm the shared key
    before = obs.COUNTERS.snapshot("serve.")
    for sc in (tS.ServeConfig(**SHAPE, scheduler="static"),
               tS.ServeConfig(**SHAPE, admit="prefill",
                              prefill_buckets=(8,))):
        tS.ServeEngine(tc, tp, sc).run(reqs)
    built = obs.COUNTERS.delta_since(before, "serve.")
    assert "serve.decode.compiles" not in built
    assert "serve.admit.compiles" not in built
    # one prefill build for the one bucket (a fresh key's first use), at
    # most: an earlier test may have built it
    assert built.get("serve.prefill.compiles", 0) <= 1


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------


def test_hot_swap_zero_dropped_and_fresh_engine_oracle(dense, tmp_path):
    tc, tp = dense[2], dense[3]
    tp2 = tM.params_from_numpy({k: np.asarray(v) for k, v in jM.init_params(
        dense[0], jax.random.PRNGKey(42)).items()}, device="cpu")
    reqs = _reqs(6, seed=31)[1]
    emitter = tS.CheckpointEmitter(str(tmp_path))
    eng = tS.ServeEngine(tc, tp, SC, watcher=tS.CheckpointWatcher(
        str(tmp_path), tS.like_tree(tp), device="cpu"))

    def on_tick(_e, t):
        if t == 8:
            emitter.emit(100, tp2)

    rep = eng.run(reqs, on_tick=on_tick)
    assert rep.dropped == 0 and rep.swaps == 1
    assert eng.param_version == 1
    post = [r for r in reqs
            if rep.records[r.req_id].param_version_admit == 1]
    pre = [r for r in reqs if r not in post]
    assert post and pre, "the swap must split the request stream"
    toks = rep.tokens_by_request()
    fresh = tS.ServeEngine(tc, tp2, SC).run(
        [r.with_arrival(0.0) for r in post]).tokens_by_request()
    for r in post:
        assert toks[r.req_id] == fresh[r.req_id] == _oracle(
            tc, tp2, r, SC.max_len)
    vs = [rep.records[r.req_id].param_version_admit for r in
          sorted(reqs, key=lambda r: rep.records[r.req_id].admit_tick)]
    assert vs == sorted(vs)


def test_watcher_surfaces_each_checkpoint_once(dense, tmp_path):
    tp = dense[3]
    emitter = tS.CheckpointEmitter(str(tmp_path))
    watcher = tS.CheckpointWatcher(str(tmp_path), tS.like_tree(tp),
                                   device="cpu")
    assert watcher.poll() is None
    emitter.emit(5, tp)
    upd = watcher.poll()
    assert upd is not None and upd.version == 1 and upd.step == 5
    assert watcher.poll() is None
    assert sorted(upd.params) == sorted(tp)
    for k, v in tp.items():
        assert torch.equal(upd.params[k], v), k
    assert all(t.device.type == "meta" for t in tS.like_tree(tp).values())
    emitter.emit(6, {k: v.to(torch.bfloat16) for k, v in tp.items()})
    upd = watcher.poll()
    assert (upd.version, upd.step) == (2, 6)
    assert all(v.dtype == torch.bfloat16 for v in upd.params.values())


# ---------------------------------------------------------------------------
# traffic and validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_requests=16, rate=0.4, vocab_size=1000, seed=4),
    dict(n_requests=24, rate=0.05, vocab_size=151_552, seed=18,
         prompt_lens=(128, 256, 512), gen_range=(32, 96)),
    dict(n_requests=5, rate=3.0, vocab_size=7, seed=2 ** 40 + 3,
         start_id=1000, start_tick=12.5),
])
def test_traffic_is_the_references(kw):
    t, j = tS.poisson_requests(**kw), jS.poisson_requests(**kw)
    assert [dataclasses.astuple(r) for r in t] == [
        dataclasses.astuple(r) for r in j]
    assert tS.poisson_requests(**{**kw, "n_requests": 4}) == t[:4]


@pytest.mark.parametrize("kw", [
    dict(n_requests=-1, rate=0.5, vocab_size=10),
    dict(n_requests=1, rate=0.0, vocab_size=10),
    dict(n_requests=1, rate=0.5, vocab_size=10, prompt_lens=()),
    dict(n_requests=1, rate=0.5, vocab_size=10, gen_range=(0, 3)),
    dict(n_requests=1, rate=0.5, vocab_size=10, gen_range=(5, 3)),
])
def test_traffic_validation_is_the_references(kw):
    with pytest.raises(ValueError) as want:
        jS.poisson_requests(**kw)
    with pytest.raises(ValueError) as got:
        tS.poisson_requests(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(n_slots=0),
    dict(prompt_pad=0),
    dict(prompt_pad=65),               # > max_len=64
    dict(admit="bogus"),
    dict(scheduler="bogus"),
    dict(admit="prefill"),             # no buckets
    dict(admit="prefill", prefill_buckets=(8, 4)),
    dict(admit="prefill", prefill_buckets=(128,)),
])
def test_serve_config_validation_is_the_references(kw):
    with pytest.raises(ValueError) as want:
        jS.ServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        tS.ServeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_engine_rejects_recurrent_prefill(ssm):
    with pytest.raises(ValueError, match="recurrent"):
        tS.ServeEngine(ssm[2], ssm[3], tS.ServeConfig(
            admit="prefill", prefill_buckets=(8,)))


def test_engine_rejects_oversize_prompt_and_audio(dense):
    bad = tS.Request(req_id=0, arrival=0.0,
                     prompt=tuple(range(SC.prompt_pad + 1)), max_gen=4)
    with pytest.raises(ValueError, match="prompt length"):
        tS.ServeEngine(dense[2], dense[3], SC).run([bad])
    wc = tbase.reduced_config(tbase.get_config("whisper-tiny"))
    with pytest.raises(ValueError, match="AUDIO"):
        tS.ServeEngine(wc, dense[3], SC)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def test_traced_run_identical_and_recorded(dense, tmp_path):
    tc, tp = dense[2], dense[3]
    reqs = _reqs(4, seed=37)[1]
    base = tS.ServeEngine(tc, tp, SC).run(reqs)
    path = os.path.join(str(tmp_path), "trace.jsonl")
    rec = obs.TraceRecorder(path)
    with obs.recording(rec):
        traced = tS.ServeEngine(tc, tp, SC).run(reqs)
    rec.close()
    assert traced.tokens_by_request() == base.tokens_by_request()
    rows = obs.read_trace(path)
    steps = [r for r in rows if r["kind"] == "step"]
    assert len(steps) == traced.ticks
    assert all(s["param_version"] == 0 and s["kind_detail"] == "serve"
               for s in steps)
    span_names = {r["name"] for r in rows if r["kind"] == "span"}
    assert {"serve.admit", "serve.decode", "serve.retire"} <= span_names
    counters = [r for r in rows if r["kind"] == "counters"][-1]["values"]
    assert counters["serve.admissions"] >= 4
    assert counters["serve.tokens"] >= traced.total_tokens
    for name in ("serve.ticks", "serve.retired",
                 "serve.slot_occupancy_ticks", "serve.decode.compiles"):
        assert counters[name] > 0, name


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-2.7b", "whisper-tiny"])
def test_launcher_batch_loop(arch, capsys, tmp_path):
    path = tmp_path / "t.jsonl"
    assert tlaunch.main(["--device", "cpu", "--arch", arch, "--reduced",
                         "--batch", "2", "--prompt-len", "8", "--gen", "4",
                         "--trace", str(path)]) == 0
    out = capsys.readouterr().out
    assert "prefill: 2x8 in" in out and "decode: 4 steps x batch 2" in out
    ids = out.split("sampled token ids (first row):")[1].split("\n")[0]
    assert len(eval(ids)) == 5
    names = {r["name"] for r in obs.read_trace(str(path))
             if r["kind"] == "span"}
    assert {"serve.prefill", "serve.decode"} <= names


def test_launcher_engine_runs_as_a_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "glm4-9b", "--reduced", "--engine", "--requests", "4",
         "--batch", "2", "--prompt-len", "8", "--gen", "4",
         "--temperature", "0.7"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "engine: 4/4 requests, 16 tokens in" in out.stdout
    assert "latency ticks p50/p95/p99:" in out.stdout
